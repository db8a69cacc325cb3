"""The rows a tiled backstep kernel can get wrong, shared by the CPU parity
tests (tests/test_torch_backstep.py) and the card tests
(tests/test_torch_cuda.py).  NumPy only: the card's machine has no JAX.

backstep stages a warp's 32 rows at a time and runs blocks of 128 or 256
threads, so the cases are row counts around those tiles, rows at the word
and block edges of a 256-row block, the table's ends and the sentinel's
row, rows past either end (clamped into the table), and repeated and
unsorted rows."""

import numpy as np

# Row counts: one row, a part of one tile, around a block of 256 threads,
# and a prime near 10^4.
COUNTS = (1, 7, 255, 256, 257, 10_007)
# Bits of a block: the first and last of words 0, 1 and 4, and of the block.
BITS = (0, 31, 32, 127, 128, 255)
CASES = (*(f"count {n}" for n in COUNTS), "block bits", "table edges", "past either end", "repeated", "unsorted")


def case_rows(case: str, bwt_len: int, nbits: int, sentinel_row: int, seed: int = 0) -> np.ndarray:
    """int64 rows of ``case`` over a table of ``bwt_len`` rows in ``nbits``
    bits (whole blocks) whose sentinel symbol sits at ``sentinel_row``.
    Only "past either end" holds rows outside [0, bwt_len)."""
    rng = np.random.default_rng(seed)
    if case.startswith("count "):
        return rng.integers(0, bwt_len, size=int(case.split()[1]))
    if case == "block bits":
        blocks = rng.choice(bwt_len // 256, size=min(40, bwt_len // 256), replace=False)
        return (blocks[:, None] * 256 + np.array(BITS)[None, :]).reshape(-1)
    if case == "table edges":
        around = [max(sentinel_row - 1, 0), min(sentinel_row + 1, bwt_len - 1)]
        return np.array([0, sentinel_row, bwt_len - 1, 1, *around, bwt_len - 2, 255, 256,
                         bwt_len - 1 - (bwt_len - 1) % 256])
    if case == "past either end":
        return np.array([nbits, nbits + 1, nbits + 257, 1 << 40, -1, -4, -(1 << 40), nbits - 1, 0, bwt_len - 1])
    if case == "repeated":
        # Whole tiles of one row, and rows repeated across tiles.
        return np.concatenate([np.full(64, rng.integers(0, bwt_len)), np.repeat(rng.integers(0, bwt_len, 37), 9)])
    if case == "unsorted":
        rows = np.sort(rng.integers(0, bwt_len, size=700))
        return np.concatenate([rows[::-1], rng.permutation(rows)])
    raise ValueError(f"unknown case {case!r}")


def clamped(rows: np.ndarray, nbits: int) -> np.ndarray:
    """The rows a kernel reads: clamped into [0, nbits), as row_at does."""
    return np.clip(rows, 0, nbits - 1)
