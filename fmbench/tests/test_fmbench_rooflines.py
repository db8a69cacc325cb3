"""The frozen bound arithmetic against hand counts on toy requests."""

import torch

from fmbench import rooflines


def test_occ_pair_bound_hand_count():
    blocks = torch.zeros((4, 32), dtype=torch.int32)  # 4 rows of 4 sectors
    pos_a = torch.tensor([0, 300], dtype=torch.int64)
    pos_b = torch.tensor([10, 600], dtype=torch.int64)
    sym = torch.tensor([1, 2], dtype=torch.int32)
    codes = torch.zeros(6, dtype=torch.int32)
    nbytes, ops = rooflines.occ_pair_bound(blocks, pos_a, pos_b, sym, codes, 3)
    # Rows 0, 1, 2: 3 plane sectors each, and one milestone sector each
    # (sector 3 of the row): 12 sectors; 28 B of request and result per request.
    assert nbytes == 12 * 32 + 2 * 28
    assert ops == 2 * 2 * (3 * 16 + 8 * 3 + 1)


def test_window_read_bound_hand_count():
    flat = torch.zeros(100, dtype=torch.int32)
    wbase = torch.tensor([7, 7, 50], dtype=torch.int64)
    nbytes, ops = rooflines.window_read_bound(flat, wbase, 2)
    # Words 7, 6 (sector 0) and 50, 49 (sector 6); 8 B in and 8 B out per request.
    assert nbytes == 2 * 32 + 3 * 8 + 3 * 2 * 4
    assert ops == 0.0


def test_kernel_share_is_a_ratio_of_means():
    # 4 recorded calls whose least time is 1 ms in all (0.25 ms a call),
    # against 4 traced launches of 1 ms each: 25 %.
    rec = {"recorded": {"m": {"bytes": 3.35e9, "ops": 0.0, "calls": 4}},
           "trace": {"kernels": {"void occ_pair_kernel<3, false>(int)": (4, 0.004), "other": (9, 1.0)}}}
    assert abs(rooflines.kernel_share(rec, "m", r"occ_pair_kernel<\d+, false>") - 25.0) < 1e-9
    # The recording pass need not make as many calls as the slice traced.
    rec["recorded"]["m"]["calls"] = 8
    assert abs(rooflines.kernel_share(rec, "m", r"occ_pair_kernel<\d+, false>") - 12.5) < 1e-9
    rec["recorded"]["m"]["ops"] = 67e9 * 4  # operations bound: 4 ms over 8 calls
    assert abs(rooflines.kernel_share(rec, "m", r"occ_pair_kernel<\d+, false>") - 50.0) < 1e-9
    assert rooflines.kernel_share(rec, "m", "no such kernel") is None
    assert rooflines.kernel_share({}, "m", "x") is None


def test_the_copied_lf_step_is_the_programs():
    import numpy as np

    from awry_tpu_torch import FmBuildArgs, build_from_records
    from awry_tpu_torch.ops import kernels
    from awry_tpu_torch.ops.device_index import to_device

    rng = np.random.default_rng(3)
    text = np.frombuffer(b"ACGT", dtype=np.uint8)[rng.integers(0, 4, 20_000)].tobytes()
    idx = build_from_records([("a", text[:12_000]), ("b", text[12_000:])],
                             FmBuildArgs(lookup_table_kmer_len=6, locate_mark_ratio=4))
    dev = to_device(idx, "cpu")
    rows = torch.randint(0, idx.bwt_len, (3000,))
    visit = (dev.prefix_sums, dev.codes, dev.c2i, dev.num_planes, dev.mark_offset, dev.alphabet.ambiguity_idx)
    stepped, packed = kernels.backstep_plain(dev.blocks, rows, *visit)
    mine, rank = rooflines._backstep(dev.blocks, rows, *visit)
    assert torch.equal(stepped, mine)
    assert torch.equal((packed.to(torch.int64) & 0xFFFFFFFF) >> 1, rank)
    # A walk of rows already marked takes no step: its bound is its SA
    # sectors, its mark-word sectors and 16 B per lane, with no stepping ops.
    walk = (*visit, 4, dev.text_sampled_sa, dev.bwt_len)
    marked = rows[(packed & 1) == 1][:50]
    nbytes, ops = rooflines.marked_walk_bound(dev.blocks, marked, *walk)
    assert ops == marked.shape[0] * (8 * 3 + 4 + 4)
    assert nbytes >= marked.shape[0] * 16 + 32
