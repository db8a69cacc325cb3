"""``engine.stats["laid_positions"]`` over ``batches`` in the recording pass:
the hits per batch that the card walks and lays out at their final offsets
(on a verify batch, the re-dispatched lanes' summed counts).  It repeats
exactly for a seed."""

from fmbench import spans


def read(rec: dict) -> float | None:
    return spans.read("laid_positions_per_batch", rec)
