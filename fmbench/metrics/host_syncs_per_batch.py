"""``engine.stats["host_syncs"]`` over ``batches`` in the recording pass
(every pool batch once, one client): the blocking reads of the card a batch
makes."""

from fmbench import spans


def read(rec: dict) -> float | None:
    return spans.read("host_syncs_per_batch", rec)
