"""Mean ``awry.d2h_wait`` span (ms) in the span slice: the host waiting on a
batch's copies to land.  The CPU makes no copy event, so it opens none."""

from fmbench import spans


def read(rec: dict) -> float | None:
    return spans.read("d2h_wait_ms_per_batch", rec)
