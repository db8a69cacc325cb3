"""Mean ``awry.dispatch`` span (ms) in the span slice: a batch's upload,
its kernels' launches and its copies enqueued, on the host."""

from fmbench import spans


def read(rec: dict) -> float | None:
    return spans.read("dispatch_ms_per_batch", rec)
