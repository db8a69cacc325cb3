"""``awry.assemble`` less its ``awry.d2h_wait``, ms per assemble span in the
span slice: the host's work on a batch once its copies have landed."""

from fmbench import spans


def read(rec: dict) -> float | None:
    return spans.read("assemble_ms_per_batch", rec)
