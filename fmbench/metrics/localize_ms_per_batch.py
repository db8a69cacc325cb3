"""``awry.localize`` (global text positions to record and local position),
ms per assemble span in the span slice."""

from fmbench import spans


def read(rec: dict) -> float | None:
    return spans.read("localize_ms_per_batch", rec)
