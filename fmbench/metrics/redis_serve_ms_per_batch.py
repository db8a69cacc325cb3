"""The re-dispatched lanes' serve, ``awry.redispatch`` (their full-depth
search and counts read back) and ``awry.redis_layout`` (their hits walked
and laid out on the card, copied back), ms per assemble span in the span
slice."""

from fmbench import spans


def read(rec: dict) -> float | None:
    return spans.read("redis_serve_ms_per_batch", rec)
