"""Summed device time of kernels and copies per batch (ms) in the profiled
slice: the card's work for one batch, overlap between clients counted
twice."""


def read(rec: dict) -> float | None:
    t = rec.get("trace")
    if not t or not t["batches"] or t["summed_s"] <= 0:
        return None
    return 1000.0 * t["summed_s"] / t["batches"]
