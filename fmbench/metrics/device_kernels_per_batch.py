"""Device kernels launched per batch in the profiled slice (copies and
memsets not counted).  It repeats exactly for a seed: a fused step shows
here as fewer kernels."""


def read(rec: dict) -> float | None:
    t = rec.get("trace")
    if not t or not t["batches"] or not t["kernels"]:
        return None
    return sum(n for n, _ in t["kernels"].values()) / t["batches"]
