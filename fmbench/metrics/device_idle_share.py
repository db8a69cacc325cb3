"""Share (%) of the profiled slice in which no kernel or copy ran on the
card: 1 minus the union of the device intervals of every client's stream
over the slice's length."""


def read(rec: dict) -> float | None:
    t = rec.get("trace")
    if not t or t["busy_s"] <= 0 or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
