"""Seconds to load the cached index artifact from disk (``load_artifact``),
by the host clock around the harness's call in set-up."""


def read(rec: dict) -> float | None:
    return rec.get("setup", {}).get("index_load_s")
