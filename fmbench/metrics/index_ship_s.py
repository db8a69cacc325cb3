"""Seconds to ship the loaded index to the card (``FmQueryEngine(index)``
until ``torch.cuda.synchronize()``), by the host clock in set-up."""


def read(rec: dict) -> float | None:
    return rec.get("setup", {}).get("index_ship_s")
