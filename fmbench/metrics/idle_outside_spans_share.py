"""Share (%) of the span slice's device-idle time during which no ``awry.*``
span was open on any thread: idle time that no part of the engine names."""

from fmbench import spans


def read(rec: dict) -> float | None:
    return spans.read("idle_outside_spans_share", rec)
