"""Share of the traced ticks' span in which no operation ran on the device:
1 - the union of the device operations' intervals over the span, in %.
The span includes the waits between ticks."""


def read(rec):
    tr = rec.get("trace") if rec.get("kind") == "stream" else None
    if not tr:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["span_s"])
