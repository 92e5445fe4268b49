"""Share of the traced batch in which no operation ran on the device:
1 - the union of the device operations' intervals over the span, in %."""


def read(rec):
    tr = rec.get("trace") if rec.get("kind") == "offline" else None
    if not tr:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["span_s"])
