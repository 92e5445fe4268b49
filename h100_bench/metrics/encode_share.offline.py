"""Share of the window's batch walls spent in serve_clips' bulk encode
(its encode wall ends in a device sync), in %."""


def read(rec):
    b = rec.get("batches") if rec.get("kind") == "offline" else None
    if not b:
        return None
    return 100.0 * sum(x["encode_s"] for x in b) / sum(x["wall_s"] for x in b)
