"""serve_clips' batched prompt prefill, ms a batch (its wall ends in a
device sync), the mean over the window's batches."""


def read(rec):
    b = rec.get("batches") if rec.get("kind") == "offline" else None
    if not b:
        return None
    return 1e3 * sum(x["prefill_s"] for x in b) / len(b)
