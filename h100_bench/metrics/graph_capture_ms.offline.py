"""Host ms a batch spent capturing CUDA graphs (ops/graphs.py
GraphedCall.capture_s, counted over each batch): serve_clips makes new
decoder caches a call, so each batch captures its step graph again."""


def read(rec):
    b = rec.get("batches") if rec.get("kind") == "offline" else None
    if not b:
        return None
    return 1e3 * sum(x["capture_s"] for x in b) / len(b)
