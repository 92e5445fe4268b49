"""serve_clips' greedy bursts: the decode walls of all the window's
batches over all their decode steps, ms a step (B streams a step)."""


def read(rec):
    b = rec.get("batches") if rec.get("kind") == "offline" else None
    if not b:
        return None
    return 1e3 * sum(x["decode_s"] for x in b) / sum(
        x["decode_steps"] for x in b)
