"""Device time of ServeEngine.prefill_chunk per 1000 prompt tokens over
the window: CUDA events around each chunk call (ms)."""


def read(ctx):
    ms = ctx["device_ms"].get("prefill_chunk")
    toks = sum(p["tokens"] for p in ctx["passes"] if p["kind"] == "chunk")
    if not ms or not toks:
        return None
    return 1000.0 * sum(ms) / toks
