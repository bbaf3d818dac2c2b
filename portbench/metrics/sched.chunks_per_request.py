"""Prefill chunks a request took, over the requests finished in the
window (the batcher cuts a prompt into power-of-two chunks; a count)."""


def read(ctx):
    done = ctx["completions"]
    if not done:
        return None
    return sum(ctx["chunks"].get(c.rid, 0) for c in done) / len(done)
