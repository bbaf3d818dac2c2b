"""Median wait in the admission queue (Completion.queue_wait_s) of the
requests finished in the window (ms)."""

import statistics


def read(ctx):
    done = ctx["completions"]
    if not done:
        return None
    return 1e3 * statistics.median(c.queue_wait_s for c in done)
