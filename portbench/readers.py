"""What the per-layer metrics' readers share.

A reader is ``metrics/<metric name>.py`` with ``read(ctx)``; ``ctx`` is
the traced run's record: ``model`` (``counts.dims``), ``window_s``, the
window's ``passes`` (the shapes the wrappers saw), ``device_ms`` (CUDA
events around each wrapped call, by name), the serving driver's
``completions`` and ``chunks`` (chunk calls by request), and ``timeline``
(``timeline.reduce``).  A reader that finds nothing to read returns None,
and the metric is left out of the line; a share of a roofline or a peak is
never made 0 for want of data.
"""

from __future__ import annotations

from portbench import counts


def roofline(ctx: dict, family: str):
    """Percent: the least time the window's work of ``family`` needs at
    the peaks, over the device time of that family's kernels."""
    tl = ctx.get("timeline")
    if not tl or not ctx["passes"] or not tl["family_s"].get(family):
        return None
    need = sum(counts.pass_work(ctx["model"], p)[family].min_s
               for p in ctx["passes"])
    return 100.0 * need / tl["family_s"][family]


def mfu(ctx: dict):
    """Percent: the model FLOPs of the window's work over the window's
    seconds at the bf16 peak."""
    if not ctx["passes"]:
        return None
    m = ctx["model"]
    flops = 0.0
    for p in ctx["passes"]:
        if p["kind"] == "train":
            flops += counts.train_model_flops(m, p["batch"], p["seq"])
        else:
            work = counts.pass_work(m, p)
            flops += work["matmul"].flops + work["attention"].flops
    return 100.0 * flops / (ctx["window_s"]
                            * counts.PEAKS["bf16_flops_per_s"])


def idle(ctx: dict):
    """Percent of the traced window with nothing running on the device."""
    tl = ctx.get("timeline")
    if not tl or tl["busy_s"] <= 0 or tl["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tl["busy_s"] / tl["window_s"])


def mean_ms(ctx: dict, name: str):
    vals = ctx["device_ms"].get(name)
    return sum(vals) / len(vals) if vals else None
