"""Host spans and the device's timeline over a traced window.

``Tracer`` records host spans (name, start, end on the wall clock in ns,
the clock ``torch.profiler``'s events carry) and, in a traced run, the
device's activity over the window with ``torch.profiler`` (CUDA activity
only: one event a kernel, copy or fill, no host operators).  The timeline
is reduced once the window has closed, from the raw events, without the
profiler's own per-event processing.  Times of a layer come from CUDA
events around its calls (``timed``), read after the window.

What ``reduce`` gives: the union of device activity (``busy_s``) over the
window (``window_s``), the seconds of each kernel family
(``kernel_families.json``), the ten kernels with the most time, and the
idle gaps summed by the innermost host span that covers each gap's
middle (``host`` where none does).
"""

from __future__ import annotations

import contextlib
import json
import re
import time
from pathlib import Path

_FAMILIES = json.loads((Path(__file__).resolve().parent
                        / "kernel_families.json").read_text())["families"]
_PATTERNS = [(fam, re.compile(p)) for fam, pats in _FAMILIES.items()
             for p in pats]


def bare_name(name: str) -> str:
    """A kernel's identifier: no return type, namespaces, template
    arguments or parameter list (a copy or fill keeps its words)."""
    name = name.replace("(anonymous namespace)::", "")
    cut = min((i for i in (name.find("<"), name.find("(")) if i >= 0),
              default=len(name))
    head = name[:cut].strip()
    if head.startswith(("Memcpy", "Memset")):
        return head
    return head.split(" ")[-1].split("::")[-1]


def family(name: str) -> str:
    bare = bare_name(name)
    for fam, pat in _PATTERNS:
        if pat.search(bare):
            return fam
    return "other"


class Tracer:
    """Spans, CUDA events and the profiler, only inside a traced window
    (``start`` .. ``stop``); otherwise each wrapper is a plain call."""

    def __init__(self, trace: bool, cuda: bool = True):
        self.trace, self.cuda = trace, cuda
        self.on = False          # inside a traced window
        self.spans: list[tuple[str, int, int]] = []
        self.events: dict[str, list] = {}
        self._prof = None

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.on:
            yield
            return
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.spans.append((name, t0, time.time_ns()))

    def timed(self, name: str, fn, *args, **kwargs):
        """``fn(*args, **kwargs)`` inside a host span and, traced, between
        two CUDA events of the current stream."""
        if not self.on:
            return fn(*args, **kwargs)
        if not self.cuda:            # a rehearsal on the CPU: host time
            with self.span(name):
                t0 = time.perf_counter()
                out = fn(*args, **kwargs)
            self.events.setdefault(name, []).append(
                (time.perf_counter() - t0) * 1e3)
            return out
        import torch
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with self.span(name):
            start.record()
            out = fn(*args, **kwargs)
            end.record()
        self.events.setdefault(name, []).append((start, end))
        return out

    def device_ms(self) -> dict[str, list[float]]:
        """Milliseconds between each call's two events, by span name."""
        return {k: [x if isinstance(x, float) else x[0].elapsed_time(x[1])
                    for x in v] for k, v in self.events.items()}

    def start(self) -> None:
        if not self.trace:
            return
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CUDA if self.cuda
                                         else ProfilerActivity.CPU])
        self._prof.__enter__()
        self.on = True

    def stop(self) -> list[tuple[str, int, int]]:
        """Stop the profiler: (name, start ns, end ns) of every device
        event."""
        if self._prof is None:
            return []
        from torch.autograd import DeviceType
        self.on = False
        self._prof.__exit__(None, None, None)
        raw = self._prof.profiler.kineto_results.events()
        out = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
               for e in raw if e.device_type() == DeviceType.CUDA]
        self._prof = None
        return out


def reduce(device_events: list[tuple[str, int, int]], t0_ns: int,
           t1_ns: int, spans: list[tuple[str, int, int]]) -> dict:
    """The window [t0_ns, t1_ns] of a traced run, from its device events
    and host spans."""
    ivs, fam_ns, name_ns = [], {}, {}
    for name, a, b in device_events:
        a, b = max(a, t0_ns), min(b, t1_ns)
        if b <= a:
            continue
        ivs.append((a, b))
        fam = family(name)
        fam_ns[fam] = fam_ns.get(fam, 0) + (b - a)
        bare = bare_name(name)
        name_ns[bare] = name_ns.get(bare, 0) + (b - a)
    ivs.sort()
    merged: list[list[int]] = []
    for a, b in ivs:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy = sum(b - a for a, b in merged)
    gaps, prev = [], t0_ns
    for a, b in merged + [[t1_ns, t1_ns]]:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    by_host: dict[str, int] = {}
    ordered = sorted(spans, key=lambda s: s[1])
    active: list[tuple[str, int, int]] = []
    j = 0
    for a, b in gaps:                       # in time order
        mid = (a + b) // 2
        while j < len(ordered) and ordered[j][1] <= mid:
            active.append(ordered[j])
            j += 1
        active = [s for s in active if s[2] >= mid]
        label = (min(active, key=lambda s: s[2] - s[1])[0] if active
                 else "host")
        by_host[label] = by_host.get(label, 0) + (b - a)
    top = sorted(name_ns.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(by_host.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy * 1e-9, "window_s": (t1_ns - t0_ns) * 1e-9,
            "family_s": {k: v * 1e-9 for k, v in fam_ns.items()},
            "device_ops": [[k, v * 1e-9] for k, v in top],
            "idle_gaps": [[k, v * 1e-9] for k, v in idle]}
