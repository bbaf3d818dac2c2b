"""Step accounting on H100 constants: the counted work and the roofline.

Counterpart of ``src/repro/launch/hlo_analysis.py``, under the same name so
that a reader finds it; there is no HLO here.  The reference reads a
compiled XLA module: ``cost_analysis()`` for FLOPs and bytes, the
partitioned HLO text for the collectives.  The port runs a step eagerly,
so ``count_step`` runs it once on meta tensors (nothing allocated, no
card needed) under a ``TorchDispatchMode`` that sums

* the FLOPs of every product PyTorch runs itself (``torch.utils.
  flop_counter``'s formulas: ``mm``, ``bmm``, ``addmm``, ...; ``matmul``
  and ``einsum`` where they reach the mode whole), and
* the bytes every operation reads and writes (views move nothing; a gather
  reads the rows it takes, a scatter writes the rows it puts),

while a kernel op of the port counts as **its kernel**, not as its plain
version: on a meta tensor ``kernels/dispatch.py`` takes a third route that
records the kernel's FLOPs and operand/result bytes (``kernels/cost.py``)
and gives an empty result of its shapes; the plain version never runs.

``Roofline`` is the reference's dataclass with its peaks from
``chip/h100.py`` (module constants, which a test may replace).  What has no
twin, and why: ``parse_collectives`` and its regexes parse XLA's
partitioned HLO, which nothing in PyTorch produces, and one card runs no
collective, so ``collective_s`` is 0 and the record's ``collectives`` null;
``roofline_from_compiled`` reads a compiled XLA object.
"""

from __future__ import annotations

import contextlib
import dataclasses
from collections import Counter
from typing import Callable, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as _pytree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.chip import h100
from repro_torch.kernels.dispatch import counting

PEAK_FLOPS = h100.BF16_FLOPS          # 989 TFLOP/s dense bf16
HBM_BW = h100.HBM_BYTES_PER_S         # 3.35 TB/s
LINK_BW = h100.NVLINK_BYTES_PER_S     # 450 GB/s a direction

COLLECTIVES_NOTE = ("one H100 runs no collective and PyTorch produces no "
                    "partitioned HLO to parse: collective_s is 0")

_aten = torch.ops.aten
_NO_DATA = {_aten.empty, _aten.empty_like, _aten.empty_strided,
            _aten.new_empty, _aten.new_empty_strided, _aten.lift_fresh}
_GATHERS = {_aten.index, _aten.embedding, _aten.index_select, _aten.gather}
_SCATTERS = {_aten.index_put, _aten.index_put_, _aten._index_put_impl_,
             _aten.scatter, _aten.scatter_}
_WRITES = {_aten.fill_, _aten.zero_, _aten.zeros, _aten.ones, _aten.full,
           _aten.zeros_like, _aten.ones_like, _aten.full_like}


def _composite_flops(packet, args, out) -> float:
    """FLOPs of ``matmul`` and ``einsum``, which reach the mode whole under
    inference mode (their parts, ``bmm`` and the like, do not):
    2 x the output's elements x the contracted size."""
    if packet is _aten.matmul:
        return 2.0 * out.numel() * args[0].shape[-1]
    eq, ops = args[0].replace(" ", ""), args[1]
    ins, res = eq.split("->")
    sizes = {c: n for term, t in zip(ins.split(","), ops)
             for c, n in zip(term, t.shape)}
    k = 1
    for c in set(ins.replace(",", "")) - set(res):
        k *= sizes[c]
    return 2.0 * out.numel() * k


def _tensors(tree) -> list[torch.Tensor]:
    return [t for t in _pytree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


@dataclasses.dataclass
class StepCount:
    """What one step did: FLOPs (products), bytes moved, a host-to-device
    copy's bytes (streamed weights), and per kernel of the port its
    launches, FLOPs and bytes."""
    flops: float = 0.0
    bytes: float = 0.0
    host_bytes: float = 0.0
    kernels: dict = dataclasses.field(default_factory=dict)
    ops: Counter = dataclasses.field(default_factory=Counter)

    def attention_flops(self) -> float:
        return sum(k["flops"] for name, k in self.kernels.items()
                   if "attention" in name)

    def to_dict(self) -> dict:
        return {"flops": self.flops, "bytes": self.bytes,
                "host_bytes": self.host_bytes,
                "attention_flops": self.attention_flops(),
                "kernels": self.kernels,
                "aten_ops": sum(self.ops.values())}


class _Counter(TorchDispatchMode):
    """Counts every operation of a step into a ``StepCount``, and the port's
    kernel launches that ``kernels/dispatch.py`` reports (its third route)."""

    def __init__(self):
        super().__init__()
        self.count = StepCount()

    def kernel(self, name: str, flops: float, nbytes: float) -> None:
        k = self.count.kernels.setdefault(
            name, {"launches": 0, "flops": 0.0, "bytes": 0.0})
        k["launches"] += 1
        k["flops"] += flops
        k["bytes"] += nbytes
        self.count.flops += flops
        self.count.bytes += nbytes

    def host_copy(self, nbytes: float) -> None:
        """A host-to-device copy: PCIe bytes, and their write to HBM."""
        self.count.host_bytes += nbytes
        self.count.bytes += nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.is_view:
            return out
        packet = func.overloadpacket
        if packet in _NO_DATA:
            return out
        c = self.count
        c.ops[packet.__name__] += 1
        if packet in flop_registry:
            c.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        elif packet in (_aten.matmul, _aten.einsum):
            c.flops += _composite_flops(packet, args, out)
        outs = _tensors(out)
        if packet in _GATHERS:         # the rows taken, not the table
            idx = _tensors(args[1:]) + _tensors(kwargs)
            c.bytes += _nbytes(idx) + 2 * _nbytes(outs)
        elif packet in _SCATTERS:      # the rows put, not the whole buffer
            vals = _tensors(args[1:]) + _tensors(kwargs)
            c.bytes += 2 * _nbytes(vals)
        elif packet is _aten.copy_:
            c.bytes += 2 * _nbytes(_tensors(args[1:2]))
        elif packet in _WRITES:
            c.bytes += _nbytes(outs)
        else:
            c.bytes += _nbytes(_tensors(args) + _tensors(kwargs)) \
                + _nbytes(outs)
        return out


def count_step(fn: Callable, args: tuple, *, train: bool = False
               ) -> StepCount:
    """Run ``fn(*args)`` once on meta tensors and count it: the
    counterpart of ``cost_analysis()``.  A serving step runs under
    inference mode, as the engine runs it; a training step with autograd."""
    mode = _Counter()
    grad = contextlib.nullcontext() if train else torch.inference_mode()
    with grad, counting(mode), mode:
        fn(*args)
    return mode.count


@dataclasses.dataclass
class Roofline:
    """The three roofline terms, in seconds (per step)."""
    compute_s: float
    memory_s: float
    collective_s: float
    hlo_flops_per_chip: float
    hlo_bytes_per_chip: float
    wire_bytes_per_chip: float
    model_flops: float
    num_chips: int

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / total counted FLOPs: remat and redundancy."""
        tot = self.hlo_flops_per_chip * self.num_chips
        return self.model_flops / tot if tot else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the compute roofline achieved if the step runs at
        its bound: MODEL_FLOPS / (chips * peak * bound_s)."""
        return self.fraction_at(self.bound_s)

    def fraction_at(self, seconds: float) -> float:
        """MODEL_FLOPS / (chips * peak * seconds): the share of the peak a
        step of ``seconds`` (a measured one) reaches."""
        denom = self.num_chips * PEAK_FLOPS * seconds
        return self.model_flops / denom if denom else 0.0

    def to_dict(self) -> dict:
        return {
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "dominant": self.dominant,
            "bound_s": self.bound_s,
            "hlo_flops_per_chip": self.hlo_flops_per_chip,
            "hlo_bytes_per_chip": self.hlo_bytes_per_chip,
            "wire_bytes_per_chip": self.wire_bytes_per_chip,
            "model_flops": self.model_flops,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
            "num_chips": self.num_chips,
        }


def roofline(flops_per_chip: float, bytes_per_chip: float,
             model_flops: float, num_chips: int) -> Roofline:
    """The roofline of per-device counts on this module's peaks; no
    collective term (one card)."""
    return Roofline(compute_s=flops_per_chip / PEAK_FLOPS,
                    memory_s=bytes_per_chip / HBM_BW, collective_s=0.0,
                    hlo_flops_per_chip=flops_per_chip,
                    hlo_bytes_per_chip=bytes_per_chip,
                    wire_bytes_per_chip=0.0, model_flops=model_flops,
                    num_chips=num_chips)


def memory_summary(argument_bytes: int,
                   peak_bytes: Optional[int] = None) -> dict:
    """The reference's memory record: ``argument_size_in_bytes`` from
    ``sharding.local_bytes``; where the step ran on the card,
    ``temp_size_in_bytes`` is ``torch.cuda.max_memory_allocated`` above
    the arguments (null where it did not, and then ``total_hbm_bytes`` is
    the arguments alone, a lower bound).  Outputs are the caches and
    parameters updated in place, so no output bytes are counted apart."""
    temp = None if peak_bytes is None else max(peak_bytes - argument_bytes, 0)
    return {"argument_size_in_bytes": int(argument_bytes),
            "output_size_in_bytes": 0,
            "temp_size_in_bytes": temp,
            "alias_size_in_bytes": 0,
            "total_hbm_bytes": int(argument_bytes + (temp or 0))}


def combine(parts: list[tuple[float, StepCount]]) -> StepCount:
    """The sum of ``weight x count`` over (weight, count) pairs: a training
    step of ``ga`` microbatches from one microbatch's count and its
    update's (``launch/dryrun.count_cell``)."""
    out = StepCount()
    for w, c in parts:
        out.flops += w * c.flops
        out.bytes += w * c.bytes
        out.host_bytes += w * c.host_bytes
        for op, n in c.ops.items():
            out.ops[op] += w * n
        for name, k in c.kernels.items():
            acc = out.kernels.setdefault(
                name, {"launches": 0, "flops": 0.0, "bytes": 0.0})
            for key in acc:
                acc[key] += w * k[key]
    return out
