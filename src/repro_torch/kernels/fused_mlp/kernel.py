"""Wrapper of the hand-written Hopper kernel ``csrc/fused_mlp.cu``.

Counterpart of ``src/repro/kernels/fused_mlp/kernel.py``
(``fused_mlp_kernel``).  The CUDA source says what the kernel computes and
how it is cut for the card.  This wrapper checks device, type, shape and
contiguity, decides the route before the launch (``route_of``: "two_pass"
for bf16 with more than ``SPLIT_FF_MAX_M`` rows and operands TMA takes,
"split_ff" for other bf16, "fma" for fp32), allocates the output, the
intermediate h of the two-pass route and the single-pass route's fp32
partial sums with ``torch.empty``, launches on PyTorch's current stream
without synchronising, and raises if the launch is refused.  It
never gives way to another route or to the plain version: a tensor that
is not on a CUDA device is an error here (``ops.fused_mlp`` routes CPU
tensors to ``ref.fused_mlp_ref``).

``fused_mlp_kernel.launches`` counts the launches, one per call that
reaches the card, and ``fused_mlp_kernel.by_route`` the same calls by
route, so that a run can show which kernels it went through.

``fused_mlp_bwd_kernel`` is the gradient (``csrc/fused_mlp_bwd.cu``).  On
route "fused" (bf16 operands TMA takes) one launch recomputes g and u,
takes dh = dy w_down^T and writes dg, du and h, and a GLU's dw_gate and
dw_up are one more launch; on route "fma" (fp32 and any other bf16) the
recompute and the dh pass are two launches of an FMA tile kernel and the
weight gradients ``elk_matmul``'s.  The rest is ``elk_matmul`` (x read
transposed in place; dx one two-part sum) and the bias gradients are column
sums.  ``fused_mlp_bwd_kernel.launches`` counts its calls (one a backward),
``by_route`` them by route.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.chip.h100 import wg_smem_bytes, wg_stages
from repro_torch.kernels import _build
from repro_torch.kernels.elk_matmul.kernel import elk_matmul_kernel, plan_for
from repro_torch.kernels.fused_mlp.ref import ACTS

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SMS = 132          # H100 SXM (datasheet); only steers how ff is split
_ROWS16_MAX_M = 16  # bf16: at most this many rows take the 16-row tiling
# R: bf16 products of at most this many rows keep h on chip ("split_ff")
# even where TMA takes them.  The crossover chip_smoke.py measured (PERF.md:
# fused_mlp at m = 8, 16, 32, 64, 128 and 256 on both routes, qwen3-14b) is
# below 8: the two-pass route was the faster at every one of them.
SPLIT_FF_MAX_M = 0
ROUTES = ("two_pass", "split_ff", "fma")


def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_mlp")
    if lib.fused_mlp_launch.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.fused_mlp_launch.argtypes = [ptr] * 8 + [i32] * 8 + [ptr]
        lib.fused_mlp_launch.restype = i32
        lib.fused_mlp_tiles.argtypes = [i32, i32] + [ctypes.POINTER(i32)] * 3
        lib.fused_mlp_tiles.restype = i32
        lib.fused_mlp_pass1_launch.argtypes = [ptr] * 5 + [i32] * 4 + [ptr]
        lib.fused_mlp_pass1_launch.restype = i32
        lib.fused_mlp_pass2_launch.argtypes = [ptr] * 4 + [i32] * 6 + [ptr]
        lib.fused_mlp_pass2_launch.restype = i32
        lib.fused_mlp_error_name.argtypes = [i32]
        lib.fused_mlp_error_name.restype = ctypes.c_char_p
    return lib


def _bwd_lib() -> ctypes.CDLL:
    lib = _build.load("fused_mlp_bwd")
    if lib.fused_mlp_bwd_pre_launch.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.fused_mlp_bwd_pre_launch.argtypes = [ptr] * 6 + [i32] * 4 + [ptr]
        lib.fused_mlp_bwd_pre_launch.restype = i32
        lib.fused_mlp_bwd_dh_launch.argtypes = [ptr] * 7 + [i32] * 5 + [ptr]
        lib.fused_mlp_bwd_dh_launch.restype = i32
        lib.fused_mlp_bwd_fused_launch.argtypes = [ptr] * 9 + [i32] * 5 + [ptr]
        lib.fused_mlp_bwd_fused_launch.restype = i32
        lib.fused_mlp_bwd_wgrad_launch.argtypes = [ptr] * 5 + [i32] * 3 + [ptr]
        lib.fused_mlp_bwd_wgrad_launch.restype = i32
        lib.fused_mlp_bwd_colsum_launch.argtypes = [ptr] * 2 + [i32] * 3 + [ptr]
        lib.fused_mlp_bwd_colsum_launch.restype = i32
        lib.fused_mlp_bwd_error_name.argtypes = [i32]
        lib.fused_mlp_bwd_error_name.restype = ctypes.c_char_p
    return lib


def plan_splits(m: int, ff: int, bm: int, bf: int, blocks_per_sm: int
                ) -> tuple[int, int]:
    """(chunks_per_split, splits): how the ``ceil(ff / bf)`` chunks of the
    intermediate are shared out among blocks.  A split takes as many
    chunks as it must for all blocks (row tiles x splits) to be resident
    at once, ``blocks_per_sm`` to an SM: with one tile of rows (decode)
    every chunk is its own split and the splits fill the card; with many
    (prefill) few splits keep the fp32 partials small."""
    chunks = -(-ff // bf)
    m_tiles = -(-m // bm)
    want = max(1, min(chunks, _SMS * blocks_per_sm // m_tiles))
    per_split = -(-chunks // want)
    return per_split, -(-chunks // per_split)


def _tma_ok(*ts: torch.Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 and t.shape[-1] % 8 == 0 for t in ts)


def route_of(x: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor,
             w_gate: Optional[torch.Tensor] = None) -> str:
    """The route ``fused_mlp_kernel`` takes, from dtype, rows and strides,
    before any launch: "fma" for fp32; "two_pass" for bf16 with more than
    ``SPLIT_FF_MAX_M`` rows whose x, weights and h meet TMA's rules (bases
    on 16 bytes, d, ff and d_out multiples of 8); "split_ff" for other
    bf16."""
    if x.dtype == torch.float32:
        return "fma"
    m = math.prod(x.shape[:-1])
    tensors = (x, w_up, w_down) + (() if w_gate is None else (w_gate,))
    if m > SPLIT_FF_MAX_M and _tma_ok(*tensors):
        return "two_pass"
    return "split_ff"


def _check(name: str, t: torch.Tensor, shape: tuple, like: torch.Tensor):
    if t.device != like.device:
        raise ValueError(f"{name} on {t.device}, x on {like.device}")
    if t.dtype != like.dtype:
        raise TypeError(f"{name} is {t.dtype}, x is {like.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def fused_mlp_kernel(x: torch.Tensor, w_up: torch.Tensor,
                     w_down: torch.Tensor,
                     w_gate: Optional[torch.Tensor] = None,
                     b_up: Optional[torch.Tensor] = None,
                     b_down: Optional[torch.Tensor] = None, *,
                     act: str = "silu",
                     route: Optional[str] = None) -> torch.Tensor:
    """act(x @ w_up [+ b_up]) [* gate] @ w_down [+ b_down] on the card.

    ``x``: (..., d); ``w_up``/``w_gate``: (d, ff); ``w_down``: (ff, d_out);
    fp32 or bf16, all of one type, contiguous, on one CUDA device.  The
    biases come both or not at all, and not with a gate (the three
    variants of the reference kernel).  ``route`` is ``route_of``'s unless
    given (to time one route against the other at the same rows); a route
    that does not take these tensors raises."""
    if not x.is_cuda:
        raise ValueError(f"fused_mlp_kernel needs a CUDA tensor, got "
                         f"{x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"fused_mlp_kernel takes float32 or bfloat16, "
                        f"got {x.dtype}")
    if act not in ACTS:
        raise ValueError(f"unknown activation {act!r}; known: {ACTS}")
    if x.dim() < 1 or w_up.dim() != 2 or w_down.dim() != 2:
        raise ValueError("x must be (..., d), w_up (d, ff), w_down "
                         "(ff, d_out)")
    lead, d = x.shape[:-1], x.shape[-1]
    ff, dout = w_up.shape[1], w_down.shape[1]
    if min(d, ff, dout) < 1:
        raise ValueError(f"empty weight: d={d}, ff={ff}, d_out={dout}")
    if (b_up is None) != (b_down is None):
        raise ValueError("b_up and b_down come both or not at all")
    if w_gate is not None and b_up is not None:
        raise ValueError("the gated variant takes no biases")
    if not x.is_contiguous():
        raise ValueError("x is not contiguous")
    _check("w_up", w_up, (d, ff), x)
    _check("w_down", w_down, (ff, dout), x)
    if w_gate is not None:
        _check("w_gate", w_gate, (d, ff), x)
    if b_up is not None:
        _check("b_up", b_up, (ff,), x)
        _check("b_down", b_down, (dout,), x)
    m = math.prod(lead)
    if m == 0:
        return torch.zeros((*lead, dout), dtype=x.dtype, device=x.device)
    if max(m, d, ff, dout) >= 2 ** 31:
        raise ValueError("a dimension exceeds the kernel's 32-bit indices")

    if route is None:
        route = route_of(x, w_up, w_down, w_gate)
    elif route not in ROUTES:
        raise ValueError(f"unknown route {route!r}; known: {ROUTES}")
    lib = _lib()
    dtype = _DTYPES[x.dtype]
    if (route == "fma") != (dtype == 0):
        raise ValueError(f"route {route} does not take {x.dtype}")
    stream = torch.cuda.current_stream(x.device).cuda_stream

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(x.device):
        out = torch.empty((m, dout), dtype=x.dtype, device=x.device)
        if route == "two_pass":
            # pass 2 is elk_matmul's product h @ w_down, on its plan
            plan = plan_for(m, dout, ff, x.dtype)
            h = torch.empty((m, ff), dtype=x.dtype, device=x.device)
            detail = "pass 1"
            err = lib.fused_mlp_pass1_launch(
                ptr(x), ptr(w_up), ptr(w_gate), ptr(b_up), ptr(h), m, d, ff,
                ACTS.index(act), stream)
            if err == 0:
                detail = (f"pass 2, ({plan.bm}, {plan.bn}) in {plan.splits} "
                          "splits")
                err = lib.fused_mlp_pass2_launch(
                    ptr(h), ptr(w_down), ptr(b_down), ptr(out), m, ff, dout,
                    plan.bm // 64, plan.bn, plan.k_per_split, stream)
        else:
            config = int(dtype == 1 and m > _ROWS16_MAX_M)
            bm, bf, per_sm = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
            if lib.fused_mlp_tiles(dtype, config, ctypes.byref(bm),
                                   ctypes.byref(bf), ctypes.byref(per_sm)):
                raise RuntimeError(f"no tiling for dtype {x.dtype}, config "
                                   f"{config}")
            per_split, splits = plan_splits(m, ff, bm.value, bf.value,
                                            per_sm.value)
            partial = torch.empty((splits, m, dout), dtype=torch.float32,
                                  device=x.device)
            detail = f"config {config}, splits {splits}"
            err = lib.fused_mlp_launch(
                ptr(x), ptr(w_up), ptr(w_gate), ptr(w_down), ptr(b_up),
                ptr(b_down), ptr(out), ptr(partial), m, d, ff, dout, dtype,
                config, ACTS.index(act), per_split, stream)
    fused_mlp_kernel.launches += 1
    fused_mlp_kernel.by_route[route] += 1
    if err != 0:
        raise RuntimeError(f"fused_mlp launch failed: CUDA error {err} "
                           f"({lib.fused_mlp_error_name(err).decode()}; "
                           f"route {route}, m={m}, d={d}, ff={ff}, "
                           f"d_out={dout}, {x.dtype}, {detail})")
    return out.reshape(*lead, dout)


fused_mlp_kernel.launches = 0
fused_mlp_kernel.by_route = dict.fromkeys(ROUTES, 0)


BWD_ROUTES = ("fused", "fma")
# route "fused": the (rows, columns of ff) tile of a block of the fused pass
# (csrc/fused_mlp_bwd.cu kFusedBN, FusedCfg): two consumer warpgroups of 64
# rows; 64 columns, where 128 spilled (PERF.md)
FUSED_BM, FUSED_BN = 128, 64


def fused_bwd_plan(gated: bool) -> tuple[int, int]:
    """(stages, shared memory bytes) of a block of the fused pass
    (``FusedCfg<GATED>`` of ``csrc/fused_mlp_bwd.cu``): the TMA ring
    ``wg_stages`` gives its tile with two b operands (GLU: both weights) or
    one, and the reserve."""
    nb = 2 if gated else 1
    stages = wg_stages(FUSED_BM, FUSED_BN, nb)[0]
    return stages, wg_smem_bytes(FUSED_BM, FUSED_BN, stages, nb)


def bwd_route_of(x: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor,
                 w_gate: Optional[torch.Tensor] = None) -> str:
    """The route of ``fused_mlp_bwd_kernel``'s MLP passes: "fused" (the
    fused pass on TMA + wgmma) for bf16 whose x, weights and dy TMA takes
    (bases on 16 bytes, d, ff and d_out multiples of 8), "fma" for the
    rest."""
    tensors = (x, w_up, w_down) + (() if w_gate is None else (w_gate,))
    if x.dtype == torch.bfloat16 and _tma_ok(*tensors):
        return "fused"
    return "fma"


def fused_mlp_bwd_kernel(x: torch.Tensor, w_up: torch.Tensor,
                         w_down: torch.Tensor, dy: torch.Tensor,
                         w_gate: Optional[torch.Tensor] = None,
                         b_up: Optional[torch.Tensor] = None,
                         b_down: Optional[torch.Tensor] = None, *,
                         act: str = "silu") -> dict:
    """The gradients of ``fused_mlp_kernel``'s function for ``dy`` on the
    card, by the names of the operands (``x``, ``w_up``, ``w_down``,
    ``w_gate``, ``b_up``, ``b_down``; None for one not given), each in x's
    type.  Operands as ``fused_mlp_kernel`` takes them; ``dy`` (..., d_out)
    of x's type.  The plain version is ``ref.fused_mlp_bwd_ref``."""
    if not x.is_cuda:
        raise ValueError(f"fused_mlp_bwd_kernel needs a CUDA tensor, got "
                         f"{x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"fused_mlp_bwd_kernel takes float32 or bfloat16, "
                        f"got {x.dtype}")
    if act not in ACTS:
        raise ValueError(f"unknown activation {act!r}; known: {ACTS}")
    if (b_up is None) != (b_down is None) or (w_gate is not None
                                              and b_up is not None):
        raise ValueError("biases come both or not at all, and not with a "
                         "gate")
    if not x.is_contiguous():
        raise ValueError("x is not contiguous")
    d, ff, dout = x.shape[-1], w_up.shape[1], w_down.shape[1]
    m = math.prod(x.shape[:-1])
    _check("w_up", w_up, (d, ff), x)
    _check("w_down", w_down, (ff, dout), x)
    if w_gate is not None:
        _check("w_gate", w_gate, (d, ff), x)
    if b_up is not None:
        _check("b_up", b_up, (ff,), x)
        _check("b_down", b_down, (dout,), x)
    dy2 = dy.reshape(m, dout).to(x.dtype).contiguous()
    _check("dy", dy2, (m, dout), x)
    if min(m, d, ff, dout) < 1:
        raise ValueError(f"empty operand: m={m}, d={d}, ff={ff}, "
                         f"d_out={dout}")
    if max(m, d, ff, dout) >= 2 ** 31:
        raise ValueError("a dimension exceeds the kernel's 32-bit indices")
    route = ("fused" if bwd_route_of(x, w_up, w_down, w_gate) == "fused"
             and _tma_ok(dy2) else "fma")
    lib = _bwd_lib()
    dtype = _DTYPES[x.dtype]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    x2 = x.reshape(m, d)

    def ptr(t):
        return None if t is None else t.data_ptr()

    def check(err, what):
        if err != 0:
            raise RuntimeError(
                f"fused_mlp_bwd {what} failed: CUDA error {err} "
                f"({lib.fused_mlp_bwd_error_name(err).decode()}; route "
                f"{route}, m={m}, d={d}, ff={ff}, d_out={dout}, {x.dtype})")

    grads = dict.fromkeys(("x", "w_up", "w_down", "w_gate", "b_up",
                           "b_down"))
    with torch.cuda.device(x.device):
        du = torch.empty((m, ff), dtype=x.dtype, device=x.device)
        h = torch.empty_like(du)
        dg = None if w_gate is None else torch.empty_like(du)
        fused_mlp_bwd_kernel.launches += 1
        fused_mlp_bwd_kernel.by_route[route] += 1
        if route == "fused":
            check(lib.fused_mlp_bwd_fused_launch(
                ptr(x), ptr(w_up), ptr(w_gate), ptr(b_up), ptr(dy2),
                ptr(w_down), ptr(dg), ptr(du), ptr(h), m, d, ff, dout,
                ACTS.index(act), stream), "fused pass")
        else:
            pre_u = torch.empty((m, ff), dtype=torch.float32,
                                device=x.device)
            pre_g = None if w_gate is None else torch.empty_like(pre_u)
            check(lib.fused_mlp_bwd_pre_launch(
                ptr(x), ptr(w_up), ptr(w_gate), ptr(b_up), ptr(pre_g),
                ptr(pre_u), m, d, ff, dtype, stream), "recompute")
            check(lib.fused_mlp_bwd_dh_launch(
                ptr(dy2), ptr(w_down), ptr(pre_g), ptr(pre_u), ptr(dg),
                ptr(du), ptr(h), m, ff, dout, ACTS.index(act), dtype,
                stream), "dh pass")
            del pre_g, pre_u
        grads["w_down"] = elk_matmul_kernel(h.t(), dy2)
        if w_gate is not None and route == "fused":
            grads["w_gate"] = torch.empty((d, ff), dtype=x.dtype,
                                          device=x.device)
            grads["w_up"] = torch.empty_like(grads["w_gate"])
            check(lib.fused_mlp_bwd_wgrad_launch(
                ptr(x2), ptr(dg), ptr(du), ptr(grads["w_gate"]),
                ptr(grads["w_up"]), m, d, ff, stream), "weight gradients")
        else:
            grads["w_up"] = elk_matmul_kernel(x2.t(), du)
            if w_gate is not None:
                grads["w_gate"] = elk_matmul_kernel(x2.t(), dg)
        if w_gate is not None:
            dx = elk_matmul_kernel(dg, w_gate.t(), du, w_up.t())
        else:
            dx = elk_matmul_kernel(du, w_up.t())
        grads["x"] = dx.reshape(x.shape)
        if b_up is not None:
            for name, src, n in (("b_up", du, ff), ("b_down", dy2, dout)):
                grads[name] = torch.empty((n,), dtype=x.dtype,
                                          device=x.device)
                check(lib.fused_mlp_bwd_colsum_launch(
                    ptr(src), ptr(grads[name]), m, n, dtype, stream),
                    "bias sums")
    return grads


fused_mlp_bwd_kernel.launches = 0
fused_mlp_bwd_kernel.by_route = dict.fromkeys(BWD_ROUTES, 0)
