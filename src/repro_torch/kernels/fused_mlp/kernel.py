"""Wrapper of the hand-written Hopper kernel ``csrc/fused_mlp.cu``.

Counterpart of ``src/repro/kernels/fused_mlp/kernel.py``
(``fused_mlp_kernel``).  The CUDA source says what the kernel computes and
how it is cut for the card.  This wrapper checks device, type, shape and
contiguity, allocates the output and the fp32 partial sums with
``torch.empty``, launches on PyTorch's current stream without
synchronising, and raises if the launch is refused.  It never gives way to
the plain version: a tensor that is not on a CUDA device is an error here
(``ops.fused_mlp`` routes CPU tensors to ``ref.fused_mlp_ref``).

``fused_mlp_kernel.launches`` counts the launches, one per call that
reaches the card, so that a run can show it went through the kernel.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.fused_mlp.ref import ACTS

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SMS = 132          # H100 SXM (datasheet); only steers how ff is split
_ROWS16_MAX_M = 16  # bf16: at most this many rows take the 16-row tiling


def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_mlp")
    if lib.fused_mlp_launch.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.fused_mlp_launch.argtypes = [ptr] * 8 + [i32] * 8 + [ptr]
        lib.fused_mlp_launch.restype = i32
        lib.fused_mlp_tiles.argtypes = [i32, i32] + [ctypes.POINTER(i32)] * 3
        lib.fused_mlp_tiles.restype = i32
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
                     act: str = "silu") -> torch.Tensor:
    """act(x @ w_up [+ b_up]) [* gate] @ w_down [+ b_down] on the card.

    ``x``: (..., d); ``w_up``/``w_gate``: (d, ff); ``w_down``: (ff, d_out);
    fp32 or bf16, all of one type, contiguous, on one CUDA device.  The
    biases come both or not at all, and not with a gate (the three
    variants of the reference kernel)."""
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

    lib = _lib()
    dtype = _DTYPES[x.dtype]
    config = int(dtype == 1 and m > _ROWS16_MAX_M)
    bm, bf, per_sm = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    if lib.fused_mlp_tiles(dtype, config, ctypes.byref(bm), ctypes.byref(bf),
                           ctypes.byref(per_sm)):
        raise RuntimeError(f"no tiling for dtype {x.dtype}, config {config}")
    per_split, splits = plan_splits(m, ff, bm.value, bf.value, per_sm.value)

    with torch.cuda.device(x.device):
        out = torch.empty((m, dout), dtype=x.dtype, device=x.device)
        partial = torch.empty((splits, m, dout), dtype=torch.float32,
                              device=x.device)

        def ptr(t):
            return None if t is None else t.data_ptr()

        err = lib.fused_mlp_launch(
            ptr(x), ptr(w_up), ptr(w_gate), ptr(w_down), ptr(b_up),
            ptr(b_down), ptr(out), ptr(partial), m, d, ff, dout, dtype,
            config, ACTS.index(act), per_split,
            torch.cuda.current_stream().cuda_stream)
    fused_mlp_kernel.launches += 1
    if err != 0:
        raise RuntimeError(f"fused_mlp launch failed: CUDA error {err} "
                           f"(m={m}, d={d}, ff={ff}, d_out={dout}, "
                           f"{x.dtype}, config {config}, splits {splits})")
    return out.reshape(*lead, dout)


fused_mlp_kernel.launches = 0
