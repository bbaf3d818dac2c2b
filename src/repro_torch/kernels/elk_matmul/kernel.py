"""Wrapper of the hand-written Hopper kernel ``csrc/elk_matmul.cu``.

Counterpart of ``src/repro/kernels/elk_matmul/kernel.py`` (``elk_matmul``).
The CUDA source says what the kernel computes and how it is cut for the
card.  This wrapper checks device, types, shapes and strides, takes the
block shape from ``chip/h100.smem_plan`` (cached per shape and type, so a
decode step's 161 products do not run the greedy), allocates the output
with ``torch.empty``, launches on PyTorch's current stream without
synchronising, and raises if the launch is refused.  It never gives way to
the plain version: a tensor that is not on a CUDA device is an error here
(``ops.matmul`` routes CPU tensors to ``ref.matmul_ref``).

``elk_matmul_kernel.launches`` counts the launches, one per call that
reaches the card, so that a run can show it went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.chip.h100 import TILE_M, TILE_N, SmemPlan, smem_plan
from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_PREPARED: set = set()    # device indices whose kernel attributes are set


def _lib() -> ctypes.CDLL:
    lib = _build.load("elk_matmul")
    if lib.elk_matmul_launch.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.elk_matmul_launch.argtypes = [ptr] * 3 + [i32] * 10 + [ptr]
        lib.elk_matmul_launch.restype = i32
        lib.elk_matmul_prepare.argtypes = []
        lib.elk_matmul_prepare.restype = i32
    return lib


def _prepare(lib: ctypes.CDLL, device: torch.device) -> None:
    """Set the kernels' shared-memory limits once on ``device``."""
    if device.index in _PREPARED:
        return
    with torch.cuda.device(device):
        err = lib.elk_matmul_prepare()
    if err:
        raise RuntimeError(f"elk_matmul_prepare failed: CUDA error {err}")
    _PREPARED.add(device.index)


@functools.lru_cache(maxsize=4096)
def plan_for(m: int, n: int, k: int, dtype: torch.dtype) -> SmemPlan:
    """``smem_plan`` on one H100 for this product, once per shape and type."""
    return smem_plan(m, n, k, dtype_bytes=torch.empty(
        (), dtype=dtype).element_size())


def layout(x: torch.Tensor, y: torch.Tensor
           ) -> tuple[int, int, int, int, int, int]:
    """(m, n, k, lda, ldy, y_trans) of ``x @ y`` as the kernel takes it, or
    raises.  ``x`` (m, k) with unit column stride (a row stride of its own,
    as ``x[:, -1, :]`` of a prefill has); ``y`` (k, n) row-major, or the
    transposed view of an (n, k) row-major tensor (``embed.t()`` of a tied
    embedding, ``y_trans`` 1); no other stride."""
    if x.dim() != 2 or y.dim() != 2:
        raise ValueError(f"x must be (m, k) and y (k, n), got "
                         f"{tuple(x.shape)} and {tuple(y.shape)}")
    (m, k), (k2, n) = x.shape, y.shape
    if k != k2:
        raise ValueError(f"x {tuple(x.shape)} and y {tuple(y.shape)} do not "
                         "chain")
    if k > 1 and x.stride(1) != 1:
        raise ValueError(f"x's rows are not contiguous (strides "
                         f"{x.stride()})")
    lda = x.stride(0) if m > 1 else k
    if y.is_contiguous():
        return m, n, k, lda, n, 0
    if y.t().is_contiguous():
        return m, n, k, lda, k, 1
    raise ValueError(f"y {tuple(y.shape)} with strides {y.stride()} is "
                     "neither (k, n) row-major nor the transpose of an "
                     "(n, k) row-major tensor")


def elk_matmul_kernel(x: torch.Tensor, y: torch.Tensor, *,
                      bm: Optional[int] = None, bn: Optional[int] = None,
                      bk: Optional[int] = None) -> torch.Tensor:
    """(m, k) @ (k, n) -> (m, n) on the card, fp32 sum, output in x's type.

    fp32 or bf16, both of one type, on one CUDA device; strides as
    ``layout`` says.  A block shape not given comes from ``plan_for``;
    ``bm`` must be in ``TILE_M``, ``bn`` in ``TILE_N``, ``bk`` a multiple
    of 16."""
    if not x.is_cuda:
        raise ValueError(f"elk_matmul_kernel needs a CUDA tensor, got "
                         f"{x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"elk_matmul_kernel takes float32 or bfloat16, got "
                        f"{x.dtype}")
    if y.dtype != x.dtype:
        raise TypeError(f"y is {y.dtype}, x is {x.dtype}")
    if y.device != x.device:
        raise ValueError(f"y on {y.device}, x on {x.device}")
    m, n, k, lda, ldy, y_trans = layout(x, y)
    if m == 0 or n == 0 or k == 0:
        return torch.zeros((m, n), dtype=x.dtype, device=x.device)
    if max(m, n, k, lda, ldy) >= 2 ** 31:
        raise ValueError("a dimension exceeds the kernel's 32-bit indices")
    if None in (bm, bn, bk):
        plan = plan_for(m, n, k, x.dtype)
        bm, bn, bk = bm or plan.bm, bn or plan.bn, bk or plan.bk
    if bm not in TILE_M or bn not in TILE_N or bk < 16 or bk % 16:
        raise ValueError(f"block ({bm}, {bn}, {bk}) is not one the kernel "
                         f"compiles: bm in {TILE_M}, bn in {TILE_N}, bk a "
                         "multiple of 16")

    lib = _lib()
    _prepare(lib, x.device)
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    args = (x.data_ptr(), y.data_ptr(), out.data_ptr(), m, n, k, lda, ldy,
            y_trans, _DTYPES[x.dtype], bm, bn, bk, stream)
    # the runtime launches on the calling thread's device; enter x's only
    # when it is another
    if x.device.index == torch.cuda.current_device():
        err = lib.elk_matmul_launch(*args)
    else:
        with torch.cuda.device(x.device):
            err = lib.elk_matmul_launch(*args)
    elk_matmul_kernel.launches += 1
    if err != 0:
        raise RuntimeError(f"elk_matmul launch failed: CUDA error {err} "
                           f"(m={m}, n={n}, k={k}, lda={lda}, ldy={ldy}, "
                           f"y_trans={y_trans}, {x.dtype}, block ({bm}, "
                           f"{bn}, {bk}))")
    return out


elk_matmul_kernel.launches = 0
