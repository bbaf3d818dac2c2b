"""Wrapper of the hand-written Hopper kernel ``csrc/flash_attention.cu``.

Counterpart of ``src/repro/kernels/flash_attention/kernel.py``
(``flash_attention``).  The CUDA source says what the kernel computes and
how it is cut for the card.  This wrapper checks device, types, shapes,
contiguity, alignment and the head ratio, allocates the output with
``torch.empty``, launches on PyTorch's current stream without
synchronising, and raises if the launch is refused.  It never gives way to
the plain version: a tensor that is not on a CUDA device is an error here
(``ops.flash_attn`` / ``ops.flash_attn_pos`` route CPU tensors to
``ref.mha_ref`` / ``ref.mha_pos_ref``).

``flash_attention_kernel.launches`` counts the launches, one per call that
reaches the card, so that a run can show it went through the kernel.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MMA_HEAD_DIMS = (16, 32, 64, 80, 96, 128, 256)   # head dims of the bf16 kernel
_PREPARED: set = set()    # device indices whose kernel attributes are set


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    if lib.flash_attention_launch.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.flash_attention_launch.argtypes = (
            [ptr] * 6 + [i32] * 10 + [ctypes.c_float] + [i32] * 2 + [ptr])
        lib.flash_attention_launch.restype = i32
        lib.flash_attention_prepare.argtypes = []
        lib.flash_attention_prepare.restype = i32
    return lib


def _prepare(lib: ctypes.CDLL, device: torch.device) -> None:
    """Set the kernels' shared-memory limits once on ``device``."""
    if device.index in _PREPARED:
        return
    with torch.cuda.device(device):
        err = lib.flash_attention_prepare()
    if err:
        raise RuntimeError(f"flash_attention_prepare failed: CUDA error {err}")
    _PREPARED.add(device.index)


def _positions(name: str, t: torch.Tensor, b: int, n: int, device
               ) -> int:
    """Batch stride of an int32 (B, n) or (1, n) position tensor."""
    if t.dtype != torch.int32:
        raise TypeError(f"{name} is {t.dtype}, expected torch.int32")
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, q on {device}")
    if t.dim() != 2 or t.shape[1] != n or t.shape[0] not in (1, b):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"({b}, {n})")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")
    return n if t.shape[0] == b and b > 1 else 0


def flash_attention_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           q_pos: Optional[torch.Tensor] = None,
                           k_pos: Optional[torch.Tensor] = None, *,
                           causal: bool = True, window: int = 0,
                           scale: Optional[float] = None) -> torch.Tensor:
    """Causal / bidirectional, GQA, sliding-window attention on the card.

    ``q``: (B, Hq, Sq, D); ``k``/``v``: (B, Hkv, Sk, D), one type;
    contiguous, 16-byte aligned, on one CUDA device; ``Hq`` a multiple of
    ``Hkv``.  bf16 ``q`` with a bf16 cache and ``D`` in ``MMA_HEAD_DIMS``
    (tensor cores), or fp32 ``q`` with an fp32 or bf16 cache and ``D`` a
    multiple of 8 up to 256.  Without positions, ``Sq == Sk`` at positions
    0..S-1; with them, ``q_pos`` (B, Sq) and ``k_pos`` (B, Sk) int32 on the
    card.  Returns (B, Hq, Sq, D) in ``q``'s type."""
    if not q.is_cuda:
        raise ValueError(f"flash_attention_kernel needs a CUDA tensor, got "
                         f"{q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype not in _DTYPES:
            raise TypeError(f"flash_attention_kernel takes float32 or "
                            f"bfloat16, {name} is {t.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")
    if v.dtype != k.dtype:
        raise TypeError(f"v is {v.dtype}, k is {k.dtype}")
    if q.dtype == torch.bfloat16 and k.dtype != torch.bfloat16:
        raise TypeError("a bf16 query takes a bf16 cache only")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError("q must be (B, Hq, Sq, D) and k, v (B, Hkv, Sk, D)")
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if tuple(k.shape) != (b, hkv, sk, d) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} must be "
                         f"({b}, Hkv, Sk, {d})")
    if hkv < 1 or hq % hkv:
        raise ValueError(f"Hq = {hq} is not a multiple of Hkv = {hkv}")
    if q.dtype == torch.bfloat16 and d not in MMA_HEAD_DIMS:
        raise ValueError(f"head dim {d}: the bf16 kernel takes "
                         f"{MMA_HEAD_DIMS}")
    if d % 8 or not 0 < d <= 256:
        raise ValueError(f"head dim {d}: the kernel takes multiples of 8 "
                         "up to 256")
    if min(b, hq, sq, sk) < 1:
        raise ValueError(f"empty input: B={b}, Hq={hq}, Sq={sq}, Sk={sk}")
    if (q_pos is None) != (k_pos is None):
        raise ValueError("q_pos and k_pos come both or not at all")
    if q_pos is None:
        if sq != sk:
            raise ValueError(f"without positions Sq must equal Sk, got "
                             f"{sq} and {sk}")
        qp_stride = kp_stride = 0
    else:
        qp_stride = _positions("q_pos", q_pos, b, sq, q.device)
        kp_stride = _positions("k_pos", k_pos, b, sk, q.device)
    scale = float(scale) if scale is not None else d ** -0.5

    lib = _lib()
    _prepare(lib, q.device)
    with torch.cuda.device(q.device):
        out = torch.empty_like(q)
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if q_pos is None else q_pos.data_ptr(),
            None if k_pos is None else k_pos.data_ptr(), out.data_ptr(),
            b, hq, hkv, sq, sk, d, qp_stride, kp_stride, int(causal),
            int(window), scale, _DTYPES[q.dtype], _DTYPES[k.dtype],
            torch.cuda.current_stream().cuda_stream)
    flash_attention_kernel.launches += 1
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err} "
                           f"(B={b}, Hq={hq}, Hkv={hkv}, Sq={sq}, Sk={sk}, "
                           f"D={d}, {q.dtype}/{k.dtype}, positions "
                           f"{q_pos is not None})")
    return out


flash_attention_kernel.launches = 0
