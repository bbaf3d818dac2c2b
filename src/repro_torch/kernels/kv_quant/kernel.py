"""Wrapper of the hand-written Hopper kernel ``csrc/kv_quant.cu``.

It quantizes a layer's new K and V rows and writes them, with their bf16
scales, into the int8 ring's slots in place: one launch for both tensors,
K's rotary embedding applied first when the rope tables are given (the int8
serving paths pass K as the projection leaves it).
The wrapper checks device, types, shapes, strides and positions, launches
on PyTorch's current stream without synchronising, and raises if the launch
is refused.  It never gives way to the plain version: a tensor that is not
on a CUDA device is an error here (``ops.quantize_into`` routes CPU tensors
to ``ref.quantize_into_ref``).

``kv_quant_kernel.launches`` counts the launches, one per call that reaches
the card.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Union

import torch

from repro_torch.kernels import _build

_SRC_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the attention kernels' cache types, by the id their sources take, and the
# names their ``by_kv`` counts use
KV_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
KV_TYPES = ("float32", "bfloat16", "int8")


def _lib() -> ctypes.CDLL:
    lib = _build.load("kv_quant")
    if lib.kv_quant_launch.argtypes is None:
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.kv_quant_launch.argtypes = (
            [ptr] * 2 + [i64] * 6 + [ptr] * 5 + [i32] + [ptr] * 2 + [i64] * 2
            + [i32] * 6 + [ptr])
        lib.kv_quant_launch.restype = i32
    return lib


def kv_scale_pointers(k_cache: torch.Tensor, kv_scales: Optional[tuple]
                      ) -> tuple[Optional[int], Optional[int]]:
    """The device pointers of an int8 cache's scales (k_scale, v_scale),
    each bf16 (B, Hkv, C, 1), contiguous, beside the cache; (None, None) for
    a cache of another type, which takes no scales."""
    if k_cache.dtype != torch.int8:
        if kv_scales is not None:
            raise ValueError(f"a {k_cache.dtype} cache takes no kv_scales")
        return None, None
    if kv_scales is None:
        raise ValueError("an int8 cache needs its kv_scales")
    want = (*k_cache.shape[:3], 1)
    for name, t in zip(("k_scale", "v_scale"), kv_scales):
        if (t.dtype != torch.bfloat16 or tuple(t.shape) != want
                or t.device != k_cache.device or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous bf16 {want} "
                             f"tensor on {k_cache.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    return kv_scales[0].data_ptr(), kv_scales[1].data_ptr()


def _rope_tables(sin: Optional[torch.Tensor], cos: Optional[torch.Tensor],
                 b: int, t: int, d: int, device: torch.device
                 ) -> tuple[Optional[int], Optional[int], int, int]:
    """(sin pointer, cos pointer, batch stride, token stride) of rope tables
    ``apply_rope`` takes for (B, Hkv, T, D) rows: fp32 (T, D/2) or
    (B, T, D/2), a leading 1 broadcast, last dimension contiguous, one
    shape and layout; (None, None, 0, 0) without them.  Read from shapes
    and strides alone (no view is made: this runs at every decode step of
    every layer)."""
    if sin is None and cos is None:
        return None, None, 0, 0
    if sin is None or cos is None:
        raise ValueError("the rope takes both sin and cos")
    if d % 2:
        raise ValueError(f"head dim {d}: the rope takes an even head dim")
    for name, x in (("sin", sin), ("cos", cos)):
        if x.dtype != torch.float32 or x.device != device:
            raise ValueError(f"{name} is {x.dtype} on {x.device}, expected "
                             f"float32 on {device}")
    if (sin.shape != cos.shape or sin.stride() != cos.stride()
            or sin.dim() not in (2, 3)):
        raise ValueError(f"sin {tuple(sin.shape)} and cos "
                         f"{tuple(cos.shape)} must be one (T, D/2) or "
                         f"(B, T, D/2) layout")
    rows = sin.shape[0] if sin.dim() == 3 else 1
    if sin.shape[-1] != d // 2 or rows not in (1, b) or \
            sin.shape[-2] not in (1, t):
        raise ValueError(f"sin {tuple(sin.shape)} does not broadcast to "
                         f"({b}, {t}, {d // 2})")
    if sin.stride(-1) != 1:
        raise ValueError("sin's last dimension is not contiguous")
    return (sin.data_ptr(), cos.data_ptr(),
            sin.stride(0) if rows > 1 else 0,
            sin.stride(-2) if sin.shape[-2] > 1 else 0)


def kv_quant_kernel(k_new: torch.Tensor, v_new: torch.Tensor,
                    k_cache: torch.Tensor, v_cache: torch.Tensor,
                    k_scale: torch.Tensor, v_scale: torch.Tensor,
                    positions: Union[int, torch.Tensor],
                    sin: Optional[torch.Tensor] = None,
                    cos: Optional[torch.Tensor] = None) -> None:
    """Quantize ``k_new``/``v_new`` (B, Hkv, T, D), fp32 or bf16, last
    dimension contiguous, into the int8 rings ``k_cache``/``v_cache``
    (B, Hkv, C, D) and their bf16 scales ``k_scale``/``v_scale``
    (B, Hkv, C, 1), all contiguous, at slot ``position % C``; ``positions``
    an int >= 0 for every row (T = 1) or an int32 (B, T) tensor on the
    card.  With ``sin``/``cos`` (the tables ``models.layers.apply_rope``
    takes, fp32 on the card) K is rotated first, as ``apply_rope`` does.
    Writes in place; returns nothing."""
    if not k_new.is_cuda:
        raise ValueError(f"kv_quant_kernel needs a CUDA tensor, got "
                         f"{k_new.device}")
    if k_new.dim() != 4 or v_new.shape != k_new.shape:
        raise ValueError(f"k_new {tuple(k_new.shape)} and v_new "
                         f"{tuple(v_new.shape)} must be one (B, Hkv, T, D)")
    b, hkv, t, d = k_new.shape
    if not 0 < d <= 256:
        raise ValueError(f"head dim {d}: the kernel takes 1 to 256")
    c = k_cache.shape[2] if k_cache.dim() == 4 else 0
    for name, x in (("k_new", k_new), ("v_new", v_new)):
        if x.dtype not in _SRC_DTYPES or x.dtype != k_new.dtype:
            raise TypeError(f"{name} is {x.dtype}; the new rows are one of "
                            f"float32 and bfloat16")
        if x.stride(-1) != 1:
            raise ValueError(f"{name}'s last dimension is not contiguous")
    for name, x, dtype, shape in (
            ("k_cache", k_cache, torch.int8, (b, hkv, c, d)),
            ("v_cache", v_cache, torch.int8, (b, hkv, c, d)),
            ("k_scale", k_scale, torch.bfloat16, (b, hkv, c, 1)),
            ("v_scale", v_scale, torch.bfloat16, (b, hkv, c, 1))):
        if x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(f"{name} is {x.dtype} {tuple(x.shape)}, "
                             f"expected {dtype} {shape}")
        if not x.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    for name, x in (("v_new", v_new), ("k_cache", k_cache),
                    ("v_cache", v_cache), ("k_scale", k_scale),
                    ("v_scale", v_scale)):
        if x.device != k_new.device:
            raise ValueError(f"{name} on {x.device}, k_new on {k_new.device}")
    if c < 1:
        raise ValueError("empty ring")
    if isinstance(positions, torch.Tensor):
        if (positions.dtype != torch.int32 or positions.device != k_new.device
                or tuple(positions.shape) != (b, t)
                or not positions.is_contiguous()):
            raise ValueError(f"positions must be a contiguous int32 ({b}, "
                             f"{t}) tensor on {k_new.device}, got "
                             f"{positions.dtype} {tuple(positions.shape)} on "
                             f"{positions.device}")
        pos_ptr, pos_value = positions.data_ptr(), 0
    else:
        if t != 1 or int(positions) < 0:
            raise ValueError(f"one position {positions} for every row takes "
                             f"T = 1 and a position >= 0, got T = {t}")
        pos_ptr, pos_value = None, int(positions)
    sin_ptr, cos_ptr, rs_b, rs_t = _rope_tables(sin, cos, b, t, d,
                                                k_new.device)

    lib = _lib()
    with torch.cuda.device(k_new.device):
        err = lib.kv_quant_launch(
            k_new.data_ptr(), v_new.data_ptr(), *k_new.stride()[:3],
            *v_new.stride()[:3], k_cache.data_ptr(), v_cache.data_ptr(),
            k_scale.data_ptr(), v_scale.data_ptr(), pos_ptr, pos_value,
            sin_ptr, cos_ptr, rs_b, rs_t, b, hkv, t, c, d,
            _SRC_DTYPES[k_new.dtype],
            torch.cuda.current_stream().cuda_stream)
    kv_quant_kernel.launches += 1
    if err != 0:
        raise RuntimeError(f"kv_quant launch failed: CUDA error {err} "
                           f"(B={b}, Hkv={hkv}, T={t}, C={c}, D={d}, "
                           f"{k_new.dtype}, rope {sin is not None})")


kv_quant_kernel.launches = 0
