"""Wrapper of the hand-written Hopper kernel ``csrc/decode_attention.cu``.

Counterpart of ``src/repro/kernels/decode_attention/kernel.py``
(``decode_attention``).  The CUDA source says what the kernel computes and
how it is cut for the card.  This wrapper checks device, types, shapes,
contiguity and the head ratio, picks the tile depth and the splits of the
cache, allocates the output and the fp32 per-split scratch with
``torch.empty``, launches on PyTorch's current stream without
synchronising, and raises if the launch is refused.  It never gives way to
the plain version: a tensor that is not on a CUDA device is an error here
(``ops.decode_attn`` routes CPU tensors to ``ref.decode_attention_ref``).

``decode_attention_kernel.launches`` counts the launches, one per call that
reaches the card, so that a run can show it went through the kernel.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Union

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_SPLITS = 128    # the combine kernel's limit
_MAX_GROUP = 16      # query rows one block holds
# (device index, kv dtype, head dim, group) -> (tile depth, blocks the card
# holds at once)
_TILINGS: dict = {}


def _lib() -> ctypes.CDLL:
    lib = _build.load("decode_attention")
    if lib.decode_attention_launch.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.decode_attention_launch.argtypes = (
            [ptr] * 8 + [i32] * 9 + [ctypes.c_float] + [i32] * 5 + [ptr])
        lib.decode_attention_launch.restype = i32
        lib.decode_attention_tile.argtypes = [i32, i32, i32,
                                              ctypes.POINTER(i32),
                                              ctypes.POINTER(i32)]
        lib.decode_attention_tile.restype = i32
    return lib


def plan_splits(rows: int, c: int, bk: int, slots: int) -> tuple[int, int]:
    """(tiles_per_split, splits): how the ``ceil(c / bk)`` tiles of the
    cache are shared out among the blocks of ``rows`` (batch x kv heads x
    query-row chunks).  ``slots`` is how many blocks the card holds at once
    (SMs x blocks an SM): the splits fill them in one wave, and every split
    keeps at least one tile."""
    tiles = -(-c // bk)
    want = max(1, min(tiles, _MAX_SPLITS, slots // rows))
    per_split = -(-tiles // want)
    return per_split, -(-tiles // per_split)


def _tiling(lib: ctypes.CDLL, device: torch.device, kv_dtype: int, d: int,
            g: int) -> tuple[int, int]:
    """(tile depth, blocks the card holds at once) for this cache type, head
    dim and group on ``device``.  Asked of the library once a key, which
    also sets the kernel's shared-memory attributes on that device."""
    key = (device.index, kv_dtype, d, g)
    if key not in _TILINGS:
        bk, per_sm = ctypes.c_int(), ctypes.c_int()
        with torch.cuda.device(device):
            err = lib.decode_attention_tile(kv_dtype, d, g, ctypes.byref(bk),
                                            ctypes.byref(per_sm))
        if err:
            raise RuntimeError(f"no tiling for D={d}, G={g}, kv dtype "
                               f"{kv_dtype} (error {err})")
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        _TILINGS[key] = (bk.value, sms * per_sm.value)
    return _TILINGS[key]


def _positions(slot_pos: torch.Tensor, q_pos, b: int, c: int, device
               ) -> tuple[int, Optional[torch.Tensor], int, int]:
    """(sp_stride, q_pos tensor or None, qp_stride, q_pos value)."""
    if slot_pos.dtype != torch.int32:
        raise TypeError(f"slot_pos is {slot_pos.dtype}, expected torch.int32")
    if slot_pos.device != device:
        raise ValueError(f"slot_pos on {slot_pos.device}, q on {device}")
    if tuple(slot_pos.shape) == (c,):
        sp_stride = 0
    elif tuple(slot_pos.shape) == (b, c):
        sp_stride = c
    else:
        raise ValueError(f"slot_pos has shape {tuple(slot_pos.shape)}, "
                         f"expected ({c},) or ({b}, {c})")
    if not slot_pos.is_contiguous():
        raise ValueError("slot_pos is not contiguous")
    if not isinstance(q_pos, torch.Tensor):
        return sp_stride, None, 0, int(q_pos)
    if q_pos.dtype != torch.int32:
        raise TypeError(f"q_pos is {q_pos.dtype}, expected torch.int32")
    if q_pos.device != device:
        raise ValueError(f"q_pos on {q_pos.device}, q on {device}")
    if q_pos.dim() == 0:
        return sp_stride, q_pos, 0, 0
    if tuple(q_pos.shape) != (b,) or not q_pos.is_contiguous():
        raise ValueError(f"q_pos has shape {tuple(q_pos.shape)}, expected a "
                         f"scalar or a contiguous ({b},)")
    return sp_stride, q_pos, 1, 0


def decode_attention_kernel(q: torch.Tensor, k_cache: torch.Tensor,
                            v_cache: torch.Tensor, slot_pos: torch.Tensor,
                            q_pos: Union[int, torch.Tensor], *,
                            window: int = 0,
                            scale: Optional[float] = None) -> torch.Tensor:
    """Attention of one query token a row against the ring cache, on the
    card.

    ``q``: (B, Hq, D); ``k_cache``/``v_cache``: (B, Hkv, C, D), one type;
    ``q`` fp32 or bf16, the caches fp32 or bf16, all contiguous on one CUDA
    device; ``Hq`` a multiple of ``Hkv``; ``D`` a multiple of 8 up to 256.
    ``slot_pos``: int32 (C,) or (B, C); ``q_pos``: an int, or an int32
    scalar or (B,) tensor on the card.  Returns (B, Hq, D) in ``q``'s
    type."""
    if not q.is_cuda:
        raise ValueError(f"decode_attention_kernel needs a CUDA tensor, got "
                         f"{q.device}")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if t.dtype not in _DTYPES:
            raise TypeError(f"decode_attention_kernel takes float32 or "
                            f"bfloat16, {name} is {t.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    if v_cache.dtype != k_cache.dtype:
        raise TypeError(f"v_cache is {v_cache.dtype}, k_cache is "
                        f"{k_cache.dtype}")
    if q.dim() != 3 or k_cache.dim() != 4:
        raise ValueError("q must be (B, Hq, D) and the caches (B, Hkv, C, D)")
    b, hq, d = q.shape
    hkv, c = k_cache.shape[1], k_cache.shape[2]
    if tuple(k_cache.shape) != (b, hkv, c, d):
        raise ValueError(f"k_cache has shape {tuple(k_cache.shape)}, "
                         f"expected ({b}, Hkv, C, {d})")
    if tuple(v_cache.shape) != tuple(k_cache.shape):
        raise ValueError(f"v_cache has shape {tuple(v_cache.shape)}, "
                         f"k_cache {tuple(k_cache.shape)}")
    if hkv < 1 or hq % hkv:
        raise ValueError(f"Hq = {hq} is not a multiple of Hkv = {hkv}")
    if d % 8 or not 0 < d <= 256:
        raise ValueError(f"head dim {d}: the kernel takes multiples of 8 "
                         "up to 256")
    if c < 1 or b < 1:
        raise ValueError(f"empty cache or batch: C={c}, B={b}")
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")
    sp_stride, qp_t, qp_stride, qp_value = _positions(slot_pos, q_pos, b, c,
                                                      q.device)
    scale = float(scale) if scale is not None else d ** -0.5

    lib = _lib()
    kv_dtype = _DTYPES[k_cache.dtype]
    g = hq // hkv
    bk, slots = _tiling(lib, q.device, kv_dtype, d, g)
    rows = b * hkv * -(-g // _MAX_GROUP)
    per_split, splits = plan_splits(rows, c, bk, slots)

    with torch.cuda.device(q.device):
        out = torch.empty((b, hq, d), dtype=q.dtype, device=q.device)
        # per-split acc (splits, B, Hq, D), then (m, l) (splits, B, Hq, 2)
        scratch = torch.empty(splits * b * hq * (d + 2), dtype=torch.float32,
                              device=q.device)
        part_acc = scratch.data_ptr()
        err = lib.decode_attention_launch(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            slot_pos.data_ptr(), None if qp_t is None else qp_t.data_ptr(),
            part_acc, part_acc + splits * b * hq * d * 4, out.data_ptr(),
            b, hq, hkv, c, d, sp_stride, qp_stride, qp_value, int(window),
            scale, _DTYPES[q.dtype], kv_dtype, bk, per_split, splits,
            torch.cuda.current_stream().cuda_stream)
    decode_attention_kernel.launches += 1
    if err != 0:
        raise RuntimeError(f"decode_attention launch failed: CUDA error {err} "
                           f"(B={b}, Hq={hq}, Hkv={hkv}, C={c}, D={d}, "
                           f"{k_cache.dtype}, bk {bk}, splits {splits})")
    return out


decode_attention_kernel.launches = 0
