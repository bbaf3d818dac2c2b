"""Wrapper of the hand-written Hopper kernel ``csrc/decode_attention.cu``.

Counterpart of ``src/repro/kernels/decode_attention/kernel.py``
(``decode_attention``).  The CUDA source says what the kernel computes and
how it is cut for the card.  This wrapper checks device, types, shapes,
contiguity and the head ratio, picks the tile depth, the ring's stages and
the splits of the cache (``plan_splits``: blocks of one cluster, at most
``chip/h100.MAX_SPLITS``), allocates the output with ``torch.empty`` (and
nothing else: the splits are combined inside the one launch), launches on
PyTorch's current stream without synchronising, and raises if the launch is
refused.  It never gives way to the plain version: a tensor that is not on
a CUDA device is an error here (``ops.decode_attn`` routes CPU tensors to
``ref.decode_attention_ref``).

An int8 ring (``kv_scales`` = its bf16 scales) is read as it is stored and
dequantized inside the kernel, tile by tile, on both routes; route "mma"
builds its fragments from the int8 bytes in registers, reading the head
dim permuted (``k_perm``, ``v_perm``).

``decode_attention_kernel.launches`` counts the launches, one per call that
reaches the card, ``decode_attention_kernel.by_route`` the same calls by
route ("mma": bf16, the products on mma.sync; "fma": FMA loops) and
``decode_attention_kernel.by_kv`` by the ring's type, so that a run can show
which kernels it went through.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Union

import torch

from repro_torch.chip.h100 import MAX_SPLITS, SMS
from repro_torch.kernels import _build
from repro_torch.kernels.kv_quant.kernel import (KV_DTYPES, KV_TYPES,
                                                 kv_scale_pointers)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}              # the query
ROUTES = ("mma", "fma")
_ROUTE_IDS = {"fma": 0, "mma": 1}
MMA_HEAD_DIMS = (16, 32, 64, 72, 80, 96, 112, 128, 256)  # route "mma"
# kWarps, kMaxGroup, kMaxSplits, kMinStages, kMaxStages, kMaxListed, kCoef
# of the source: eight consumer warps (and one producer warp) a block, up to
# 8 query rows a block, a ring of 2 to 4 stages of TILE_SLOTS slots
WARPS = 8
THREADS = 32 * (WARPS + 1)
MAX_GROUP = 8
MIN_STAGES, MAX_STAGES = 2, 4  # route "fma" plans 3 or 4, "mma" 2 or 4
MAX_LISTED = 1024
COEF = WARPS + MAX_SPLITS + 2
TILE_SLOTS = (64, 32, 16)      # tile depths, the deepest that fits first
BLOCKS_PER_SM = 2              # the tiling is sized for two blocks an SM
SM_BYTES = 233_472             # shared memory of an SM
BLOCK_RESERVE = 1024           # of it the system keeps for each block
_PREPARED: set = set()    # (device index, route, kv dtype, head dim, group)


def maxg_for(g: int) -> int:
    """Query rows a block's kernel instance holds for a group of ``g``."""
    c = min(g, MAX_GROUP)
    return 1 if c <= 1 else 4 if c <= 4 else 5 if c == 5 else 8


def smem_bytes(maxg: int, d: int, bk: int, stages: int, elem: int) -> int:
    """Shared memory of a block (``smem_bytes`` of the source): the ring
    of K and V tiles, rows padded to 128-byte blocks (``elem`` bytes an
    element, 1 for int8), or the carries after the loop if they are
    larger; and the rest, an int8 ring's scales among it."""
    ring = stages * 2 * bk * (-(-d * elem // 128) * 128)
    region = max(ring, 4 * (WARPS + 1) * maxg * (d + 2))
    rest = 4 * (maxg * d + bk * (-(-maxg // 4) * 4)
                + stages * bk * (3 if elem == 1 else 1)
                + MAX_LISTED + maxg * COEF + 4) + 2 * stages * 8
    return 1024 + region + rest


def k_perm(d: int) -> list[int]:
    """The head dims route "mma" over an int8 ring reads K at (``k_perm``
    of the source): entry 16 kk + j is the dim at position j of k16 step
    kk of S^T = K Q^T, for lane tig = (j % 8) // 2 the dims 4 KS tig + 4 kk
    + (j % 2 + 2 (j // 8)), so that a lane's elements of every step lie
    side by side in the slot's row.  Q's B fragments are read at the same
    dims.  A permutation of range(16 KS), KS = ceil(d / 16); entries past
    d meet zeros of the query."""
    ks = -(-d // 16)
    return [4 * ks * ((j % 8) // 2) + 4 * kk + j % 2 + 2 * (j // 8)
            for kk in range(ks) for j in range(16)]


def v_perm(d: int) -> list[int]:
    """The head dims route "mma" over an int8 ring reads V at (``v_perm``
    of the source): entry 16 mt + r is the dim of row r of m tile mt of
    O^T += V^T P^T, for r = gid + 8 h the dim 2 KS gid + 2 mt + h, so that
    a lane's dims over every m tile are one run of a slot's row.  A
    permutation of range(16 KS); rows for entries past d are not
    stored."""
    ks = -(-d // 16)
    return [2 * ks * (r % 8) + 2 * mt + r // 8
            for mt in range(ks) for r in range(16)]


def route_of(q: torch.Tensor, k_cache: torch.Tensor) -> str:
    """The route a call with this query and cache takes: "mma" (bf16 query,
    a bf16 or int8 cache, head dim in MMA_HEAD_DIMS: mma.sync products,
    eight query rows a block), "fma" (the rest: FMA products)."""
    if (q.dtype == torch.bfloat16
            and k_cache.dtype in (torch.bfloat16, torch.int8)
            and q.shape[-1] in MMA_HEAD_DIMS):
        return "mma"
    return "fma"


@functools.lru_cache(maxsize=None)
def tiling(g: int, d: int, elem: int, route: str = "fma") -> tuple[int, int]:
    """(tile depth, stages).  Route "fma": the deepest tile whose ring of
    three stages lets BLOCKS_PER_SM blocks share an SM, then as many stages,
    up to MAX_STAGES, as fit beside it.  Route "mma": tiles of 64 slots
    (four warps of 16) and eight query rows; its two groups of four warps
    take alternate tiles, so the stages come in pairs, one group's each; as
    many as fit with BLOCKS_PER_SM blocks an SM, else with one.  ``elem``
    is the ring's element size, 1 for int8."""
    if route == "mma":
        for budget in (SM_BYTES // BLOCKS_PER_SM - BLOCK_RESERVE,
                       SM_BYTES - BLOCK_RESERVE):
            for stages in range(MAX_STAGES, MIN_STAGES - 1, -2):
                if smem_bytes(MAX_GROUP, d, TILE_SLOTS[0], stages,
                              elem) <= budget:
                    return TILE_SLOTS[0], stages
        raise ValueError(f"no tiling of route mma at head dim {d}")
    budget = SM_BYTES // BLOCKS_PER_SM - BLOCK_RESERVE
    maxg = maxg_for(g)
    bk = next((t for t in TILE_SLOTS
               if smem_bytes(maxg, d, t, MIN_STAGES + 1, elem) <= budget),
              TILE_SLOTS[-1])
    stages = MIN_STAGES + 1
    while stages < MAX_STAGES and smem_bytes(maxg, d, bk, stages + 1,
                                             elem) <= budget:
        stages += 1
    return bk, stages


def _lib() -> ctypes.CDLL:
    lib = _build.load("decode_attention")
    if lib.decode_attention_launch.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.decode_attention_launch.argtypes = (
            [ptr] * 8 + [i32] * 9 + [ctypes.c_float] + [i32] * 7 + [ptr])
        lib.decode_attention_launch.restype = i32
        lib.decode_attention_prepare.argtypes = [i32] * 6
        lib.decode_attention_prepare.restype = i32
    return lib


def plan_splits(rows: int, c: int, bk: int, sms: int = SMS
                ) -> tuple[int, int]:
    """(tiles_per_split, splits): how the ``ceil(c / bk)`` tiles of the
    cache are shared out among the blocks of ``rows`` (batch x kv heads x
    query-row chunks).  The splits of a row run as one cluster and give the
    ``sms`` SMs a block each as far as MAX_SPLITS (the blocks of one
    cluster) allows, never more blocks than SMs unless the rows alone are
    more: a second block on an SM, or a bigger cluster, costs more in its
    prologue and in the merge than it saves (PERF.md), and every
    split keeps at least one tile of the ring.  The kernel divides a row's
    live tiles among the ``splits`` evenly; ``tiles_per_split`` is each
    split's range of a ring too long to list.  From the shapes and the card
    alone, so the same inputs are summed in the same order on every run."""
    tiles = -(-c // bk)
    want = max(1, min(tiles, MAX_SPLITS, sms // rows))
    per_split = -(-tiles // want)
    return per_split, -(-tiles // per_split)


def _prepare(lib: ctypes.CDLL, device: torch.device, route: str,
             kv_dtype: int, d: int, g: int, bk: int, stages: int) -> None:
    """Set the kernel instance's shared-memory attributes on ``device``,
    once a key."""
    key = (device.index, route, kv_dtype, d, g)
    if key not in _PREPARED:
        with torch.cuda.device(device):
            err = lib.decode_attention_prepare(_ROUTE_IDS[route], kv_dtype, d,
                                               g, bk, stages)
        if err:
            raise RuntimeError(f"no tiling for D={d}, G={g}, kv dtype "
                               f"{kv_dtype}, route {route}, bk {bk}, stages "
                               f"{stages} (error {err})")
        _PREPARED.add(key)


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def plan_for(q: torch.Tensor, k_cache: torch.Tensor) -> dict:
    """The launch plan of a call with this query and cache on its device:
    ``route``, tile depth ``bk``, ``stages``, ``splits``,
    ``tiles_per_split`` and the ``blocks`` launched."""
    b, hkv, c, d = k_cache.shape
    g = q.shape[1] // hkv
    route = route_of(q, k_cache)
    bk, stages = tiling(g, d, k_cache.element_size(), route)
    rows = b * hkv * -(-g // MAX_GROUP)
    per_split, splits = plan_splits(rows, c, bk, _sms(k_cache.device.index))
    return {"route": route, "bk": bk, "stages": stages, "splits": splits,
            "tiles_per_split": per_split, "blocks": rows * splits}


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
                            scale: Optional[float] = None,
                            kv_scales: Optional[tuple] = None,
                            splits: Optional[int] = None,
                            route: Optional[str] = None) -> torch.Tensor:
    """Attention of one query token a row against the ring cache, on the
    card.  ``splits`` (1 to MAX_SPLITS) and ``route`` override
    ``plan_splits`` and ``route_of``.

    ``q``: (B, Hq, D); ``k_cache``/``v_cache``: (B, Hkv, C, D), one type;
    ``q`` fp32 or bf16, the caches fp32, bf16 or int8, all contiguous on one
    CUDA device; an int8 cache with its ``kv_scales`` = (k_scale, v_scale),
    bf16 (B, Hkv, C, 1), contiguous, and no other cache with scales; ``Hq``
    a multiple of ``Hkv``; ``D`` a multiple of 8 up to 256.  ``slot_pos``:
    int32 (C,) or (B, C); ``q_pos``: an int, or an int32 scalar or (B,)
    tensor on the card.  Returns (B, Hq, D) in ``q``'s type."""
    if not q.is_cuda:
        raise ValueError(f"decode_attention_kernel needs a CUDA tensor, got "
                         f"{q.device}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"decode_attention_kernel takes a float32 or "
                        f"bfloat16 query, q is {q.dtype}")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if t is not q and t.dtype not in KV_DTYPES:
            raise TypeError(f"decode_attention_kernel takes a float32, "
                            f"bfloat16 or int8 cache, {name} is {t.dtype}")
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
    scale_ptrs = kv_scale_pointers(k_cache, kv_scales)
    scale = float(scale) if scale is not None else d ** -0.5

    lib = _lib()
    kv_dtype = KV_DTYPES[k_cache.dtype]
    g = hq // hkv
    if route is None:
        route = route_of(q, k_cache)
    elif route not in ROUTES:
        raise ValueError(f"unknown route {route!r}; known: {ROUTES}")
    if route == "mma" and route_of(q, k_cache) != "mma":
        raise ValueError(f"route mma takes a bf16 query, a bf16 or int8 "
                         f"cache, at head dims {MMA_HEAD_DIMS}")
    bk, stages = tiling(g, d, k_cache.element_size(), route)
    _prepare(lib, q.device, route, kv_dtype, d, g, bk, stages)
    rows = b * hkv * -(-g // MAX_GROUP)
    if splits is None:
        per_split, splits = plan_splits(rows, c, bk, _sms(q.device.index))
    elif 1 <= splits <= MAX_SPLITS:
        per_split = -(-(-(-c // bk)) // splits)
        splits = -(-(-(-c // bk)) // per_split)
    else:
        raise ValueError(f"splits {splits}: 1 to {MAX_SPLITS}")

    with torch.cuda.device(q.device):
        out = torch.empty((b, hq, d), dtype=q.dtype, device=q.device)
        err = lib.decode_attention_launch(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), *scale_ptrs,
            slot_pos.data_ptr(), None if qp_t is None else qp_t.data_ptr(),
            out.data_ptr(), b, hq, hkv, c, d, sp_stride, qp_stride, qp_value,
            int(window), scale, _DTYPES[q.dtype], kv_dtype, _ROUTE_IDS[route],
            bk, stages, per_split, splits,
            torch.cuda.current_stream().cuda_stream)
    decode_attention_kernel.launches += 1
    decode_attention_kernel.by_route[route] += 1
    decode_attention_kernel.by_kv[KV_TYPES[kv_dtype]] += 1
    if err != 0:
        raise RuntimeError(f"decode_attention launch failed: CUDA error {err} "
                           f"(B={b}, Hq={hq}, Hkv={hkv}, C={c}, D={d}, "
                           f"{k_cache.dtype}, route {route}, bk {bk}, "
                           f"stages {stages}, "
                           f"splits {splits})")
    return out


decode_attention_kernel.launches = 0
decode_attention_kernel.by_route = dict.fromkeys(ROUTES, 0)
decode_attention_kernel.by_kv = dict.fromkeys(KV_TYPES, 0)
