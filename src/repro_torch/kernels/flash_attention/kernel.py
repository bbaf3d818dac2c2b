"""Wrapper of the hand-written Hopper kernel ``csrc/flash_attention.cu``.

Counterpart of ``src/repro/kernels/flash_attention/kernel.py``
(``flash_attention``).  The CUDA source says what the kernel computes and
how it is cut for the card.  This wrapper checks device, types, shapes,
strides, alignment and the head ratio, decides the route before the launch
(``route_of``: "wgmma" for bf16 at the head dims of ``WGMMA_HEAD_DIMS``, an
int8 cache at those of ``WGMMA_INT8_HEAD_DIMS``, "mma_sync" for the other
bf16 head dims, "fma" for an fp32 query) and, on "wgmma", the
split of the KV loop over a cluster (``plan_splits``, from the shapes and
the card alone), allocates the output in (B, Sq, Hq, D) storage with
``torch.empty`` and returns it as the (B, Hq, Sq, D) view, launches on
PyTorch's current stream without synchronising, and raises if the launch is
refused.  It never gives way to another route or to the plain version: a
tensor that is not on a CUDA device is an error here (``ops.flash_attn`` /
``ops.flash_attn_pos`` route CPU tensors to ``ref.mha_ref`` /
``ref.mha_pos_ref``).

An int8 cache (``kv_scales`` = its bf16 scales, the ring of a chunk of a
prompt) is read as it is stored on every route and dequantized inside the
kernel, tile by tile; route "wgmma" keeps its int8 tiles in a ring of
``WG_STAGES`` as over bf16, beside one bf16 K and one V tile dequantized
from them, two blocks an SM as over bf16 (D 256: one).

``flash_attention_kernel.launches`` counts the launches, one per call that
reaches the card, ``flash_attention_kernel.by_route`` the same calls by
route and ``flash_attention_kernel.by_kv`` by the cache's type, so that a
run can show which kernels it went through.

Training asks the forward for each row's log-sum-exp (``lse``, fp32
(B, Hq, Sq)), which every route writes when given the buffer; the serving
paths pass none and run as before.  ``flash_attention_bwd_kernel`` is the
gradient (a dQ pass, then a dK/dV pass; ``bwd_route_of``: "wgmma" for bf16
at ``BWD_WGMMA_HEAD_DIMS``, ``csrc/flash_attention_bwd_wgmma.cu``;
"mma_sync" for the other bf16 head dims and "fma" for fp32,
``csrc/flash_attention_bwd.cu``), ``flash_attention_bwd_kernel.launches``
counts its calls (two kernels each) and ``by_route`` them by route.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.chip.h100 import MAX_SPLITS, SMS
from repro_torch.kernels import _build
from repro_torch.kernels.kv_quant.kernel import (KV_DTYPES, KV_TYPES,
                                                 kv_scale_pointers)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}              # the query
ROUTES = ("wgmma", "mma_sync", "fma")
_ROUTE_IDS = {"fma": 0, "mma_sync": 1, "wgmma": 2}
MMA_HEAD_DIMS = (16, 32, 64, 72, 80, 96, 112, 128, 256)  # the bf16 routes
# route "wgmma" (csrc/flash_attention_wgmma.cu): a bf16 cache at these head
# dims, an int8 one at those of WGMMA_INT8_HEAD_DIMS (an int8 row of 72 bytes
# is no stride TMA takes); "mma_sync" (csrc/flash_attention.cu) compiles
# MMA_SYNC_HEAD_DIMS and is the plan at the rest
WGMMA_HEAD_DIMS = (64, 72, 80, 96, 112, 128, 256)
WGMMA_INT8_HEAD_DIMS = (64, 80, 96, 112, 128, 256)
MMA_SYNC_HEAD_DIMS = (16, 32, 72, 80, 96, 112)
# route "wgmma": kWgRows, kWgBK, kWgThreads of the source.  A block owns 64
# rows, a row being a (query position, head of the kv head's group) pair,
# and walks K and V tiles of 64 keys; one consumer warpgroup and one
# producer warp
WG_ROWS = 64
WG_BK = 64
WG_THREADS = 160
WG_STAGES = {d: 4 if d == 64 else 2 for d in WGMMA_HEAD_DIMS}  # the ring's stages
# head dims route "wgmma" lays out as 128; there it takes a group of one
# query head a kv head (G 1) only where no "mma_sync" instance is compiled:
# packing rows saves nothing at G 1 (each K/V tile is read once a head on
# both routes), and dit-xl's prefill (D 72, G 1) measured "mma_sync" faster
# (0.0220 against 0.0240 ms, PERF.md, PR 24)
PADDED_HEAD_DIMS = (72, 80, 96, 112)
_PREPARED: set = set()    # (library, device index) whose kernel attributes are set


def route_for(q_dtype: torch.dtype, kv_dtype: torch.dtype, d: int,
              g: int) -> str:
    """The route of a query of ``q_dtype`` on a cache of ``kv_dtype`` at head
    dim ``d`` with ``g`` query heads a kv head: "fma" for an fp32 query;
    "wgmma" for bf16 at the head dims of ``WGMMA_HEAD_DIMS`` (an int8
    cache: ``WGMMA_INT8_HEAD_DIMS``), but at ``PADDED_HEAD_DIMS`` only with
    g > 1; "mma_sync" for the rest."""
    if q_dtype == torch.float32:
        return "fma"
    dims = WGMMA_INT8_HEAD_DIMS if kv_dtype == torch.int8 else WGMMA_HEAD_DIMS
    if d in PADDED_HEAD_DIMS and g == 1:
        return "mma_sync"
    return "wgmma" if d in dims else "mma_sync"


def route_of(q: torch.Tensor, k: torch.Tensor) -> str:
    """The route a call with this query and cache takes (``route_for``)."""
    return route_for(q.dtype, k.dtype, q.shape[-1],
                     q.shape[1] // max(1, k.shape[1]))


def plan_splits(b: int, hkv: int, sq: int, sk: int, g: int,
                sms: int = SMS) -> tuple[int, int]:
    """(row tiles, splits) of route "wgmma": a block owns (b, kv head, row
    tile of WG_ROWS rows of Sq x G); when those blocks do not cover the
    ``sms`` SMs, the live KV tiles of each are divided among ``splits``
    blocks of one cluster, enough to cover them, at most MAX_SPLITS (the
    portable cluster size) and at most the tiles of Sk.  From the shapes
    and the card alone, never from the data, so that the same chunk is
    summed in the same order, to the same bits, on every run."""
    row_tiles = -(-sq * g // WG_ROWS)
    base = b * hkv * row_tiles
    if base >= sms:
        return row_tiles, 1
    return row_tiles, max(1, min(MAX_SPLITS, -(-sk // WG_BK), -(-sms // base)))


# the library of a route: "wgmma" is compiled from flash_attention_wgmma.cu,
# the others from flash_attention.cu, two nvcc processes side by side
_LIBS = {"wgmma": "flash_attention_wgmma", "mma_sync": "flash_attention",
         "fma": "flash_attention"}


def _lib(route: str) -> tuple[ctypes.CDLL, str]:
    """The library of ``route`` and the prefix of its functions."""
    name = _LIBS[route]
    lib = _build.load(name)
    launch = getattr(lib, f"{name}_launch")
    if launch.argtypes is None:
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        # route "wgmma" takes no route id
        launch.argtypes = (
            [ptr] * 9 + [i32] * 6 + [i64] * 6 + [i32] * 4 + [ctypes.c_float]
            + [i32] * (3 if route == "wgmma" else 4) + [ptr])
        launch.restype = i32
        getattr(lib, f"{name}_prepare").argtypes = []
        getattr(lib, f"{name}_prepare").restype = i32
    return lib, name


def _prepare(lib: ctypes.CDLL, name: str, device: torch.device) -> None:
    """Set the library's shared-memory limits once on ``device``."""
    if (name, device.index) in _PREPARED:
        return
    with torch.cuda.device(device):
        err = getattr(lib, f"{name}_prepare")()
    if err:
        raise RuntimeError(f"{name}_prepare failed: CUDA error {err}")
    _PREPARED.add((name, device.index))


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
                           scale: Optional[float] = None,
                           kv_scales: Optional[tuple] = None,
                           route: Optional[str] = None,
                           splits: Optional[int] = None,
                           lse: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Causal / bidirectional, GQA, sliding-window attention on the card.

    ``q``: (B, Hq, Sq, D) with any strides whose last is 1 (on the bf16
    routes multiples of 8 elements, 16-byte aligned); ``k``/``v``:
    (B, Hkv, Sk, D), one type, contiguous, 16-byte aligned; on one CUDA
    device; ``Hq`` a multiple of ``Hkv``.  bf16 ``q`` with a bf16 or int8
    cache and ``D`` in ``MMA_HEAD_DIMS`` (tensor cores), or fp32 ``q`` with
    an fp32, bf16 or int8 cache and ``D`` a multiple of 8 up to 256; an int8
    cache with its ``kv_scales`` = (k_scale, v_scale), bf16 (B, Hkv, Sk, 1),
    contiguous.  Without positions,
    ``Sq == Sk`` at positions 0..S-1, or any Sq against any Sk when
    ``causal`` is False and there is no window (a cross-attention: keys
    past Sk and query rows past Sq are masked by index); with them, ``q_pos`` (B, Sq) and
    ``k_pos`` (B, Sk) int32 on the card.  Returns (B, Hq, Sq, D) in ``q``'s
    type, the transposed view of (B, Sq, Hq, D) storage.  ``route`` and
    ``splits`` (route "wgmma", 1 to MAX_SPLITS) override ``route_of`` and
    ``plan_splits``.  ``lse``: None, or an fp32 (B, Hq, Sq) contiguous
    tensor on q's device into which the kernel writes each row's
    log-sum-exp of the scaled scores (+inf for a row with no live key)."""
    if not q.is_cuda:
        raise ValueError(f"flash_attention_kernel needs a CUDA tensor, got "
                         f"{q.device}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention_kernel takes a float32 or bfloat16 "
                        f"query, q is {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t is not q and t.dtype not in KV_DTYPES:
            raise TypeError(f"flash_attention_kernel takes a float32, "
                            f"bfloat16 or int8 cache, {name} is {t.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if t is not q and not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")
    if v.dtype != k.dtype:
        raise TypeError(f"v is {v.dtype}, k is {k.dtype}")
    if q.dtype == torch.bfloat16 and k.dtype == torch.float32:
        raise TypeError("a bf16 query takes a bf16 or int8 cache")
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
        raise ValueError(f"head dim {d}: the bf16 kernels take "
                         f"{MMA_HEAD_DIMS}")
    if d % 8 or not 0 < d <= 256:
        raise ValueError(f"head dim {d}: the kernel takes multiples of 8 "
                         "up to 256")
    if min(b, hq, sq, sk) < 1:
        raise ValueError(f"empty input: B={b}, Hq={hq}, Sq={sq}, Sk={sk}")
    q_sb, q_sh, q_ss, q_sd = q.stride()
    if q_sd != 1 or (q.dtype == torch.bfloat16
                     and (q_sb % 8 or q_sh % 8 or q_ss % 8)):
        raise ValueError(f"q's strides {q.stride()}: the last must be 1, on "
                         "the bf16 routes the others multiples of 8")
    if (q_pos is None) != (k_pos is None):
        raise ValueError("q_pos and k_pos come both or not at all")
    if q_pos is None:
        if sq != sk and (causal or window):
            raise ValueError(f"without positions Sq must equal Sk unless "
                             f"causal is False with no window, got {sq} "
                             f"and {sk}")
        qp_stride = kp_stride = 0
    else:
        qp_stride = _positions("q_pos", q_pos, b, sq, q.device)
        kp_stride = _positions("k_pos", k_pos, b, sk, q.device)
    if lse is not None and (lse.dtype != torch.float32 or lse.device
                            != q.device or tuple(lse.shape) != (b, hq, sq)
                            or not lse.is_contiguous()):
        raise ValueError(f"lse must be float32 ({b}, {hq}, {sq}), "
                         "contiguous, on q's device")
    scale_ptrs = kv_scale_pointers(k, kv_scales)
    scale = float(scale) if scale is not None else d ** -0.5
    if route is None:
        route = route_of(q, k)
    elif route not in ROUTES:
        raise ValueError(f"unknown route {route!r}; known: {ROUTES}")
    if (route == "fma") != (q.dtype == torch.float32) or (
            route == "wgmma" and route_for(q.dtype, k.dtype, d, 2) != "wgmma") \
            or (route == "mma_sync" and d not in MMA_SYNC_HEAD_DIMS):
        raise ValueError(f"route {route} does not take {q.dtype} with a "
                         f"{k.dtype} cache at head dim {d}")
    if route != "wgmma":
        splits = 1
    elif splits is None:
        splits = plan_splits(b, hkv, sq, sk, hq // hkv,
                             _sms(q.device))[1]
    elif not 1 <= splits <= MAX_SPLITS:
        raise ValueError(f"splits {splits}: 1 to {MAX_SPLITS}")

    lib, name = _lib(route)
    _prepare(lib, name, q.device)
    last = (splits,) if route == "wgmma" else (_ROUTE_IDS[route], splits)
    with torch.cuda.device(q.device):
        out = torch.empty((b, sq, hq, d), dtype=q.dtype,
                          device=q.device).transpose(1, 2)
        err = getattr(lib, f"{name}_launch")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), *scale_ptrs,
            None if q_pos is None else q_pos.data_ptr(),
            None if k_pos is None else k_pos.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), b, hq, hkv, sq, sk, d, q_sb, q_sh, q_ss, *out.stride()[:3],
            qp_stride, kp_stride, int(causal), int(window), scale,
            _DTYPES[q.dtype], KV_DTYPES[k.dtype], *last,
            torch.cuda.current_stream().cuda_stream)
    flash_attention_kernel.launches += 1
    flash_attention_kernel.by_route[route] += 1
    flash_attention_kernel.by_kv[KV_TYPES[KV_DTYPES[k.dtype]]] += 1
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err} "
                           f"(route {route}, splits {splits}, B={b}, "
                           f"Hq={hq}, Hkv={hkv}, Sq={sq}, Sk={sk}, D={d}, "
                           f"{q.dtype}/{k.dtype}, positions "
                           f"{q_pos is not None})")
    return out


@functools.lru_cache(maxsize=None)
def _sms_of(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _sms(device: torch.device) -> int:
    return _sms_of(device.index)


flash_attention_kernel.launches = 0
flash_attention_kernel.by_route = dict.fromkeys(ROUTES, 0)
flash_attention_kernel.by_kv = dict.fromkeys(KV_TYPES, 0)


BWD_ROUTES = ("wgmma", "mma_sync", "fma")
BWD_HEAD_DIMS = (16, 32, 64, 72, 80, 96, 112, 128, 256)  # the bf16 backward's
# route "wgmma" (csrc/flash_attention_bwd_wgmma.cu): these head dims, 72-112
# in the layout of 128, faster than "mma_sync" at every one measured
# (PERF.md); "mma_sync" (csrc/flash_attention_bwd.cu) compiles the rest
BWD_WGMMA_HEAD_DIMS = (64, 72, 80, 96, 112, 128, 256)
BWD_MMA_HEAD_DIMS = (16, 32)
# kBwdBlockRows, kBwdTile, the threads and the stages of its two passes: a
# block owns 128 query rows (dQ: two consumer warpgroups of 64) or 64 keys
# (dK/dV: one warpgroup takes dV, the other dK), and a producer warp, and
# walks tiles of 64 keys (dQ) or query rows (dK/dV)
BWD_BLOCK_ROWS = 128
BWD_TILE = 64
BWD_DQ_THREADS = 288
BWD_DKV_THREADS = 288
BWD_DQ_STAGES = 3
BWD_DKV_STAGES = 4
# head dims past 128 (``BwdTile<D>::SPLIT``): the two warpgroups split each
# output's columns; a dQ block owns BWD_TILE query rows, a dK/dV block 64
# keys and half of D's columns, and both rings have BWD_SPLIT_STAGES stages
BWD_SPLIT_STAGES = 2


def bwd_route_of(q: torch.Tensor) -> str:
    """The route ``flash_attention_bwd_kernel`` takes for this query: "fma"
    for fp32, "wgmma" for bf16 at ``BWD_WGMMA_HEAD_DIMS``, "mma_sync" for
    the other bf16 head dims."""
    if q.dtype == torch.float32:
        return "fma"
    return "wgmma" if q.shape[-1] in BWD_WGMMA_HEAD_DIMS else "mma_sync"


def bwd_wgmma_smem(d: int) -> tuple[int, int]:
    """Shared memory of a block of route "wgmma"'s (dQ, dK/dV) passes at
    head dim ``d``: ``BwdTile<D>::DQ_SMEM`` and ``DKV_SMEM`` of the source
    (1024 bytes of alignment slack, the block's Q and dO, or K and V,
    tiles, the ring of 64-row tiles, the (lse, delta) pairs, the
    mbarriers)."""
    dp = 64 if d <= 64 else 128 if d <= 128 else 256
    split = d > 128
    rows = BWD_TILE if split else BWD_BLOCK_ROWS
    dq_stages = BWD_SPLIT_STAGES if split else BWD_DQ_STAGES
    dkv_stages = BWD_SPLIT_STAGES if split else BWD_DKV_STAGES
    tile64, tile_rows = BWD_TILE * dp * 2, rows * dp * 2
    dq = (1024 + 2 * tile_rows + dq_stages * 2 * tile64
          + rows * 8 + (2 * dq_stages + 1) * 8)
    dkv = (1024 + 2 * tile64 + dkv_stages * 2 * tile64
           + dkv_stages * BWD_TILE * 8 + (2 * dkv_stages + 1) * 8)
    return dq, dkv


# the library of a backward route and the prefix of its functions; both
# launchers take the same arguments
_BWD_LIBS = {"wgmma": "flash_attention_bwd_wgmma",
             "mma_sync": "flash_attention_bwd", "fma": "flash_attention_bwd"}
# the passes a launch runs: the dQ pass (which also writes each row's delta),
# the dK/dV pass (which reads it)
BWD_PASS_DQ, BWD_PASS_DKV = 1, 2


def _bwd_lib(route: str) -> tuple[ctypes.CDLL, str]:
    name = _BWD_LIBS[route]
    lib = _build.load(name)
    launch = getattr(lib, f"{name}_launch")
    if launch.argtypes is None:
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        launch.argtypes = ([ptr] * 10 + [i32] * 6 + [i64] * 12 + [i32] * 2
                           + [ctypes.c_float, i32, i32, ptr])
        launch.restype = i32
        getattr(lib, f"{name}_error_name").argtypes = [i32]
        getattr(lib, f"{name}_error_name").restype = ctypes.c_char_p
    return lib, name


def _strided(name: str, t: torch.Tensor, shape: tuple, like: torch.Tensor,
             bf16: bool) -> torch.Tensor:
    """``t`` as the kernel reads it: ``shape``, ``like``'s type and device,
    the last stride 1 (and on bf16 the others multiples of 8, the base on
    16 bytes); a tensor that is not so is copied contiguous first."""
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{shape}")
    if t.dtype != like.dtype or t.device != like.device:
        raise ValueError(f"{name} must have q's type and device")
    ok = t.stride(-1) == 1 and (not bf16 or (
        all(s % 8 == 0 for s in t.stride()[:-1]) and t.data_ptr() % 16 == 0))
    return t if ok else t.contiguous()


def flash_attention_bwd_kernel(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, out: torch.Tensor,
                               dout: torch.Tensor, lse: torch.Tensor, *,
                               causal: bool = True, window: int = 0,
                               scale: Optional[float] = None
                               ) -> tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """(dq, dk, dv) of ``flash_attention_kernel``'s function at positions
    0..S-1 (Sq != Sk bidirectional with no window only) on the card, from
    its output ``out`` and row log-sum-exp ``lse``.  q, out, dout (B, Hq,
    Sq, D) with any strides whose last is 1 (dout as autograd hands it: the
    (B, Sq, Hq, D) storage of the forward's output); k, v (B, Hkv, Sk, D)
    contiguous; one type, bf16 (D in ``BWD_HEAD_DIMS``) or fp32 (D a
    multiple of 8 up to 256).  dq comes in (B, Sq, Hq, D) storage as the
    forward's output, dk and dv contiguous; the route ``bwd_route_of``'s.
    The plain version is ``ref.mha_bwd_ref``."""
    if not q.is_cuda:
        raise ValueError(f"flash_attention_bwd_kernel needs a CUDA tensor, "
                         f"got {q.device}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention_bwd_kernel takes float32 or "
                        f"bfloat16, got {q.dtype}")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError("q must be (B, Hq, Sq, D) and k, v (B, Hkv, Sk, D)")
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    bf16 = q.dtype == torch.bfloat16
    if bf16 and d not in BWD_HEAD_DIMS:
        raise ValueError(f"head dim {d}: the bf16 backward takes "
                         f"{BWD_HEAD_DIMS}")
    if d % 8 or not 0 < d <= 256:
        raise ValueError(f"head dim {d}: the kernel takes multiples of 8 "
                         "up to 256")
    if hkv < 1 or hq % hkv:
        raise ValueError(f"Hq = {hq} is not a multiple of Hkv = {hkv}")
    if sq != sk and (causal or window):
        raise ValueError(f"Sq {sq} != Sk {sk} takes causal=False and no "
                         "window")
    for name, t in (("k", k), ("v", v)):
        if (tuple(t.shape) != (b, hkv, sk, d) or t.dtype != q.dtype
                or t.device != q.device or not t.is_contiguous()
                or t.data_ptr() % 16):
            raise ValueError(f"{name} must be ({b}, {hkv}, {sk}, {d}) of "
                             "q's type, contiguous, 16-byte aligned")
    q = _strided("q", q, (b, hq, sq, d), q, bf16)
    out = _strided("out", out, (b, hq, sq, d), q, bf16)
    dout = _strided("dout", dout, (b, hq, sq, d), q, bf16)
    if (lse.dtype != torch.float32 or tuple(lse.shape) != (b, hq, sq)
            or not lse.is_contiguous() or lse.device != q.device):
        raise ValueError(f"lse must be float32 ({b}, {hq}, {sq}), "
                         "contiguous, on q's device")
    scale = float(scale) if scale is not None else d ** -0.5
    route = bwd_route_of(q)
    lib, name = _bwd_lib(route)
    with torch.cuda.device(q.device):
        dq = torch.empty((b, sq, hq, d), dtype=q.dtype,
                         device=q.device).transpose(1, 2)
        dk = torch.empty_like(k)
        dv = torch.empty_like(v)
        # each row's (lse log2 e, delta) on route "wgmma", rows padded to
        # the 64 of a tile; each row's delta on the others
        work = torch.empty((b, hq, -(-sq // BWD_TILE) * BWD_TILE, 2),
                           dtype=torch.float32, device=q.device)
        err = getattr(lib, f"{name}_launch")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), work.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), b, hq, hkv, sq, sk, d,
            *q.stride()[:3], *out.stride()[:3], *dout.stride()[:3],
            *dq.stride()[:3], int(causal), int(window), scale, int(bf16),
            BWD_PASS_DQ | BWD_PASS_DKV,
            torch.cuda.current_stream().cuda_stream)
    flash_attention_bwd_kernel.launches += 1
    flash_attention_bwd_kernel.by_route[route] += 1
    if err != 0:
        raise RuntimeError(
            f"flash_attention_bwd launch failed: CUDA error {err} "
            f"({getattr(lib, f'{name}_error_name')(err).decode()}; route "
            f"{route}, B={b}, Hq={hq}, Hkv={hkv}, Sq={sq}, Sk={sk}, D={d}, "
            f"{q.dtype}, causal {causal}, window {window})")
    return dq, dk, dv


flash_attention_bwd_kernel.launches = 0
flash_attention_bwd_kernel.by_route = dict.fromkeys(BWD_ROUTES, 0)
