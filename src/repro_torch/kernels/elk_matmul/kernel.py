"""Wrapper of the hand-written Hopper kernel ``csrc/elk_matmul.cu``.

Counterpart of ``src/repro/kernels/elk_matmul/kernel.py`` (``elk_matmul``).
The CUDA source says what the kernel computes and how it is cut for the
card.  This wrapper checks device, types, shapes and strides, decides the
route before the launch (``route_of``: "wgmma" for bf16 with m >= 64 and
operands TMA takes, "splitk" for such products with fewer rows,
"wgmma_xt" for such an x^T dy (x read transposed) at any m; their
"_realign" twins where TMA takes x but not a (K, N) row-major y, whose
tiles the producer loads and realigns itself; "fma" for fp32, "fma_splitk"
where its output tiles do not cover the SMs; "mma_sync" for the rest and
for any forced block shape) and takes its plan from ``chip/h100.smem_plan``
(cached per shape, type, route and operand, so a decode step's 161
products do not run the greedy), allocates the output with
``torch.empty``, launches on PyTorch's current stream without
synchronising, and raises if the launch is refused.  It never gives way to
another route or to the plain version: a tensor that is not on a CUDA
device is an error here (``ops.matmul`` routes CPU tensors to
``ref.matmul_ref``).

``elk_matmul_kernel.launches`` counts the launches, one per call that
reaches the card, ``elk_matmul_kernel.by_route`` the same calls by
route, and ``elk_matmul_kernel.by_operand`` by how x is read ("x", or
"x_trans": the transposed view of a stored matrix, the x^T dy of a weight
gradient), so that a run can show which kernels it went through.

The training side adds two operands the kernel reads in place: ``x`` given
as the transpose of a stored (k, m) matrix (the activations of a weight
gradient x^T dy, contracted over the tokens, with no transposed copy:
TMA's box over the stored layout and wgmma's MN-major A, ldmatrix.trans on
mma_sync, the stored tile on the FMA route), and a second pair ``x2, y2``
whose product is summed after the first in the same fp32 accumulator (the
MLP's dx = dg w_gate^T + du w_up^T, one sum in a fixed order; x as stored,
y transposed, an instance of its own on every route).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.chip.h100 import (FMA_STAGES, ROW_PAD_BYTES,
                                   SMEM_PER_BLOCK, STAGES, TILE_M, TILE_N,
                                   SmemPlan, smem_plan)
from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_PREPARED: set = set()    # device indices whose kernel attributes are set
ROUTES = ("wgmma", "splitk", "wgmma_xt", "wgmma_realign", "splitk_realign",
          "fma", "fma_splitk", "mma_sync")
# the library of a route: the TMA + wgmma routes are compiled from
# csrc/elk_matmul.cu, the others from csrc/elk_matmul_sync.cu (two nvcc
# processes side by side)
_TMA_ROUTES = ("wgmma", "splitk", "wgmma_xt", "wgmma_realign",
               "splitk_realign")
OPERANDS = ("x", "x_trans")


def _tma_lib() -> ctypes.CDLL:
    lib = _build.load("elk_matmul")
    if lib.elk_matmul_tma_launch.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.elk_matmul_tma_launch.argtypes = [ptr] * 5 + [i32] * 11 + [ptr]
        lib.elk_matmul_tma_launch.restype = i32
        lib.elk_matmul_xt_capacity.argtypes = [i32] * 3
        lib.elk_matmul_xt_capacity.restype = i32
    return lib


def _lib() -> ctypes.CDLL:
    lib = _build.load("elk_matmul_sync")
    if lib.elk_matmul_launch.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.elk_matmul_launch.argtypes = [ptr] * 5 + [i32] * 11 + [ptr]
        lib.elk_matmul_launch.restype = i32
        lib.elk_matmul_fma_launch.argtypes = [ptr] * 5 + [i32] * 12 + [ptr]
        lib.elk_matmul_fma_launch.restype = i32
        lib.elk_matmul_error_name.argtypes = [i32]
        lib.elk_matmul_error_name.restype = ctypes.c_char_p
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
def plan_for(m: int, n: int, k: int, dtype: torch.dtype,
             tma: bool = True, realign: bool = False,
             mma_sync: bool = False, x_trans: bool = False) -> SmemPlan:
    """``smem_plan`` on one H100 for this product, once per shape, type and
    what the operands allow (``tma``: TMA takes both; ``realign``: TMA
    takes x, y is loaded and realigned by the producer; ``mma_sync``: the
    plan behind a forced block shape; ``x_trans``: x read as the transpose
    of a stored (k, m) matrix, the x^T dy of a weight gradient, whose TMA
    plan is its own, route "wgmma_xt")."""
    return smem_plan(m, n, k, dtype_bytes=torch.empty(
        (), dtype=dtype).element_size(), tma=tma, realign=realign,
        mma_sync=mma_sync, x_trans=x_trans)


def xt_capacity(device: torch.device, bm: int, bn: int, splits: int) -> int:
    """Blocks of the persistent x^T dy instance (bm, bn) the card holds at
    once in clusters of ``splits`` (1: no clusters), as the launch finds
    it (``cudaOccupancyMaxActiveClusters``); the plan reads the H100's
    from ``chip/h100.XT_RESIDENT``."""
    with torch.cuda.device(device):
        return _tma_lib().elk_matmul_xt_capacity(bm // 64, bn, splits)


def _tma_ok(t: torch.Tensor, ld: int) -> bool:
    return ld % 8 == 0 and t.data_ptr() % 16 == 0


def tma_legal(x: torch.Tensor, y: torch.Tensor, lda: int, ldy: int) -> bool:
    """The operands are what TMA takes: bf16, bases on 16 bytes, row
    strides of whole 16 bytes (8 elements)."""
    return x.dtype == torch.bfloat16 and _tma_ok(x, lda) and _tma_ok(y, ldy)


def realign_legal(x: torch.Tensor, y: torch.Tensor, lda: int, ldy: int,
                  y_trans: int) -> bool:
    """A bf16 product the "_realign" routes take: x (m, k) as stored and
    what TMA takes, y (k, n) row-major with a row stride or a base TMA
    refuses (hymba's untied head, rows of 32001 elements; an unaligned
    view), loaded by the producer warpgroup and realigned."""
    return (x.dtype == torch.bfloat16 and not x_trans_of(x) and not y_trans
            and _tma_ok(x, lda) and not _tma_ok(y, ldy))


def plan_of(x: torch.Tensor, y: torch.Tensor) -> SmemPlan:
    """The plan ``elk_matmul_kernel`` takes for ``x @ y`` with no block
    shape given: from dtype, shapes and strides, before any launch."""
    m, n, k, lda, ldy, y_trans = layout(x, y)
    return plan_for(m, n, k, x.dtype, tma_legal(x, y, lda, ldy),
                    realign_legal(x, y, lda, ldy, y_trans),
                    x_trans=x_trans_of(x))


def route_of(x: torch.Tensor, y: torch.Tensor) -> str:
    """The route ``elk_matmul_kernel`` takes for ``x @ y`` with no block
    shape given: from dtype, m and strides, before any launch."""
    return plan_of(x, y).route


def route_for(m: int, n: int, k: int, dtype: torch.dtype, lda: int,
              ldy: int, y_trans: int = 0) -> str:
    """``route_of`` from shapes and row strides alone, the bases on 16
    bytes (a model's weights and activations)."""
    bf16 = dtype == torch.bfloat16
    x_ok, y_ok = lda % 8 == 0, ldy % 8 == 0
    return plan_for(m, n, k, dtype, bf16 and x_ok and y_ok,
                    bf16 and x_ok and not y_ok and not y_trans).route


def x_trans_of(x: torch.Tensor) -> bool:
    """Whether ``x`` (m, k) is read as the transpose of a stored (k, m)
    matrix (unit row stride, its column stride the stored row's), rather
    than by rows: an x whose rows are contiguous is read by rows."""
    m, k = x.shape
    return k > 1 and x.stride(1) != 1 and (m == 1 or x.stride(0) == 1)


def layout(x: torch.Tensor, y: torch.Tensor
           ) -> tuple[int, int, int, int, int, int]:
    """(m, n, k, lda, ldy, y_trans) of ``x @ y`` as the kernel takes it, or
    raises.  ``x`` (m, k) with unit column stride (a row stride of its own,
    as ``x[:, -1, :]`` of a prefill has; ``lda`` that stride), or the
    transposed view of a stored (k, m) matrix (``x_trans_of``; ``lda`` the
    stored row stride, y then (k, n) row-major); ``y`` (k, n) with unit
    column stride and a row stride of at least n (``ldy``: n, or a column
    view's), or the transposed view of an (n, k) row-major tensor
    (``embed.t()`` of a tied embedding, ``y_trans`` 1); no other stride."""
    xs, ys = x.shape, y.shape
    if len(xs) != 2 or len(ys) != 2:
        raise ValueError(f"x must be (m, k) and y (k, n), got "
                         f"{tuple(xs)} and {tuple(ys)}")
    (m, k), (k2, n) = xs, ys
    if k != k2:
        raise ValueError(f"x {tuple(xs)} and y {tuple(ys)} do not chain")
    (sx0, sx1), (sy0, sy1) = x.stride(), y.stride()
    if x_trans_of(x):
        lda = sx1
    elif k > 1 and sx1 != 1:
        raise ValueError(f"x's rows are not contiguous (strides "
                         f"{(sx0, sx1)})")
    else:
        lda = sx0 if m > 1 else k
    # the stride of a dimension of size 1 does not matter, as for
    # is_contiguous (a call here costs a view for the transposed case)
    if (n == 1 or sy1 == 1) and (k == 1 or sy0 >= n):
        return m, n, k, lda, sy0 if k > 1 else n, 0
    if (k == 1 or sy0 == 1) and (n == 1 or sy1 == k):
        return m, n, k, lda, k, 1
    raise ValueError(f"y {tuple(ys)} with strides {(sy0, sy1)} is "
                     "neither (k, n) row-major nor the transpose of an "
                     "(n, k) row-major tensor")


def _xt_bk(bm: int, bn: int, bk: int, esize: int,
           stages: int = STAGES) -> int:
    """bk of an mma_sync / FMA plan for a transposed x: the x tile is
    stored (bk, bm) there, which can take more shared memory than the
    plan's (bm, bk); halve bk (not below 32) until the ring of ``stages``
    fits."""
    pad = ROW_PAD_BYTES // esize
    while bk > 32 and stages * (bk * (bm + pad) + bk * (bn + pad)) * esize \
            > SMEM_PER_BLOCK:
        bk //= 2
    return bk


def elk_matmul_kernel(x: torch.Tensor, y: torch.Tensor,
                      x2: Optional[torch.Tensor] = None,
                      y2: Optional[torch.Tensor] = None, *,
                      bm: Optional[int] = None, bn: Optional[int] = None,
                      bk: Optional[int] = None,
                      xt_plan: Optional[SmemPlan] = None) -> torch.Tensor:
    """(m, k) @ (k, n) [+ x2 @ y2] -> (m, n) on the card, fp32 sum, output
    in x's type.

    fp32 or bf16, all of one type, on one CUDA device; strides as
    ``layout`` says (a transposed x takes a row-major y).  ``x2``/``y2``:
    a second product of the same shapes and strides, x as stored and y
    transposed, summed after the first in the same accumulator (its K
    tiles after x's).  With no block
    shape given the route and its plan come from ``plan_for`` (over the K
    of both parts).  A block shape given, or any part of it, is one of
    the mma_sync kernel's and runs it (the rest from its plan): ``bm`` in
    ``TILE_M``, ``bn`` in ``TILE_N``, ``bk`` a multiple of 16.
    ``xt_plan``: a plan of route "wgmma_xt" for this x^T dy to launch in
    place of ``plan_for``'s (``chip_smoke.py`` times the tiles and splits
    the plan did not choose beside the one it did)."""
    if not x.is_cuda:
        raise ValueError(f"elk_matmul_kernel needs a CUDA tensor, got "
                         f"{x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"elk_matmul_kernel takes float32 or bfloat16, got "
                        f"{x.dtype}")
    if y.dtype != x.dtype:
        raise TypeError(f"y is {y.dtype}, x is {x.dtype}")
    dev = x.get_device()
    if y.get_device() != dev:
        raise ValueError(f"y on {y.device}, x on {x.device}")
    m, n, k, lda, ldy, y_trans = layout(x, y)
    x_trans = int(x_trans_of(x))
    if x_trans and y_trans:
        raise ValueError("a transposed x takes a (k, n) row-major y")
    parts = 1
    if (x2 is None) != (y2 is None):
        raise ValueError("x2 and y2 come both or not at all")
    if x2 is not None:
        for name, t, like in (("x2", x2, x), ("y2", y2, y)):
            if (t.shape != like.shape or t.stride() != like.stride()
                    or t.dtype != like.dtype or t.device != like.device):
                raise ValueError(f"{name} must have the shape, strides, "
                                 f"type and device of {name[0]}")
        if x_trans or not y_trans:
            raise ValueError("a second part takes x as stored and y "
                             "transposed (dg w_gate^T + du w_up^T)")
        parts = 2
    if m == 0 or n == 0 or k == 0:
        return torch.zeros((m, n), dtype=x.dtype, device=x.device)
    if max(m, n, parts * k, lda, ldy) >= 2 ** 31:
        raise ValueError("a dimension exceeds the kernel's 32-bit indices")
    forced = not (bm is None and bn is None and bk is None)
    legal = tma_legal(x, y, lda, ldy) and (
        x2 is None or tma_legal(x2, y2, lda, ldy))
    realign = x2 is None and realign_legal(x, y, lda, ldy, y_trans)
    plan = plan_for(m, n, parts * k, x.dtype, not forced and legal,
                    not forced and realign, forced, bool(x_trans))
    if xt_plan is not None:
        if plan.route != "wgmma_xt" or xt_plan.route != "wgmma_xt":
            raise ValueError(f"xt_plan takes route wgmma_xt, this product "
                             f"is on {plan.route}")
        plan = xt_plan
    route = plan.route
    if forced:
        bm, bn, bk = bm or plan.bm, bn or plan.bn, bk or plan.bk
        if bm not in TILE_M or bn not in TILE_N or bk < 16 or bk % 16:
            raise ValueError(f"block ({bm}, {bn}, {bk}) is not one the "
                             f"kernel compiles: bm in {TILE_M}, bn in "
                             f"{TILE_N}, bk a multiple of 16")
    else:
        bm, bn, bk = plan.bm, plan.bn, plan.bk
    if x_trans and route == "mma_sync":
        bk = _xt_bk(bm, bn, bk, x.element_size())
    elif x_trans and route.startswith("fma"):
        bk = _xt_bk(bm, bn, bk, x.element_size(), FMA_STAGES)

    out = x.new_empty((m, n))
    stream = torch._C._cuda_getCurrentRawStream(dev)
    ptr2 = (None, None) if x2 is None else (x2.data_ptr(), y2.data_ptr())
    head = (x.data_ptr(), y.data_ptr(), out.data_ptr(), *ptr2, m, n, k, lda,
            ldy, x_trans, y_trans)
    splits = plan.splits
    if route in _TMA_ROUTES:
        lib = _tma_lib()
        launch = lib.elk_matmul_tma_launch
        args = (*head, bm // 64, bn, plan.k_per_split,
                int(route.endswith("_realign")), stream)
    else:
        lib = _lib()
        _prepare(lib, x.device)
        if route == "mma_sync":
            launch = lib.elk_matmul_launch
            args = (*head, _DTYPES[x.dtype], bm, bn, bk, stream)
        else:
            # the kernel's K tiles over both parts, cut as the plan's splits
            k_tiles = parts * -(-k // bk)
            per = -(-k_tiles // splits)
            splits = -(-k_tiles // per)
            launch = lib.elk_matmul_fma_launch
            args = (*head, bm, bn, bk, per, splits, stream)
    # the runtime launches on the calling thread's device; enter x's only
    # when it is another
    if dev == torch.cuda.current_device():
        err = launch(*args)
    else:
        with torch.cuda.device(dev):
            err = launch(*args)
    elk_matmul_kernel.launches += 1
    elk_matmul_kernel.by_route[route] += 1
    elk_matmul_kernel.by_operand[OPERANDS[x_trans]] += 1
    if err != 0:
        raise RuntimeError(f"elk_matmul launch failed: CUDA error {err} "
                           f"({_lib().elk_matmul_error_name(err).decode()}; "
                           f"route {route}, m={m}, n={n}, k={k}, lda={lda}, "
                           f"ldy={ldy}, x_trans={x_trans}, y_trans={y_trans}, "
                           f"parts {parts}, {x.dtype}, block ({bm}, {bn}, "
                           f"{bk}), splits {splits})")
    return out


elk_matmul_kernel.launches = 0
elk_matmul_kernel.by_route = dict.fromkeys(ROUTES, 0)
elk_matmul_kernel.by_operand = dict.fromkeys(OPERANDS, 0)
