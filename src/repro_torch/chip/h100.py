"""One NVIDIA H100 read as an ICCA chip, at two levels (port only).

``h100_host()`` -- the card as a one-core pod for the ELK planner, in the
terms of the weight-streaming mode (``serve/stream.py``); counterpart of
``tpu_v5e_pod`` (``chip/config.py``):

* the one "core" is the whole card, and its local store ("SRAM" in the
  planner's vocabulary) is the card's HBM, where the execute state of the
  layer weights lives;
* the off-chip store ("HBM" in the planner's vocabulary) is pinned host
  memory behind PCIe, where the preload state lives: the planner prices
  bringing a layer's weights onto the card at the PCIe rate;
* there are no peers: one core, so no inter-core traffic.  The planner
  still routes every preload over the core's link (at one core its
  delivery rate is ``min(link_bw, off-chip rate)``), and the one link a
  preload crosses on this card is the PCIe link itself: ``link_bw``
  defaults to the PCIe rate.  From there up the knobs do not depend on it;
  below it the link, not PCIe, would pace the preloads
  (``tests/test_torch_planner.py`` checks both).

``h100_sxm()`` -- the card as an ICCA chip at the SM level; counterpart of
``tpu_v5e_vmem`` for the port's matmul kernel (``kernels/elk_matmul``):
the 132 SMs are the cores, the shared memory a block can use is the
per-core store, HBM3 the off-chip one.  ``smem_plan`` picks the kernel's
block shape on it, as ``core/integration.vmem_plan`` does for the Pallas
kernel on ``tpu_v5e_vmem``.

Every constant is a datasheet number of the H100 SXM5 80GB (NVIDIA H100
Tensor Core GPU datasheet, and NVIDIA's Hopper architecture white paper
for the SM's shared memory and registers), but for the fields of
``h100_sxm`` that no datasheet gives, which are marked as such:
``DSMEM_BYTES_PER_S`` is measured on the card by the probe of
``chip/dsmem.py`` (``python -m repro_torch.chip.dsmem``).  ``PERF.md``
names them and gives beside them the rates ``chip_smoke.py`` measured.
``smem_plan`` reads none of the unpublished ones; its x^T dy plan reads
three numbers of its own measured on the card (``XT_TILE_LOAD_BYTES_PER_S``,
``XT_MMA_SHARE``, ``XT_RESIDENT``).  Units are bytes, bytes/s and FLOP/s,
decimal as the datasheet gives them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

from repro_torch.chip.config import ChipConfig

HBM_BYTES = 80e9           # HBM3, 80 GB
HBM_BYTES_PER_S = 3.35e12  # HBM3, 3.35 TB/s
BF16_FLOPS = 989e12        # dense bf16 on the tensor cores (no sparsity)
FP32_FLOPS = 67e12         # fp32 outside the tensor cores
PCIE_BYTES_PER_S = 64e9    # PCIe Gen5 x16: 128 GB/s both ways, 64 GB/s host to card
NVLINK_BYTES_PER_S = 450e9 # NVLink 4: 900 GB/s both ways, 450 GB/s each way
SMS = 132                  # streaming multiprocessors of the SXM5 card
SMEM_PER_BLOCK = 232_448   # shared memory one block can opt in to (227 KB)
REGISTERS_PER_SM = 65_536  # 32-bit registers of one SM
THREADS_PER_SM = 2048      # resident threads of one SM

# Fields of h100_sxm that no datasheet gives.  smem_plan does not read them;
# the planner's cost model (core/cost_model.py) divides by link_bw.
SMEM_BYTES_PER_S_PER_SM = 128 * 1.98e9   # 128 bytes a clock at the boost clock
# cluster shared memory between SMs, one SM reading its peer's, one
# direction: measured by chip/dsmem.py, 61706352430 B/s an SM with all 132
# SMs reading at once (66 clusters of 2), on an NVIDIA H100 80GB HBM3, power
# limit 700.00 W: about 31 bytes a clock, a quarter of the SM's own rate
DSMEM_BYTES_PER_S = 61.7e9


def h100_host(link_bw: float = PCIE_BYTES_PER_S) -> ChipConfig:
    """One H100 with its weights' home in pinned host memory, as a one-core
    pod: HBM is the on-chip store, host memory over PCIe the off-chip one.
    ``link_bw`` is the one core's link, which preloads cross: PCIe."""
    return ChipConfig(
        name="h100-host",
        num_cores=1,
        sram_per_core=int(HBM_BYTES),
        core_flops=BF16_FLOPS,
        core_flops_vector=FP32_FLOPS,
        sram_bw_per_core=HBM_BYTES_PER_S,
        link_bw=link_bw,
        topology="all2all",
        hbm_bw=PCIE_BYTES_PER_S,
        hbm_controllers=1,          # one PCIe link
        sram_port_blocking=False,   # HBM is not blocked by host copies
        reserved_per_core=0,
    )


def h100_sxm() -> ChipConfig:
    """One H100 read as an ICCA chip at the SM level: 132 SMs as cores,
    232,448 bytes of shared memory a block as ``sram_per_core``, HBM3 at
    3.35 TB/s as the off-chip store, the tensor cores' dense bf16 rate
    shared out over the SMs as ``core_flops``.

    Not datasheet numbers: ``sram_bw_per_core`` (128 bytes a clock at the
    1.98 GHz boost clock, an estimate), ``link_bw`` (the distributed
    shared memory of a thread-block cluster, an SM reading a neighbour's:
    no rate is published, so it is ``DSMEM_BYTES_PER_S``, measured on the
    card by ``chip/dsmem.py``) and the latencies (``ChipConfig``'s
    defaults).  The topology stays "all2all" over the 132 SMs, though an
    SM reaches another's shared memory only inside its cluster (at most 16
    SMs)."""
    return ChipConfig(
        name="h100-sxm",
        num_cores=SMS,
        sram_per_core=SMEM_PER_BLOCK,
        core_flops=BF16_FLOPS / SMS,
        core_flops_vector=FP32_FLOPS / SMS,
        sram_bw_per_core=SMEM_BYTES_PER_S_PER_SM,
        link_bw=DSMEM_BYTES_PER_S,
        topology="all2all",
        hbm_bw=HBM_BYTES_PER_S,
        hbm_controllers=1,
        sram_port_blocking=False,   # loads into shared memory do not stall the MMAs
        reserved_per_core=0,
    )


# ---------------------------------------------------------------------------
# Shared-memory block planning for the elk_matmul kernel
# ---------------------------------------------------------------------------

MMA_M, MMA_N, MMA_K = 16, 8, 16     # mma.sync m16n8k16
# the block shapes csrc/elk_matmul.cu compiles (bm x bn), and the K depths
# it takes (bk is an argument of the kernel, a multiple of MMA_K)
TILE_M = (16, 32, 64, 128)
TILE_N = (32, 64, 128)
TILE_K = (32, 64, 128, 256)
STAGES = 3                  # the cp.async ring (kStages in the kernel): one
#                             tile in use, two in flight
ROW_PAD_BYTES = 16          # the kernel pads every shared-memory row by this
# (tests/test_torch_elk_matmul.py reads these and block_threads from the
# kernel's source)
# the fp32 accumulators of one block may take a quarter of an SM's registers
ACC_BYTES_MAX = REGISTERS_PER_SM * 4 // 4

# The TMA + wgmma mainloop (csrc/hopper_gemm.cuh), routes "wgmma" (m >= 64)
# and "splitk" (m < 64) of bf16 products whose operands meet TMA's rules.
# A block has one or two consumer warpgroups of 64 rows (bm 64 or 128);
# WG_BK, WG_SMEM_RESERVE, WG_MAX_STAGES and wg_stages are kBK,
# kSmemReserve, kMaxStages and stages_for of the header.
WGMMA_M = 64                # rows of a wgmma, and of a consumer warpgroup
WG_TILE_M = (64, 128)       # one or two consumer warpgroups
WG_TILE_N = (64, 128, 256)  # the wgmma widths the kernels compile
WG_BK = 64                  # K depth of a stage: a 128-byte swizzled row
WG_SMEM_RESERVE = 2048      # alignment slack and the mbarriers
WG_MAX_STAGES = 8
WGMMA_MIN_M = 64            # fewer rows split K instead (route "splitk")
# fp32 accumulator registers a consumer thread holds: of the 232 that
# setmaxnreg gives it with two warpgroups; 64 with one, two blocks an SM
WGMMA_ACC_REGS = {128: 128, 64: 64}
SMEM_BLOCK_RESERVE = 1024   # shared memory the system keeps for each block
# splits of K at most: one cluster a tile, of the size every card takes
# (kMaxSplits of the header)
MAX_SPLITS = 8
# route "wgmma_xt": the x^T dy of a weight gradient (x read as the transpose
# of a stored (K, m) matrix) on the persistent instance (GemmCfg::PERSIST,
# ELK_XT_TILES of csrc/elk_matmul.cu): its (bm, bn) tiles, and the bytes a
# row of its epilogue tile is padded by (kEpiPad of the header)
XT_TILES = ((64, 128), (128, 128), (128, 256))
XT_EPI_PAD = 16
# row tiles a group of the block order spans (kGroupM of the header): the
# order every TMA route visits its output tiles in
GROUP_M = 8
# _xt_plan takes the fewest splits, then the largest tile, among the plans
# its model puts within this share of the fastest
XT_TIE = 0.01
# Measured, not datasheet numbers, which _xt_plan reads; chip_smoke.py's
# [train] phase prints what each is read from on every run (NVIDIA H100
# 80GB HBM3 at 700 W):
# the rate at which the SMs together load operand tiles into shared memory
# on the x^T dy kernel: qwen3-14b's LM head row, 74.74 GB of 128 x 256
# tiles' loads in 8.4476 ms, about 2.6 times the HBM rate: the loads come
# from L2
XT_TILE_LOAD_BYTES_PER_S = 8.85e12
# the share of the tensor cores' dense peak the instance's products reach
# where the loads keep up: the k/v row's 128 x 256 tiles without a split
# (other_plans_ms "128x256/1"), 2 waves of 64 steps of 128 x 256 x 64 in
# 0.09628 ms: 0.752 us a step against 0.560 at the peak
XT_MMA_SHARE = 0.74
# blocks of a persistent x^T dy instance resident at once in clusters of
# 1-8 blocks, by blocks an SM (cudaOccupancyMaxActiveClusters; the
# "[train] elk_matmul_xt blocks resident" line): the GPCs hold fewer
# clusters of 3-8 than the 132 SMs would
XT_RESIDENT = {1: (132, 132, 117, 120, 110, 102, 105, 120),
               2: (264, 264, 237, 248, 235, 234, 224, 240)}
# routes "wgmma_realign" / "splitk_realign": y loaded and realigned by the
# producer warpgroup (GemmCfg::B_LDG), one consumer warpgroup, these widths
# (ELK_REALIGN_TILES of csrc/elk_matmul.cu)
REALIGN_TILE_N = (64, 128)

# fp32, routes "fma" / "fma_splitk" (csrc/elk_matmul_sync.cu: ELK_FMA_TILES,
# kF32Stages, F32Shape): the (bm, bn) tiles, the ring's stages, the threads
# of a block
FMA_TILES = ((16, 32), (16, 64), (32, 64), (64, 64), (64, 128), (128, 128))
FMA_STAGES = 4


def fma_threads(bm: int, bn: int) -> int:
    """Threads of a block of the "fma" kernel: 256 from 128 x 128, else
    128."""
    return 256 if bm * bn >= 128 * 128 else 128


@dataclasses.dataclass(frozen=True)
class SmemPlan:
    """Shaped like ``core/integration.VmemPlan``, plus what the kernel's
    launch needs."""
    bm: int
    bn: int
    bk: int
    smem_bytes: int       # operand stages claimed in shared memory
    hbm_traffic: int      # bytes moved for the whole matmul
    tiles: int            # output tiles = blocks launched
    acc_bytes: int        # the fp32 accumulator, held in registers
    blocks_per_sm: int    # blocks bk was sized to keep resident together
    route: str = "mma_sync"   # "mma_sync", "wgmma", "splitk", their
    #                           "_realign" twins, "fma" or "fma_splitk"
    stages: int = STAGES      # the ring's depth
    splits: int = 1           # splits of K (route "splitk"), each its blocks;
    #                           "wgmma_xt": the clusters of its last wave
    k_per_split: int = 0      # K tiles of one split
    grid: int = 0             # "wgmma_xt": blocks launched (xt_schedule)
    tail: int = 0             # "wgmma_xt": tiles split over a cluster

    @property
    def blocks(self) -> int:
        """Blocks launched: output tiles x splits of K, or the persistent
        grid of "wgmma_xt"."""
        return self.grid or self.tiles * self.splits


def smem_bytes(bm: int, bn: int, bk: int, *, dtype_bytes: int) -> int:
    """Shared memory of the kernel's operand ring: ``STAGES`` x the (bm, bk)
    and (bk, bn) tiles, each row padded by ``ROW_PAD_BYTES`` (y's rows are
    k or n by its layout; the larger is counted)."""
    stage = ((bm * bk + bk * bn) * dtype_bytes
             + (bm + max(bk, bn)) * ROW_PAD_BYTES)
    return STAGES * stage


def block_threads(bm: int) -> int:
    """Threads of one block of the kernel (``kThreads``): 8 warps at 128
    rows, else 4."""
    return 256 if bm >= 128 else 128


def _round_up(v: int, a: int) -> int:
    return -(-v // a) * a


def _step(sizes: tuple, v: int, by: int) -> Optional[int]:
    i = sizes.index(v) + by
    return sizes[i] if 0 <= i < len(sizes) else None


def wg_stages(bm: int, bn: int, nb: int = 1, *,
              budget: int = SMEM_PER_BLOCK) -> tuple[int, int]:
    """(stages, blocks an SM) of the TMA ring for a (bm, bn) tile with
    ``nb`` b operands: ``stages_for`` of ``csrc/hopper_gemm.cuh`` on this
    budget.  One consumer warpgroup (bm 64) runs two blocks an SM, each on
    half the shared memory less the system's share; two run one.  Where two
    blocks leave fewer than two stages, one block takes it all (a budget
    below the card's; at the card's the header's numbers hold)."""
    stage = (bm + nb * bn) * WG_BK * 2
    if bm == WGMMA_M:
        s = (budget // 2 - SMEM_BLOCK_RESERVE - WG_SMEM_RESERVE) // stage
        if s >= 2:
            return min(s, WG_MAX_STAGES), 2
    s = (budget - WG_SMEM_RESERVE) // stage
    return min(s, WG_MAX_STAGES), 1


def wg_smem_bytes(bm: int, bn: int, stages: int, nb: int = 1) -> int:
    """Shared memory of a TMA block: the ring and the reserve."""
    return stages * (bm + nb * bn) * WG_BK * 2 + WG_SMEM_RESERVE


def wg_acc_fits(bm: int, bn: int, nb: int = 1) -> bool:
    """The accumulators of a consumer thread (bn / 2 fp32 a b operand) fit
    the registers it has (``WGMMA_ACC_REGS``)."""
    return nb * bn // 2 <= WGMMA_ACC_REGS[bm]


def _split(k_tiles: int, tiles: int, sms: int) -> tuple[int, int]:
    """(splits, K tiles a split): the fewest splits of ``k_tiles``, at most
    ``MAX_SPLITS``, that give every SM a block, each split the same whole
    number of K tiles but the last; the most the cap allows when none does.
    The splits cover K exactly: (splits - 1) * per < k_tiles <= splits *
    per."""
    best = (1, k_tiles)
    for s in range(1, min(k_tiles, MAX_SPLITS) + 1):
        per = -(-k_tiles // s)
        used = -(-k_tiles // per)
        if tiles * used >= sms:
            return used, per
        best = max(best, (used, per))
    return best


def _tma_plan(m: int, n: int, k: int, chip: ChipConfig,
              realign: bool = False) -> Optional[SmemPlan]:
    """The plan of a bf16 product on the TMA + wgmma mainloop, or None when
    no tile of it fits ``chip``'s shared memory.  The same three steps as
    the mma_sync plan: cost = HBM traffic, then cover the SMs, then the
    preload depth (stages) from what shared memory is left.  ``realign``:
    y loaded by the producer warpgroup (routes "wgmma_realign" and
    "splitk_realign"), one consumer warpgroup and the widths of
    ``REALIGN_TILE_N``."""
    budget, sms = chip.sram_per_core, chip.num_cores
    k_tiles = -(-k // WG_BK)
    suffix = "_realign" if realign else ""

    def fits(bm, bn):
        if realign and (bm != WGMMA_M or bn not in REALIGN_TILE_N):
            return False
        return wg_acc_fits(bm, bn) and wg_stages(bm, bn, budget=budget)[0] >= 2

    def plan(bm, bn, route, splits=1, per=k_tiles, traffic=0):
        stages, per_sm = wg_stages(bm, bn, budget=budget)
        return SmemPlan(bm=bm, bn=bn, bk=WG_BK,
                        smem_bytes=wg_smem_bytes(bm, bn, stages),
                        hbm_traffic=traffic, tiles=tiles(bm, bn),
                        acc_bytes=bm * bn * 4, blocks_per_sm=per_sm,
                        route=route + suffix, stages=stages, splits=splits,
                        k_per_split=per)

    def traffic(bm, bn):
        # a split's sums meet in the cluster's shared memory: no bytes here
        return (m * k * math.ceil(n / bn) + k * n * math.ceil(m / bm)
                + m * n) * 2

    def tiles(bm, bn):
        return math.ceil(m / bm) * math.ceil(n / bn)

    if m < WGMMA_MIN_M:
        # "splitk": one row tile of 64; of the widths that fit, split K so
        # that every SM has a block (as far as MAX_SPLITS allows), and of
        # those that leave the fewest SMs idle take the least traffic (x
        # is read again for every column tile)
        cands = []
        for bn in WG_TILE_N:
            if not fits(WGMMA_M, bn):
                continue
            splits, per = _split(k_tiles, tiles(WGMMA_M, bn), sms)
            idle = max(0, sms - tiles(WGMMA_M, bn) * splits)
            cands.append((idle, traffic(WGMMA_M, bn), -bn, splits, per))
        if not cands:
            return None
        _, cost, neg_bn, splits, per = min(cands)
        return plan(WGMMA_M, -neg_bn, "splitk", splits, per, cost)
    # "wgmma": the greedy over the tiles that fit, from the smallest
    bm, bn = WG_TILE_M[0], WG_TILE_N[0]
    if not fits(bm, bn):
        return None

    def footprint(a, b):
        return wg_smem_bytes(a, b, 2)

    while True:
        cands = []
        for nb in ((_step(WG_TILE_M, bm, 1), bn),
                   (bm, _step(WG_TILE_N, bn, 1))):
            if None in nb or not fits(*nb):
                continue
            if nb[0] > _round_up(m, WGMMA_M) or nb[1] > _round_up(n, 64):
                continue
            saved = traffic(bm, bn) - traffic(*nb)
            spent = footprint(*nb) - footprint(bm, bn)
            cands.append((saved / max(spent, 1), nb))
        if not cands:
            break
        gain, nb = max(cands, key=lambda c: c[0])
        if gain <= 0:
            break
        bm, bn = nb
    smaller = [(a, b) for a in WG_TILE_M if a <= bm for b in WG_TILE_N
               if b <= bn and fits(a, b)]
    covering = [t for t in smaller if tiles(*t) >= sms]
    if covering:
        bm, bn = min(covering, key=lambda t: (traffic(*t), -t[0]))
        return plan(bm, bn, "wgmma", traffic=traffic(bm, bn))
    # even the smallest tile leaves SMs idle (k/v of a chunk of 256: 64
    # tiles): split K over them as "splitk" does
    bm, bn = smaller[0]
    splits, per = _split(k_tiles, tiles(bm, bn), sms)
    return plan(bm, bn, "wgmma", splits, per, traffic(bm, bn))


def xt_stages(bm: int, bn: int, *, budget: int = SMEM_PER_BLOCK
              ) -> tuple[int, int]:
    """(stages, blocks an SM) of the persistent x^T dy instance:
    ``xt_stages_for`` of ``csrc/hopper_gemm.cuh``, ``wg_stages``'s budget
    less the epilogue tile (bm rows of bn bf16, each padded by
    ``XT_EPI_PAD``); two blocks an SM at one consumer warpgroup."""
    stage = (bm + bn) * WG_BK * 2
    epi = bm * (bn * 2 + XT_EPI_PAD)
    if bm == WGMMA_M:
        s = (budget // 2 - SMEM_BLOCK_RESERVE - epi - WG_SMEM_RESERVE) // stage
        return min(s, WG_MAX_STAGES), 2
    return min((budget - epi - WG_SMEM_RESERVE) // stage, WG_MAX_STAGES), 1


@dataclasses.dataclass(frozen=True)
class XtSchedule:
    """How the persistent x^T dy kernel deals out its tiles (``XtSched``
    of ``csrc/hopper_gemm.cuh``): ``grid`` blocks; block b takes the tiles
    b, b + grid, ... below ``full`` over all of K; then, with ``tail`` > 0,
    the blocks run as clusters of ``splits`` and cluster c < tail takes
    tile full + c, its rank r the K tiles [r per, (r + 1) per)."""
    grid: int
    full: int
    tail: int
    splits: int
    per: int


def xt_schedule(tiles: int, k_tiles: int, cap: int, s: int
                ) -> Optional[XtSchedule]:
    """The kernel's rule (``xt_schedule`` of the header), for ``cap``
    blocks resident at once (a multiple of ``s``): ``s`` = 1 deals the
    tiles out over min(tiles, cap) blocks; ``s`` > 1 keeps whole waves of
    ``cap`` tiles and splits the short last wave's tiles by K over
    clusters of ``s``, or is None where that does not fit (no short wave,
    more of its tiles than clusters, a rank with no K tile)."""
    if s == 1:
        return XtSchedule(min(tiles, cap), tiles, 0, 1, k_tiles)
    per = -(-k_tiles // s)
    if -(-k_tiles // per) != s or cap < s:
        return None
    waves, tail = divmod(tiles, cap)
    if tail == 0 or tail > cap // s:
        return None
    return XtSchedule(cap if waves else tail * s, waves * cap, tail, s, per)


def xt_schedule_of(plan: SmemPlan) -> XtSchedule:
    """The schedule of a "wgmma_xt" plan: its whole tiles are those before
    the split ones."""
    return XtSchedule(plan.grid, plan.tiles - plan.tail, plan.tail,
                      plan.splits, plan.k_per_split)


def tile_origin(tile: int, m_tiles: int, n_tiles: int,
                group_m: int = GROUP_M) -> tuple[int, int]:
    """(row tile, column tile) of output tile ``tile`` in the order of
    groups of ``group_m`` row tiles (``tile_origin`` of the header)."""
    per_group = group_m * n_tiles
    first = tile // per_group * group_m
    gm = min(group_m, m_tiles - first)
    rest = tile % per_group
    return first + rest % gm, rest // gm


def xt_units(sched: XtSchedule, k_tiles: int
             ) -> list[list[tuple[int, int, int]]]:
    """The (tile, first K tile, K tiles) units of each block of ``sched``,
    in the order the kernel's block takes them."""
    out = []
    for b in range(sched.grid):
        units = [(t, 0, k_tiles) for t in range(b, sched.full, sched.grid)]
        if sched.tail and b // sched.splits < sched.tail:
            k0 = b % sched.splits * sched.per
            units.append((sched.full + b // sched.splits, k0,
                          min(sched.per, k_tiles - k0)))
        out.append(units)
    return out


def xt_resident(chip: ChipConfig, per_sm: int, s: int) -> int:
    """Blocks of a persistent x^T dy instance that ``per_sm`` of fit on an
    SM which the card holds at once in clusters of ``s`` (1: none): the
    H100's measured ``XT_RESIDENT`` (its GPCs, not its SM count, bound the
    clusters), or the SMs times ``per_sm`` cut to a multiple of ``s`` on
    any other chip."""
    if chip.num_cores == SMS and per_sm in XT_RESIDENT:
        return XT_RESIDENT[per_sm][s - 1]
    return chip.num_cores * per_sm // s * s


def _xt_plan(m: int, n: int, k: int, chip: ChipConfig
             ) -> Optional[SmemPlan]:
    """The plan of a bf16 x^T dy (route "wgmma_xt"), or None when no tile
    of ``XT_TILES`` fits ``chip``'s shared memory.  Where ``_tma_plan``
    takes any tile that gives every SM a block, this scores each (bm, bn,
    clusters of the last wave) by a model of its time: the larger of (a)
    the operand tiles every block loads (every tile's K tiles, (bm + bn)
    rows of 128 bytes each) at ``XT_TILE_LOAD_BYTES_PER_S``, the rate the
    SMs together load tiles at, and (b) when the last block finishes its
    products at its share of the SM's tensor-core rate (``core_flops``) and
    its stores at its share of the memory rate (``hbm_bw``), the products
    at ``XT_MMA_SHARE`` of the peak: its whole
    tiles, and in a split wave its piece of K and its fp32 tile's sum
    (counted as two stores).  Clusters fit as ``xt_resident`` says.  Of the
    plans within ``XT_TIE`` of the fastest: fewer splits, the larger tile,
    fewer bytes.  chip_smoke.py times every other plan beside the one this
    picks (``other_plans_ms``)."""
    budget, sms = chip.sram_per_core, chip.num_cores
    k_tiles = -(-k // WG_BK)
    cands = []
    for bm, bn in XT_TILES:
        stages, per_sm = xt_stages(bm, bn, budget=budget)
        if stages < 2 or not wg_acc_fits(bm, bn) \
                or bm * bn * 4 > stages * (bm + bn) * WG_BK * 2:
            continue
        tiles = math.ceil(m / bm) * math.ceil(n / bn)
        step = 2 * bm * bn * WG_BK * per_sm / (chip.core_flops
                                                 * XT_MMA_SHARE)
        store = bm * bn * 2 * per_sm * sms / chip.hbm_bw
        load = tiles * k_tiles * (bm + bn) * WG_BK * 2 \
            / XT_TILE_LOAD_BYTES_PER_S
        traffic = (m * k * math.ceil(n / bn) + k * n * math.ceil(m / bm)
                   + m * n) * 2
        for s in range(1, MAX_SPLITS + 1):
            sched = xt_schedule(tiles, k_tiles, xt_resident(chip, per_sm, s),
                                s)
            if sched is None:
                continue
            t = -(-sched.full // sched.grid) * (k_tiles * step + store)
            if sched.tail:
                t += sched.per * step + 2 * store
            cands.append((max(t, load), bm, bn, stages, per_sm, tiles, sched,
                          traffic))
    if not cands:
        return None
    fastest = min(c[0] for c in cands)
    _, bm, bn, stages, per_sm, tiles, sched, traffic = min(
        (c for c in cands if c[0] <= fastest * (1 + XT_TIE)),
        key=lambda c: (c[6].splits, -c[1] * c[2], c[7], c[0]))
    return SmemPlan(bm=bm, bn=bn, bk=WG_BK,
                    smem_bytes=stages * (bm + bn) * WG_BK * 2
                    + bm * (bn * 2 + XT_EPI_PAD) + WG_SMEM_RESERVE,
                    hbm_traffic=traffic, tiles=tiles, acc_bytes=bm * bn * 4,
                    blocks_per_sm=per_sm, route="wgmma_xt", stages=stages,
                    splits=sched.splits, k_per_split=sched.per,
                    grid=sched.grid, tail=sched.tail)


def _fma_plan(m: int, n: int, k: int, chip: ChipConfig
              ) -> Optional[SmemPlan]:
    """The plan of an fp32 product on the "fma" kernel, or None when no tile
    of it fits ``chip``'s shared memory.  Cost = HBM traffic over the
    compiled tiles (``FMA_TILES``) no larger than m and n rounded up to 16
    and 32: of those that give every SM a block, the one that moves the
    fewest bytes ("fma"); when none does, the smallest, and K split over
    up to MAX_SPLITS blocks of a cluster so that the SMs have blocks
    ("fma_splitk"; rank-order sums in the cluster's shared memory).  Then
    the depth bk: the deepest of ``TILE_K`` (not past K) whose ring of
    ``FMA_STAGES`` fits the budget shared by the blocks an SM runs at once
    (the splits counted at the finest depth first).  From the shapes and
    the card alone.  The smallest tile's fp32 sums, one set a K slice (8
    KB), always fit the ring they are left in."""
    budget, sms = chip.sram_per_core, chip.num_cores

    def ring(bm, bn, bk):
        return FMA_STAGES * ((bm * bk + bk * bn) * 4
                             + (bm + max(bk, bn)) * ROW_PAD_BYTES)

    def traffic(bm, bn):
        return (m * k * math.ceil(n / bn) + k * n * math.ceil(m / bm)
                + m * n) * 4

    def tiles(bm, bn):
        return math.ceil(m / bm) * math.ceil(n / bn)

    fit = [t for t in FMA_TILES if ring(*t, TILE_K[0]) <= budget]
    if not fit:
        return None
    cands = [t for t in fit if t[0] <= _round_up(m, 16)
             and t[1] <= _round_up(n, 32)] or fit[:1]
    covering = [t for t in cands if tiles(*t) >= sms]
    if covering:
        bm, bn = min(covering, key=lambda t: (traffic(*t), -t[0]))
        splits = 1
    else:       # the smallest tile: the most blocks
        bm, bn = max(cands, key=lambda t: (tiles(*t), -t[0] * t[1]))
        splits = _split(-(-k // TILE_K[0]), tiles(bm, bn), sms)[0]
    threads = fma_threads(bm, bn)
    resident = max(1, min(math.ceil(tiles(bm, bn) * splits / sms),
                          THREADS_PER_SM // threads))
    k_cap = _round_up(k, MMA_K)
    bk = TILE_K[0]
    while True:
        nk = _step(TILE_K, bk, 1)
        if nk is None or nk > k_cap or ring(bm, bn, nk) > budget // resident:
            break
        bk = nk
    k_tiles = -(-k // bk)
    per = -(-k_tiles // splits)
    splits = -(-k_tiles // per)     # none empty
    return SmemPlan(bm=bm, bn=bn, bk=bk, smem_bytes=ring(bm, bn, bk),
                    hbm_traffic=traffic(bm, bn), tiles=tiles(bm, bn),
                    acc_bytes=bm * bn * 4, blocks_per_sm=resident,
                    route="fma_splitk" if splits > 1 else "fma",
                    stages=FMA_STAGES, splits=splits, k_per_split=per)


def smem_plan(m: int, n: int, k: int, *, dtype_bytes: int = 2,
              chip: Optional[ChipConfig] = None, tma: bool = True,
              realign: bool = False, mma_sync: bool = False,
              x_trans: bool = False) -> SmemPlan:
    """Choose the route and the block plan of ``elk_matmul`` on one H100
    (``h100_sxm``).

    A bf16 product whose operands meet TMA's rules (``tma``: 16-byte
    aligned bases, row strides of whole 16 bytes) runs on the TMA + wgmma
    mainloop (``_tma_plan``): route "wgmma" from ``WGMMA_MIN_M`` rows on,
    tiles (bm, bn) of ``WG_TILE_M`` x ``WG_TILE_N`` and the ring's stages
    (K split too when even the smallest tile leaves SMs idle); route
    "splitk" below, one 64-row tile, a width of ``WG_TILE_N`` and
    the split of K that gives every SM a block (``splits`` <= MAX_SPLITS,
    ``k_per_split``; the splits of a tile run as one cluster and are summed
    in rank order).  A bf16 product whose x TMA takes and whose (K, N)
    row-major y it refuses (``realign``: hymba's untied head, rows of 32001
    elements) takes the same plan on one consumer warpgroup as
    "wgmma_realign" / "splitk_realign".  A bf16 x^T dy whose operands TMA
    takes (``x_trans``: x read as the transpose of a stored (k, m) matrix)
    takes ``_xt_plan`` (route "wgmma_xt", the persistent instance; a plan
    of its own, the forward's unchanged).  fp32 takes ``_fma_plan`` (routes
    "fma" and "fma_splitk").  Anything else (another stride TMA does not
    take, a budget no tile of those fits, or ``mma_sync``: the plan behind
    a forced block shape) takes the route "mma_sync", (bm, bn, bk) as
    follows.

    The shared-memory twin of ``vmem_plan``, with Hopper's model: shared
    memory holds a ring of ``STAGES`` operand tiles (the execution space
    and the preload space of the ELK split), ``smem_bytes``; the fp32
    accumulator ``bm*bn*4`` lives in registers and is bounded by
    ``ACC_BYTES_MAX``, not by shared memory; tiles are the kernel's
    compiled sizes, multiples of the MMA tile.  Cost = HBM traffic: x is
    read ``ceil(n/bn)`` times, y ``ceil(m/bm)`` times, the output written
    once.  Three steps:

    1. the greedy of ``vmem_plan``, from the smallest tile (bm 16: m = 8
       is padded to 16 rows, not 128) and with the starting tile itself
       checked against the budget: grow bm or bn, whichever saves the most
       HBM bytes per byte of shared memory spent, while the tile fits the
       budget and the register bound and does not pass m, n rounded up to
       the MMA tile;
    2. cover the SMs: when the output tiles are fewer than the SMs (at
       m = 8, bn = 128 gives 40 blocks for a 5120-wide product), take the
       tile no larger than the greedy's in either dimension that gives a
       block to every SM and moves the fewest bytes (at m = 8: bn = 32,
       160 blocks), or the smallest tile when none does.  A larger budget
       gives a greedy tile at least as large in both dimensions, so it
       never moves more bytes;
    3. the preload depth: with ``b`` blocks needed a SM to run every tile
       at once (at most what the registers allow), grow bk while the ring
       fits ``budget / b``.  bk moves no HBM byte; a deeper tile keeps
       more bytes in flight and takes fewer barriers.

    Reads ``num_cores`` and ``sram_per_core`` (the budget) of ``chip``
    and nothing else."""
    if min(m, n, k) < 1:
        raise ValueError(f"empty product: m={m}, n={n}, k={k}")
    chip = chip or h100_sxm()
    plan = None
    if not mma_sync and dtype_bytes == 2 and tma and x_trans:
        plan = _xt_plan(m, n, k, chip)
    elif not mma_sync and dtype_bytes == 2 and (tma or realign):
        plan = _tma_plan(m, n, k, chip, realign=not tma)
    elif not mma_sync and dtype_bytes == 4:
        plan = _fma_plan(m, n, k, chip)
    if plan is not None:
        return plan
    budget = chip.sram_per_core
    sms = chip.num_cores

    def footprint(bm, bn, bk):
        return smem_bytes(bm, bn, bk, dtype_bytes=dtype_bytes)

    def traffic(bm, bn):
        return (m * k * math.ceil(n / bn) + k * n * math.ceil(m / bm)
                + m * n) * dtype_bytes

    def tiles(bm, bn):
        return math.ceil(m / bm) * math.ceil(n / bn)

    m_cap, n_cap = _round_up(m, MMA_M), _round_up(n, MMA_N)
    k_cap = _round_up(k, MMA_K)
    bm, bn, bk = TILE_M[0], TILE_N[0], TILE_K[0]
    if footprint(bm, bn, bk) > budget:
        raise ValueError(f"the smallest tile ({bm}, {bn}, {bk}) needs "
                         f"{footprint(bm, bn, bk)} bytes of shared memory, "
                         f"over the budget of {budget}")
    # 1. the greedy (vmem_plan's delta rule): bytes saved per byte spent
    while True:
        cands = []
        for nb in ((_step(TILE_M, bm, 1), bn), (bm, _step(TILE_N, bn, 1))):
            if None in nb or nb[0] > m_cap or nb[1] > n_cap:
                continue
            if (footprint(*nb, bk) > budget
                    or nb[0] * nb[1] * 4 > ACC_BYTES_MAX):
                continue
            saved = traffic(bm, bn) - traffic(*nb)
            spent = footprint(*nb, bk) - footprint(bm, bn, bk)
            cands.append((saved / max(spent, 1), nb))
        if not cands:
            break
        gain, nb = max(cands, key=lambda c: c[0])
        if gain <= 0:
            break
        bm, bn = nb
    # 2. cover the SMs: of the tiles no larger than the greedy's, the one
    # that moves the fewest bytes with a block for every SM, else the
    # smallest (the most blocks)
    smaller = [(a, b) for a in TILE_M if a <= bm for b in TILE_N if b <= bn]
    covering = [t for t in smaller if tiles(*t) >= sms]
    bm, bn = (min(covering, key=lambda t: (traffic(*t), -t[0]))
              if covering else smaller[0])
    # 3. the preload depth
    threads = block_threads(bm)
    regs = bm * bn // threads + 64          # accumulators + the rest
    resident = max(1, min(math.ceil(tiles(bm, bn) / sms),
                          REGISTERS_PER_SM // (threads * regs),
                          THREADS_PER_SM // threads))
    while True:
        nk = _step(TILE_K, bk, 1)
        if (nk is None or nk > k_cap
                or footprint(bm, bn, nk) > budget // resident):
            break
        bk = nk
    return SmemPlan(bm=bm, bn=bn, bk=bk, smem_bytes=footprint(bm, bn, bk),
                    hbm_traffic=traffic(bm, bn), tiles=tiles(bm, bn),
                    acc_bytes=bm * bn * 4,
                    blocks_per_sm=resident, k_per_split=-(-k // bk))
