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
for the SM's shared memory and registers); ``PERF.md`` names
them and gives beside them the rates ``chip_smoke.py`` measured.  Fields
of ``h100_sxm`` that no datasheet gives are marked as such, and
``smem_plan`` reads none of them.  Units are bytes, bytes/s and FLOP/s,
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
SMS = 132                  # streaming multiprocessors of the SXM5 card
SMEM_PER_BLOCK = 232_448   # shared memory one block can opt in to (227 KB)
REGISTERS_PER_SM = 65_536  # 32-bit registers of one SM
THREADS_PER_SM = 2048      # resident threads of one SM

# Fields of h100_sxm that no datasheet gives.  They only complete the
# ChipConfig; smem_plan does not read them.
SMEM_BYTES_PER_S_PER_SM = 128 * 1.98e9   # 128 bytes a clock at the boost clock
DSMEM_BYTES_PER_S = 0.0    # cluster shared memory between SMs: not published


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
    shared memory of a thread-block cluster, an SM reading a neighbour's;
    no rate is published, 0 here) and the latencies (``ChipConfig``'s
    defaults)."""
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


def smem_plan(m: int, n: int, k: int, *, dtype_bytes: int = 2,
              chip: Optional[ChipConfig] = None) -> SmemPlan:
    """Choose (bm, bn, bk) for ``elk_matmul`` on one H100 (``h100_sxm``).

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
                    blocks_per_sm=resident)
