"""The port's copy of the ELK planner against the reference's, on the CPU,
and the port's own SM-level plan for its matmul kernel.

``repro_torch.core`` and ``repro_torch.chip.{config,topology}`` are copies of
the reference's modules with their imports renamed; the port imports nothing
of ``repro``.  These tests run both copies on the same inputs and require
equal results, so that the copies cannot drift unnoticed: block shapes
(``vmem_plan``), whole-model plan totals (the full-config references of the
verify skill), pod-level knobs, and the serving knobs of
``elk_serve_config`` on the default pod, on an SRAM-only pod with stacked
DRAM, and on one H100 read as a pod (``chip.h100.h100_host``), and the
event simulator (``chip/simulator.py``).  Smoke configs keep the compiles
short; repeated compiles hit the plan caches.  ``smem_plan`` on
``h100_sxm`` has no reference twin; its budget, alignment and pinned
serving plans are checked here as ``vmem_plan``'s are in
``tests/test_kernels.py`` and ``tests/test_properties.py``.
"""

import dataclasses

import pytest

from repro.chip import config as rchip
from repro.configs import get_config as ref_config
from repro.configs import get_smoke_config as ref_smoke
from repro.core import integration as rint
from repro.core.elk import compile_model as ref_compile
from repro.serve import engine as reng
from repro_torch.chip import config as tchip
from repro.chip import simulator as rsim
from repro_torch.chip import simulator as tsim
from repro_torch.chip.h100 import (ACC_BYTES_MAX, BF16_FLOPS, FMA_STAGES,
                                   FMA_TILES, FP32_FLOPS,
                                   HBM_BYTES, HBM_BYTES_PER_S, MAX_SPLITS,
                                   MMA_K, MMA_M, MMA_N, PCIE_BYTES_PER_S,
                                   SMEM_PER_BLOCK, SMS, TILE_K, TILE_M,
                                   TILE_N, WG_BK, WG_TILE_M, WG_TILE_N,
                                   WGMMA_ACC_REGS, WGMMA_M, WGMMA_MIN_M,
                                   h100_host, h100_sxm, smem_plan,
                                   wg_smem_bytes, wg_stages)
from repro_torch.configs import get_config as port_config
from repro_torch.configs import get_smoke_config as port_smoke
from repro_torch.core import integration as tint
from repro_torch.core.elk import compile_model as port_compile
from repro_torch.serve import engine as teng

DENSE = ["qwen3_14b", "llama2_13b", "gemma_7b", "opt_30b", "h2o_danube_1_8b"]


def _fields(obj) -> dict:
    """A dataclass of either copy as plain values (the two copies' classes
    are distinct, so their instances never compare equal themselves)."""
    return dataclasses.asdict(obj)


def _ref_h100(**kw) -> rchip.ChipConfig:
    """A reference ``ChipConfig`` with the fields of ``h100_host()``."""
    h = h100_host(**kw)
    return rchip.ChipConfig(**{f.name: getattr(h, f.name)
                               for f in dataclasses.fields(h)
                               if f.name != "mem_tiers"})


@pytest.mark.parametrize("mnk", [(128, 128, 128), (256, 64, 512),
                                 (100, 60, 70), (33, 129, 257),
                                 (4096, 5120, 17408), (8, 5120, 151936)])
@pytest.mark.parametrize("dtype_bytes", [2, 4])
def test_vmem_plan_equal(mnk, dtype_bytes):
    assert (_fields(tint.vmem_plan(*mnk, dtype_bytes=dtype_bytes))
            == _fields(rint.vmem_plan(*mnk, dtype_bytes=dtype_bytes)))


@pytest.mark.parametrize("arch,total", [("opt_30b", 0.00928679),
                                        ("llama2_13b", 0.00605007)])
def test_compile_model_totals_equal(arch, total):
    """The verify skill's reference totals (ipu-pod4-hbm, batch 32, seq
    2048, decode, ELK-Full) from both copies, decision for decision."""
    kw = dict(batch=32, seq=2048, phase="decode", design="ELK-Full")
    ref = ref_compile(ref_config(arch), rchip.ipu_pod4_hbm(), **kw)
    got = port_compile(port_config(arch), tchip.ipu_pod4_hbm(), **kw)
    assert got.total_time == ref.total_time
    assert round(got.total_time, 8) == total
    assert _fields(got.breakdown) == _fields(ref.breakdown)
    assert ([_fields(t) for t in got.timing]
            == [_fields(t) for t in ref.timing])


@pytest.mark.parametrize("arch", DENSE)
def test_pod_plan_flat_equal(arch):
    kw = dict(batch=4, seq=256, phase="decode")
    assert (_fields(tint.pod_plan(port_smoke(arch), **kw))
            == _fields(rint.pod_plan(ref_smoke(arch), **kw)))


@pytest.mark.parametrize("arch", ["qwen3_14b", "opt_30b"])
def test_pod_plan_hybrid_equal(arch):
    kw = dict(batch=8, seq=256, phase="decode", mode="hybrid")
    got = tint.pod_plan(port_smoke(arch),
                        chip=tchip.tpu_v5e_pod_hier(64, groups=4), **kw)
    ref = rint.pod_plan(ref_smoke(arch),
                        chip=rchip.tpu_v5e_pod_hier(64, groups=4), **kw)
    assert _fields(got) == _fields(ref)
    assert got.num_stages >= 1 and got.stage_widths


def _pods():
    """(port pod, reference pod) pairs: the default, an SRAM-only IPU with
    stacked DRAM (a finite hierarchy: KV capacity and oversubscription
    bite), one H100 read as a pod."""
    return [(None, None),
            (tchip.ipu_mk2().with_stacked_dram(2 * tchip.GB),
             rchip.ipu_mk2().with_stacked_dram(2 * rchip.GB)),
            (h100_host(), _ref_h100())]


@pytest.mark.parametrize("pod", range(3))
@pytest.mark.parametrize("arch", ["qwen3_14b", "h2o_danube_1_8b"])
def test_elk_serve_config_equal(arch, pod):
    tpod, rpod = _pods()[pod]
    for batch, cap, role in ((2, 64, "mixed"), (4, 256, "prefill"),
                             (4, 256, "decode")):
        got = teng.elk_serve_config(port_smoke(arch), batch=batch,
                                    cache_capacity=cap, pod=tpod, role=role)
        ref = reng.elk_serve_config(ref_smoke(arch), batch=batch,
                                    cache_capacity=cap, pod=rpod, role=role)
        assert _fields(got) == _fields(ref)
        assert got.mode == "elk_stream"


@pytest.mark.parametrize("kv_dtype", ["bfloat16", "float32", "int8"])
@pytest.mark.parametrize("arch", DENSE)
def test_kv_tier_helpers_equal(arch, kv_dtype):
    """``kv_ring_bytes`` counts the leaves of the reference's per-slot
    cache from their shapes; the tier helpers follow on finite and
    unbounded pods."""
    tcfg, rcfg = port_smoke(arch), ref_smoke(arch)
    assert (teng.kv_ring_bytes(tcfg, 48, kv_dtype)
            == reng.kv_ring_bytes(rcfg, 48, kv_dtype))
    for tpod, rpod in _pods():
        assert (teng.tier_kv_capacity(tcfg, tpod, batch=3, kv_dtype=kv_dtype)
                == reng.tier_kv_capacity(rcfg, rpod, batch=3,
                                         kv_dtype=kv_dtype))
        assert (teng.tier_kv_oversub(tcfg, tpod, slots=3, cache_capacity=48,
                                     kv_dtype=kv_dtype)
                == reng.tier_kv_oversub(rcfg, rpod, slots=3,
                                        cache_capacity=48,
                                        kv_dtype=kv_dtype))


def test_h100_host_is_the_datasheet_card():
    """One core whose store is the card's HBM, fed over PCIe from the host;
    the tiers the planner sees follow from those numbers."""
    h = h100_host()
    assert (h.num_cores, h.total_sram, h.core_flops, h.core_flops_vector) == (
        1, int(HBM_BYTES), BF16_FLOPS, FP32_FLOPS)
    assert (HBM_BYTES, HBM_BYTES_PER_S, BF16_FLOPS, FP32_FLOPS,
            PCIE_BYTES_PER_S) == (80e9, 3.35e12, 989e12, 67e12, 64e9)
    sram, host = h.mem_tiers
    assert (sram.capacity, sram.bandwidth) == (int(HBM_BYTES), HBM_BYTES_PER_S)
    assert host.unbounded and host.bandwidth == PCIE_BYTES_PER_S


@pytest.mark.parametrize("arch", ["qwen3_14b", "opt_30b"])
def test_knobs_do_not_depend_on_link_bw_at_one_core(arch):
    """There are no peers on one card.  The planner still sends every
    preload over the core's link (delivery at min(link, PCIe)), so from the
    PCIe rate up, the link's rate moves no knob; far below it the link
    paces the preloads and the knobs move (here at 1 GB/s)."""
    cfg = port_smoke(arch)

    def knobs(lb):
        return _fields(tint.pod_plan(cfg, batch=8, seq=512,
                                     chip=h100_host(link_bw=lb)))

    fast = [knobs(lb) for lb in (PCIE_BYTES_PER_S, 1e12, 1e14)]
    assert fast[0] == fast[1] == fast[2]
    assert _fields(tint.pod_plan(cfg, batch=8, seq=512,
                                 chip=h100_host())) == fast[0]
    assert knobs(1e9) != fast[0]
    serve = [_fields(teng.elk_serve_config(
        cfg, batch=8, cache_capacity=512, pod=h100_host(link_bw=lb)))
        for lb in (PCIE_BYTES_PER_S, 1e13)]
    assert serve[0] == serve[1]


def test_full_qwen3_14b_knobs_do_not_depend_on_link_bw():
    """At full width the served config's window does not move with the
    link's rate even far below PCIe."""
    cfg = port_config("qwen3_14b")
    depth = {lb: tint.pod_plan(cfg, batch=8, seq=2048,
                               chip=h100_host(link_bw=lb)).prefetch_depth
             for lb in (1e9, 1e13)}
    assert depth == {1e9: 3, 1e13: 3}


def test_full_qwen3_14b_knobs_on_h100():
    """The knobs the launcher's default path serves full qwen3-14b with on
    one H100 (``chip_smoke.py``'s stream phase), from both copies."""
    kw = dict(batch=8, cache_capacity=2048)
    got = teng.elk_serve_config(port_config("qwen3_14b"), pod=h100_host(),
                                **kw)
    ref = reng.elk_serve_config(ref_config("qwen3_14b"), pod=_ref_h100(),
                                **kw)
    assert _fields(got) == _fields(ref)
    assert (got.prefetch_depth, got.prefill_chunk) == (3, 48)


# ---------------------------------------------------------------------------
# the event simulator's copy
# ---------------------------------------------------------------------------

def test_simulate_kv_traffic_equal():
    events = [("spill", 1 << 20), ("refill", 3 << 19, 0.001),
              ("spill", 1 << 21), ("refill", 1 << 20, 0.5)]
    for tpod, rpod in _pods()[1:]:
        got = tsim.simulate_kv_traffic(tpod, events)
        ref = rsim.simulate_kv_traffic(rpod, events)
        assert _fields(got) == _fields(ref)


@pytest.mark.parametrize("arch", ["qwen3_14b", "opt_30b"])
def test_simulate_equal(arch):
    """The simulator re-times a compiled plan the same way in both copies."""
    kw = dict(batch=4, seq=256, phase="decode", design="ELK-Full")
    tplan = port_compile(port_smoke(arch), tchip.ipu_pod4_hbm(), **kw)
    rplan = ref_compile(ref_smoke(arch), rchip.ipu_pod4_hbm(), **kw)
    got = tsim.simulate(tplan, tchip.ipu_pod4_hbm())
    ref = rsim.simulate(rplan, rchip.ipu_pod4_hbm())
    assert got.total_time == ref.total_time > 0
    assert _fields(got) == _fields(ref)


# ---------------------------------------------------------------------------
# smem_plan on h100_sxm
# ---------------------------------------------------------------------------

def test_h100_sxm_is_the_datasheet_card():
    h = h100_sxm()
    assert (h.num_cores, h.sram_per_core, h.hbm_bw) == (
        SMS, SMEM_PER_BLOCK, HBM_BYTES_PER_S)
    assert (SMS, SMEM_PER_BLOCK) == (132, 232_448)
    assert h.total_flops == pytest.approx(BF16_FLOPS)
    assert h.mem_tiers[-1].unbounded


def _sxm_with(budget):
    """``h100_sxm`` with another shared-memory budget a block."""
    return dataclasses.replace(h100_sxm(), sram_per_core=budget)


def _check_fits(p, budget=SMEM_PER_BLOCK):
    """A plan within the shared-memory budget and the register bound of its
    route's kernel, its tiles ones the kernel compiles, its splits covering
    K exactly."""
    assert p.smem_bytes <= budget
    assert p.acc_bytes == p.bm * p.bn * 4
    assert 1 <= p.splits <= MAX_SPLITS and p.k_per_split >= 1
    if p.route in ("fma", "fma_splitk"):
        assert (p.bm, p.bn) in FMA_TILES and p.bk in TILE_K
        assert p.stages == FMA_STAGES
        assert (p.splits > 1) == (p.route == "fma_splitk")
        if p.splits > 1:    # the tile's fp32 sums are left in the ring
            assert p.bm * p.bn * 4 <= p.smem_bytes
        return
    if p.route == "mma_sync":
        assert p.acc_bytes <= ACC_BYTES_MAX
        assert p.bm % MMA_M == 0 and p.bn % MMA_N == 0 and p.bk % MMA_K == 0
        assert p.bm in TILE_M and p.bn in TILE_N and p.bk in TILE_K
        assert p.splits == 1
        return
    assert p.route in ("wgmma", "splitk")
    assert p.bm in WG_TILE_M and p.bn in WG_TILE_N and p.bk == WG_BK
    # a consumer thread's accumulators: bn / 2 fp32 registers
    assert p.bn // 2 <= WGMMA_ACC_REGS[p.bm]
    assert (p.stages, p.blocks_per_sm) == wg_stages(p.bm, p.bn, budget=budget)
    assert p.stages >= 2
    assert p.blocks_per_sm * (p.smem_bytes + 1024) <= budget + 1024
    assert p.smem_bytes == wg_smem_bytes(p.bm, p.bn, p.stages)
    if p.splits > 1:    # the tile's fp32 sums are left in the ring
        assert p.bm * p.bn * 4 <= p.stages * (p.bm + p.bn) * WG_BK * 2
    if p.route == "splitk":
        assert p.bm == WGMMA_M
    elif p.splits > 1:      # wgmma splits K only on its smallest tile
        assert (p.bm, p.bn) == (WG_TILE_M[0], WG_TILE_N[0])


def _covers_k(p, k):
    k_tiles = -(-k // p.bk)
    assert (p.splits - 1) * p.k_per_split < k_tiles <= p.splits * p.k_per_split


def test_smem_plan_within_budget():
    plan = smem_plan(8192, 8192, 8192)
    _check_fits(plan)
    # a bigger budget must never increase HBM traffic
    small = smem_plan(8192, 8192, 8192, chip=_sxm_with(48 * 1024))
    _check_fits(small, 48 * 1024)
    assert plan.hbm_traffic <= small.hbm_traffic
    assert (plan.route, plan.bm, plan.bn) == ("wgmma", 128, 256)
    # the mma_sync kernel's plan (fp32, or operands TMA does not take)
    plan = smem_plan(8192, 8192, 8192, tma=False)
    _check_fits(plan)
    small = smem_plan(8192, 8192, 8192, chip=_sxm_with(48 * 1024), tma=False)
    _check_fits(small, 48 * 1024)
    assert plan.hbm_traffic <= small.hbm_traffic
    assert (plan.route, plan.bm, plan.bn) == ("mma_sync", 128, 128)


def test_smem_plan_always_fits():
    """Twin of ``test_vmem_plan_always_fits`` (``tests/test_properties.py``),
    a hypothesis property over shapes, types and budgets."""
    hyp = pytest.importorskip("hypothesis",
                              reason="dev dependency (requirements-dev.txt)")
    st = hyp.strategies

    @hyp.settings(max_examples=60, deadline=None)
    @hyp.given(m=st.integers(1, 70000), n=st.integers(1, 200000),
               k=st.integers(1, 20000), dtype_bytes=st.sampled_from([2, 4]),
               budget=st.integers(40_000, SMEM_PER_BLOCK))
    def prop(m, n, k, dtype_bytes, budget):
        _plan_fits(m, n, k, dtype_bytes, budget)

    prop()


def _plan_fits(m, n, k, dtype_bytes, budget):
    p = smem_plan(m, n, k, dtype_bytes=dtype_bytes)
    _check_fits(p)
    q = smem_plan(m, n, k, dtype_bytes=dtype_bytes, chip=_sxm_with(budget))
    _check_fits(q, budget)
    assert p.hbm_traffic <= q.hbm_traffic
    assert p.tiles == -(-m // p.bm) * -(-n // p.bn)
    _covers_k(p, k)
    _covers_k(q, k)


# qwen3-14b's serving products, bf16, operands TMA takes: (m, n, k) ->
# (route, bm, bn, bk, tiles, stages, splits)
SERVING_PLANS = {
    (8, 5120, 5120): ("splitk", 64, 128, 64, 40, 4, 4),     # decode: q, o
    (8, 1024, 5120): ("splitk", 64, 64, 64, 16, 6, 8),      # decode: k, v
    (8, 151936, 5120): ("splitk", 64, 128, 64, 1187, 4, 1),  # the LM head
    (32, 5120, 5120): ("splitk", 64, 128, 64, 40, 4, 4),
    (32, 1024, 5120): ("splitk", 64, 64, 64, 16, 6, 8),
    (32, 151936, 5120): ("splitk", 64, 128, 64, 1187, 4, 1),
    (256, 5120, 5120): ("wgmma", 128, 64, 64, 160, 8, 1),   # a chunk of 256
    (256, 1024, 5120): ("wgmma", 64, 64, 64, 64, 6, 3),
    (4096, 5120, 5120): ("wgmma", 128, 256, 64, 640, 4, 1),  # prefill
    (4096, 1024, 5120): ("wgmma", 128, 128, 64, 256, 7, 1),
    # the down product of the MLP's two-pass route (h @ w_down)
    (256, 5120, 17408): ("wgmma", 128, 64, 64, 160, 8, 1),
    (4096, 5120, 17408): ("wgmma", 128, 256, 64, 640, 4, 1),
}
# the same products on the mma_sync kernel (its plans before the TMA
# routes): (bm, bn, bk, tiles)
MMA_SYNC_PLANS = {
    (8, 5120, 5120): (16, 32, 256, 160),
    (8, 1024, 5120): (16, 32, 256, 32),
    (8, 151936, 5120): (16, 128, 32, 1187),
    (32, 5120, 5120): (32, 32, 256, 160),
    (32, 1024, 5120): (16, 32, 256, 64),
    (32, 151936, 5120): (32, 128, 32, 1187),
    (256, 5120, 5120): (128, 64, 64, 160),
    (256, 1024, 5120): (32, 32, 256, 256),
    (4096, 5120, 5120): (128, 128, 64, 1280),
    (4096, 1024, 5120): (128, 128, 64, 256),
}


# the products new with the paper's Table 2 models and the MoE family, bf16,
# operands TMA takes: dit-xl's LM head 8 wide (a tile of 64 or 128 columns
# over 8, the rest zero-filled by TMA and masked at the store), the routers
# of llama4-maverick (128 experts) and kimi-k2 (384), gemma2-27b's tied head
NEW_PRODUCT_PLANS = {
    (8, 8, 1152): ("splitk", 64, 128, 64, 1, 4, 6),
    (4096, 8, 1152): ("wgmma", 64, 64, 64, 64, 6, 3),
    (8, 128, 5120): ("splitk", 64, 64, 64, 2, 6, 8),
    (4096, 128, 5120): ("wgmma", 64, 64, 64, 128, 6, 2),
    (8, 384, 7168): ("splitk", 64, 64, 64, 6, 6, 8),
    (4096, 384, 7168): ("wgmma", 128, 64, 64, 192, 8, 1),
    (8, 256000, 4608): ("splitk", 64, 128, 64, 2000, 4, 1),
}


@pytest.mark.parametrize("mnk", sorted(NEW_PRODUCT_PLANS))
def test_smem_plan_new_model_products_pinned(mnk):
    """Every product of the new configs has a TMA route that covers K and
    fits the card; the plan is the one ``chip_smoke.py`` held against the
    plain version on the card."""
    p = smem_plan(*mnk)
    _check_fits(p)
    _covers_k(p, mnk[2])
    assert (p.route, p.bm, p.bn, p.bk, p.tiles, p.stages,
            p.splits) == NEW_PRODUCT_PLANS[mnk]


@pytest.mark.parametrize("mnk", sorted(SERVING_PLANS))
def test_smem_plan_serving_shapes_pinned(mnk):
    p = smem_plan(*mnk)
    _check_fits(p)
    _covers_k(p, mnk[2])
    assert (p.route, p.bm, p.bn, p.bk, p.tiles, p.stages,
            p.splits) == SERVING_PLANS[mnk]
    assert p.blocks >= min(SMS, p.tiles * MAX_SPLITS)
    if mnk in MMA_SYNC_PLANS:
        q = smem_plan(*mnk, tma=False)
        _check_fits(q)
        assert (q.bm, q.bn, q.bk, q.tiles) == MMA_SYNC_PLANS[mnk]
        if q.tiles >= SMS:
            assert q.blocks_per_sm * q.smem_bytes <= SMEM_PER_BLOCK


@pytest.mark.parametrize("m", [1, 8, 16])
def test_smem_plan_does_not_pad_a_decode_step_to_128_rows(m):
    """The mma_sync plan takes 16 rows; the TMA plan one wgmma's 64, and
    splits K instead of adding row tiles."""
    for n, k in ((5120, 5120), (1024, 5120), (151936, 5120)):
        assert smem_plan(m, n, k, tma=False).bm == 16
        p = smem_plan(m, n, k)
        assert (p.route, p.bm, p.tiles) == ("splitk", WGMMA_M,
                                            -(-n // p.bn))


def test_smem_plan_covers_the_sms_at_small_m():
    """The greedy alone would take bn = 128 at m = 8 (40 blocks for q/o);
    the mma_sync plan narrows it until every SM has a block, the TMA plan
    splits K (q/o 4 splits of 20 K tiles: 160 blocks; k/v as far as a
    cluster of 8 goes, 16 tiles x 8: 128)."""
    p = smem_plan(8, 5120, 5120, tma=False)
    assert p.tiles >= SMS and p.bn == 32
    p = smem_plan(8, 5120, 5120)
    assert (p.route, p.splits, p.blocks) == ("splitk", 4, 160)
    _covers_k(p, 5120)
    p = smem_plan(8, 1024, 5120)
    assert (p.route, p.bn, p.splits, p.blocks) == ("splitk", 64, MAX_SPLITS,
                                                   128)
    _covers_k(p, 5120)
    assert smem_plan(8, 151936, 5120).splits == 1   # 1187 tiles already


def test_wgmma_route_starts_at_64_rows():
    assert WGMMA_MIN_M == WGMMA_M == 64
    assert smem_plan(WGMMA_MIN_M - 1, 5120, 5120).route == "splitk"
    assert smem_plan(WGMMA_MIN_M, 5120, 5120).route == "wgmma"
    assert smem_plan(4096, 5120, 5120, dtype_bytes=4).route == "fma"


def test_wg_stages_fill_the_budget():
    """Stages are what shared memory holds: at one consumer warpgroup two
    blocks an SM, each on half of it less the system's share; at two, one
    block on all of it; never more than the header's limit."""
    for bm in WG_TILE_M:
        for bn in WG_TILE_N:
            if bn // 2 > WGMMA_ACC_REGS[bm]:
                continue
            stages, per_sm = wg_stages(bm, bn)
            stage = (bm + bn) * WG_BK * 2
            assert per_sm == (2 if bm == 64 else 1)
            room = SMEM_PER_BLOCK // per_sm - (1024 if per_sm == 2 else 0)
            assert stages == min(8, (room - 2048) // stage) >= 2
            assert per_sm * (wg_smem_bytes(bm, bn, stages) + 1024) <= 233472
    # the gated pass 1 of the MLP: two b tiles a stage, 48 KB, 4 stages
    assert wg_stages(128, 128, 2) == (4, 1)


def test_smem_plan_reads_no_field_no_datasheet_gives():
    shapes = list(SERVING_PLANS) + [(128, 128, 128), (33, 129, 257)]
    base = [smem_plan(*s, chip=h100_sxm()) for s in shapes]
    for kw in (dict(link_bw=1e12), dict(sram_bw_per_core=1e15),
               dict(link_bw=1.0, sram_bw_per_core=1.0),
               dict(link_latency=1.0, hbm_latency=1.0)):
        chip = dataclasses.replace(h100_sxm(), **kw)
        assert [smem_plan(*s, chip=chip) for s in shapes] == base


def test_smem_plan_checks_the_starting_tile():
    with pytest.raises(ValueError, match="smallest tile"):
        smem_plan(8, 5120, 5120, chip=_sxm_with(1024))
    with pytest.raises(ValueError, match="empty"):
        smem_plan(0, 5120, 5120)
