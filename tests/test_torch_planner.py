"""The port's copy of the ELK planner against the reference's, on the CPU.

``repro_torch.core`` and ``repro_torch.chip.{config,topology}`` are copies of
the reference's modules with their imports renamed; the port imports nothing
of ``repro``.  These tests run both copies on the same inputs and require
equal results, so that the copies cannot drift unnoticed: block shapes
(``vmem_plan``), whole-model plan totals (the full-config references of the
verify skill), pod-level knobs, and the serving knobs of
``elk_serve_config`` on the default pod, on an SRAM-only pod with stacked
DRAM, and on one H100 read as a pod (``chip.h100.h100_host``).  Smoke
configs keep the compiles short; repeated compiles hit the plan caches.
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
from repro_torch.chip.h100 import (BF16_FLOPS, FP32_FLOPS, HBM_BYTES,
                                   HBM_BYTES_PER_S, PCIE_BYTES_PER_S,
                                   h100_host)
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
