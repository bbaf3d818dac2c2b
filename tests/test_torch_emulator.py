"""The port's plan emulator (``repro_torch/chip/emulator.py``) against the
reference's (``repro.chip.emulator``), on the CPU.

The same numpy inputs go through both ``emulate_matmul_plan``s under the
same plans (the first exec plans of a decode matmul, each with its first and
last preload plan, as ``tests/test_runtime.py::test_emulator_validates_plans``
takes them); both run the same fp32 tile loop, so they agree to the order of
their fp32 sums: within 1e-5 * (max|ref| + 1).
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.chip.config import ipu_mk2 as jax_ipu_mk2
from repro.chip.emulator import emulate_matmul_plan as jax_emulate
from repro.configs import get_config as jax_get_config
from repro.core.graph import build_graph as jax_build_graph
from repro.core.partition import (
    enumerate_exec_plans as jax_exec_plans,
    enumerate_preload_plans as jax_preload_plans)
from repro_torch.chip.config import ipu_mk2
from repro_torch.chip.emulator import check_plan_numerics, emulate_matmul_plan
from repro_torch.chip.h100 import h100_sxm
from repro_torch.configs import get_config
from repro_torch.core.graph import build_graph
from repro_torch.core.partition import (enumerate_exec_plans,
                                        enumerate_preload_plans)

TOL = 1e-5


def _plans(chip, graph_fn, cfg, exec_fn, preload_fn, count=4):
    g = graph_fn(cfg, batch=4, seq=128, phase="decode")
    op = next(o for o in g.ops if o.kind == "matmul")
    out = []
    for ep in exec_fn(op, chip)[:count]:
        pps = preload_fn(op, ep, chip)
        out += [(ep, pps[0]), (ep, pps[-1])]
    return out


def test_emulator_validates_plans():
    """Twin of the reference's test: every plan passes
    ``check_plan_numerics`` (on the CPU here)."""
    for ep, pp in _plans(ipu_mk2(), build_graph, get_config("llama2_13b"),
                         enumerate_exec_plans, enumerate_preload_plans):
        assert check_plan_numerics(ep, pp, device="cpu") >= 0.0


@pytest.mark.parametrize("shape", [(64, 48, 32), (37, 53, 29)])
def test_emulator_equals_the_reference(shape):
    """Plan for plan (the port's plans equal the reference's, which
    ``test_torch_planner.py`` holds), the same numpy inputs through both
    emulators."""
    m, n, k = shape
    rng = np.random.default_rng(m)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.standard_normal((k, n)).astype(np.float32)
    ours = _plans(ipu_mk2(), build_graph, get_config("llama2_13b"),
                  enumerate_exec_plans, enumerate_preload_plans)
    theirs = _plans(jax_ipu_mk2(), jax_build_graph,
                    jax_get_config("llama2_13b"), jax_exec_plans,
                    jax_preload_plans)
    assert len(ours) == len(theirs) > 0
    for (ep, pp), (jep, jpp) in zip(ours, theirs):
        assert (ep.split, ep.chunk, pp.frac) == (jep.split, jep.chunk,
                                                  jpp.frac)
        ref = np.asarray(jax_emulate(jnp.asarray(x), jnp.asarray(w), jep,
                                     jpp))
        got = emulate_matmul_plan(torch.from_numpy(x), torch.from_numpy(w),
                                  ep, pp).numpy()
        assert got.shape == ref.shape and got.dtype == np.float32
        assert np.max(np.abs(got - ref)) <= TOL * (np.max(np.abs(ref)) + 1)


def test_emulator_on_the_h100_plans():
    """The plans of a decode matmul on ``h100_sxm`` (what ``chip_smoke.py``
    checks on the card) pass on the CPU too."""
    chip = h100_sxm()
    g = build_graph(get_config("qwen3_14b"), batch=8, seq=1024,
                    phase="decode")
    op = next(o for o in g.ops if o.kind == "matmul")
    plans = enumerate_exec_plans(op, chip)[:4]
    assert plans
    for ep in plans:
        pps = enumerate_preload_plans(op, ep, chip)
        for pp in (pps[0], pps[-1]):
            check_plan_numerics(ep, pp, device="cpu")


@pytest.mark.parametrize("arch", ["qwen3_14b", "h2o_danube_1_8b"])
def test_every_layer0_matmul_plans_on_the_h100(arch):
    """``h100_sxm``'s link rate is the measured DSMEM rate, so the planner
    prices every matmul op of layer 0 of a decode graph (B 8, a ring of
    1024), not only the projections (a link rate of 0 made ``kv``,
    ``score`` and ``attnv`` divide by zero); the first and last preload
    plans of up to 4 exec plans an op pass on the CPU, as ``chip_smoke.py``
    checks them on the card."""
    chip = h100_sxm()
    assert chip.link_bw > 0
    g = build_graph(get_config(arch), batch=8, seq=1024, phase="decode")
    ops = [o for o in g.ops
           if o.kind == "matmul" and o.name.startswith("l0.")]
    assert {o.name for o in ops} >= {"l0.q", "l0.kv", "l0.score",
                                     "l0.attnv", "l0.o"}
    for op in ops:
        plans = enumerate_exec_plans(op, chip)
        assert plans, op.name
        for ep in plans[:4]:
            pps = enumerate_preload_plans(op, ep, chip)
            for pp in (pps[0], pps[-1]):
                check_plan_numerics(ep, pp, device="cpu")


def test_emulator_default_device_is_the_card():
    """No card here: the default device raises instead of taking the CPU."""
    ep = enumerate_exec_plans(next(
        o for o in build_graph(get_config("llama2_13b"), batch=4, seq=128,
                               phase="decode").ops if o.kind == "matmul"),
        ipu_mk2())[0]
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="runs on a CUDA device"):
        check_plan_numerics(ep)
