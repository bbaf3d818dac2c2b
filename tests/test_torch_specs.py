"""The port's dry-run cells and accounting against the JAX package's.

``launch/specs.py``'s shape cases, eligibility, capacities, ``model_flops``
and ``needs_fsdp`` against the reference's for all 60 cells; its
``input_specs`` meta tensors against the reference's ``ShapeDtypeStruct``s;
``hlo_analysis.Roofline`` against the reference's on the reference's
constants; ``count_step`` against an analytic count; the kernel ops'
third route (``kernels/dispatch.py``) on meta tensors beside their CPU
route.
"""

import types

import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.launch import hlo_analysis as ref_hlo
from repro.launch import specs as ref_specs
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.kernels.decode_attention.ops import decode_attn
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.kernels.elk_matmul.ops import matmul
from repro_torch.kernels.elk_matmul.ref import matmul_ref
from repro_torch.kernels.flash_attention.ops import flash_attn
from repro_torch.kernels.flash_attention.ref import mha_ref
from repro_torch.kernels.fused_mlp.ops import fused_mlp
from repro_torch.kernels.fused_mlp.ref import fused_mlp_ref
from repro_torch.launch import hlo_analysis as hlo
from repro_torch.launch import specs
from repro_torch.models import transformer as tfm
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.step import jit_train_step

CELLS = [(a, s) for a in ARCH_IDS for s in specs.SHAPES]
GIB16 = 16 * 1024 ** 3


def stub(**shape):
    return types.SimpleNamespace(shape=shape)


def test_shapes_and_cells_equal_the_references():
    assert len(CELLS) == 60
    assert specs.all_cells() == CELLS
    assert set(ref_specs.all_cells()) <= set(CELLS)
    assert list(specs.SHAPES) == list(ref_specs.SHAPES)
    for name, case in specs.SHAPES.items():
        ref = ref_specs.SHAPES[name]
        assert (case.name, case.kind, case.seq, case.batch) == (
            ref.name, ref.kind, ref.seq, ref.batch)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cell_rules_equal_the_references(arch):
    """eligible, cache_capacity, model_flops exactly, and needs_fsdp with
    the reference's 16 GiB, on the production meshes and a mesh of one."""
    cfg, ref = get_config(arch), ref_get_config(arch)
    for shape, case in specs.SHAPES.items():
        rcase = ref_specs.SHAPES[shape]
        assert specs.eligible(cfg, shape) == ref_specs.eligible(ref, shape)
        assert specs.cache_capacity(cfg, case) == \
            ref_specs.cache_capacity(ref, rcase)
        assert specs.model_flops(cfg, case) == \
            ref_specs.model_flops(ref, rcase)
    for mesh in (stub(data=16, model=16), stub(pod=2, data=16, model=16),
                 stub(data=1, model=1)):
        assert specs.needs_fsdp(cfg, mesh, hbm_bytes=GIB16) == \
            ref_specs.needs_fsdp(ref, mesh)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_equal_the_references(arch):
    cfg, ref = get_config(arch), ref_get_config(arch)
    for shape, case in specs.SHAPES.items():
        got = specs.input_specs(cfg, case)
        want = ref_specs.input_specs(ref, ref_specs.SHAPES[shape])
        assert sorted(got) == sorted(want)
        for key, t in got.items():
            assert t.device.type == "meta"
            assert tuple(t.shape) == tuple(want[key].shape)
            assert str(t.dtype).replace("torch.", "") == \
                np.dtype(want[key].dtype).name


def test_roofline_equals_the_references_on_its_constants(monkeypatch):
    for name in ("PEAK_FLOPS", "HBM_BW", "LINK_BW"):
        monkeypatch.setattr(hlo, name, getattr(ref_hlo, name))
    for args in ((3e12, 2e9, 0.0, 1e13), (1e10, 5e11, 0.0, 4e9)):
        flops, byts, wire, mf = args
        kw = dict(compute_s=flops / ref_hlo.PEAK_FLOPS,
                  memory_s=byts / ref_hlo.HBM_BW,
                  collective_s=wire / ref_hlo.LINK_BW,
                  hlo_flops_per_chip=flops, hlo_bytes_per_chip=byts,
                  wire_bytes_per_chip=wire, model_flops=mf, num_chips=256)
        got, want = hlo.Roofline(**kw).to_dict(), ref_hlo.Roofline(**kw)
        assert got == pytest.approx(want.to_dict(), rel=1e-12, abs=0)
        assert hlo.roofline(flops, byts, mf, 256).to_dict() == \
            pytest.approx(want.to_dict(), rel=1e-12, abs=0)


def test_h100_constants_are_the_datasheets():
    assert (hlo.PEAK_FLOPS, hlo.HBM_BW, hlo.LINK_BW) == (989e12, 3.35e12,
                                                          450e9)


def test_count_step_matches_an_analytic_count():
    """A 2-layer smoke prefill on meta: every product of the decoder and
    the head, the attention kernel's pairs, each kernel's launches."""
    cfg = get_smoke_config("qwen3_14b")
    b, s = 2, 16
    params = tfm.param_shapes(cfg)
    cache = tfm.init_cache(cfg, tfm.CacheSpec(capacity=s, batch=b), "meta")
    tokens = torch.empty((b, s), dtype=torch.int32, device="meta")
    c = hlo.count_step(tfm.prefill, (params, cfg, tokens, cache))
    d, hd, L = cfg.d_model, cfg.resolved_head_dim, cfg.num_layers
    nq, nkv, ff, v = cfg.num_heads, cfg.num_kv_heads, cfg.d_ff, cfg.vocab_size
    t = b * s
    proj = 2 * t * d * hd * (2 * nq + 2 * nkv)
    mlp = 2 * t * 3 * d * ff
    attn = 4 * b * nq * (s * (s + 1) / 2) * hd
    head = 2 * b * d * v                     # the last token only
    assert c.kernels["elk_matmul"]["launches"] == 4 * L + 1
    assert c.kernels["fused_mlp"]["launches"] == L
    assert c.kernels["flash_attention"]["launches"] == L
    assert c.attention_flops() == attn * L
    assert c.flops == L * (proj + mlp + attn) + head
    assert c.bytes > 0 and c.host_bytes == 0


def test_kernel_ops_on_meta_record_their_kernel_and_shape():
    """Meta tensors take the third route: the kernel's entry is recorded
    and an empty result of the right shape returned; the plain version
    never runs (nor does an operation of its own get counted)."""
    meta = dict(device="meta", dtype=torch.bfloat16)
    x, w = torch.empty(6, 32, **meta), torch.empty(32, 48, **meta)
    up, down = torch.empty(32, 64, **meta), torch.empty(64, 32, **meta)
    q = torch.empty(2, 4, 8, 16, **meta)
    k = torch.empty(2, 2, 8, 16, **meta)
    qd = torch.empty(2, 4, 16, **meta)
    ring = torch.empty(2, 2, 8, 16, **meta)
    tags = torch.empty(8, dtype=torch.int32, device="meta")
    calls = [
        ("elk_matmul", lambda: matmul(x, w), (6, 48), 2 * 6 * 32 * 48),
        ("fused_mlp", lambda: fused_mlp(x, up, down, w_gate=up),
         (6, 32), 2 * 6 * 64 * (32 * 2 + 32)),
        ("flash_attention", lambda: flash_attn(q, k, k),
         (2, 4, 8, 16), 4 * 2 * 4 * 36 * 16),
        ("decode_attention", lambda: decode_attn(qd, ring, ring, tags, 7),
         (2, 4, 16), 4 * 2 * 4 * 8 * 16),
    ]
    for name, fn, shape, flops in calls:
        out = []
        c = hlo.count_step(lambda: out.append(fn()), ())  # noqa: B023
        assert tuple(out[0].shape) == shape and out[0].device.type == "meta"
        assert c.kernels == {name: {"launches": 1, "flops": float(flops),
                                    "bytes": c.kernels[name]["bytes"]}}
        assert c.flops == flops and not c.ops


def test_kernel_ops_on_cpu_still_take_the_plain_version():
    g = torch.Generator().manual_seed(0)
    x, w = torch.randn(6, 32, generator=g), torch.randn(32, 48, generator=g)
    assert torch.equal(matmul(x, w), matmul_ref(x, w))
    up, down = torch.randn(32, 64, generator=g), torch.randn(64, 32,
                                                             generator=g)
    assert torch.equal(fused_mlp(x, up, down, w_gate=up),
                       fused_mlp_ref(x, up, down, w_gate=up))
    q, k = torch.randn(2, 4, 8, 16, generator=g), torch.randn(2, 2, 8, 16,
                                                             generator=g)
    assert torch.equal(flash_attn(q, k, k), mha_ref(q, k, k))
    qd, tags = q[:, :, 0], torch.arange(8, dtype=torch.int32)
    assert torch.equal(decode_attn(qd, k, k, tags, 7),
                       decode_attention_ref(qd, k, k, tags, 7))


def test_jit_train_step_gives_the_references_spec_trees():
    cfg = get_smoke_config("qwen3_14b")
    params = tfm.param_shapes(cfg)
    batch = {"tokens": torch.empty((32, 8), dtype=torch.int32,
                                   device="meta")}
    mesh = stub(data=16, model=16)
    step, sp = jit_train_step(cfg, mesh, AdamWConfig(), params, batch,
                              fsdp=True, layout="tp", compression="int8")
    assert callable(step)
    assert sp["batch"] == {"tokens": (("data",), None)}
    assert sp["opt"]["step"] == () and sp["opt"]["m"] is sp["opt"]["v"]
    assert sp["err"] is sp["opt"]["m"]
    assert sp["opt"]["m"]["layers"][0]["attn"]["w_q"] == ("data", "model")
    _, sp2 = jit_train_step(cfg, mesh, AdamWConfig(), params, batch,
                            layout="fsdp2d")
    assert sp2["opt"]["m"] is sp2["params"] and sp2["err"] is None


def test_meta_cells_build_every_kind_without_allocating():
    mesh = stub(data=16, model=16)
    for arch, shape in (("qwen3_14b", "train_4k"),
                        ("kimi_k2_1t_a32b", "decode_32k"),
                        ("whisper_tiny", "prefill_32k")):
        cell = specs.build_cell(arch, shape, mesh)
        leaves = [t for t in torch.utils._pytree.tree_leaves(cell.args)
                  if isinstance(t, torch.Tensor)]
        assert leaves and all(t.device.type == "meta" for t in leaves)
    # kimi-k2 decodes streamed (needs_fsdp), its layers a meta LayerStream
    assert cell.meta["fsdp"] is False
    kimi = specs.build_cell("kimi_k2_1t_a32b", "decode_32k", mesh)
    assert kimi.meta["streamed"] and kimi.meta["kv_dtype"] == "int8"
    with pytest.raises(ValueError, match="ineligible"):
        specs.build_cell("qwen3_14b", "long_500k", mesh)
