"""The MoE family of the port against the JAX reference, on the CPU.

``repro_torch.models.moe`` against ``repro.models.moe`` on the same seeded
numpy inputs; the MoE layer kinds, block structure and parameters against
the reference's model; and the full configs' parameter counts (the port's
and the reference's ``param_count``, and the shapes each ``init_params``
draws).

Tolerances: gates 1e-6 absolute (a softmax over k fp32 values on both
sides); ``moe_ffn`` in fp32 within 2e-4 * (max|ref| + 1) and in bf16 within
6e-2 * (max|ref| + 1), the kernel tests' bounds (the two frameworks sum the
expert products in different orders, and in bf16 round at other places);
``aux_load_balance_loss`` 1e-6 relative.  Expert ids and slots are exact.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import moe as jmoe
from repro.models import transformer as jtfm
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as tfm

MOE = ["llama4_maverick_400b_a17b", "kimi_k2_1t_a32b"]
NEW = ["gemma2_27b", "llama2_70b", "dit_xl"] + MOE
TOL = {"float32": 2e-4, "bfloat16": 6e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _cfgs(arch: str, dtype: str = "float32"):
    jcfg = dataclasses.replace(jax_smoke_config(arch), dtype=dtype,
                               param_dtype=dtype)
    tcfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype,
                               param_dtype=dtype)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    return jcfg, tcfg


def _moe_inputs(arch: str, dtype: str, t: int, seed: int = 0):
    """The reference's ``moe_params`` (numpy, then both sides) and a (T, d)
    input drawn with numpy."""
    jcfg, tcfg = _cfgs(arch, dtype)
    jp = jmoe.moe_params(jax.random.PRNGKey(seed), jcfg, JDT[dtype])
    tp = {k: torch.from_numpy(np.array(v, np.float32)).to(TDT[dtype])
          for k, v in jp.items()}
    x = np.random.default_rng(seed).normal(size=(t, jcfg.d_model))
    x = x.astype(np.float32)
    return (jcfg, jp, jnp.asarray(x, JDT[dtype]),
            tcfg, tp, torch.from_numpy(x).to(TDT[dtype]))


@pytest.mark.parametrize("factor", [0.25, 0.5, 1.0, 1.25, 2.0])
def test_capacity_grid(factor):
    for tokens in (1, 2, 3, 8, 17, 100, 512, 4096):
        for experts in (4, 16, 128, 384):
            for top_k in (1, 2, 8):
                assert (tmoe.capacity(tokens, experts, top_k, factor)
                        == jmoe.capacity(tokens, experts, top_k, factor))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("top_k", [1, 2, 8])
def test_router_weights(top_k, dtype):
    logits = np.random.default_rng(top_k).normal(size=(37, 24))
    logits = logits.astype(np.float32)
    jg, ji = jmoe.router_weights(jnp.asarray(logits, JDT[dtype]), top_k)
    tg, ti = tmoe.router_weights(torch.from_numpy(logits).to(TDT[dtype]),
                                 top_k)
    assert tg.dtype == torch.float32 and ti.dtype == torch.int32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=0, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_router_ties_go_to_the_lower_expert(dtype):
    """Equal logits: ``lax.top_k`` gives the lower expert index first, and
    so must the port.  The bf16 rows hold fp32 values that round to equal
    bf16 values."""
    eps = 2.0 ** -12                    # below half a bf16 ulp at 1.0
    rows = np.array([
        [0.0, 3.0, 3.0, 1.0, 3.0, 3.0],
        [2.0, 2.0, 2.0, 2.0, 2.0, 2.0],
        [1.0, 1.0 + eps, 5.0, 1.0 - eps, 1.0, 0.0],
        [-1.0, -1.0, -1.0, -4.0, -1.0, -1.0],
    ], np.float32)
    for k in (1, 2, 3, 4):
        jg, ji = jmoe.router_weights(jnp.asarray(rows, JDT[dtype]), k)
        tg, ti = tmoe.router_weights(torch.from_numpy(rows).to(TDT[dtype]),
                                     k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-6)
    _, ti = tmoe.router_weights(torch.from_numpy(rows).to(TDT[dtype]), 3)
    assert ti[0].tolist() == [1, 2, 4] and ti[1].tolist() == [0, 1, 2]
    if dtype == "bfloat16":
        assert ti[2].tolist() == [2, 0, 1]


@pytest.mark.parametrize("experts", [1, 4, 9])
def test_expert_slots_rank_in_token_order(experts):
    """The slot of an assignment is its rank among the assignments to the
    same expert in (token, k) order: the reference's cumulative sum over
    the one-hot dispatch."""
    flat_e = np.random.default_rng(experts).integers(0, experts, 61)
    onehot = np.eye(experts, dtype=np.int64)[flat_e]
    ref_slot = (np.cumsum(onehot, axis=0) * onehot).sum(-1) - 1
    order, slot, counts = tmoe.expert_slots(torch.from_numpy(flat_e),
                                            experts)
    got = np.empty_like(ref_slot)
    got[order.numpy()] = slot.numpy()
    np.testing.assert_array_equal(got, ref_slot)
    np.testing.assert_array_equal(counts.numpy(),
                                  np.bincount(flat_e, minlength=experts))
    assert np.all(np.diff(flat_e[order.numpy()]) >= 0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["drop", "capacity", "dropless"])
@pytest.mark.parametrize("arch", MOE)
def test_moe_ffn_matches_reference(arch, mode, dtype):
    """``moe_ffn`` at a capacity factor of 0.5 (assignments are dropped),
    at the config's, and dropless."""
    t = 24
    jcfg, jp, jx, tcfg, tp, tx = _moe_inputs(arch, dtype, t)
    kw = {"drop": {"capacity_factor": 0.5}, "capacity": {},
          "dropless": {"dropless": True}}[mode]
    ref = np.asarray(jnp.asarray(jmoe.moe_ffn(jx, jp, jcfg, **kw),
                                 jnp.float32))
    out = tmoe.moe_ffn(tx, tp, tcfg, **kw)
    assert out.dtype == TDT[dtype] and tuple(out.shape) == ref.shape
    err = float(np.max(np.abs(out.to(torch.float32).numpy() - ref)))
    assert err <= TOL[dtype] * (float(np.max(np.abs(ref))) + 1.0), err
    if mode == "drop":
        _, idx = tmoe.router_weights(tx.to(torch.float32) @ tp["router"]
                                     .to(torch.float32), tcfg.moe_top_k)
        counts = np.bincount(idx.numpy().ravel(),
                             minlength=tcfg.moe_experts)
        c = tmoe.capacity(t, tcfg.moe_experts, tcfg.moe_top_k, 0.5)
        assert counts.max() > c          # some assignment was dropped


def test_moe_ffn_dropped_rows_get_zero():
    """A token whose every assignment is past capacity comes out as zeros,
    on both sides."""
    jcfg, jp, jx, tcfg, tp, tx = _moe_inputs(MOE[0], "float32", 16, seed=3)
    # every token routes to expert 0, which keeps top_k slots
    jp = dict(jp, router=jnp.zeros_like(jp["router"]).at[:, 0].set(1.0))
    tp = dict(tp, router=torch.zeros_like(tp["router"]))
    tp["router"][:, 0] = 1.0
    jx = jnp.abs(jx)
    tx = tx.abs()
    ref = np.asarray(jmoe.moe_ffn(jx, jp, jcfg, capacity_factor=0.01))
    out = tmoe.moe_ffn(tx, tp, tcfg, capacity_factor=0.01).numpy()
    c = tmoe.capacity(16, tcfg.moe_experts, tcfg.moe_top_k, 0.01)
    assert c == tcfg.moe_top_k
    assert np.all(out[c:] == 0) and np.all(ref[c:] == 0)
    np.testing.assert_allclose(out, ref, atol=2e-4 * (np.abs(ref).max() + 1))


@pytest.mark.parametrize("slots", [1, 3, 4])
@pytest.mark.parametrize("dropless", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_ffn_on_streamed_experts(slots, dropless, dtype):
    """``moe_ffn`` on a streamed layer's experts (``p["experts"]``, fetched
    after the router into an expert buffer of ``slots``, in rounds when the
    rows touch more) gives the resident layer's output bit for bit: the
    same products on the same rows, in the same order."""
    from repro_torch.serve import stream
    cfg = dataclasses.replace(get_smoke_config("kimi_k2_1t_a32b"),
                              param_dtype=str(dtype).split(".")[-1])
    layer = tfm.init_params(torch.Generator().manual_seed(3), cfg,
                            "cpu")["layers"][1]
    ls = stream.LayerStream([layer], "cpu", depth=1)
    ls.reserve_experts(slots)
    ls.issue(0, 0)
    p = ls.acquire(0, 0)["moe"]
    assert set(p) == {"router", "experts"}
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (16, cfg.d_model)).astype(np.float32)).to(dtype)
    want = tmoe.moe_ffn(x, layer["moe"], cfg, dropless=dropless)
    assert torch.equal(tmoe.moe_ffn(x, p, cfg, dropless=dropless), want)
    fetched = [e for what, _, e in ls.log if what == "expert"]
    assert fetched == sorted(set(fetched)) and len(fetched) > slots // 2
    assert ls.expert_copies == len(fetched)


@pytest.mark.parametrize("arch", MOE)
def test_moe_params_through_params_from_jax(arch):
    """The reference's MoE layers come over with ``router``, ``w_gate`` /
    ``w_up`` (E, d, ff), ``w_down`` (E, ff, d) and ``shared_mlp``, and have
    the structure, shapes and types of the port's own draw."""
    jcfg, tcfg = _cfgs(arch)
    jparams = jtfm.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    prefix, period, n_blocks = tfm.block_structure(tcfg)
    kinds = tfm.layer_kinds(tcfg)
    assert "moe" in kinds and "dense" in kinds
    d, e, ff = tcfg.d_model, tcfg.moe_experts, tcfg.moe_hidden()
    for li, (layer, kind) in enumerate(zip(tparams["layers"], kinds)):
        if li < prefix:
            ref = jax.tree.map(np.asarray, jparams["prefix"][li])
        else:
            b, slot = divmod(li - prefix, period)
            ref = jax.tree.map(lambda a: np.asarray(a[b]),
                               jparams["blocks"][slot])
        assert set(layer) == set(ref)
        if kind == "moe":
            moe = layer["moe"]
            assert tuple(moe["router"].shape) == (d, e)
            assert tuple(moe["w_gate"].shape) == (e, d, ff)
            assert tuple(moe["w_up"].shape) == (e, d, ff)
            assert tuple(moe["w_down"].shape) == (e, ff, d)
            assert "shared_mlp" in layer and "mlp" not in layer
        for path, t in jax.tree_util.tree_leaves_with_path(layer):
            want = ref
            for key in path:
                want = want[key.key]
            np.testing.assert_array_equal(t.numpy(), want)
    fresh = tfm.init_params(torch.Generator().manual_seed(0), tcfg, "cpu")
    assert (jax.tree.structure(jax.tree.map(lambda t: 0, fresh))
            == jax.tree.structure(jax.tree.map(lambda t: 0, tparams)))
    for a, b in zip(jax.tree.leaves(fresh), jax.tree.leaves(tparams)):
        assert a.shape == b.shape and a.dtype == b.dtype


@pytest.mark.parametrize("top_k", [1, 2])
def test_aux_load_balance_loss(top_k):
    rng = np.random.default_rng(top_k)
    logits = rng.normal(size=(33, 8)).astype(np.float32)
    idx = np.argsort(-logits, axis=-1)[:, :top_k].astype(np.int32)
    ref = float(jmoe.aux_load_balance_loss(jnp.asarray(logits),
                                           jnp.asarray(idx), 8))
    got = float(tmoe.aux_load_balance_loss(torch.from_numpy(logits),
                                           torch.from_numpy(idx), 8))
    assert abs(got - ref) <= 1e-6 * abs(ref)


@pytest.mark.parametrize("arch", MOE)
def test_layer_kinds_and_block_structure(arch):
    """kimi-k2: one dense prefix layer, then MoE every layer (period 1);
    llama4-maverick: no prefix, dense / MoE alternating (period 2); full
    and smoke configs as the reference has them."""
    for full in (True, False):
        tcfg = get_config(arch) if full else get_smoke_config(arch)
        jcfg = jax_config(arch) if full else jax_smoke_config(arch)
        assert tfm.layer_kinds(tcfg) == jtfm.layer_kinds(jcfg)
        assert tfm.block_structure(tcfg) == jtfm.block_structure(jcfg)
    want = {"kimi_k2_1t_a32b": (1, 1, 60),
            "llama4_maverick_400b_a17b": (0, 2, 24)}[arch]
    assert tfm.block_structure(get_config(arch)) == want


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_full_config_param_counts(arch):
    """The twin of ``tests/test_models.py::test_full_config_param_counts``:
    the port's full config counts the reference's parameters, and the
    shapes the port's ``init_params`` draws (on the meta device, nothing
    allocated) add up to what the reference's draws (``eval_shape``)."""
    tcfg, jcfg = get_config(arch), jax_config(arch)
    assert tcfg.param_count() == jcfg.param_count()
    assert tcfg.active_param_count() == jcfg.active_param_count()

    class MetaInit:
        def normal(self, shape, scale):
            return torch.empty(shape, device="meta")

        def zeros(self, shape):
            return torch.empty(shape, device="meta")

        def full(self, shape, value):
            return torch.empty(shape, device="meta")

    init = MetaInit()
    layers = [tfm.decoder_layer_params(init, tcfg, kind)
              for kind in tfm.layer_kinds(tcfg)]
    layers += [tfm.encoder_layer_params(init, tcfg)
               for _ in range(tcfg.encoder_layers)]
    total = sum(t.numel() for t in jax.tree.leaves(layers))
    total += tcfg.d_model * tcfg.vocab_size * (1 if tcfg.tie_embeddings
                                               else 2) + tcfg.d_model
    if tcfg.encoder_layers:     # enc_norm, enc_pos, dec_pos (4096 rows)
        total += tcfg.d_model * (1 + max(tcfg.encoder_seq, 1) + 4096)
    tree = jax.eval_shape(lambda: jtfm.init_params(jax.random.PRNGKey(0),
                                                   jcfg))
    assert total == sum(math.prod(leaf.shape)
                        for leaf in jax.tree.leaves(tree))


@pytest.mark.parametrize("arch", NEW)
def test_new_ids_are_known_by_every_name(arch):
    dashed = arch.replace("_", "-")
    assert get_config(dashed) == get_config(arch)
    assert get_smoke_config(arch).name == get_config(arch).name + "-smoke"
