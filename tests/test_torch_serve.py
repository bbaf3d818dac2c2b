"""The first slice of the port as a whole, against the JAX reference.

The reference's ``init_params`` makes the weights; they go through numpy
into ``repro_torch.convert.params_from_jax`` so that both sides run on the
same numbers.  Prompts come from ``numpy.random.default_rng``.  Everything
runs on the CPU (the port with ``device="cpu"``, i.e. its plain path).

Tolerances: fp32 logits within 2e-4 * (max|ref| + 1), the bound the kernel
tests use for fp32 (the two frameworks sum in different orders); bf16
logits within 6e-2 * (max|ref| + 1), because bf16 rounds at different
places in the two frameworks.  Greedy tokens must be equal in fp32.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import transformer as jtfm
from repro.serve.engine import ServeConfig as JaxServeConfig
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro_torch.configs import get_smoke_config
from repro_torch.convert import (cache_from_jax, cache_to_numpy,
                                 params_from_jax)
from repro_torch.models import transformer as tfm
from repro_torch.serve.engine import ServeConfig, ServeEngine

DENSE = ["qwen3_14b", "llama2_13b", "gemma_7b", "opt_30b", "h2o_danube_1_8b"]
TOL = {"float32": 2e-4, "bfloat16": 6e-2}


def _tol(dtype: str, ref: np.ndarray) -> float:
    return TOL[dtype] * (float(np.max(np.abs(ref))) + 1.0)


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _both(arch: str, dtype: str, seed: int = 0):
    """(jax cfg, jax params, port cfg, port params) on the same weights."""
    jcfg = dataclasses.replace(jax_smoke_config(arch), dtype=dtype,
                               param_dtype=dtype)
    tcfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype,
                               param_dtype=dtype)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jparams = jtfm.init_params(jax.random.PRNGKey(seed), jcfg)
    if jcfg.qkv_bias:
        # the reference initialises biases to zero; draw them so that a
        # bias the port dropped or misplaced would show
        rng = np.random.default_rng(seed + 1)

        def fill(path, a):
            name = path[-1].key
            if name.startswith("b_"):
                return jnp.asarray(rng.normal(size=a.shape) * 0.1, a.dtype)
            return a

        jparams = jax.tree_util.tree_map_with_path(fill, jparams)
    as_numpy = jax.tree.map(np.asarray, jparams)
    tparams = params_from_jax(as_numpy, tcfg, device="cpu")
    return jcfg, jparams, tcfg, tparams


def _prompts(cfg, batch: int, length: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (batch, length)).astype(np.int32)


def _engines(arch, dtype, mesh, *, batch, capacity, kv_dtype):
    jcfg, jparams, tcfg, tparams = _both(arch, dtype)
    jeng = JaxServeEngine(jcfg, mesh, jparams, JaxServeConfig(
        batch=batch, cache_capacity=capacity, mode="gspmd",
        kv_dtype=kv_dtype))
    teng = ServeEngine(tcfg, tparams, ServeConfig(
        batch=batch, cache_capacity=capacity, mode="gspmd",
        kv_dtype=kv_dtype), device="cpu")
    return jcfg, jeng, teng


@pytest.mark.parametrize("arch", DENSE)
def test_converted_params_match_layout(arch):
    jcfg, jparams, tcfg, tparams = _both(arch, "float32")
    assert len(tparams["layers"]) == tcfg.num_layers
    for li, layer in enumerate(tparams["layers"]):
        ref = jax.tree.map(lambda a: np.asarray(a[li]), jparams["blocks"][0])
        for group in ("attn", "mlp"):
            assert set(layer[group]) == set(ref[group])
            for name, t in layer[group].items():
                np.testing.assert_array_equal(t.numpy(), ref[group][name])
    fresh = tfm.init_params(torch.Generator().manual_seed(0), tcfg, "cpu")
    assert (jax.tree.structure(jax.tree.map(lambda t: 0, fresh))
            == jax.tree.structure(jax.tree.map(lambda t: 0, tparams)))
    for a, b in zip(jax.tree.leaves(fresh), jax.tree.leaves(tparams)):
        assert a.shape == b.shape and a.dtype == b.dtype


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", DENSE)
def test_prefill_and_decode_logits(arch, dtype):
    """prefill logits and three decode_step logits, function to function."""
    jcfg, jparams, tcfg, tparams = _both(arch, dtype)
    batch, s0, cap = 2, 12, 32
    kv = jnp.float32 if dtype == "float32" else jnp.bfloat16
    prompts = _prompts(jcfg, batch, s0)
    jcache = jtfm.init_cache(jcfg, jtfm.CacheSpec(cap, batch, kv_dtype=kv))
    tcache = tfm.init_cache(tcfg, tfm.CacheSpec(
        cap, batch, kv_dtype=getattr(torch, dtype)), device="cpu")
    with torch.inference_mode():
        jlog, jcache = jtfm.prefill(jparams, jcfg, jnp.asarray(prompts),
                                    jcache)
        tlog, tcache = tfm.prefill(tparams, tcfg, torch.from_numpy(prompts)
                                   .long(), tcache)
        ref = _f32(jlog)
        assert tlog.shape == ref.shape
        assert np.max(np.abs(_f32(tlog) - ref)) <= _tol(dtype, ref)
        for step in range(3):
            # both sides decode the reference's greedy token
            tok = np.array(jnp.argmax(jlog[:, -1, :], axis=-1),
                           dtype=np.int32)
            jlog, jcache = jtfm.decode_step(jparams, jcfg, jnp.asarray(tok),
                                            jcache)
            tlog, tcache = tfm.decode_step(
                tparams, tcfg, torch.from_numpy(tok).long(), tcache)
            ref = _f32(jlog)
            err = np.max(np.abs(_f32(tlog) - ref))
            assert err <= _tol(dtype, ref), (arch, dtype, step, err)
    got = cache_to_numpy(tcache)
    assert int(got["pos"]) == int(jcache["pos"]) == s0 + 3
    np.testing.assert_array_equal(got["slot_pos"],
                                  np.asarray(jcache["slot_pos"]))
    kref = _f32(jcache["k"])
    assert np.max(np.abs(got["k"] - kref)) <= _tol(dtype, kref)


@pytest.mark.parametrize("arch", DENSE)
def test_generate_tokens_equal_reference(arch, mesh11):
    jcfg, jeng, teng = _engines(arch, "float32", mesh11, batch=2,
                                capacity=32, kv_dtype="float32")
    prompts = _prompts(jcfg, 2, 10, seed=3)
    ref = np.asarray(jeng.generate(jnp.asarray(prompts), steps=8))
    out = teng.generate(torch.from_numpy(prompts), steps=8)
    assert out.shape == (2, 18)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_generate_with_default_bf16_cache(mesh11):
    """fp32 weights with the engines' default bf16 KV cache: the cache
    rounds the same values on both sides, so tokens still agree."""
    jcfg, jeng, teng = _engines("qwen3_14b", "float32", mesh11, batch=2,
                                capacity=32, kv_dtype="bfloat16")
    prompts = _prompts(jcfg, 2, 10, seed=4)
    ref = np.asarray(jeng.generate(jnp.asarray(prompts), steps=6))
    out = teng.generate(torch.from_numpy(prompts), steps=6)
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("arch", ["qwen3_14b", "h2o_danube_1_8b"])
def test_ring_wraparound(arch, mesh11):
    """capacity < prompt + steps: decode wraps the ring, and a prompt
    longer than the ring is laid out ring-wise by prefill."""
    for s0, cap, steps in ((10, 16, 12), (20, 16, 6)):
        jcfg, jeng, teng = _engines(arch, "float32", mesh11, batch=2,
                                    capacity=cap, kv_dtype="float32")
        prompts = _prompts(jcfg, 2, s0, seed=5)
        ref = np.asarray(jeng.generate(jnp.asarray(prompts), steps=steps))
        out = teng.generate(torch.from_numpy(prompts), steps=steps)
        np.testing.assert_array_equal(out.numpy(), ref)


def test_prefill_ring_layout_matches_reference():
    """A prompt longer than the ring: K/V rows and slot tags land where
    the reference puts them (position p at slot p % C)."""
    jcfg, jparams, tcfg, tparams = _both("llama2_13b", "float32")
    prompts = _prompts(jcfg, 1, 21)
    jcache = jtfm.init_cache(jcfg, jtfm.CacheSpec(8, 1, kv_dtype=jnp.float32))
    _, jcache = jtfm.prefill(jparams, jcfg, jnp.asarray(prompts), jcache)
    tcache = tfm.init_cache(tcfg, tfm.CacheSpec(8, 1, kv_dtype=torch.float32),
                            device="cpu")
    with torch.inference_mode():
        _, tcache = tfm.prefill(tparams, tcfg,
                                torch.from_numpy(prompts).long(), tcache)
    got = cache_to_numpy(tcache)
    np.testing.assert_array_equal(got["slot_pos"],
                                  np.asarray(jcache["slot_pos"]))
    for key in ("k", "v"):
        ref = _f32(jcache[key])
        assert np.max(np.abs(got[key] - ref)) <= _tol("float32", ref)


def test_cache_from_jax_roundtrip():
    """A reference cache carried over continues as the port's own."""
    jcfg, jparams, tcfg, tparams = _both("qwen3_14b", "float32")
    prompts = _prompts(jcfg, 2, 9)
    jcache = jtfm.init_cache(jcfg, jtfm.CacheSpec(16, 2,
                                                  kv_dtype=jnp.float32))
    jlog, jcache = jtfm.prefill(jparams, jcfg, jnp.asarray(prompts), jcache)
    tcache = cache_from_jax(jax.tree.map(np.asarray, jcache), device="cpu")
    assert tcache["pos"] == 9 and tcache["k"].dtype == torch.float32
    tok = np.array(jnp.argmax(jlog[:, -1, :], axis=-1), dtype=np.int32)
    jlog, _ = jtfm.decode_step(jparams, jcfg, jnp.asarray(tok), jcache)
    with torch.inference_mode():
        tlog, _ = tfm.decode_step(tparams, tcfg,
                                  torch.from_numpy(tok).long(), tcache)
    ref = _f32(jlog)
    assert np.max(np.abs(_f32(tlog) - ref)) <= _tol("float32", ref)


@pytest.mark.parametrize("steps", [0, 1, 2])
def test_generate_lengths(steps):
    tcfg = get_smoke_config("qwen3_14b")
    params = tfm.init_params(torch.Generator().manual_seed(0), tcfg, "cpu")
    eng = ServeEngine(tcfg, params, ServeConfig(batch=2, cache_capacity=16),
                      device="cpu")
    prompts = torch.from_numpy(_prompts(tcfg, 2, 5))
    out = eng.generate(prompts, steps=steps)
    assert out.shape == (2, 5 + steps)
    assert torch.equal(out[:, :5], prompts)
    if steps == 0:
        assert out is prompts
    assert int(out.min()) >= 0 and int(out.max()) < tcfg.vocab_size


def test_decode_updates_cache_in_place():
    """The counterpart of donation: a decode step writes into the cache
    tensors it was given and allocates no new ones."""
    tcfg = get_smoke_config("llama2_13b")
    params = tfm.init_params(torch.Generator().manual_seed(0), tcfg, "cpu")
    eng = ServeEngine(tcfg, params, ServeConfig(batch=2, cache_capacity=8),
                      device="cpu")
    logits, cache = eng.prefill(torch.from_numpy(_prompts(tcfg, 2, 5)))
    ptrs = {k: cache[k].data_ptr() for k in ("k", "v", "slot_pos")}
    tok = torch.argmax(logits[:, -1, :], dim=-1)
    for step in range(6):      # wraps the ring of 8 after 3 steps
        before = cache["k"].clone()
        logits, cache2 = eng.decode(tok, cache)
        assert cache2 is cache
        assert {k: cache[k].data_ptr() for k in ptrs} == ptrs
        changed = (cache["k"] != before).any(dim=-1)      # (L, B, Hkv, C)
        slot = (5 + step) % 8
        assert changed[..., slot].all()
        assert not changed[..., [c for c in range(8) if c != slot]].any()
        assert int(cache["slot_pos"][slot]) == 5 + step
        tok = torch.argmax(logits[:, -1, :], dim=-1)
    assert cache["pos"] == 11


def test_argmax_breaks_ties_to_first_index():
    """Greedy parity needs ``torch.argmax`` to pick the first maximal
    index, as ``jnp.argmax`` does."""
    rows = np.zeros((4, 300), np.float32)
    rows[0, [7, 200]] = 3.0
    rows[1, [299, 0]] = 1.0
    rows[2, :] = -1.0
    rows[3, [150, 151, 152]] = 2.0
    want = np.asarray(jnp.argmax(jnp.asarray(rows), axis=-1))
    np.testing.assert_array_equal(want, [7, 0, 0, 150])
    for dtype in (torch.float32, torch.bfloat16):
        got = torch.argmax(torch.from_numpy(rows).to(dtype), dim=-1)
        np.testing.assert_array_equal(got.numpy(), want)


def test_unported_parts_raise_and_name_the_roadmap():
    tcfg = get_smoke_config("qwen3_14b")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tfm.init_cache(tcfg, tfm.CacheSpec(8, 1, per_slot=True), "cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tfm.init_cache(tcfg, tfm.CacheSpec(8, 1, kv_dtype=torch.int8), "cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ServeEngine(tcfg, {}, ServeConfig(1, 8, mode="elk_stream"), "cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        get_smoke_config("rwkv6-7b")
    with pytest.raises(KeyError):
        get_smoke_config("no-such-model")
    moe = dataclasses.replace(tcfg, moe_experts=4)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tfm.init_params(torch.Generator().manual_seed(0), moe, "cpu")
