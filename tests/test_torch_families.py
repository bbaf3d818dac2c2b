"""The four model families the ninth slice of the port adds, against the
JAX reference on the CPU: rwkv6-7b (RWKV6, recurrent state, no KV ring),
hymba-1.5b (attention with a parallel SSM branch, state beside the ring),
whisper-tiny (encoder-decoder over stub frame embeddings) and internvl2-1b
(stub patch embeddings ahead of the prompt), each at its smoke config.

The reference's ``init_params`` makes the weights; they reach the port
through ``convert.params_from_jax``.  ``jax.random`` cannot be reproduced in
PyTorch, so the reference's stub frontend arrays are carried over as they are
(``convert.tensor_from_numpy``) and handed to both sides.

Tolerances are those of ``test_torch_serve.py``: fp32 logits and cache
leaves within 2e-4 * (max|ref| + 1), bf16 within 6e-2 * (max|ref| + 1);
greedy tokens equal in fp32.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.models import transformer as jtfm
from repro.models.frontends import frontend_embeddings as jax_frontends
from repro.models.layers import AttnSpec as JaxAttnSpec
from repro.models.layers import chunked_gqa_attention
from repro.serve.engine import ServeConfig as JaxServeConfig
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro_torch import configs
from repro_torch.convert import (cache_from_jax, cache_to_numpy,
                                 params_from_jax, tensor_from_numpy)
from repro_torch.models import frontends
from repro_torch.models import transformer as tfm
from repro_torch.serve import engine as engine_mod
from repro_torch.serve.engine import ServeConfig, ServeEngine

FAMILIES = ["rwkv6_7b", "hymba_1_5b", "whisper_tiny", "internvl2_1b"]
TOL = {"float32": 2e-4, "bfloat16": 6e-2}
BATCH, PROMPT, CAP = 2, 12, 32


def _tol(dtype: str, ref: np.ndarray) -> float:
    return TOL[dtype] * (float(np.max(np.abs(ref))) + 1.0)


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _both(arch: str, dtype: str, seed: int = 0):
    """(jax cfg, jax params, port cfg, port params) on the same weights."""
    jcfg = dataclasses.replace(jax_configs.get_smoke_config(arch),
                               dtype=dtype, param_dtype=dtype)
    tcfg = dataclasses.replace(configs.get_smoke_config(arch), dtype=dtype,
                               param_dtype=dtype)
    jparams = jtfm.init_params(jax.random.PRNGKey(seed), jcfg)
    if jcfg.qkv_bias:
        # the reference's biases are zeros; draw them so that a bias the
        # port dropped or misplaced shows
        rng = np.random.default_rng(seed + 1)

        def fill(path, a):
            if path[-1].key.startswith("b_"):
                return jnp.asarray(rng.normal(size=a.shape) * 0.1, a.dtype)
            return a

        jparams = jax.tree_util.tree_map_with_path(fill, jparams)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return jcfg, jparams, tcfg, tparams


def _frontends(jcfg, batch: int):
    """The reference's stub frontend arrays, and the same arrays as
    tensors for the port."""
    jfe = jax_frontends(jcfg, batch)
    return jfe, {k: tensor_from_numpy(np.asarray(v), "cpu")
                 for k, v in jfe.items()}


def _prompts(cfg, batch: int, length: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (batch, length)).astype(np.int32)


def test_every_reference_id_resolves_to_the_same_config():
    """``get_config`` and ``get_smoke_config`` give the reference's configs
    field by field for all ten architecture ids and the five paper
    models; no id is left unported."""
    assert not hasattr(configs, "UNPORTED_ARCH_IDS")
    assert not hasattr(tfm, "_require_ported")
    ids = jax_configs.ARCH_IDS + jax_configs.PAPER_MODEL_IDS
    assert set(ids) <= set(configs.ARCH_IDS)
    for arch in ids:
        assert (dataclasses.asdict(configs.get_config(arch))
                == dataclasses.asdict(jax_configs.get_config(arch))), arch
        assert (dataclasses.asdict(configs.get_smoke_config(arch))
                == dataclasses.asdict(jax_configs.get_smoke_config(arch))), \
            arch
    for alias in ("rwkv6-7b", "hymba-1.5b", "whisper-tiny", "internvl2-1b"):
        assert configs.get_config(alias).name == alias


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_decode_and_cache_leaves(arch, dtype):
    """prefill logits, every cache leaf after prefill, and four decode
    steps' logits, function to function; greedy tokens equal in fp32."""
    jcfg, jparams, tcfg, tparams = _both(arch, dtype)
    prompts = _prompts(jcfg, BATCH, PROMPT)
    jfe, tfe = _frontends(jcfg, BATCH)
    kv = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jcache = jtfm.init_cache(jcfg, jtfm.CacheSpec(CAP, BATCH, kv_dtype=kv))
    tcache = tfm.init_cache(tcfg, tfm.CacheSpec(
        CAP, BATCH, kv_dtype=getattr(torch, dtype)), "cpu")
    assert set(tcache) == set(jcache)
    with torch.inference_mode():
        jlog, jcache = jtfm.prefill(jparams, jcfg, jnp.asarray(prompts),
                                    jcache, **jfe)
        tlog, tcache = tfm.prefill(tparams, tcfg,
                                   torch.from_numpy(prompts).long(), tcache,
                                   **tfe)
        got = cache_to_numpy(tcache)
        assert set(got) == set(jcache)
        for key, ref in jcache.items():
            ref = np.asarray(ref) if key in ("pos", "slot_pos") else _f32(ref)
            assert got[key].shape == ref.shape, key
            if key in ("pos", "slot_pos"):
                np.testing.assert_array_equal(got[key], ref)
            else:
                assert np.max(np.abs(got[key] - ref)) <= _tol(dtype, ref), key
            if key.startswith("cross_"):
                # prefill replaced init_cache's bf16 zeros with K/V in the
                # activation type, as the reference's does
                assert str(tcache[key].dtype).endswith(dtype)
                assert str(jcache[key].dtype) == dtype
        for step in range(5):
            ref = _f32(jlog)
            assert tlog.shape == ref.shape
            err = np.max(np.abs(_f32(tlog) - ref))
            assert err <= _tol(dtype, ref), (arch, dtype, step, err)
            tok = np.array(jnp.argmax(jlog[:, -1, :], axis=-1), np.int32)
            if dtype == "float32":
                np.testing.assert_array_equal(
                    torch.argmax(tlog[:, -1, :], dim=-1).numpy(), tok)
            if step == 4:
                break
            jlog, jcache = jtfm.decode_step(jparams, jcfg, jnp.asarray(tok),
                                            jcache)
            tlog, tcache = tfm.decode_step(
                tparams, tcfg, torch.from_numpy(tok).long(), tcache)
    got = cache_to_numpy(tcache)
    for key in set(jcache) - {"pos", "slot_pos"}:
        ref = _f32(jcache[key])
        assert np.max(np.abs(got[key] - ref)) <= _tol(dtype, ref), key
    assert int(got["pos"]) == int(jcache["pos"])


@pytest.mark.parametrize("arch", FAMILIES)
def test_generate_tokens_equal_reference(arch, mesh11, monkeypatch):
    """``ServeEngine.generate`` on both sides, fp32, with the reference's
    stub frontend arrays given to the port's ``generate``."""
    jcfg, jparams, tcfg, tparams = _both(arch, "float32")
    _, tfe = _frontends(jcfg, BATCH)
    monkeypatch.setattr(engine_mod, "frontend_embeddings",
                        lambda cfg, batch, **kw: tfe)
    kw = dict(batch=BATCH, cache_capacity=CAP, mode="gspmd",
              kv_dtype="float32")
    jeng = JaxServeEngine(jcfg, mesh11, jparams, JaxServeConfig(**kw))
    teng = ServeEngine(tcfg, tparams, ServeConfig(**kw), device="cpu")
    prompts = _prompts(jcfg, BATCH, 10, seed=3)
    ref = np.asarray(jeng.generate(jnp.asarray(prompts), steps=6))
    out = teng.generate(torch.from_numpy(prompts), steps=6)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_whisper_encoder_and_cross_attention_alone():
    """``_encode`` over the reference's stub frames, and one layer's
    ``_cross_attention`` (Sq 5 and Sq 1 against the encoder's E keys)
    against the reference's, fp32."""
    jcfg, jparams, tcfg, tparams = _both("whisper_tiny", "float32")
    jfe, tfe = _frontends(jcfg, BATCH)
    ref = _f32(jtfm._encode(jparams, jcfg, jfe["enc_embeds"]))
    with torch.inference_mode():
        got = tfm._encode(tparams, tcfg, tfe["enc_embeds"])
    assert got.dtype == torch.float32        # bf16 frames + fp32 positions
    assert np.max(np.abs(_f32(got) - ref)) <= _tol("float32", ref)

    rng = np.random.default_rng(7)
    hd, nkv = tcfg.resolved_head_dim, tcfg.num_kv_heads
    e = tcfg.encoder_seq
    ck = rng.normal(size=(BATCH, nkv, e, hd)).astype(np.float32)
    cv = rng.normal(size=(BATCH, nkv, e, hd)).astype(np.float32)
    jx = jax.tree.map(lambda a: a[0], jparams["blocks"][0])["xattn"]
    for s in (5, 1):
        x = rng.normal(size=(BATCH, s, tcfg.d_model)).astype(np.float32)
        ref = _f32(jtfm._cross_attention(jnp.asarray(x), jx, jcfg,
                                         jnp.asarray(ck), jnp.asarray(cv)))
        with torch.inference_mode():
            got = tfm._cross_attention(
                torch.from_numpy(x), tparams["layers"][0]["xattn"], tcfg,
                torch.from_numpy(ck), torch.from_numpy(cv))
        assert np.max(np.abs(_f32(got) - ref)) <= _tol("float32", ref), s


def test_internvl_patches_go_ahead_of_the_prompt():
    """internvl's prefill with the reference's patch embeddings: P + S
    positions in the ring, last-token logits equal to the reference's; the
    same prompt without patches gives other logits."""
    jcfg, jparams, tcfg, tparams = _both("internvl2_1b", "float32")
    jfe, tfe = _frontends(jcfg, BATCH)
    prompts = _prompts(jcfg, BATCH, 6, seed=2)
    jcache = jtfm.init_cache(jcfg, jtfm.CacheSpec(CAP, BATCH,
                                                  kv_dtype=jnp.float32))
    ref, jcache = jtfm.prefill(jparams, jcfg, jnp.asarray(prompts), jcache,
                               **jfe)
    teng = ServeEngine(tcfg, tparams, ServeConfig(
        batch=BATCH, cache_capacity=CAP, kv_dtype="float32"), device="cpu")
    logits, cache = teng.prefill(torch.from_numpy(prompts), **tfe)
    ref = _f32(ref)
    assert np.max(np.abs(_f32(logits) - ref)) <= _tol("float32", ref)
    p = tcfg.vision_patches
    assert cache["pos"] == int(jcache["pos"]) == p + 6
    np.testing.assert_array_equal(cache["slot_pos"].numpy(),
                                  np.asarray(jcache["slot_pos"]))
    bare, _ = teng.prefill(torch.from_numpy(prompts))
    assert not torch.allclose(bare, logits)


@pytest.mark.parametrize("arch", ["rwkv6_7b", "hymba_1_5b", "whisper_tiny"])
def test_cache_from_jax_carries_the_state_leaves(arch):
    """A reference cache after prefill, carried over, decodes on the port
    as the reference's does: ``rwkv_state``, ``ssm_state`` and
    ``cross_k``/``cross_v`` come with it, and an RWKV cache has no K/V
    ring."""
    jcfg, jparams, tcfg, tparams = _both(arch, "float32")
    jfe, _ = _frontends(jcfg, BATCH)
    prompts = _prompts(jcfg, BATCH, 9)
    jcache = jtfm.init_cache(jcfg, jtfm.CacheSpec(16, BATCH,
                                                  kv_dtype=jnp.float32))
    jlog, jcache = jtfm.prefill(jparams, jcfg, jnp.asarray(prompts), jcache,
                                **jfe)
    tcache = cache_from_jax(jax.tree.map(np.asarray, jcache), device="cpu")
    assert set(tcache) == set(jcache)
    assert ("k" in tcache) != tcfg.rwkv
    tok = np.array(jnp.argmax(jlog[:, -1, :], axis=-1), np.int32)
    jlog, _ = jtfm.decode_step(jparams, jcfg, jnp.asarray(tok), jcache)
    with torch.inference_mode():
        tlog, _ = tfm.decode_step(tparams, tcfg,
                                  torch.from_numpy(tok).long(), tcache)
    ref = _f32(jlog)
    assert np.max(np.abs(_f32(tlog) - ref)) <= _tol("float32", ref)


@pytest.mark.parametrize("arch", FAMILIES)
def test_converted_params_match_a_fresh_draw(arch):
    """The port's own draw has the converted tree's structure, shapes and
    types (the RWKV layer, ``ssm``, ``xattn``/``ln_x``, the encoder as a
    list, ``enc_norm``, ``enc_pos``, ``dec_pos``), and the meta-device
    draw of ``layer_shapes`` matches the layers."""
    _, _, tcfg, tparams = _both(arch, "float32")
    fresh = tfm.init_params(torch.Generator().manual_seed(0), tcfg, "cpu")
    assert (jax.tree.structure(jax.tree.map(lambda t: 0, fresh))
            == jax.tree.structure(jax.tree.map(lambda t: 0, tparams)))
    for a, b in zip(jax.tree.leaves(fresh), jax.tree.leaves(tparams)):
        assert a.shape == b.shape and a.dtype == b.dtype
    for meta, layer in zip(tfm.layer_shapes(tcfg), tparams["layers"]):
        assert ([(t.shape, t.dtype) for t in jax.tree.leaves(meta)]
                == [(t.shape, t.dtype) for t in jax.tree.leaves(layer)])
    if tcfg.encoder_layers:
        assert len(tparams["encoder"]) == tcfg.encoder_layers
        assert fresh["dec_pos"].shape == (4096, tcfg.d_model)


def test_frontend_stubs_have_the_reference_shapes():
    """Shapes, type and scale of the stubs; the same seed draws the same
    arrays, another seed others."""
    for arch, key in (("whisper_tiny", "enc_embeds"),
                      ("internvl2_1b", "embeds")):
        cfg = configs.get_config(arch)
        ref = jax_frontends(cfg, 2)[key]
        got = frontends.frontend_embeddings(cfg, 2, seed=0,
                                            device="cpu")[key]
        assert tuple(got.shape) == ref.shape
        assert got.dtype == torch.bfloat16 and str(ref.dtype) == "bfloat16"
        assert 0.015 < float(got.float().std()) < 0.025
        again = frontends.frontend_embeddings(cfg, 2, seed=0, device="cpu")
        assert torch.equal(got, again[key])
        other = frontends.frontend_embeddings(cfg, 2, seed=1, device="cpu")
        assert not torch.equal(got, other[key])
    assert frontends.frontend_embeddings(configs.get_config("rwkv6_7b"),
                                         2, device="cpu") == {}


def test_enc_dec_refuses_the_slot_path_as_the_reference():
    """whisper: no per-slot cache, ``decode_slots`` and ``chunk_prefill``
    raise the reference's ``ValueError``; prefill without frames raises."""
    cfg = configs.get_smoke_config("whisper_tiny")
    jcfg = jax_configs.get_smoke_config("whisper_tiny")
    for init in (lambda: jtfm.init_cache(jcfg, jtfm.CacheSpec(
            8, 1, per_slot=True)),
                 lambda: tfm.init_cache(cfg, tfm.CacheSpec(
                     8, 1, per_slot=True), "cpu")):
        with pytest.raises(ValueError, match="per-slot caches do not "
                           "support enc-dec"):
            init()
    params = tfm.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    cache = tfm.init_cache(cfg, tfm.CacheSpec(8, 1), "cpu")
    tok = torch.zeros((1,), dtype=torch.long)
    with pytest.raises(ValueError, match="decode_slots does not support"):
        tfm.decode_slots(params, cfg, tok, cache)
    with pytest.raises(ValueError, match="chunk_prefill does not support"):
        tfm.chunk_prefill(params, cfg, tok[None], cache)
    with pytest.raises(ValueError, match="needs enc_embeds"):
        tfm.prefill(params, cfg, tok[None], cache)


def test_cross_attention_oracle_takes_sq_not_sk():
    """The flash-attention oracle takes Sq != Sk bidirectional without
    positions (a cross-attention) and refuses it causal or windowed; it
    agrees with the reference's masked attention."""
    from repro_torch.kernels.flash_attention.ref import mha_ref
    rng = np.random.default_rng(3)
    q = rng.normal(size=(2, 6, 3, 16)).astype(np.float32)
    k = rng.normal(size=(2, 2, 11, 16)).astype(np.float32)
    v = rng.normal(size=(2, 2, 11, 16)).astype(np.float32)
    spec = JaxAttnSpec(6, 2, 16, causal=False)
    ref = _f32(chunked_gqa_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), spec,
        jnp.zeros((3,), jnp.int32), jnp.zeros((11,), jnp.int32)))
    got = mha_ref(torch.from_numpy(q), torch.from_numpy(k),
                  torch.from_numpy(v), causal=False)
    assert np.max(np.abs(_f32(got) - ref)) <= _tol("float32", ref)
    for kw in ({"causal": True}, {"causal": False, "window": 4}):
        with pytest.raises(ValueError, match="Sq 3 != Sk 11"):
            mha_ref(torch.from_numpy(q), torch.from_numpy(k),
                    torch.from_numpy(v), **kw)
