"""The tenth slice of the port: the int8 KV cache, on the CPU.

The reference's quantized serving cache (``kv_dtype`` int8: one bf16 scale
a slot and kv head, ``k_scale``/``v_scale``) against the port's, on
converted weights, inputs made from seeds through numpy:

* ``quantize_kv``/``dequantize_kv`` equal the reference's ``_quantize_kv``/
  ``_dequantize_kv`` bit for bit, ties at .5 and all-zero rows among them;
* ``quantize_into`` with the rope tables (K rotated inside the quantizing
  launch on the card) equals the reference's ``apply_rope``, then
  ``_quantize_kv`` and its scatter, bit for bit;
* the cache leaves ``k``, ``v``, ``k_scale``, ``v_scale`` after ``prefill``,
  ``decode_step``, ``decode_slots`` and ``chunk_prefill`` in fp32 equal the
  reference's exactly on qwen3; on hymba, whose fp32 K and V already differ
  from the reference's in their last bits (its products and its SSM scan sum
  in another order), within one quantization step on at most 0.5 % of the
  elements and one bf16 step of a scale;
* greedy tokens equal through every entry point: lock-step, the slot path,
  the continuous batcher, the oversubscribed batcher with spills and a
  prefix hit (K = 1 against K = 2), ``elk_stream`` against resident, and
  the launcher;
* the attention kernels' plain versions with ``kv_scales`` equal the same
  plain versions on the ring dequantized by the reference, and the Pallas
  kernels in interpret mode on it within the attention tests' tolerance;
* the wrappers' int8 plans (routes, tilings that fit the budget) and the
  constants of the CUDA sources.
"""

import dataclasses
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.kernels.decode_attention.kernel import \
    decode_attention as pallas_decode_attention
from repro.kernels.flash_attention.ref import mha_ref as jax_mha_ref
from repro.models import layers as jlayers
from repro.models import transformer as jtfm
from repro.serve.batcher import ContinuousBatcher as JaxBatcher
from repro.serve.batcher import make_trace as jax_make_trace
from repro.serve.engine import ServeConfig as JaxServeConfig
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro_torch.configs import get_smoke_config
from repro_torch.convert import (cache_from_jax, cache_to_numpy,
                                 params_from_jax, tensor_from_numpy)
from repro_torch.kernels.decode_attention import kernel as dk
from repro_torch.kernels.decode_attention.ref import (
    decode_attention_ref, decode_attention_split_ref)
from repro_torch.kernels.flash_attention import kernel as fk
from repro_torch.kernels.flash_attention.ref import (mha_pos_ref,
                                                     mha_pos_split_ref)
from repro_torch.kernels.kv_quant.kernel import (_rope_tables,
                                                 kv_quant_kernel,
                                                 kv_scale_pointers)
from repro_torch.kernels.kv_quant.ops import quantize_into
from repro_torch.kernels.kv_quant.ref import dequantize_kv, quantize_kv
from repro_torch.models import transformer as tfm
from repro_torch.serve.batcher import ContinuousBatcher, Request, make_trace
from repro_torch.serve.engine import (ServeConfig, ServeEngine,
                                      kv_ring_bytes)
from repro_torch.serve.prefix import PrefixStore

CSRC = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
        / "kernels" / "csrc")
B, PROMPT, CAP = 2, 12, 32
# the attention tests' bounds: fp32 within 2e-4 * (max|ref| + 1); against
# the Pallas kernels in interpret mode, which sum in blocks
ATTN_TOL = 2e-4


def _both(arch: str, seed: int = 0):
    """(jax cfg, jax params, port cfg, port params), fp32, same weights."""
    jcfg = dataclasses.replace(jax_smoke_config(arch), dtype="float32",
                               param_dtype="float32")
    tcfg = dataclasses.replace(get_smoke_config(arch), dtype="float32",
                               param_dtype="float32")
    jparams = jtfm.init_params(jax.random.PRNGKey(seed), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return jcfg, jparams, tcfg, tparams


def _prompts(cfg, batch: int, length: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (batch, length)).astype(np.int32)


def _np(a) -> np.ndarray:
    """A reference leaf as numpy: int8 as int8, bf16 scales widened to
    float32 (exactly), the rest as it is."""
    a = jnp.asarray(a)
    return np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16
                      else a)


# ---------------------------------------------------------------------------
# quantization
# ---------------------------------------------------------------------------

def _tie_rows() -> np.ndarray:
    """Rows whose elements land on .5 exactly: amax 127 (scale 1) and 254
    (scale 2), both signs; an all-zero row; a row of one element."""
    rows = np.zeros((4, 8), np.float32)
    rows[0] = [0.5, 1.5, 2.5, -0.5, -2.5, 126.5, -127.0, 3.5]
    rows[1] = [1.0, 3.0, 5.0, -1.0, -7.0, 254.0, 0.0, 9.0]
    rows[3, 5] = -3.0
    return rows


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_equals_reference_bit_for_bit(dtype):
    """Random rows (B, Hkv, S, D) and the tie rows, in fp32 and bf16: the
    same int8 values and bf16 scales; ties round half to even."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2, 3, 5, 64)) * 3).astype(np.float32)
    ties = _tie_rows()
    for a in (x, ties):
        ja = jnp.asarray(a, getattr(jnp, dtype))
        ta = tensor_from_numpy(np.asarray(ja), "cpu")
        jq, js = jtfm._quantize_kv(ja)
        tq, ts = quantize_kv(ta)
        assert tq.dtype == torch.int8 and ts.dtype == torch.bfloat16
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.float().numpy(), _np(js))
    tq, ts = quantize_kv(torch.from_numpy(ties))
    assert tq[0].tolist() == [0, 2, 2, 0, -2, 126, -127, 4]
    assert tq[1].tolist() == [0, 2, 2, 0, -4, 127, 0, 4]
    assert not tq[2].any()
    assert float(ts[2, 0]) == float(torch.tensor(1e-6 / 127).bfloat16())


def test_dequantize_kv_equals_reference_bit_for_bit():
    rng = np.random.default_rng(1)
    q = rng.integers(-127, 128, (2, 3, 7, 64)).astype(np.int8)
    s = jnp.asarray(rng.random((2, 3, 7, 1)) * 0.05, jnp.bfloat16)
    ref = jtfm._dequantize_kv(jnp.asarray(q), s)
    got = dequantize_kv(torch.from_numpy(q), tensor_from_numpy(
        np.asarray(s), "cpu"))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), _np(ref))


@pytest.mark.parametrize("positions", ["int", "rows"])
def test_quantize_into_writes_rows_and_scales(positions):
    """The plain scatter the CPU runs: each new row and its scale land at
    slot position % C of its row's ring, nothing else moves."""
    rng = np.random.default_rng(2)
    b, h, c, d = 2, 3, 16, 32
    t = 1 if positions == "int" else 4
    k_new = torch.from_numpy(rng.standard_normal((b, h, t, d)).astype(
        np.float32))
    v_new = torch.from_numpy(rng.standard_normal((b, t, h, d)).astype(
        np.float32)).transpose(1, 2)
    ring = [torch.full((b, h, c, d), 7, dtype=torch.int8) for _ in range(2)]
    sc = [torch.full((b, h, c, 1), 3.0, dtype=torch.bfloat16)
          for _ in range(2)]
    pos = 21 if positions == "int" else torch.tensor(
        [[30, 31, 32, 33], [5, 6, 7, 8]], dtype=torch.int32)
    quantize_into(k_new, v_new, *ring, *sc, pos)
    pos_t = (torch.full((b, 1), 21) if positions == "int" else pos).long()
    for new, r, s in ((k_new, ring[0], sc[0]), (v_new, ring[1], sc[1])):
        q, qs = quantize_kv(new)
        for bi in range(b):
            slots = (pos_t[bi] % c).tolist()
            assert torch.equal(r[bi][:, slots], q[bi])
            assert torch.equal(s[bi][:, slots], qs[bi])
            rest = [j for j in range(c) if j not in slots]
            assert (r[bi][:, rest] == 7).all() and (s[bi][:, rest] == 3).all()


def test_kv_quant_kernel_refuses_the_cpu():
    """The kernel wrapper never gives way to the plain version."""
    z = torch.zeros(1, 1, 1, 8)
    ring = torch.zeros(1, 1, 4, 8, dtype=torch.int8)
    sc = torch.zeros(1, 1, 4, 1, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        kv_quant_kernel(z, z, ring, ring, sc, sc, 0)
    assert kv_quant_kernel.launches == 0


def _reference_scatter(ring, scales, q, s, positions):
    """The reference's writes of quantized rows (B, H, T, D) and their
    scales into a ring: ``dynamic_update_slice_in_dim`` at one position's
    slot, or its ``.at[rows, :, slots, :].set`` scatter for (B, T)."""
    c = ring.shape[2]
    if isinstance(positions, int):
        slot = positions % c
        return (jax.lax.dynamic_update_slice_in_dim(ring, q, slot, axis=2),
                jax.lax.dynamic_update_slice_in_dim(scales, s, slot, axis=2))
    rows = jnp.arange(ring.shape[0])[:, None]
    slots = jnp.asarray(positions) % c
    return tuple(buf.at[rows, :, slots, :].set(
        val.astype(buf.dtype).transpose(0, 2, 1, 3), unique_indices=True)
        for buf, val in ((ring, q), (scales, s)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("positions", ["int", "rows"])
def test_rope_and_quantize_equal_reference_bit_for_bit(dtype, positions):
    """``quantize_into`` with the rope tables (its plain version: the port's
    ``apply_rope`` on K, then ``quantize_kv`` and the scatter) against the
    reference's ``layers.apply_rope``, ``_quantize_kv`` and its scatter on
    the same numpy rows and tables: the same int8 ring and bf16 scales.
    One position for every row (T 1, tables (1, D/2)) and (B, T) positions
    (tables (B, T, D/2)); V through the strides of a (B, T, Hkv, D)
    projection; a token whose tables are sin 0, cos 1 (position 0) carries
    rows whose rotated elements fall on .5 exactly, another sin 1, cos 0."""
    rng = np.random.default_rng(11)
    b, h, c, d = 2, 3, 16, 40
    t = 1 if positions == "int" else 4
    k = (rng.standard_normal((b, h, t, d)) * 3).astype(np.float32)
    v = (rng.standard_normal((b, t, h, d)) * 3).astype(np.float32)
    ties = _tie_rows()
    k[0, :2, 0, :8], k[0, :2, 0, d // 2:d // 2 + 8] = ties[:2], -ties[:2]
    ang = rng.uniform(0, 200, (1 if positions == "int" else b, t, d // 2))
    sin, cos = np.sin(ang).astype(np.float32), np.cos(ang).astype(np.float32)
    sin[0, 0], cos[0, 0] = 0.0, 1.0
    if positions == "rows":
        sin[1, 1], cos[1, 1] = 1.0, 0.0
        pos = np.asarray([[30, 31, 32, 33], [5, 6, 7, 8]], np.int32)
        tables = (sin, cos)
    else:
        pos, tables = 21, (sin[0], cos[0])
    jdt = getattr(jnp, dtype)
    jk = jlayers.apply_rope(jnp.asarray(k, jdt), *map(jnp.asarray, tables))
    jv = jnp.asarray(v, jdt).transpose(0, 2, 1, 3)
    ring0 = np.full((b, h, c, d), 7, np.int8)
    sc0 = jnp.full((b, h, c, 1), 3.0, jnp.bfloat16)
    want = []
    for new in (jk, jv):
        q, s_ = jtfm._quantize_kv(new)
        want += _reference_scatter(jnp.asarray(ring0), sc0, q, s_, pos)
    tk = tensor_from_numpy(np.asarray(jnp.asarray(k, jdt)), "cpu")
    tv = tensor_from_numpy(np.asarray(jnp.asarray(v, jdt)),
                           "cpu").transpose(1, 2)
    rings = [torch.from_numpy(ring0.copy()) for _ in range(2)]
    scs = [torch.full((b, h, c, 1), 3.0, dtype=torch.bfloat16)
           for _ in range(2)]
    tpos = pos if positions == "int" else torch.from_numpy(pos)
    quantize_into(tk, tv, rings[0], rings[1], scs[0], scs[1], tpos,
                  *map(torch.from_numpy, tables))
    got = [rings[0], scs[0], rings[1], scs[1]]
    for name, g, w in zip(("k", "k_scale", "v", "v_scale"), got, want):
        np.testing.assert_array_equal(g.float().numpy(), _np(w),
                                      err_msg=name)
    # the tie rows: rotated by sin 0, cos 1 they are themselves (scales 1
    # and 2), and round half to even as quantize_kv's own tie test
    slot = (21 if positions == "int" else 30) % c
    assert rings[0][0, 0, slot, :8].tolist() == [0, 2, 2, 0, -2, 126, -127, 4]
    assert rings[0][0, 1, slot, :8].tolist() == [0, 2, 2, 0, -4, 127, 0, 4]


def test_rope_tables_of_the_kernel():
    """The strides the kernel gets for the tables ``apply_rope`` takes:
    (1, D/2) for every row, (T, D/2) for every batch row, (B, T, D/2) a
    token each; the pair refused unless both are fp32 of one shape that
    broadcasts to (B, T, D/2), and on an odd head dim."""
    one = torch.zeros(1, 8)
    assert _rope_tables(None, None, 2, 1, 16, one.device) == (None, None,
                                                              0, 0)
    assert _rope_tables(one, one, 4, 1, 16, one.device)[2:] == (0, 0)
    per_t = torch.zeros(5, 8)
    assert _rope_tables(per_t, per_t, 4, 5, 16, one.device)[2:] == (0, 8)
    per_bt = torch.zeros(3, 5, 8)
    assert _rope_tables(per_bt, per_bt, 3, 5, 16, one.device)[2:] == (40, 8)
    for bad, match in (((one, None), "both"), ((one.double(), one), "float32"),
                       ((one, torch.zeros(1, 1, 8)), "one"),
                       ((per_t, per_t), "broadcast")):
        with pytest.raises(ValueError, match=match):
            _rope_tables(*bad, 4, 2, 16, one.device)
    with pytest.raises(ValueError, match="even head dim"):
        _rope_tables(one, one, 1, 1, 15, one.device)


def test_kv_scale_pointers_check_the_pairing():
    ring = torch.zeros(1, 2, 4, 8, dtype=torch.int8)
    bf = torch.zeros(1, 2, 4, 8, dtype=torch.bfloat16)
    sc = torch.zeros(1, 2, 4, 1, dtype=torch.bfloat16)
    assert kv_scale_pointers(bf, None) == (None, None)
    with pytest.raises(ValueError, match="takes no kv_scales"):
        kv_scale_pointers(bf, (sc, sc))
    with pytest.raises(ValueError, match="needs its kv_scales"):
        kv_scale_pointers(ring, None)
    with pytest.raises(ValueError, match="contiguous bf16"):
        kv_scale_pointers(ring, (sc.float(), sc))
    assert kv_scale_pointers(ring, (sc, sc)) == (sc.data_ptr(),
                                                 sc.data_ptr())


# ---------------------------------------------------------------------------
# the cache leaves against the reference's
# ---------------------------------------------------------------------------

def _assert_leaves(arch: str, got: dict, ref: dict, where: str) -> None:
    """k, v, k_scale, v_scale (and the tags, positions) of the port's cache
    against the reference's: exact on qwen3; on hymba within one step of
    int8 on at most 0.5 % of the elements and one bf16 step of a scale
    (the module's docstring says why)."""
    got = cache_to_numpy(got)
    assert got["k"].dtype == np.int8 and got["v"].dtype == np.int8
    for key in ("pos", "slot_pos", "k", "v", "k_scale", "v_scale"):
        r, g = _np(ref[key]), got[key]
        assert g.shape == r.shape, (where, key)
        if key in ("pos", "slot_pos") or arch == "qwen3_14b":
            np.testing.assert_array_equal(g, r, err_msg=f"{where} {key}")
            continue
        diff = np.abs(g.astype(np.float32) - r.astype(np.float32))
        if key in ("k", "v"):
            assert diff.max() <= 1 and (diff > 0).mean() <= 5e-3, (where, key)
        else:
            assert np.all(diff <= np.abs(r) * 2 ** -7), (where, key)


@pytest.mark.parametrize("arch", ["qwen3_14b", "hymba_1_5b"])
def test_lockstep_int8_leaves_and_tokens_equal_reference(arch):
    """prefill, then decode_step after decode_step (past the ring's end):
    every int8 leaf after every call, and the greedy tokens."""
    jcfg, jparams, tcfg, tparams = _both(arch)
    prompts = _prompts(jcfg, B, PROMPT)
    jc = jtfm.init_cache(jcfg, jtfm.CacheSpec(16, B, kv_dtype=jnp.int8))
    tc = tfm.init_cache(tcfg, tfm.CacheSpec(16, B, kv_dtype=torch.int8),
                        "cpu")
    assert set(tc) == set(jc)
    with torch.inference_mode():
        jl, jc = jtfm.prefill(jparams, jcfg, jnp.asarray(prompts), jc)
        tl, tc = tfm.prefill(tparams, tcfg, torch.from_numpy(prompts).long(),
                             tc)
        for step in range(8):
            _assert_leaves(arch, tc, jc, f"step {step}")
            tok = np.array(jnp.argmax(jl[:, -1, :], axis=-1), np.int32)
            np.testing.assert_array_equal(
                torch.argmax(tl[:, -1, :], dim=-1).numpy(), tok)
            jl, jc = jtfm.decode_step(jparams, jcfg, jnp.asarray(tok), jc)
            tl, tc = tfm.decode_step(tparams, tcfg,
                                     torch.from_numpy(tok).long(), tc)


@pytest.mark.parametrize("arch", ["qwen3_14b", "hymba_1_5b"])
def test_slot_path_int8_leaves_and_tokens_equal_reference(arch):
    """chunk_prefill in chunks of 5 into a per-slot cache, rows at their
    own positions, then decode_slots: every int8 leaf after every call (a
    chunk attends its own quantized rows), and the greedy tokens."""
    jcfg, jparams, tcfg, tparams = _both(arch)
    prompts = _prompts(jcfg, B, 15, seed=4)
    spec = dict(capacity=CAP, batch=B, per_slot=True)
    jc = jtfm.init_cache(jcfg, jtfm.CacheSpec(kv_dtype=jnp.int8, **spec))
    tc = tfm.init_cache(tcfg, tfm.CacheSpec(kv_dtype=torch.int8, **spec),
                        "cpu")
    with torch.inference_mode():
        for off in range(0, 15, 5):
            chunk = prompts[:, off:off + 5]
            jl, jc = jtfm.chunk_prefill(jparams, jcfg, jnp.asarray(chunk),
                                        jc)
            tl, tc = tfm.chunk_prefill(tparams, tcfg,
                                       torch.from_numpy(chunk).long(), tc)
            _assert_leaves(arch, tc, jc, f"chunk at {off}")
        for step in range(6):
            tok = np.array(jnp.argmax(jl[:, -1, :], axis=-1), np.int32)
            np.testing.assert_array_equal(
                torch.argmax(tl[:, -1, :], dim=-1).numpy(), tok)
            jl, jc = jtfm.decode_slots(jparams, jcfg, jnp.asarray(tok), jc)
            tl, tc = tfm.decode_slots(tparams, tcfg,
                                      torch.from_numpy(tok).long(), tc)
            _assert_leaves(arch, tc, jc, f"slot step {step}")


def test_int8_kv_cache_close_to_bf16():
    """Twin of the reference's test (``tests/test_models.py``): bf16 smoke
    qwen3, prefill of 9 tokens into a ring of 16, one decode step; the int8
    cache's logits within rel 0.15 of the bf16 cache's."""
    cfg = get_smoke_config("qwen3_14b")
    params = tfm.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    tokens = torch.from_numpy(_prompts(cfg, 2, 10, seed=5)).long()
    outs = {}
    with torch.inference_mode():
        for dt in (torch.bfloat16, torch.int8):
            cache = tfm.init_cache(cfg, tfm.CacheSpec(16, 2, kv_dtype=dt),
                                   "cpu")
            _, cache = tfm.prefill(params, cfg, tokens[:, :9], cache)
            outs[dt], _ = tfm.decode_step(params, cfg, tokens[:, 9], cache)
    a, b = outs[torch.bfloat16].float(), outs[torch.int8].float()
    rel = float((a - b).abs().max()) / (float(a.abs().max()) + 1e-9)
    assert 0 < rel < 0.15, f"int8 KV cache too lossy: {rel}"


def test_int8_kv_slot_path_runs():
    """Twin of the reference's ``test_int8_kv_slot_path_runs``."""
    cfg = get_smoke_config("qwen3_14b")
    eng = ServeEngine(cfg, tfm.init_params(torch.Generator().manual_seed(0),
                                           cfg, "cpu"),
                      ServeConfig(batch=2, cache_capacity=64,
                                  prefill_chunk=8, kv_dtype="int8"),
                      device="cpu")
    reqs = [Request(0, np.arange(6, dtype=np.int32), 4),
            Request(1, np.arange(9, dtype=np.int32), 2)]
    out = ContinuousBatcher(eng).run(reqs)
    assert sorted(c.rid for c in out) == [0, 1]
    for c in out:
        assert c.tokens.shape == (c.prompt_len + (4 if c.rid == 0 else 2),)
    assert eng.slot_cache["k"].dtype == torch.int8
    assert eng.slot_cache["k_scale"].dtype == torch.bfloat16


def test_init_cache_int8_leaves():
    """int8 rings with bf16 scales (L, B, Hkv, C, 1) of zeros; rwkv gets
    neither (no ring), hymba both beside its SSM state, whisper's cross
    K/V stay bf16."""
    spec = tfm.CacheSpec(8, 2, kv_dtype=torch.int8)
    for arch, want in (("rwkv6_7b", {"pos", "rwkv_state"}),
                       ("hymba_1_5b", {"pos", "k", "v", "k_scale", "v_scale",
                                       "slot_pos", "ssm_state"}),
                       ("whisper_tiny", {"pos", "k", "v", "k_scale",
                                         "v_scale", "slot_pos", "cross_k",
                                         "cross_v"})):
        cfg = get_smoke_config(arch)
        cache = tfm.init_cache(cfg, spec, "cpu")
        assert set(cache) == want, arch
        ref = jtfm.init_cache(jax_smoke_config(arch), jtfm.CacheSpec(
            8, 2, kv_dtype=jnp.int8))
        assert set(ref) == want, arch
        for key, t in cache.items():
            if key != "pos":
                assert tuple(t.shape) == ref[key].shape, (arch, key)
                assert str(t.dtype).split(".")[1] == str(ref[key].dtype), \
                    (arch, key)
        if "k" in cache:
            assert not cache["k_scale"].any()


def test_convert_round_trips_the_scales():
    """A reference int8 cache through ``cache_from_jax``: int8 stays int8,
    the scales come bf16 bit for bit; and back through ``cache_to_numpy``
    and ``cache_from_jax`` unchanged."""
    jcfg, jparams, tcfg, _ = _both("qwen3_14b")
    jc = jtfm.init_cache(jcfg, jtfm.CacheSpec(16, B, kv_dtype=jnp.int8))
    _, jc = jtfm.prefill(jparams, jcfg, jnp.asarray(_prompts(jcfg, B, 9)), jc)
    tc = cache_from_jax(jax.tree.map(np.asarray, jc), device="cpu")
    assert tc["k"].dtype == torch.int8
    assert tc["k_scale"].dtype == torch.bfloat16
    for key in ("k", "v", "k_scale", "v_scale"):
        np.testing.assert_array_equal(
            cache_to_numpy(tc)[key], _np(jc[key]), err_msg=key)
    again = cache_from_jax(cache_to_numpy(tc), device="cpu")
    for key in ("k", "v", "k_scale", "v_scale", "slot_pos"):
        assert again[key].dtype == tc[key].dtype
        assert torch.equal(again[key], tc[key]), key


def test_ring_bytes_are_what_a_spill_moves():
    """``kv_ring_bytes`` (which counts the scales) equals the bytes
    ``offload_slot`` copies, int8 and bf16."""
    cfg = get_smoke_config("qwen3_14b")
    params = tfm.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    for kv in ("int8", "bfloat16"):
        eng = ServeEngine(cfg, params, ServeConfig(
            batch=2, cache_capacity=CAP, kv_dtype=kv), device="cpu")
        state = eng.offload_slot(0)
        moved = sum(t.numel() * t.element_size() for t in state.values())
        assert moved == eng.slot_state_bytes() == kv_ring_bytes(
            cfg, CAP, kv), kv
    assert kv_ring_bytes(cfg, CAP, "int8") < kv_ring_bytes(cfg, CAP,
                                                            "bfloat16")


# ---------------------------------------------------------------------------
# serving paths
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen3_14b", "hymba_1_5b"])
def test_batcher_int8_tokens_equal_reference(arch, mesh11):
    """The port's ContinuousBatcher against the reference's, int8 cache,
    chunks of 4 into rings of 32: tokens per request and finish order."""
    jcfg, jparams, tcfg, tparams = _both(arch)
    kw = dict(batch=2, cache_capacity=CAP, prefill_chunk=4, kv_dtype="int8")
    tkw = dict(vocab_size=tcfg.vocab_size, prompt_lens=(5, 9, 6, 12),
               max_new=(3, 6, 4, 8), seed=1)
    ref = JaxBatcher(JaxServeEngine(jcfg, mesh11, jparams,
                                    JaxServeConfig(**kw))).run(
        jax_make_trace(6, **tkw))
    got = ContinuousBatcher(ServeEngine(tcfg, tparams, ServeConfig(**kw),
                                        device="cpu")).run(make_trace(6, **tkw))
    assert [c.rid for c in got] == [c.rid for c in ref]
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.tokens, b.tokens, err_msg=a.rid)


def test_oversubscribed_int8_equal_tokens_at_k1_and_k2():
    """Spills copy the int8 rows and the scales unchanged, and a prefix
    snapshot carries them: the same trace (a shared system prompt on half
    the requests) gives the same tokens at K = 1 and at K = 2 with a prefix
    store, which spills and hits."""
    cfg = get_smoke_config("qwen3_14b")
    params = tfm.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    kw = dict(batch=2, cache_capacity=CAP, prefill_chunk=4, kv_dtype="int8")
    tkw = dict(vocab_size=cfg.vocab_size, prompt_lens=(5, 9, 6, 12),
               max_new=(3, 6, 4, 8), sys_prompt_len=8, sys_prompt_frac=0.5,
               seed=0)
    runs = {}
    for k in (1.0, 2.0):
        eng = ServeEngine(cfg, params, ServeConfig(**kw), device="cpu")
        bat = ContinuousBatcher(
            eng, oversub=k, prefix_store=PrefixStore(4 << 20) if k > 1
            else None, swap_after=2)
        runs[k] = ({c.rid: c.tokens for c in bat.run(make_trace(8, **tkw))},
                   bat)
    (one, _), (two, bat) = runs[1.0], runs[2.0]
    assert bat.spill_events and bat.prefix_hits > 0
    assert sorted(one) == sorted(two) == list(range(8))
    for rid in one:
        np.testing.assert_array_equal(one[rid], two[rid], err_msg=rid)
    snaps = [state for _, _, state in bat.prefix._entries.values()]
    assert snaps and all(s["k"].dtype == torch.int8
                         and s["k_scale"].dtype == torch.bfloat16
                         for s in snaps)


@pytest.mark.parametrize("arch", ["qwen3_14b", "hymba_1_5b"])
def test_elk_stream_int8_equals_resident(arch):
    """Streamed layers get their scale slices: elk_stream tokens and last
    logits equal resident bit for bit, lock-step and through the batcher."""
    cfg = get_smoke_config(arch)
    params = tfm.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    prompts = torch.from_numpy(_prompts(cfg, 2, 10, seed=6))
    outs, done = {}, {}
    for mode in ("gspmd", "elk_stream"):
        eng = ServeEngine(cfg, params, ServeConfig(
            batch=2, cache_capacity=16, mode=mode, prefetch_depth=1,
            prefill_chunk=4, kv_dtype="int8"), device="cpu")
        outs[mode] = eng.generate(prompts, steps=8)
        done[mode] = {c.rid: c.tokens for c in ContinuousBatcher(eng).run(
            make_trace(4, vocab_size=cfg.vocab_size, seed=2))}
    assert torch.equal(outs["gspmd"], outs["elk_stream"])
    for rid, toks in done["gspmd"].items():
        np.testing.assert_array_equal(toks, done["elk_stream"][rid])


def test_lockstep_and_chunked_int8_tokens_differ_by_design():
    """A one-shot prefill attends the unquantized K/V, a chunk the
    dequantized ring, its own rows included: the two first tokens' logits
    differ (the reference's behaviour), while each equals its reference
    run (the tests above)."""
    cfg = get_smoke_config("qwen3_14b")
    params = tfm.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    prompt = torch.from_numpy(_prompts(cfg, 1, 12, seed=7)).long()
    with torch.inference_mode():
        lock, _ = tfm.prefill(params, cfg, prompt, tfm.init_cache(
            cfg, tfm.CacheSpec(16, 1, kv_dtype=torch.int8), "cpu"))
        chunked, _ = tfm.chunk_prefill(params, cfg, prompt, tfm.init_cache(
            cfg, tfm.CacheSpec(16, 1, kv_dtype=torch.int8, per_slot=True),
            "cpu"))
    assert not torch.equal(lock, chunked)
    rel = float((lock - chunked).float().abs().max()) / float(
        lock.float().abs().max())
    assert rel < 0.15


@pytest.mark.parametrize("mode", ["gspmd", "elk_stream"])
def test_launcher_serves_int8(mode, capsys):
    """``--kv-dtype int8`` serves smoke qwen3-14b on the CPU under both
    modes, lock-step and through the batcher."""
    from repro_torch.launch import serve
    base = ["--arch", "qwen3-14b", "--smoke", "--device", "cpu",
            "--kv-dtype", "int8", "--mode", mode]
    serve.main(base + ["--batch", "2", "--steps", "4", "--cache", "64"])
    out = capsys.readouterr().out
    assert "generated 4 tokens x 2 requests" in out
    assert ("ELK scheduler: prefetch_depth=" in out) == (mode == "elk_stream")
    serve.main(base + ["--trace", "4", "--cache", "64", "--batch", "2"])
    assert "continuous:" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        serve.main(base + ["--kv-dtype", "float16"])


# ---------------------------------------------------------------------------
# the attention kernels' plain versions over an int8 ring
# ---------------------------------------------------------------------------

def _int8_ring(rng, b, hkv, c, d):
    """An int8 ring and its bf16 scales quantized by the reference, as
    numpy, and the reference's dequantized bf16 ring."""
    k = jnp.asarray(rng.standard_normal((b, hkv, c, d)), jnp.float32)
    v = jnp.asarray(rng.standard_normal((b, hkv, c, d)), jnp.float32)
    (kq, ks), (vq, vs) = jtfm._quantize_kv(k), jtfm._quantize_kv(v)
    deq = (jtfm._dequantize_kv(kq, ks), jtfm._dequantize_kv(vq, vs))
    to_t = [tensor_from_numpy(np.asarray(a), "cpu")
            for a in (kq, vq, ks, vs) + deq]
    return to_t[:2], tuple(to_t[2:4]), tuple(to_t[4:]), deq


@pytest.mark.parametrize("qdtype", ["float32", "bfloat16"])
def test_decode_oracles_over_int8_equal_dequantize_then_attend(qdtype):
    """``decode_attention_ref`` and ``decode_attention_split_ref`` with
    ``kv_scales``: equal to themselves on the reference's dequantized ring,
    and within tolerance of the Pallas kernel (interpret mode) on it; a
    row with no live slot gives zeros."""
    rng = np.random.default_rng(8)
    b, hq, hkv, c, d, pos = 3, 8, 2, 128, 32, 70
    (kq, vq), scales, (kd, vd), jdeq = _int8_ring(rng, b, hkv, c, d)
    q = torch.from_numpy(rng.standard_normal((b, hq, d)).astype(
        np.float32)).to(getattr(torch, qdtype))
    slot_pos = torch.where(torch.arange(c) < pos + 1, torch.arange(c),
                           tfm.POS_SENTINEL).to(torch.int32)
    got = decode_attention_ref(q, kq, vq, slot_pos, pos, kv_scales=scales)
    assert torch.equal(got, decode_attention_ref(q, kd, vd, slot_pos, pos))
    for splits in (1, 3):
        for route in ("mma", "fma"):
            split = decode_attention_split_ref(
                q, kq, vq, slot_pos, pos, splits=splits, route=route,
                kv_scales=scales)
            np.testing.assert_allclose(split.float().numpy(),
                                       got.float().numpy(), rtol=1e-5,
                                       atol=1e-5 if qdtype == "float32"
                                       else 8e-3)
    jq = jnp.asarray(q.float().numpy(), getattr(jnp, qdtype))
    ref = np.asarray(pallas_decode_attention(
        jq, jdeq[0].astype(jq.dtype), jdeq[1].astype(jq.dtype),
        jnp.asarray(slot_pos.numpy()), pos, bk=64,
        interpret=True).astype(jnp.float32))
    tol = (ATTN_TOL if qdtype == "float32" else 8e-3) * (
        np.abs(ref).max() + 1)
    assert np.abs(got.float().numpy() - ref).max() <= tol
    dead = torch.full((c,), tfm.POS_SENTINEL, dtype=torch.int32)
    assert not decode_attention_ref(q, kq, vq, dead, pos,
                                    kv_scales=scales).any()


def test_flash_oracles_over_int8_equal_dequantize_then_attend():
    """``mha_pos_ref`` and ``mha_pos_split_ref`` with ``kv_scales`` on a
    chunk against an int8 ring: equal to themselves on the reference's
    dequantized ring, within tolerance of the reference's oracle on it."""
    rng = np.random.default_rng(9)
    b, hq, hkv, c, d, t, off = 1, 8, 2, 64, 32, 12, 20
    (kq, vq), scales, (kd, vd), jdeq = _int8_ring(rng, b, hkv, c, d)
    q = torch.from_numpy(rng.standard_normal((b, hq, t, d)).astype(
        np.float32))
    q_pos = (off + torch.arange(t, dtype=torch.int32))[None]
    k_pos = torch.where(torch.arange(c) < off + t, torch.arange(c),
                        tfm.POS_SENTINEL).to(torch.int32)[None]
    got = mha_pos_ref(q, kq, vq, q_pos, k_pos, kv_scales=scales)
    assert torch.equal(got, mha_pos_ref(q, kd, vd, q_pos, k_pos))
    for splits in (1, 2):
        split = mha_pos_split_ref(q, kq, vq, q_pos, k_pos, splits=splits,
                                  kv_scales=scales)
        np.testing.assert_allclose(split.numpy(), got.numpy(), rtol=1e-5,
                                   atol=1e-5)
    # the reference's oracle over the whole ring (positions 0..C-1 fill
    # it): the chunk's rows are the last t queries of a causal prefill
    full_k_pos = torch.arange(c, dtype=torch.int32)[None]
    qf = torch.from_numpy(rng.standard_normal((b, hq, c, d)).astype(
        np.float32))
    mine = mha_pos_ref(qf, kq, vq, full_k_pos, full_k_pos, kv_scales=scales)
    ref = np.asarray(jax_mha_ref(jnp.asarray(qf.numpy()),
                                 jdeq[0].astype(jnp.float32),
                                 jdeq[1].astype(jnp.float32), causal=True))
    assert np.abs(mine.numpy() - ref).max() <= ATTN_TOL * (
        np.abs(ref).max() + 1)


# ---------------------------------------------------------------------------
# the int8 plans of the wrappers and the sources
# ---------------------------------------------------------------------------

def test_int8_routes_and_tilings():
    """An int8 ring takes route "mma" with a bf16 query at the head dims
    of MMA_HEAD_DIMS, "fma" otherwise; flash attention "wgmma" / "mma_sync"
    with a bf16 query, "fma" with an fp32 one.  Every int8 tiling fits the
    budget the bf16 one is held to, two blocks an SM on route "mma" at
    every head dim (no per-warp rows of dequantized slots beside the
    ring), and the int8 ring takes at least the bf16 one's stages: at D
    128 four to its two."""
    def t(dtype, *shape):
        return torch.empty(shape, dtype=dtype)
    bf, f32, i8 = torch.bfloat16, torch.float32, torch.int8
    assert dk.route_of(t(bf, 2, 8, 128), t(i8, 2, 2, 64, 128)) == "mma"
    assert dk.route_of(t(bf, 2, 8, 40), t(i8, 2, 2, 64, 40)) == "fma"
    assert dk.route_of(t(f32, 2, 8, 128), t(i8, 2, 2, 64, 128)) == "fma"
    assert fk.route_of(t(bf, 1, 8, 4, 128), t(i8, 1, 2, 64, 128)) == "wgmma"
    assert fk.route_of(t(bf, 1, 8, 4, 72), t(i8, 1, 8, 64, 72)) == "mma_sync"
    assert fk.route_of(t(f32, 1, 8, 4, 128), t(i8, 1, 2, 64, 128)) == "fma"
    budget2 = dk.SM_BYTES // 2 - dk.BLOCK_RESERVE
    for d in (16, 32, 64, 72, 80, 96, 112, 128, 256):
        for g in (1, 4, 5, 8):
            bk, stages = dk.tiling(g, d, 1)
            assert bk in dk.TILE_SLOTS and 3 <= stages <= dk.MAX_STAGES
            assert dk.smem_bytes(dk.maxg_for(g), d, bk, stages, 1) <= budget2
    for d in dk.MMA_HEAD_DIMS:
        bk, stages = dk.tiling(5, d, 1, "mma")
        assert bk == 64 and stages in (2, 4)
        assert dk.smem_bytes(dk.MAX_GROUP, d, bk, stages, 1) <= budget2
        assert stages >= dk.tiling(5, d, 2, "mma")[1]
    assert dk.tiling(5, 128, 1, "mma") == (64, 4)
    assert dk.tiling(5, 128, 2, "mma") == (64, 2)


def test_int8_chunk_split_plan():
    """Route "wgmma" plans one design of WG_ROWS rows a block over an int8
    ring as over bf16: at the serving chunks (qwen3-14b's G 5, kimi-k2's G
    8) the blocks of a chunk of 256 cover the SMs unsplit, and a chunk of
    32 or 64 is split among a cluster's blocks until they do."""
    assert fk.WG_ROWS == 64
    assert fk.plan_splits(1, 8, 256, 2048, 5) == (20, 1)
    assert fk.plan_splits(1, 8, 256, 2048, 8) == (32, 1)
    assert fk.plan_splits(1, 8, 32, 2048, 5) == (3, 6)
    assert fk.plan_splits(1, 8, 32, 700, 5) == (3, 6)
    assert fk.plan_splits(1, 8, 64, 2048, 8) == (8, 3)


def test_int8_instances_are_in_the_sources():
    """Both attention sources compile an int8 instance of every route and
    take kv dtype 2; the decode source's mma instances are one list for
    both cache types; every route converts int8 by the one byte-permute
    helper of hopper_gemm.cuh (no integer conversion); flash's "wgmma"
    instances bring a tile's scales by bulk copies and convert V while
    S = Q K^T runs and the next K while O += P V runs, starting S at
    scale-d 0; the kv_quant source divides IEEE round to nearest and
    rotates K as apply_rope, each product and sum rounded on its own, in
    instances of their own."""
    dec = (CSRC / "decode_attention.cu").read_text()
    for d in dk.MMA_HEAD_DIMS:
        assert f"case {d}: return F<KV, 8, 1, {d}>" in dec
    assert "DECODE_MMA_INSTANCE(prepare, int8_t, d)" in dec
    assert "DECODE_MMA_INSTANCE(launch, int8_t, d, p, s)" in dec
    assert "prepare_t<int8_t>(g, d)" in dec
    # the forward's "mma_sync" / "fma" source and its "wgmma" one
    fl = "".join((CSRC / name).read_text() for name in (
        "flash_attention.cu", "flash_attention_wgmma.cu"))
    for d in fk.WGMMA_INT8_HEAD_DIMS:
        assert f"case {d}: return launch_wgmma<{d}, true>" in fl
        assert f"allow_smem(flash_attention_wgmma_kernel<{d}, true>" in fl
    for d in fk.MMA_SYNC_HEAD_DIMS:
        assert f"case {d}: return launch_mma<{d}, true>" in fl
        assert f"allow_smem(flash_attention_mma_kernel<{d}, true>" in fl
    assert "launch_fma<bf16, true>" in fl
    assert re.search(r"STAGES = D == 64 \? 4 : 2;", fl)
    # the conversion: one helper, a byte permute and a subtraction, shared
    # by decode ("mma": i8f, deq_pair8; "fma": deq) and flash (dequant8)
    hg = (CSRC / "hopper_gemm.cuh").read_text()
    assert ("__fsub_rn(__uint_as_float(__byte_perm(wx, 0x4B000000u, "
            "0x7540 + i)), 8388736.0f)") in hg
    assert "__fmul_rn(i8f(w ^ 0x80808080u, i), scale)" in hg
    assert "deq_pair8(i8f(x0, 0), scale, i8f(x0, 1), scale)" in hg
    assert "static_cast<int>(w <<" not in hg
    for src in (dec, fl):
        assert "float i8f(" not in src and "cp.async.bulk.shared" not in src
    assert "using hg::i8f;" in dec and "using hg::deq_pair8;" in dec
    # flash "wgmma" over int8: scales by two bulk copies beside the TMA
    # boxes (the lanes only where bulk_tile refuses), one bf16 K and one V
    # tile, V converted while S runs, the next K while O += P V runs
    wg = (CSRC / "flash_attention_wgmma.cu").read_text()
    assert ("hg::bulk_copy(sc16 + 2 * s * kWgBK, a.k_scale + si, 2 * kWgBK, "
            "&full[s]);") in wg
    assert ("hg::bulk_copy(sc16 + (2 * s + 1) * kWgBK, a.v_scale + si, "
            "2 * kWgBK, &full[s]);") in wg
    assert "hg::dequant8(raw[j].x, raw[j].y, scale[j])" in wg
    assert not re.search(r"\bsc_s\b", wg) and "__ldg(a.k_scale" not in wg
    assert "hg::wgmma_m64n64<0>(sc, dq, dk, Q8 && kk == 0 ? 0 : 1);" in wg
    assert re.search(r"hg::wgmma_commit\(\);\s*(//[^\n]*\n\s*)*"
                     r"if constexpr \(Q8\) \{\s*convert\(1, s\);"
                     r"[^}]*\}\s*\}\s*hg::wgmma_wait<0>\(\);", wg)
    assert re.search(r"wgmma_pv<D>\(o, pf\[j\], dv\);\s*\}\s*"
                     r"hg::wgmma_commit\(\);\s*if constexpr \(Q8\) \{"
                     r"[^}]*convert\(0, s1\);\s*\}\s*"
                     r"hg::wgmma_wait<0>\(\);", wg)
    assert "RING = STAGES * STAGE_BYTES + (Q8 ? 2 * KV_BYTES : 0)" in wg
    # one design for both types: a block of kWgRows rows, one consumer
    # warpgroup and the producer warp
    assert "__launch_bounds__(kWgThreads, WgTile<D>::MIN_BLOCKS)" in wg
    assert "static constexpr int Q_BYTES = kWgRows * DP * 2;" in wg
    kvq = (CSRC / "kv_quant.cu").read_text()
    assert "__fdiv_rn(x[i], scale)" in kvq and "rintf" in kvq
    assert "__fdiv_rn(fmaxf(amax, 1e-6f), 127.0f)" in kvq
    assert "__fsub_rn(__fmul_rn(v, c), __fmul_rn(other, s))" in kvq
    assert "__fadd_rn(__fmul_rn(v, c), __fmul_rn(other, s))" in kvq
    assert "v = __bfloat162float(__float2bfloat16_rn(v));" in kvq
    # the rope a compile-time instance: rows without it run the loop as
    # before it was folded in
    for t in ("bf16", "float"):
        for rope in ("true", "false"):
            assert f"kv_quant_kernel<{t}, {rope}><<<" in kvq


# ---------------------------------------------------------------------------
# route "mma" over an int8 ring: fragments from the int8 bytes in registers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", dk.MMA_HEAD_DIMS)
def test_mma_int8_permutations_are_bijections(d):
    """``k_perm`` and ``v_perm`` are permutations of the KS k16 steps'
    16 KS dims; a lane's K elements of every step are one run of 4 KS
    bytes of a slot row (4 bytes a step), its V^T rows over every m tile
    one run of 2 KS bytes; every dim below d is read."""
    ks = -(-d // 16)
    kp, vp = dk.k_perm(d), dk.v_perm(d)
    assert sorted(kp) == list(range(16 * ks)) == sorted(vp)
    for tig in range(4):
        # mma.sync m16n8k16: lane tig holds k 2 tig, 2 tig + 1 (bytes 0, 1)
        # and 2 tig + 8, 2 tig + 9 (bytes 2, 3) of each step
        dims = [kp[16 * kk + j] for kk in range(ks)
                for j in (2 * tig, 2 * tig + 1, 2 * tig + 8, 2 * tig + 9)]
        assert dims == list(range(4 * ks * tig, 4 * ks * (tig + 1)))
    for gid in range(8):
        dims = [vp[16 * mt + r] for mt in range(ks) for r in (gid, gid + 8)]
        assert dims == list(range(2 * ks * gid, 2 * ks * (gid + 1)))


def test_int8_byte_permute_is_exact():
    """The kernel's int8 -> fp32 without an integer conversion: the byte,
    its sign bit flipped, as the mantissa of 2^23, less 2^23 + 128, is the
    int8's value for all 256 of them; times a bf16 scale and rounded to
    bf16 it equals the reference's ``_dequantize_kv``."""
    q = np.arange(-128, 128, dtype=np.int8)
    bits = (q.view(np.uint8).astype(np.uint32) ^ 0x80) | 0x4B000000
    exact = bits.view(np.float32) - np.float32(8388736.0)
    assert np.array_equal(exact, q.astype(np.float32))
    scales = jnp.asarray([[0.0078125], [0.013], [3.1e-3], [1.7]],
                         jnp.bfloat16)
    for row in range(scales.shape[0]):
        sc = np.asarray(scales[row].astype(jnp.float32))
        mine = (torch.from_numpy(exact * sc)).to(torch.bfloat16)
        ref = jtfm._dequantize_kv(jnp.asarray(q), scales[row])
        assert np.array_equal(mine.float().numpy(),
                              np.asarray(ref.astype(jnp.float32)))


def _permuted_decode(q, kq, vq, scales, slot_pos, pos, d):
    """The int8 "mma" route's arithmetic in fp32: the ring dequantized as
    the kernel does, S = K Q^T over the 16 KS dims read under k_perm (K's
    bytes past d arbitrary, the query's zeros), O^T's rows under v_perm,
    written back to the dims they stand for."""
    ks = -(-d // 16)
    b, hq, _ = q.shape
    hkv, c = kq.shape[1], kq.shape[2]
    g = hq // hkv
    pad = 16 * ks - d
    gen = np.random.default_rng(5)
    junk = lambda a: torch.cat([a, torch.from_numpy(gen.integers(
        -128, 128, a.shape[:-1] + (pad,)).astype(np.int8))], -1)
    kd = junk(kq).float() * scales[0].float()
    vd = junk(vq).float() * scales[1].float()
    kd, vd = kd.to(torch.bfloat16).float(), vd.to(torch.bfloat16).float()
    qf = torch.cat([q.float(), torch.zeros(b, hq, pad)], -1)
    kp, vp = torch.tensor(dk.k_perm(d)), torch.tensor(dk.v_perm(d))
    kd = kd.repeat_interleave(g, 1)[..., kp]            # (b, hq, c, 16 ks)
    vd = vd.repeat_interleave(g, 1)[..., vp]
    s = torch.einsum("bhcj,bhj->bhc", kd, qf[..., kp]) * d ** -0.5
    live = (slot_pos <= pos)[None, None, :]
    s = torch.where(live, s, torch.tensor(-torch.inf))
    p = torch.softmax(s, -1)
    ot = torch.einsum("bhc,bhcr->bhr", p, vd)           # rows of O^T
    out = torch.zeros(b, hq, 16 * ks)
    out[..., vp] = ot
    return out[..., :d]


@pytest.mark.parametrize("d", [64, 72, 128, 256])
def test_mma_int8_contraction_under_permutations_equals_reference(d):
    """A numpy/PyTorch contraction of an int8 K and V dequantized under
    ``k_perm`` and ``v_perm`` with the query permuted as K (what route
    "mma" computes over an int8 ring, up to the order of its sums) equals
    ``decode_attention_ref`` over the same ring and the reference's int8
    decode (its dequantized ring through the Pallas kernel in interpret
    mode), fp32 within the attention tests' bound."""
    rng = np.random.default_rng(9)
    b, hq, hkv, c, pos = 2, 8, 2, 96, 70
    (kq, vq), scales, _, jdeq = _int8_ring(rng, b, hkv, c, d)
    q = torch.from_numpy(rng.standard_normal((b, hq, d)).astype(
        np.float32)).to(torch.bfloat16)
    slot_pos = torch.where(torch.arange(c) < pos + 1, torch.arange(c),
                           tfm.POS_SENTINEL).to(torch.int32)
    got = _permuted_decode(q, kq, vq, scales, slot_pos, pos, d)
    want = decode_attention_ref(q.float(), kq, vq, slot_pos, pos,
                                kv_scales=scales)
    tol = ATTN_TOL * (float(want.abs().max()) + 1)
    assert float((got - want.float()).abs().max()) <= tol
    ref = np.asarray(pallas_decode_attention(
        jnp.asarray(q.float().numpy()), jdeq[0].astype(jnp.float32),
        jdeq[1].astype(jnp.float32), jnp.asarray(slot_pos.numpy()), pos,
        bk=32, interpret=True))
    assert np.abs(got.numpy() - ref).max() <= ATTN_TOL * (
        np.abs(ref).max() + 1)
