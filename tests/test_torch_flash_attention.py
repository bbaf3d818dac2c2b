"""Flash attention of the port against the JAX reference, on the CPU.

The CUDA kernel (``csrc/flash_attention.cu``) runs only on the card and is
held to ``mha_ref`` / ``mha_pos_ref`` there by ``chip_smoke.py``.  Here the
same numpy inputs go through the port's oracles and through the reference's
oracle, its Pallas kernel in interpret mode, and the model's masked
``gqa_attention`` (what the reference's ``_self_attention_slots`` computes
for a chunk), so that the oracles the card compares against are pinned to
the TPU kernel they replace and to the model path they stand in for.  Then
the model wired to the flash ops, against the JAX model.

Tolerances: against the Pallas kernel and the JAX oracle the kernel tests'
``TOL`` (fp32 2e-4, bf16 6e-2, times max|ref| + 1); against the model's
attention in fp32 1e-5 * (max|ref| + 1) (same arithmetic, another order);
model logits as in ``test_torch_serve.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.kernels.flash_attention.kernel import \
    flash_attention as pallas_flash_attention
from repro.kernels.flash_attention.ref import mha_ref as jax_mha_ref
from repro.models import layers as jl
from repro.models import transformer as jtfm
from repro_torch.configs import get_smoke_config
from repro_torch.convert import cache_from_jax, params_from_jax
from repro_torch.kernels.flash_attention.kernel import flash_attention_kernel
from repro_torch.kernels.flash_attention.ops import flash_attn, flash_attn_pos
from repro_torch.kernels.flash_attention.ref import mha_pos_ref, mha_ref
from repro_torch.models import transformer as tfm

TOL = {"float32": 2e-4, "bfloat16": 6e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
SENTINEL = 2 ** 30

# (B, Hq, Hkv, S, D, causal, window): the cases of the reference's kernel test
CASES = [
    (2, 4, 2, 128, 32, True, 0),       # GQA causal
    (1, 4, 4, 128, 16, True, 48),      # MHA sliding window
    (1, 2, 1, 64, 32, False, 0),       # bidirectional MQA
    (1, 8, 8, 256, 64, True, 0),       # MHA causal, bigger head
]


def _inputs(b, hq, hkv, sq, sk, d, dtype: str, seed: int = 0):
    rng = np.random.default_rng(seed)
    arrays = [rng.normal(size=(b, hq, sq, d)), rng.normal(size=(b, hkv, sk, d)),
              rng.normal(size=(b, hkv, sk, d))]
    arrays = [a.astype(np.float32) for a in arrays]
    return ([jnp.asarray(a, JDT[dtype]) for a in arrays],
            [torch.from_numpy(a).to(TDT[dtype]) for a in arrays])


def _err(out: torch.Tensor, ref) -> tuple[float, float]:
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    got = out.to(torch.float32).numpy()
    assert got.shape == ref.shape
    return float(np.max(np.abs(got - ref))), float(np.max(np.abs(ref))) + 1.0


def _ring(c: int, start: int, t: int) -> tuple[np.ndarray, np.ndarray]:
    """(chunk positions (T,), ring tags (C,)) of a chunk of ``t`` tokens at
    ``start`` whose own tokens are tagged already: position p at slot
    p % C, unwritten slots at the sentinel."""
    end = start + t
    idx = np.arange(c)
    if end <= c:
        tags = np.where(idx < end, idx, SENTINEL)
    else:
        first = end - c
        tags = first + (idx - first) % c
    return (np.arange(start, end, dtype=np.int32), tags.astype(np.int32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES)
def test_ref_matches_jax_oracle_and_pallas_kernel(case, dtype):
    """``mha_ref`` against the reference's oracle and against the Pallas
    kernel in interpret mode (the TPU kernel the CUDA one replaces)."""
    b, hq, hkv, s, d, causal, win = case
    (jq, jk, jv), (tq, tk, tv) = _inputs(b, hq, hkv, s, s, d, dtype)
    out = mha_ref(tq, tk, tv, causal=causal, window=win)
    assert out.dtype == TDT[dtype]
    for ref in (jax_mha_ref(jq, jk, jv, causal=causal, window=win),
                pallas_flash_attention(jq, jk, jv, causal=causal, window=win,
                                       bq=32, bk=32, interpret=True)):
        err, scale = _err(out, ref)
        assert err <= TOL[dtype] * scale, (case, dtype, err)


@pytest.mark.parametrize("case", CASES)
def test_positioned_oracle_with_arange_is_mha_ref(case):
    """The Pallas signature (positions arange(S), Sq == Sk) is the special
    case of ``mha_pos_ref``."""
    b, hq, hkv, s, d, causal, win = case
    _, (q, k, v) = _inputs(b, hq, hkv, s, s, d, "float32", seed=1)
    pos = torch.arange(s, dtype=torch.int32)[None].expand(b, s)
    torch.testing.assert_close(
        mha_pos_ref(q, k, v, pos, pos, causal=causal, window=win),
        mha_ref(q, k, v, causal=causal, window=win), rtol=0, atol=0)


@pytest.mark.parametrize("window", [0, 24])
def test_positioned_oracle_matches_model_attention(window):
    """Per-row chunk positions against per-row ring tags (row 0 part-filled,
    row 1 wrapped, row 2 evicted): what the reference's
    ``_self_attention_slots`` computes for a chunk through its per-row mask
    and ``gqa_attention``."""
    b, hq, hkv, t, c, d = 3, 8, 2, 12, 48, 32
    rows = [_ring(c, 20, t), _ring(c, 70, t), _ring(c, 0, t)]
    q_pos = np.stack([r[0] for r in rows])
    tags = np.stack([r[1] for r in rows])
    tags[2] = SENTINEL
    (jq, jk, jv), (tq, tk, tv) = _inputs(b, hq, hkv, t, c, d, "float32", 2)
    spec = jl.AttnSpec(hq, hkv, d, sliding_window=window)
    ok = tags[:, None, :] <= q_pos[:, :, None]
    if window:
        ok &= tags[:, None, :] > q_pos[:, :, None] - window
    bias = jnp.where(jnp.asarray(ok), 0.0, -jnp.inf).astype(jnp.float32)
    ref = jl.gqa_attention(jq, jk, jv, bias[:, None, None], spec)
    out = mha_pos_ref(tq, tk, tv, torch.from_numpy(q_pos),
                      torch.from_numpy(tags), window=window)
    err, scale = _err(out, ref)
    assert err <= 1e-5 * scale, err
    assert not out[2].any()


@pytest.mark.parametrize("causal", [True, False])
def test_fully_masked_rows_give_zeros(causal):
    """A query with no attendable key gives zeros (the Pallas kernel's
    -1e30 fill would give the mean of V there)."""
    _, (q, k, v) = _inputs(2, 4, 2, 8, 32, 16, "float32", seed=3)
    q_pos = torch.arange(8, dtype=torch.int32)[None].expand(2, 8)
    k_pos = torch.full((2, 32), SENTINEL, dtype=torch.int32)
    out = mha_pos_ref(q, k, v, q_pos, k_pos, causal=True, window=0)
    assert out.shape == q.shape and not out.any()
    # a window that excludes every key does the same, causal or not
    k_pos = torch.full((2, 32), -100, dtype=torch.int32)
    out = mha_pos_ref(q, k, v, q_pos, k_pos, causal=causal, window=4)
    assert not out.any()


def test_ops_take_the_plain_version_on_cpu():
    """On CPU tensors the ops run the oracles and launch nothing; the
    kernel's own wrapper refuses a CPU tensor instead of giving way."""
    _, (q, k, v) = _inputs(1, 4, 2, 20, 20, 16, "bfloat16", seed=4)
    before = flash_attention_kernel.launches
    torch.testing.assert_close(flash_attn(q, k, v, window=8),
                               mha_ref(q, k, v, window=8), rtol=0, atol=0)
    pos = torch.arange(20, dtype=torch.int32)[None]
    torch.testing.assert_close(flash_attn_pos(q, k, v, pos, pos),
                               mha_pos_ref(q, k, v, pos, pos), rtol=0,
                               atol=0)
    assert flash_attention_kernel.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_kernel(q, k, v)


def _both(arch: str, dtype: str):
    jcfg = dataclasses.replace(jax_smoke_config(arch), dtype=dtype,
                               param_dtype=dtype)
    tcfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype,
                               param_dtype=dtype)
    jparams = jtfm.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return jcfg, jparams, tcfg, tparams


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["qwen3_14b", "h2o_danube_1_8b"])
def test_wired_model_matches_reference(arch, dtype):
    """The model with its attention on the flash ops: a prefill of a ragged
    prompt longer than the sliding window and the ring (cache 16, prompt
    27), and chunked prefill that wraps the ring (chunks of 8, 8, 4 after a
    prefix of 9), logits against the JAX model's."""
    jcfg, jparams, tcfg, tparams = _both(arch, dtype)
    tol = TOL[dtype]
    kv = JDT[dtype]
    rng = np.random.default_rng(5)
    prompts = rng.integers(0, jcfg.vocab_size, (2, 27)).astype(np.int32)
    with torch.inference_mode():
        jcache = jtfm.init_cache(jcfg, jtfm.CacheSpec(16, 2, kv_dtype=kv))
        tcache = tfm.init_cache(tcfg, tfm.CacheSpec(
            16, 2, kv_dtype=TDT[dtype]), device="cpu")
        jlog, _ = jtfm.prefill(jparams, jcfg, jnp.asarray(prompts), jcache)
        tlog, _ = tfm.prefill(tparams, tcfg, torch.from_numpy(prompts).long(),
                              tcache)
        ref = _f32(jlog)
        assert np.max(np.abs(_f32(tlog) - ref)) <= tol * (
            np.max(np.abs(ref)) + 1.0)

        jcache = jtfm.init_cache(jcfg, jtfm.CacheSpec(16, 1, kv_dtype=kv,
                                                      per_slot=True))
        tcache = cache_from_jax(jax.tree.map(np.asarray, jcache), "cpu")
        off = 0
        for t in (9, 8, 8, 2):
            chunk = prompts[:1, off:off + t]
            jlog, jcache = jtfm.chunk_prefill(jparams, jcfg,
                                              jnp.asarray(chunk), jcache)
            tlog, tcache = tfm.chunk_prefill(tparams, tcfg,
                                             torch.from_numpy(chunk), tcache)
            ref = _f32(jlog)
            err = np.max(np.abs(_f32(tlog) - ref))
            assert err <= tol * (np.max(np.abs(ref)) + 1.0), (arch, t, err)
            off += t
    np.testing.assert_array_equal(tcache["slot_pos"].numpy(),
                                  np.asarray(jcache["slot_pos"]))
