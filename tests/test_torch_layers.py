"""Each function of the port's ``models/layers.py`` against its JAX
counterpart, on the same numpy inputs, on the CPU.

Tolerances: fp32 1e-5 * (max|ref| + 1) (same arithmetic, different
summation order and transcendental implementations); bf16 6e-2 *
(max|ref| + 1) (bf16 rounds at different places in the two frameworks).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import layers as jl
from repro_torch.configs import get_smoke_config
from repro_torch.models import layers as tl

TOL = {"float32": 1e-5, "bfloat16": 6e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
DTYPES = ["float32", "bfloat16"]


def _pair(a: np.ndarray, dtype: str):
    return jnp.asarray(a, JDT[dtype]), torch.from_numpy(a).to(TDT[dtype])


def _normal(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _close(out: torch.Tensor, ref, dtype: str):
    assert out.dtype == TDT[dtype]
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    assert tuple(out.shape) == ref.shape
    got = out.to(torch.float32).numpy()
    assert np.isfinite(got).all()
    err = float(np.max(np.abs(got - ref)))
    assert err <= TOL[dtype] * (float(np.max(np.abs(ref))) + 1.0), err


@pytest.mark.parametrize("dtype", DTYPES)
def test_rms_norm_scales_by_one_plus_scale(dtype):
    rng = np.random.default_rng(0)
    jx, tx = _pair(_normal(rng, 3, 5, 64), dtype)
    js, ts = _pair(_normal(rng, 64) * 0.5, dtype)
    _close(tl.rms_norm(tx, ts, 1e-6), jl.rms_norm(jx, js, 1e-6), dtype)
    # a zero scale is the identity gain, not a zero output
    unit = tl.rms_norm(tx, torch.zeros(64, dtype=TDT[dtype]))
    assert float(unit.to(torch.float32).abs().max()) > 0.5


@pytest.mark.parametrize("dtype", DTYPES)
def test_layer_norm(dtype):
    rng = np.random.default_rng(1)
    jx, tx = _pair(_normal(rng, 4, 48) * 3 + 1, dtype)
    js, ts = _pair(_normal(rng, 48), dtype)
    jb, tb = _pair(_normal(rng, 48), dtype)
    _close(tl.layer_norm(tx, ts, tb), jl.layer_norm(jx, js, jb), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", ["silu", "gelu", "relu"])
def test_activations(name, dtype):
    a = np.linspace(-6, 6, 257, dtype=np.float32)
    jx, tx = _pair(a, dtype)
    _close(tl._act(name)(tx), jl._act(name)(jx), dtype)


def test_gelu_is_the_tanh_form():
    x = torch.tensor([-2.0, -0.5, 0.7, 3.0])
    tanh_form = 0.5 * x * (1 + torch.tanh(
        0.7978845608028654 * (x + 0.044715 * x ** 3)))
    assert torch.allclose(tl._act("gelu")(x), tanh_form, atol=1e-6)
    assert not torch.allclose(tl._act("gelu")(x),
                              torch.nn.functional.gelu(x), atol=1e-5)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("batched", [False, True])
def test_rope_split_halves(batched, dtype):
    rng = np.random.default_rng(2)
    b, h, s, d = 2, 3, 7, 16
    pos = (rng.integers(0, 500, (b, s)) if batched
           else np.arange(s) + 40).astype(np.int32)
    jsin, jcos = jl.rope_tables(jnp.asarray(pos), d, 10_000.0)
    tsin, tcos = tl.rope_tables(torch.from_numpy(pos), d, 10_000.0)
    _close(tsin, jsin, "float32")
    _close(tcos, jcos, "float32")
    jx, tx = _pair(_normal(rng, b, h, s, d), dtype)
    _close(tl.apply_rope(tx, tsin, tcos), jl.apply_rope(jx, jsin, jcos),
           dtype)
    # halves, not interleaved pairs: element 0 pairs with element d/2
    one = torch.zeros(1, 1, 1, d)
    one[..., 0] = 1.0
    sin, cos = tl.rope_tables(torch.tensor([1]), d, 10_000.0)
    rot = tl.apply_rope(one, sin, cos)[0, 0, 0]
    assert abs(float(rot[d // 2]) - float(np.sin(1.0))) < 1e-6
    assert float(rot[1]) == 0.0


@pytest.mark.parametrize("window", [0, 5])
def test_attn_mask_bias(window):
    spec_args = dict(num_heads=4, num_kv_heads=2, head_dim=8,
                     sliding_window=window)
    q_pos = np.array([3, 9, 2 ** 30], np.int32)
    k_pos = np.array([0, 1, 2, 3, 8, 9, 10, 2 ** 30], np.int32)
    ref = jl.attn_mask_bias(jl.AttnSpec(**spec_args), jnp.asarray(q_pos),
                            jnp.asarray(k_pos))
    out = tl.attn_mask_bias(tl.AttnSpec(**spec_args),
                            torch.from_numpy(q_pos), torch.from_numpy(k_pos))
    assert out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert tl.AttnSpec(**spec_args).scale == jl.AttnSpec(**spec_args).scale


@pytest.mark.parametrize("dtype", DTYPES)
def test_gqa_attention_fully_masked_rows_give_zeros(dtype):
    rng = np.random.default_rng(3)
    b, hq, hkv, sq, sk, d = 2, 4, 2, 3, 6, 8
    jq, tq = _pair(_normal(rng, b, hq, sq, d), dtype)
    jk, tk = _pair(_normal(rng, b, hkv, sk, d), dtype)
    jv, tv = _pair(_normal(rng, b, hkv, sk, d), dtype)
    # query 0 sees nothing (all keys later), query 1 some, query 2 all
    q_pos = np.array([-1, 2, 9], np.int32)
    k_pos = np.arange(sk, dtype=np.int32)
    jspec = jl.AttnSpec(hq, hkv, d)
    tspec = tl.AttnSpec(hq, hkv, d)
    jbias = jl.attn_mask_bias(jspec, jnp.asarray(q_pos), jnp.asarray(k_pos))
    tbias = tl.attn_mask_bias(tspec, torch.from_numpy(q_pos),
                              torch.from_numpy(k_pos))
    out = tl.gqa_attention(tq, tk, tv, tbias, tspec)
    _close(out, jl.gqa_attention(jq, jk, jv, jbias, jspec), dtype)
    assert float(out[:, :, 0, :].to(torch.float32).abs().max()) == 0.0
    _close(tl.gqa_attention(tq, tk, tv, None, tspec),
           jl.gqa_attention(jq, jk, jv, None, jspec), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("sq, chunk, window", [
    (37, 16, 0),      # sq > chunk with a ragged tail
    (32, 16, 0),      # sq an exact multiple
    (37, 16, 9),      # sliding window across chunk borders
    (12, 16, 0),      # single shot
    (12, 0, 0),       # chunking off
])
def test_chunked_gqa_attention(sq, chunk, window, dtype):
    rng = np.random.default_rng(4)
    b, hq, hkv, d = 2, 4, 2, 8
    jq, tq = _pair(_normal(rng, b, hq, sq, d), dtype)
    jk, tk = _pair(_normal(rng, b, hkv, sq, d), dtype)
    jv, tv = _pair(_normal(rng, b, hkv, sq, d), dtype)
    pos = np.arange(sq, dtype=np.int32)
    jspec = jl.AttnSpec(hq, hkv, d, sliding_window=window)
    tspec = tl.AttnSpec(hq, hkv, d, sliding_window=window)
    ref = jl.chunked_gqa_attention(jq, jk, jv, jspec, jnp.asarray(pos),
                                   jnp.asarray(pos), chunk=chunk)
    out = tl.chunked_gqa_attention(tq, tk, tv, tspec, torch.from_numpy(pos),
                                   torch.from_numpy(pos), chunk=chunk)
    _close(out, ref, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_qk_head_norm(dtype):
    rng = np.random.default_rng(5)
    jx, tx = _pair(_normal(rng, 2, 4, 5, 16), dtype)
    js, ts = _pair(_normal(rng, 16) * 0.3, dtype)
    _close(tl.qk_head_norm(tx, ts, 1e-6), jl.qk_head_norm(jx, js, 1e-6),
           dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bias", [False, True])
def test_linear(bias, dtype):
    rng = np.random.default_rng(6)
    jx, tx = _pair(_normal(rng, 2, 5, 24), dtype)
    jw, tw = _pair(_normal(rng, 24, 40) / 5, dtype)
    jb, tb = _pair(_normal(rng, 40), dtype) if bias else (None, None)
    _close(tl.linear(tx, tw, tb), jl.linear(jx, jw, jb), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ["qwen3_14b", "gemma_7b", "opt_30b"])
def test_mlp(arch, dtype):
    """silu GLU, gelu GLU and the biased non-gated relu MLP."""
    jcfg, tcfg = jax_smoke_config(arch), get_smoke_config(arch)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    rng = np.random.default_rng(7)
    d, ff = tcfg.d_model, tcfg.d_ff
    names = {"w_up": (d, ff), "w_down": (ff, d)}
    if tcfg.gated_mlp:
        names["w_gate"] = (d, ff)
    else:
        names.update(b_up=(ff,), b_down=(d,))
    pairs = {k: _pair(_normal(rng, *shape) / np.sqrt(shape[0]), dtype)
             for k, shape in names.items()}
    jx, tx = _pair(_normal(rng, 2, 6, d), dtype)
    ref = jl.mlp(jx, {k: v[0] for k, v in pairs.items()}, jcfg)
    # a strided activation is made contiguous, not refused
    out = tl.mlp(tx.transpose(0, 1).contiguous().transpose(0, 1),
                 {k: v[1] for k, v in pairs.items()}, tcfg)
    _close(out, ref, dtype)
