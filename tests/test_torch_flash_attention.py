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
import re
from pathlib import Path

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
from repro_torch.chip import h100
from repro_torch.kernels.flash_attention import kernel as fk
from repro_torch.kernels.flash_attention.kernel import flash_attention_kernel
from repro_torch.kernels.flash_attention.ops import flash_attn, flash_attn_pos
from repro_torch.kernels.flash_attention.ref import (live_tiles, mha_pos_ref,
                                                     mha_pos_split_ref,
                                                     mha_ref)
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
# the head dims of dit-xl (72, MHA) and kimi-k2 (112, GQA group 8), on the
# bf16 route "mma_sync" on the card
HEAD_DIM_CASES = [
    (1, 4, 4, 96, 72, True, 0),        # dit-xl: D 72, G 1
    (2, 2, 2, 128, 72, True, 40),      # D 72, window
    (1, 8, 1, 96, 112, True, 0),       # kimi-k2: D 112, G 8
    (1, 16, 2, 64, 112, False, 0),     # D 112, G 8, bidirectional
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
@pytest.mark.parametrize("case", CASES + HEAD_DIM_CASES)
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


@pytest.mark.parametrize("window", [0, 24])
def test_oracle_by_batch_rows_past_its_score_budget(window, monkeypatch):
    """Past ``SCORE_BYTES_AT_ONCE`` of fp32 scores the oracle takes the
    batch rows one at a time (h2o-danube-1.8b's prefill on the card): the
    same result, per-row positions and a dead row included."""
    from repro_torch.kernels.flash_attention import ref as fr

    b, hq, hkv, t, c, d = 3, 8, 2, 12, 48, 32
    rows = [_ring(c, 20, t), _ring(c, 70, t), _ring(c, 0, t)]
    q_pos = torch.from_numpy(np.stack([r[0] for r in rows]))
    tags = torch.from_numpy(np.stack([r[1] for r in rows]))
    tags[2] = SENTINEL
    _, (q, k, v) = _inputs(b, hq, hkv, t, c, d, "float32", 4)
    whole = mha_pos_ref(q, k, v, q_pos, tags, window=window)
    monkeypatch.setattr(fr, "SCORE_BYTES_AT_ONCE", hq * t * c * 4)
    rowwise = mha_pos_ref(q, k, v, q_pos, tags, window=window)
    torch.testing.assert_close(rowwise, whole, rtol=1e-6, atol=1e-6)
    assert not rowwise[2].any()


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


# ---------------------------------------------------------------------------
# route "wgmma": the split plan, its plain split-and-combine version, and the
# constants the CUDA source compiles
# ---------------------------------------------------------------------------

CSRC = Path(fk.__file__).resolve().parents[1] / "csrc"
# the forward's sources: the header the routes share, the "mma_sync" and
# "fma" instances, the "wgmma" instances and their register-A products
CU = [CSRC / name for name in ("flash_attention.cuh", "flash_attention.cu",
                               "flash_attention_wgmma.cu", "wgmma_rs.cuh")]

# the shapes the serving paths of full qwen3-14b (Hq 40, Hkv 8, D 128) give
# the kernel: lock-step prefill, and chunks against a ring of 2048
SERVING = [("lock-step prefill", 8, 512, 512, None),
           ("chunk T=32 at 1900", 1, 32, 2048, 1900),
           ("tail T=16 at 1900", 1, 16, 2048, 1900),
           ("chunk T=256 at 1900", 1, 256, 2048, 1900)]


@pytest.mark.parametrize("label, b, t, c, start", SERVING)
def test_plan_splits_at_serving_shapes(label, b, t, c, start):
    """At every serving shape the blocks cover the 132 SMs or every split
    has at least one live tile; never more than MAX_SPLITS splits."""
    hkv, g = 8, 5
    row_tiles, splits = fk.plan_splits(b, hkv, t, c, g)
    assert row_tiles == -(-t * g // fk.WG_ROWS)
    assert 1 <= splits <= h100.MAX_SPLITS
    blocks = b * hkv * row_tiles * splits
    if start is None:
        pos = torch.arange(t, dtype=torch.int32)
        tags = pos
    else:
        pos = torch.arange(start, start + t, dtype=torch.int32)
        tags = torch.from_numpy(_ring(c, start, t)[1])
    # the fewest live tiles of any row tile
    fewest = min(len(live_tiles(pos[r0 // g:(r0 + fk.WG_ROWS - 1) // g + 1],
                                tags, causal=True, window=0, bk=fk.WG_BK))
                 for r0 in range(0, t * g, fk.WG_ROWS))
    assert blocks >= h100.SMS or fewest >= splits, (label, blocks, fewest)


def test_plan_splits_depends_on_shapes_only():
    """The plan is a function of (B, Hkv, Sq, Sk, G, SMs): splits only when
    the blocks do not cover the SMs, bounded by MAX_SPLITS and by the tiles
    of Sk, and the same every call."""
    for args in [(8, 8, 512, 512, 5), (1, 8, 32, 2048, 5),
                 (1, 8, 16, 2048, 5), (1, 8, 256, 2048, 5), (1, 1, 1, 10, 1),
                 (1, 2, 64, 100, 8), (2, 4, 200, 70000, 1)]:
        plan = fk.plan_splits(*args)
        assert plan == fk.plan_splits(*args)
        b, hkv, sq, sk, g = args
        row_tiles, splits = plan
        base = b * hkv * row_tiles
        assert 1 <= splits <= min(h100.MAX_SPLITS, -(-sk // fk.WG_BK))
        if base >= h100.SMS:
            assert splits == 1
        else:
            assert base * splits >= min(h100.SMS, base * h100.MAX_SPLITS,
                                        base * -(-sk // fk.WG_BK))
    assert fk.plan_splits(1, 8, 32, 2048, 5) == (3, 6)
    assert fk.plan_splits(1, 8, 16, 2048, 5) == (2, 8)
    assert fk.plan_splits(8, 8, 512, 512, 5) == (40, 1)
    assert fk.plan_splits(1, 8, 32, 2048, 5, sms=16) == (3, 1)


def test_route_of():
    """bf16 at every head dim from 64 up takes "wgmma" (72-112 in the
    layout of 128, there only with more than one query head a kv head, as
    measured), and over an int8 ring too but at 72, whose 72-byte rows are
    no stride TMA takes; 16 and 32 stay on "mma_sync"; an fp32 query takes
    "fma"."""
    def t(dtype, d, heads=4):
        return torch.empty(1, heads, 8, d, dtype=dtype)
    bf, i8 = torch.bfloat16, torch.int8
    assert fk.route_of(t(bf, 128), t(bf, 128)) == "wgmma"
    for d in (72, 80, 96, 112):
        assert fk.route_of(t(bf, d), t(bf, d, 2)) == "wgmma"     # G 2
        assert fk.route_of(t(bf, d), t(bf, d)) == "mma_sync"     # G 1
    for d in (80, 96, 112, 128):
        assert fk.route_of(t(bf, d), t(i8, d, 1)) == "wgmma"
    assert fk.route_of(t(bf, 72), t(i8, 72, 1)) == "mma_sync"
    assert fk.route_of(t(bf, 64), t(bf, 64)) == "wgmma"
    for d in (16, 32):
        assert fk.route_of(t(bf, d), t(bf, d)) == "mma_sync"
    assert fk.route_of(t(torch.float32, 128), t(bf, 128)) == "fma"
    assert fk.route_of(t(torch.float32, 112), t(i8, 112)) == "fma"
    assert set(fk.WGMMA_HEAD_DIMS) <= set(fk.MMA_HEAD_DIMS)
    assert set(fk.WGMMA_INT8_HEAD_DIMS) == set(fk.WGMMA_HEAD_DIMS) - {72}
    assert set(fk.MMA_SYNC_HEAD_DIMS) | set(fk.WGMMA_HEAD_DIMS) \
        == set(fk.MMA_HEAD_DIMS)


SPLIT_CASES = [
    # (B, Hq, Hkv, T, C, D, start, window, splits): groups of 1, 5 and 8;
    # a chunk early in the ring (most splits hold no live key), a wrapped
    # ring, a window, ragged C
    (1, 10, 2, 32, 512, 32, 0, 0, 8),
    (1, 10, 2, 37, 512, 32, 300, 0, 3),
    (2, 16, 2, 20, 200, 16, 190, 48, 4),
    (1, 4, 4, 64, 256, 16, 100, 0, 8),
    (1, 8, 1, 16, 130, 16, 400, 0, 1),
    (1, 16, 2, 32, 300, 112, 200, 0, 4),   # kimi-k2's D 112 at G 8
    (1, 4, 4, 37, 200, 72, 100, 0, 3),     # dit-xl's D 72 at G 1
]


@pytest.mark.parametrize("case", SPLIT_CASES)
def test_split_ref_matches_oracle(case):
    """The plain split-and-combine version (per-split (m, l, acc) over the
    plan's tile ranges, merged in rank order, empty splits included) is the
    positioned oracle, on the same numpy inputs: fp32, 1e-5 x (max|ref| +
    1) (the same sums in another order)."""
    b, hq, hkv, t, c, d, start, win, splits = case
    _, (q, k, v) = _inputs(b, hq, hkv, t, c, d, "float32", seed=11)
    rows = [_ring(c, start + 7 * i, t) for i in range(b)]
    q_pos = torch.from_numpy(np.stack([r[0] for r in rows]))
    tags = torch.from_numpy(np.stack([r[1] for r in rows]))
    tiles = live_tiles(q_pos[0][:fk.WG_ROWS // (hq // hkv)], tags[0],
                       causal=True, window=win, bk=fk.WG_BK)
    if case[0:2] == (1, 10) and start == 0:
        assert len(tiles) < splits          # some splits hold no live key
    got = mha_pos_split_ref(q, k, v, q_pos, tags, splits=splits, window=win)
    ref = mha_pos_ref(q, k, v, q_pos, tags, window=win)
    err = float((got - ref).abs().max())
    assert err <= 1e-5 * (float(ref.abs().max()) + 1.0), err


@pytest.mark.parametrize("splits", [1, 3, 8])
@pytest.mark.parametrize("case", CASES)
def test_split_ref_matches_pallas_kernel(case, splits):
    """The split-and-combine version against the Pallas kernel in
    interpret mode (contiguous positions), the kernel tests' ``TOL``."""
    b, hq, hkv, s, d, causal, win = case
    (jq, jk, jv), (tq, tk, tv) = _inputs(b, hq, hkv, s, s, d, "float32", 12)
    pos = torch.arange(s, dtype=torch.int32)[None].expand(b, s)
    got = mha_pos_split_ref(tq, tk, tv, pos, pos, splits=splits,
                            causal=causal, window=win)
    ref = pallas_flash_attention(jq, jk, jv, causal=causal, window=win,
                                 bq=32, bk=32, interpret=True)
    err, scale = _err(got, ref)
    assert err <= TOL["float32"] * scale, (case, splits, err)


def test_planner_constants_are_what_the_kernel_compiles():
    """Rows of a block, keys of a tile, threads, cluster limit and stages
    by head dim of route "wgmma": the Python plan against the CUDA
    source."""
    src = "".join(p.read_text() for p in CU)

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("kWgRows") == fk.WG_ROWS
    assert const("kWgBK") == fk.WG_BK
    assert const("kWgThreads") == fk.WG_THREADS
    assert const("kMaxSplits") == h100.MAX_SPLITS
    stages = re.search(r"STAGES = D == 64 \? (\d+) : (\d+);", src)
    assert {d: int(stages.group(1 if d == 64 else 2))
            for d in fk.WGMMA_HEAD_DIMS} == fk.WG_STAGES
    for d in fk.WGMMA_HEAD_DIMS:
        assert f"flash_attention_wgmma_kernel<{d}>" in src
        assert f"case {d}: return launch_wgmma<{d}>(a, splits, s)" in src
    wg = re.search(r"static_assert\((D == 64(?: \|\| D == \d+)*),", src)
    assert {int(d) for d in re.findall(r"D == (\d+)", wg.group(1))} \
        == set(fk.WGMMA_HEAD_DIMS)
    # the layout of 128 for every head dim from 72 to 128 (O += P V at n =
    # D: m64n72k16 ... m64n112k16)
    assert "d <= 64 ? 64 : d <= 128 ? 128 : 256" in src
    for d in set(fk.WGMMA_HEAD_DIMS) - {64, 128, 256}:
        assert f"wgmma.mma_async.sync.aligned.m64n{d}k16.f32.bf16.bf16" in src
    for d in fk.MMA_SYNC_HEAD_DIMS:
        assert f"allow_smem(flash_attention_mma_kernel<{d}>, optin)" in src
        assert f"case {d}: return launch_mma<{d}>" in src


@pytest.mark.parametrize("breakage, error, says", [
    ("q_last_stride", ValueError, "the last must be 1"),
    ("q_stride_8", ValueError, "multiples of 8"),
    ("route", ValueError, "unknown route"),
    ("route_dtype", ValueError, "does not take"),
    ("route_dim", ValueError, "does not take"),
    ("splits", ValueError, "splits 9"),
    ("splits_0", ValueError, "splits 0"),
])
def test_kernel_wrapper_rejects(breakage, error, says):
    """Checks on strides, routes and splits run before anything touches
    the card; ``meta`` tensors stand in for CUDA tensors."""
    class OnCard(torch.Tensor):
        is_cuda = True

    def t(*shape, dtype=torch.bfloat16):
        return torch.empty(shape, dtype=dtype, device="meta"
                           ).as_subclass(OnCard)

    q, k, v = t(1, 4, 16, 128), t(1, 2, 16, 128), t(1, 2, 16, 128)
    kw = {}
    if breakage == "q_last_stride":
        q = t(1, 4, 128, 16).transpose(2, 3)
    elif breakage == "q_stride_8":
        q = t(1, 4, 16, 132)[..., :128]
    elif breakage == "route":
        kw["route"] = "tensor"
    elif breakage == "route_dtype":
        kw["route"] = "fma"
    elif breakage == "route_dim":
        kw["route"] = "mma_sync"
    elif breakage == "splits":
        kw["splits"] = 9
    elif breakage == "splits_0":
        kw["splits"] = 0
    with pytest.raises(error, match=says):
        flash_attention_kernel(q, k, v, **kw)


def test_model_reads_projection_layout_without_copies():
    """``flash_attn`` takes q in any strided (B, Hq, S, D) view and, on
    the CPU, gives what the oracle gives on a contiguous copy; the model's
    reshape of a (B, S, Hq, D)-stored output for ``w_o`` is then a view."""
    _, (q, k, v) = _inputs(2, 8, 2, 24, 24, 16, "float32", seed=13)
    q_view = q.transpose(1, 2).contiguous().transpose(1, 2)  # (B,S,H,D) storage
    torch.testing.assert_close(flash_attn(q_view, k, v), mha_ref(q, k, v),
                               rtol=0, atol=0)
    out = torch.empty(2, 24, 8, 16).transpose(1, 2)           # the kernel's
    flat = out.transpose(1, 2).reshape(2, 24, -1)
    assert flat.data_ptr() == out.data_ptr() and flat.is_contiguous()


# the serving shapes of the configs whose head dims route "wgmma" lays out
# as 128 (kimi-k2: 64/8 heads of 112; dit-xl: 16/16 of 72) and of hymba-1.5b
# (25/5 of 64): (B, Hkv, Sq, Sk, G) -> (row tiles, splits)
HEAD_DIM_PLANS = {
    "kimi-k2 prefill": ((8, 8, 512, 512, 8), (64, 1)),
    "kimi-k2 chunk T 256": ((1, 8, 256, 2048, 8), (32, 1)),
    "kimi-k2 chunk T 32": ((1, 8, 32, 2048, 8), (4, 5)),
    "kimi-k2 chunk T 4": ((1, 8, 4, 2048, 8), (1, 8)),
    "dit-xl prefill": ((8, 16, 256, 256, 1), (4, 1)),
    "hymba-1.5b prefill": ((8, 5, 512, 512, 5), (40, 1)),
    "hymba-1.5b chunk T 4": ((1, 5, 4, 2048, 5), (1, 8)),
}


@pytest.mark.parametrize("label", sorted(HEAD_DIM_PLANS))
def test_plan_splits_pinned_at_model_shapes(label):
    """kimi-k2's chunks late in the ring, which on "mma_sync" were one block
    a query head walking the whole ring, are split over a cluster on
    "wgmma"; the prefills cover the SMs unsplit.  dit-xl (D 72, G 1) stays
    on "mma_sync", measured faster there."""
    args, want = HEAD_DIM_PLANS[label]
    assert fk.plan_splits(*args) == want
    d = 112 if label.startswith("kimi") else 72 if label.startswith("dit") \
        else 64
    g = args[-1]
    bf, i8 = torch.bfloat16, torch.int8
    assert fk.route_for(bf, bf, d, g) == ("mma_sync" if d == 72 else "wgmma")
    # over an int8 ring: "wgmma" at 112 and 64, "mma_sync" at 72
    assert fk.route_for(bf, i8, d, g) == ("mma_sync" if d == 72 else "wgmma")
