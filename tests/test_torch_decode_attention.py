"""Decode attention of the port against the JAX reference, on the CPU.

The CUDA kernel (``csrc/decode_attention.cu``) runs only on the card and is
held to ``decode_attention_ref`` there by ``chip_smoke.py``.  Here the same
numpy inputs go through the port's ``decode_attention_ref`` and through the
reference's oracle, its Pallas kernel in interpret mode, and the model's
masked ``gqa_attention`` (what ``_self_attention_slots`` computes at one
token), so that the oracle the card compares against is pinned to the TPU
kernel it replaces and to the model path it stands in for.

Tolerances: against the Pallas kernel and the JAX oracle the kernel tests'
``TOL`` (fp32 2e-4, bf16 6e-2, times max|ref| + 1); against the model's
attention in fp32 1e-5 * (max|ref| + 1) (same arithmetic, another order).
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.kernel import \
    decode_attention as pallas_decode_attention
from repro.kernels.decode_attention.ref import \
    decode_attention_ref as jax_decode_attention_ref
from repro.models import layers as jl
from repro_torch.chip import h100
from repro_torch.kernels.decode_attention import kernel as dk
from repro_torch.kernels.decode_attention.kernel import (
    decode_attention_kernel, plan_splits)
from repro_torch.kernels.decode_attention.ops import decode_attn
from repro_torch.kernels.decode_attention.ref import (
    decode_attention_ref, decode_attention_split_ref)
from repro_torch.models import layers as tl

TOL = {"float32": 2e-4, "bfloat16": 6e-2}
CU = Path(dk.__file__).resolve().parents[1] / "csrc" / "decode_attention.cu"
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
SENTINEL = 2 ** 30

# (B, Hq, Hkv, C, D, window, pos): the cases of the reference's kernel test
CASES = [
    (2, 8, 2, 128, 32, 0, 100),        # partial cache
    (1, 4, 4, 256, 16, 64, 300),       # ring buffer + window
    (2, 2, 1, 64, 64, 0, 64),          # exactly full cache
]
# the head dims of dit-xl (72, MHA) and kimi-k2 (112, GQA group 8), on the
# bf16 route "mma" on the card
HEAD_DIM_CASES = [
    (2, 2, 2, 128, 72, 0, 100),        # dit-xl: D 72, G 1, partial cache
    (1, 16, 2, 192, 112, 0, 150),      # kimi-k2: D 112, G 8
    (1, 8, 1, 128, 112, 48, 300),      # D 112, G 8, ring buffer + window
]


def _ring_tags(c: int, pos: int) -> np.ndarray:
    """slot_pos of a lock-step ring after ``pos`` tokens."""
    idx = np.arange(c)
    if pos <= c:
        return np.where(idx < pos, idx, SENTINEL).astype(np.int32)
    start = pos - c
    return (start + (idx - start) % c).astype(np.int32)


def _inputs(case, dtype: str, seed: int = 0):
    b, hq, hkv, c, d, _, _ = case
    rng = np.random.default_rng(seed)
    arrays = [rng.normal(size=(b, hq, d)), rng.normal(size=(b, hkv, c, d)),
              rng.normal(size=(b, hkv, c, d))]
    arrays = [a.astype(np.float32) for a in arrays]
    jax_side = [jnp.asarray(a, JDT[dtype]) for a in arrays]
    torch_side = [torch.from_numpy(a).to(TDT[dtype]) for a in arrays]
    return jax_side, torch_side


def _err(out: torch.Tensor, ref) -> tuple[float, float]:
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    got = out.to(torch.float32).numpy()
    assert got.shape == ref.shape
    return float(np.max(np.abs(got - ref))), float(np.max(np.abs(ref))) + 1.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES + HEAD_DIM_CASES)
def test_ref_matches_jax_oracle(case, dtype):
    (jq, jk, jv), (tq, tk, tv) = _inputs(case, dtype)
    win, pos = case[5], case[6]
    tags = _ring_tags(case[3], pos)
    ref = jax_decode_attention_ref(jq, jk, jv, jnp.asarray(tags), pos,
                                   window=win)
    out = decode_attention_ref(tq, tk, tv, torch.from_numpy(tags), pos,
                               window=win)
    assert out.dtype == TDT[dtype]
    err, scale = _err(out, ref)
    assert err <= TOL[dtype] * scale, (case, dtype, err)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES + HEAD_DIM_CASES)
def test_ref_matches_pallas_kernel(case, dtype):
    """The oracle the CUDA kernel is held to agrees with the TPU kernel
    (interpret mode) that the CUDA kernel replaces."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(case, dtype, seed=1)
    win, pos = case[5], case[6]
    tags = _ring_tags(case[3], pos)
    ref = pallas_decode_attention(jq, jk, jv, jnp.asarray(tags), pos,
                                  window=win, bk=64, interpret=True)
    out = decode_attention_ref(tq, tk, tv, torch.from_numpy(tags), pos,
                               window=win)
    err, scale = _err(out, ref)
    assert err <= TOL[dtype] * scale, (case, dtype, err)


@pytest.mark.parametrize("window", [0, 24])
def test_per_row_form_matches_slot_attention(window):
    """Per-row ``slot_pos (B, C)`` and ``q_pos (B,)``: what the reference's
    ``_self_attention_slots`` computes at one token (its per-row mask
    through ``gqa_attention``), one row with no live slot included."""
    b, hq, hkv, c, d = 4, 10, 2, 48, 32
    rng = np.random.default_rng(7)
    q = rng.normal(size=(b, hq, d)).astype(np.float32)
    k = rng.normal(size=(b, hkv, c, d)).astype(np.float32)
    v = rng.normal(size=(b, hkv, c, d)).astype(np.float32)
    q_pos = np.array([5, 47, 90, 0], np.int32)
    tags = np.stack([_ring_tags(c, int(p) + 1) for p in q_pos])
    tags[3] = SENTINEL                       # an evicted slot: nothing live
    spec = jl.AttnSpec(hq, hkv, d, sliding_window=window)
    ok = tags[:, None, :] <= q_pos[:, None, None]
    if window:
        ok &= tags[:, None, :] > q_pos[:, None, None] - window
    bias = jnp.where(jnp.asarray(ok), 0.0, -jnp.inf).astype(jnp.float32)
    ref = jl.gqa_attention(jnp.asarray(q)[:, :, None], jnp.asarray(k),
                           jnp.asarray(v), bias[:, None, None], spec)[:, :, 0]
    out = decode_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), torch.from_numpy(tags),
                               torch.from_numpy(q_pos), window=window)
    err, scale = _err(out, ref)
    assert err <= 1e-5 * scale, err
    assert not out[3].any()


@pytest.mark.parametrize("case", CASES)
def test_ref_matches_model_attention(case):
    """On the lock-step cache the oracle computes what the CPU model runs
    (``attn_mask_bias`` + ``gqa_attention`` of the port), so the kernel
    that replaces the one on the card stands in for the other."""
    _, (tq, tk, tv) = _inputs(case, "float32", seed=2)
    b, hq, hkv, c, d, win, pos = case
    tags = torch.from_numpy(_ring_tags(c, pos))
    spec = tl.AttnSpec(hq, hkv, d, sliding_window=win)
    bias = tl.attn_mask_bias(spec, torch.tensor([pos - 1]), tags)
    model = tl.gqa_attention(tq[:, :, None], tk, tv, bias, spec)[:, :, 0]
    out = decode_attention_ref(tq, tk, tv, tags, pos - 1, window=win)
    err = float((out - model).abs().max())
    assert err <= 1e-5 * (float(model.abs().max()) + 1.0), err


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fully_masked_rows_give_zeros(dtype):
    """A row with no attendable slot contributes exactly 0 (the Pallas
    kernel's -1e30 fill would give the mean of V instead)."""
    case = (2, 4, 2, 64, 16, 0, 10)
    _, (tq, tk, tv) = _inputs(case, dtype, seed=3)
    dead = torch.full((64,), SENTINEL, dtype=torch.int32)
    out = decode_attention_ref(tq, tk, tv, dead, 10)
    assert out.dtype == TDT[dtype] and not out.any()
    # a window that has moved past every written slot
    tags = torch.arange(64, dtype=torch.int32)
    assert not decode_attention_ref(tq, tk, tv, tags, 500, window=8).any()


def test_scale_argument():
    case = CASES[0]
    (jq, jk, jv), (tq, tk, tv) = _inputs(case, "float32", seed=4)
    tags = _ring_tags(case[3], case[6])
    ref = jax_decode_attention_ref(jq, jk, jv, jnp.asarray(tags), case[6],
                                   scale=0.3)
    out = decode_attention_ref(tq, tk, tv, torch.from_numpy(tags), case[6],
                               scale=0.3)
    err, scale = _err(out, ref)
    assert err <= 1e-5 * scale


@pytest.mark.parametrize("case", CASES)
def test_decode_attn_on_cpu_takes_plain_path(case):
    """A CPU tensor never reaches the kernel wrapper: same bits as
    ``decode_attention_ref``, and the launch count stays."""
    _, (tq, tk, tv) = _inputs(case, "float32")
    tags = torch.from_numpy(_ring_tags(case[3], case[6]))
    before = decode_attention_kernel.launches
    out = decode_attn(tq, tk, tv, tags, case[6], window=case[5])
    assert torch.equal(out, decode_attention_ref(tq, tk, tv, tags, case[6],
                                                 window=case[5]))
    assert decode_attention_kernel.launches == before


def test_kernel_wrapper_refuses_cpu_tensors():
    _, (tq, tk, tv) = _inputs(CASES[0], "float32")
    with pytest.raises(ValueError, match="CUDA tensor"):
        decode_attention_kernel(tq, tk, tv, torch.zeros(128, dtype=torch.int32),
                                5)


@pytest.mark.parametrize("breakage, error, says", [
    ("dtype", TypeError, "float32 or bfloat16"),
    ("kv_mixed", TypeError, "v_cache is torch.float32"),
    ("k_shape", ValueError, "k_cache has shape"),
    ("v_shape", ValueError, "v_cache has shape"),
    ("head_ratio", ValueError, "not a multiple of Hkv"),
    ("head_dim", ValueError, "multiples of 8"),
    ("strided", ValueError, "k_cache is not contiguous"),
    ("slot_pos_dtype", TypeError, "slot_pos is torch.int64"),
    ("slot_pos_shape", ValueError, "slot_pos has shape"),
    ("q_pos_shape", ValueError, "q_pos has shape"),
])
def test_kernel_wrapper_rejects(breakage, error, says):
    """Checks run before anything touches the card; ``meta`` tensors stand
    in for CUDA tensors so the checks are reachable here."""
    class OnCard(torch.Tensor):
        is_cuda = True

    def t(*shape, dtype=torch.bfloat16):
        return torch.empty(shape, dtype=dtype, device="meta"
                           ).as_subclass(OnCard)

    q, k, v = t(2, 8, 32), t(2, 2, 64, 32), t(2, 2, 64, 32)
    slot_pos, q_pos = t(64, dtype=torch.int32), 10
    if breakage == "dtype":
        q = t(2, 8, 32, dtype=torch.float16)
    elif breakage == "kv_mixed":
        v = t(2, 2, 64, 32, dtype=torch.float32)
    elif breakage == "k_shape":
        k = t(2, 2, 64, 16)
    elif breakage == "v_shape":
        v = t(2, 2, 32, 32)
    elif breakage == "head_ratio":
        q = t(2, 7, 32)
    elif breakage == "head_dim":
        q, k, v = t(2, 8, 20), t(2, 2, 64, 20), t(2, 2, 64, 20)
    elif breakage == "strided":
        k = t(2, 2, 32, 64).transpose(2, 3)
    elif breakage == "slot_pos_dtype":
        slot_pos = t(64, dtype=torch.int64)
    elif breakage == "slot_pos_shape":
        slot_pos = t(3, 64, dtype=torch.int32)
    elif breakage == "q_pos_shape":
        q_pos = t(3, dtype=torch.int32)
    with pytest.raises(error, match=says):
        decode_attention_kernel(q, k, v, slot_pos, q_pos)


def test_plan_splits_covers_every_tile():
    """Every tile of the ring is in exactly one split's range, at most
    MAX_SPLITS splits (the blocks of one cluster), never more blocks than
    SMs unless the rows alone are more.  The pairs were those of the old
    128-split limit at three blocks an SM; the plan now gives each of the
    132 SMs one block."""
    for rows, c, bk, sms in [(64, 1024, 64, 132), (64, 2048, 64, 132),
                             (8, 64, 64, 132), (1, 100000, 16, 132),
                             (4096, 2048, 64, 132), (2, 257, 32, 132)]:
        per_split, splits = plan_splits(rows, c, bk, sms)
        tiles = -(-c // bk)
        assert 1 <= splits <= h100.MAX_SPLITS and per_split >= 1
        assert (splits - 1) * per_split < tiles <= splits * per_split
        assert rows * splits <= max(sms, rows)
    # the serving shapes on 132 SMs: 64 rows of (batch, kv head) split in two
    assert plan_splits(64, 1024, 64, 132) == (8, 2)
    assert plan_splits(64, 2048, 64, 132) == (16, 2)
    assert plan_splits(4096, 2048, 64, 132) == (32, 1)
    assert plan_splits(1, 100000, 16, 132) == (782, 8)


# the serving shapes of full qwen3-14b (Hq 40, Hkv 8, D 128, bf16): a lock-step
# step at position 520 of a ring of 1024, and 8 slots of 2048 at the
# continuous trace's positions (prompts 128-1024, 20 tokens in)
SERVING = [("lock-step", 8, 1024, [520] * 8),
           ("continuous", 8, 2048, [p + 20 for p in (128, 384, 700, 1024)] * 2)]


@pytest.mark.parametrize("label, b, c, positions", SERVING)
def test_plan_at_serving_shapes(label, b, c, positions):
    """The blocks cover the 132 SMs or every split of every row has at
    least one live tile; the route is "mma" with tiles of 64 slots."""
    hkv, g, d = 8, 5, 128
    q = torch.empty(b, hkv * g, d, dtype=torch.bfloat16)
    k = torch.empty(b, hkv, c, d, dtype=torch.bfloat16)
    assert dk.route_of(q, k) == "mma"
    bk, stages = dk.tiling(g, d, 2, "mma")
    assert (bk, stages) == (64, 2)
    rows = b * hkv
    per_split, splits = plan_splits(rows, c, bk)
    assert splits <= h100.MAX_SPLITS
    fewest = min(-(-(p + 1) // bk) for p in positions)     # live tiles
    assert rows * splits >= h100.SMS or fewest >= splits, (label, fewest)


def test_tiling_fits_the_budget():
    """Route "fma": the deepest tile with three or more stages at two
    blocks an SM; route "mma": tiles of 64 slots, an even number of stages
    (each of its two warp groups owns half), two blocks an SM where that
    leaves two stages, else one."""
    budget2 = dk.SM_BYTES // 2 - dk.BLOCK_RESERVE
    for elem in (2, 4):
        for d in (16, 32, 64, 72, 80, 96, 112, 128, 256):
            for g in (1, 4, 5, 8):
                bk, stages = dk.tiling(g, d, elem)
                assert bk in dk.TILE_SLOTS and 3 <= stages <= dk.MAX_STAGES
                assert dk.smem_bytes(dk.maxg_for(g), d, bk, stages,
                                     elem) <= budget2
    for d in dk.MMA_HEAD_DIMS:
        bk, stages = dk.tiling(5, d, 2, "mma")
        assert bk == 64 and stages in (2, 4)
        need = dk.smem_bytes(dk.MAX_GROUP, d, bk, stages, 2)
        assert need <= (budget2 if d <= 128 else dk.SM_BYTES
                        - dk.BLOCK_RESERVE)


def test_route_of():
    def t(dtype, *shape):
        return torch.empty(shape, dtype=dtype)
    bf, f32 = torch.bfloat16, torch.float32
    assert dk.route_of(t(bf, 2, 8, 128), t(bf, 2, 2, 64, 128)) == "mma"
    assert dk.route_of(t(f32, 2, 8, 128), t(bf, 2, 2, 64, 128)) == "fma"
    assert dk.route_of(t(bf, 2, 8, 40), t(bf, 2, 2, 64, 40)) == "fma"
    assert dk.route_of(t(bf, 1, 16, 72), t(bf, 1, 16, 64, 72)) == "mma"
    assert dk.route_of(t(bf, 1, 64, 112), t(bf, 1, 8, 64, 112)) == "mma"
    assert dk.route_of(t(f32, 2, 8, 128), t(f32, 2, 2, 64, 128)) == "fma"


SPLIT_CASES = [
    # (B, Hq, Hkv, C, D, window, pos, splits): groups of 1, 5 and 8; a
    # position early in a long ring (most splits hold no live slot), a
    # wrapped ring with a window, C not a multiple of the tile
    (1, 5, 1, 2048, 32, 0, 40, 8),
    (2, 10, 2, 300, 32, 0, 250, 2),
    (1, 16, 2, 517, 16, 100, 1200, 4),
    (2, 4, 4, 256, 16, 64, 300, 3),
    (1, 16, 2, 700, 112, 0, 600, 8),   # kimi-k2's D 112 at G 8
    (2, 2, 2, 300, 72, 64, 500, 3),    # dit-xl's D 72 at G 1, a window
]


@pytest.mark.parametrize("route", ["mma", "fma"])
@pytest.mark.parametrize("case", SPLIT_CASES)
def test_split_ref_matches_oracle(case, route):
    """The plain split-and-combine version (the warps' and the splits'
    (m, l, acc) merged in order, empty splits included) is the oracle on
    the same numpy inputs: fp32, 1e-5 x (max|ref| + 1)."""
    b, hq, hkv, c, d, win, pos, splits = case
    _, (tq, tk, tv) = _inputs((b, hq, hkv, c, d, win, pos), "float32",
                              seed=21)
    tags = torch.from_numpy(_ring_tags(c, pos))
    if pos < 64 and splits > 1:
        assert -(-pos // 64) < splits       # some splits hold no live slot
    got = decode_attention_split_ref(tq, tk, tv, tags, pos - 1,
                                     splits=splits, route=route, window=win)
    ref = decode_attention_ref(tq, tk, tv, tags, pos - 1, window=win)
    err = float((got - ref).abs().max())
    assert err <= 1e-5 * (float(ref.abs().max()) + 1.0), err


@pytest.mark.parametrize("splits", [1, 2, 8])
@pytest.mark.parametrize("case", CASES)
def test_split_ref_matches_pallas_kernel(case, splits):
    """The split-and-combine version against the Pallas kernel in
    interpret mode, the kernel tests' ``TOL``."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(case, "float32", seed=22)
    win, pos = case[5], case[6]
    tags = _ring_tags(case[3], pos)
    ref = pallas_decode_attention(jq, jk, jv, jnp.asarray(tags), pos,
                                  window=win, bk=64, interpret=True)
    got = decode_attention_split_ref(tq, tk, tv, torch.from_numpy(tags), pos,
                                     splits=splits, window=win)
    err, scale = _err(got, ref)
    assert err <= TOL["float32"] * scale, (case, splits, err)


def test_planner_constants_are_what_the_kernel_compiles():
    """Warps, query rows a block, cluster limit, stages, listed tiles and
    the combine scratch of the plan against the CUDA source, and the tile
    depths and routes it takes."""
    src = CU.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("kWarps") == dk.WARPS
    assert dk.THREADS == 32 * (dk.WARPS + 1)
    assert const("kMaxGroup") == dk.MAX_GROUP
    assert const("kMaxSplits") == h100.MAX_SPLITS
    assert const("kMinStages") == dk.MIN_STAGES
    assert const("kMaxStages") == dk.MAX_STAGES
    assert const("kMaxListed") == dk.MAX_LISTED
    assert re.search(r"constexpr int kCoef = kWarps \+ kMaxSplits \+ 2;", src)
    assert dk.COEF == dk.WARPS + h100.MAX_SPLITS + 2
    assert "(bk != 16 && bk != 32 && bk != 64)" in src
    assert set(dk.TILE_SLOTS) == {16, 32, 64}
    for d in dk.MMA_HEAD_DIMS:
        assert f"case {d}: return F<KV, 8, 1, {d}>" in src
    assert "DECODE_MMA_INSTANCE(prepare, bf16, d)" in src
    for g in range(1, 9):
        assert f"F<T, {dk.maxg_for(g)}, " in src
    assert "decode_attention_combine_kernel" not in src
    # the shared-memory layout smem_bytes mirrors: the ring of K and V
    # tiles (no per-warp rows of dequantized int8 slots beside it) or the
    # carries, then the rest
    assert ("const size_t ring = (size_t)stages * 2 * bk * "
            "row_bytes_for(d, elem);") in src
    assert "region_bytes(int maxg, int d, int bk, int stages, int elem)" \
        in src
    assert "kWarps * 2 * 16" not in src and "dequant8" not in src
    rest = re.search(r"const size_t rest = (.*?);\n", src, re.S).group(1)
    assert " ".join(rest.split()) == (
        "sizeof(float) * ((size_t)maxg * d + (size_t)bk * pad4(maxg) + "
        "(size_t)stages * bk * (elem == 1 ? 3 : 1) + kMaxListed + "
        "(size_t)maxg * kCoef + 4) + 2 * (size_t)stages * sizeof(uint64_t)")
    for maxg, d, bk, stages, elem in ((8, 128, 64, 4, 1), (8, 128, 64, 2, 2),
                                      (5, 72, 32, 3, 4), (8, 256, 64, 2, 1)):
        ring = stages * 2 * bk * (-(-d * elem // 128) * 128)
        region = max(ring, 4 * (dk.WARPS + 1) * maxg * (d + 2))
        rest = 4 * (maxg * d + bk * (-(-maxg // 4) * 4)
                    + stages * bk * (3 if elem == 1 else 1) + dk.MAX_LISTED
                    + maxg * dk.COEF + 4) + 2 * stages * 8
        assert dk.smem_bytes(maxg, d, bk, stages, elem) \
            == 1024 + region + rest
    # the int8 route "mma" reads the head dim as k_perm and v_perm say
    assert "return 4 * KS * tig + 4 * kk + j;" in src
    assert "return 2 * KS * gid + 2 * mt + h;" in src
