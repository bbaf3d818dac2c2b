"""The port's ELK-blocked matmul on the CPU, and its place on the model's
path.

``ops.matmul`` takes the plain version on CPU tensors (the Hopper kernel
``csrc/elk_matmul.cu`` has no CPU mode; ``chip_smoke.py`` holds it to the
same plain version on the card).  Here: ``ops.matmul`` against the JAX
``elk_matmul`` in interpret mode (block 64) and against its oracle on the
reference's sweep, from the same numpy inputs; the layouts the kernel
takes (a transposed ``y``, a strided ``x``) give the contiguous result;
``linear`` and ``_logits`` against the JAX functions; one ``ops.matmul``
call for each projection and the LM head on every pass; the block plan
cached per shape; the planner's tile list, ring depth, row padding and
threads a block read from the CUDA source.

Tolerances: the reference's kernel-test bound ``TOL * (max|ref| + 1)``
with ``TOL = {fp32: 2e-4, bf16: 6e-2}`` (both sides sum in fp32, in other
orders; bf16 rounds the output once on both sides).
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
from repro.kernels.elk_matmul.kernel import elk_matmul as jax_elk_matmul
from repro.kernels.elk_matmul.ref import matmul_ref as jax_matmul_ref
from repro.models import layers as jlayers
from repro.models import transformer as jtfm
from repro_torch.chip import h100
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.kernels.elk_matmul import kernel as mk
from repro_torch.kernels.elk_matmul.kernel import elk_matmul_kernel, layout
from repro_torch.kernels.elk_matmul.ops import matmul
from repro_torch.models import layers, transformer as tfm

TOL = {"float32": 2e-4, "bfloat16": 6e-2}
SWEEP = [(128, 128, 128), (256, 64, 512), (100, 60, 70), (33, 129, 257)]


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _pair(shape, dtype: str, seed: int):
    """The same values as a torch and a jax array (bf16 rounded once)."""
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    t = torch.from_numpy(a).to(getattr(torch, dtype))
    return t, jnp.asarray(_f32(t), getattr(jnp, dtype))


def _check(got, ref, dtype: str) -> None:
    ref = _f32(ref)
    err = float(np.max(np.abs(_f32(got) - ref)))
    assert err <= TOL[dtype] * (float(np.max(np.abs(ref))) + 1.0), err


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mnk", SWEEP)
def test_matmul_matches_jax_kernel_and_oracle(mnk, dtype):
    m, n, k = mnk
    tx, jx = _pair((m, k), dtype, 0)
    ty, jy = _pair((k, n), dtype, 1)
    out = matmul(tx, ty, bm=64, bn=64, bk=64)
    assert out.shape == (m, n) and out.dtype == tx.dtype
    _check(out, jax_elk_matmul(jx, jy, bm=64, bn=64, bk=64, interpret=True),
           dtype)
    _check(out, jax_matmul_ref(jx, jy), dtype)
    # the block shape does not change the plain version
    assert torch.equal(out, matmul(tx, ty))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_transposed_y_and_strided_x_equal_the_contiguous_result(dtype):
    """The two layouts the kernel takes without a copy: y as the transpose
    of an (n, k) tensor (a tied embedding) and x with a row stride of its
    own (the last token of a prefill)."""
    tx, _ = _pair((3, 5, 70), dtype, 2)
    ty, _ = _pair((70, 33), dtype, 3)
    want = matmul(tx[:, -1, :].contiguous(), ty)
    yt = ty.t().contiguous().t()
    assert not yt.is_contiguous()
    xs = tx[:, -1, :]
    assert not xs.is_contiguous() and xs.stride(1) == 1
    for x, y in ((xs, ty), (tx[:, -1, :].contiguous(), yt), (xs, yt)):
        assert torch.equal(matmul(x, y), want)


def test_layout_is_what_the_kernel_takes():
    x = torch.zeros(6, 10)
    y = torch.zeros(10, 4)
    assert layout(x, y) == (6, 4, 10, 10, 4, 0)
    assert layout(x, torch.zeros(4, 10).t()) == (6, 4, 10, 10, 10, 1)
    # a column view of a wider (k, n') weight: its own row stride
    assert layout(x, torch.zeros(10, 7)[:, 1:5]) == (6, 4, 10, 10, 7, 0)
    assert layout(torch.zeros(6, 3, 10)[:, 1, :], y) == (6, 4, 10, 30, 4, 0)
    assert layout(x[:1], y)[3] == 10
    # the transpose of a stored (k, m) matrix: x^T of a weight gradient,
    # lda the stored row stride
    assert layout(torch.zeros(10, 6).t(), y) == (6, 4, 10, 6, 4, 0)
    assert mk.x_trans_of(torch.zeros(10, 6).t()) and not mk.x_trans_of(x)
    with pytest.raises(ValueError, match="rows are not contiguous"):
        layout(torch.zeros(6, 20)[:, ::2], y)
    with pytest.raises(ValueError, match="neither"):
        layout(x, torch.zeros(10, 8)[:, ::2])
    with pytest.raises(ValueError, match="do not chain"):
        layout(x, torch.zeros(9, 4))
    with pytest.raises(ValueError, match="must be"):
        layout(torch.zeros(2, 6, 10), y)


def test_kernel_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA tensor"):
        elk_matmul_kernel(torch.zeros(4, 8), torch.zeros(8, 4))


def test_plan_is_cached_per_shape_and_type(monkeypatch):
    calls = []
    real = mk.smem_plan

    def counting(*args, **kw):
        calls.append(args)
        return real(*args, **kw)

    monkeypatch.setattr(mk, "smem_plan", counting)
    mk.plan_for.cache_clear()
    try:
        a = mk.plan_for(8, 5120, 5120, torch.bfloat16)
        for _ in range(160):
            assert mk.plan_for(8, 5120, 5120, torch.bfloat16) is a
        c = mk.plan_for(8, 5120, 5120, torch.bfloat16, False)
        b = mk.plan_for(8, 5120, 5120, torch.float32)
        assert len(calls) == 3
        assert (a.route, a.bm, a.bn, a.bk, a.splits) == ("splitk", 64, 128,
                                                         64, 4)
        assert (c.route, c.bm, c.bn, c.bk) == ("mma_sync", 16, 32, 256)
        assert b.route == "fma"   # 160 tiles of (16, 32): no split
        assert b.bk < c.bk        # fp32 tiles take twice the bytes
    finally:
        mk.plan_for.cache_clear()


def _cu(name: str) -> str:
    return (Path(mk.__file__).parents[1] / "csrc" / name).read_text()


def test_planner_constants_are_what_the_kernel_compiles():
    """``chip/h100.py`` plans for the kernels: the mma_sync kernel's tile
    list, ring depth, row padding and threads a block, and the TMA
    mainloop's tiles (of ``elk_matmul`` and of the MLP's down product),
    K depth, reserve, stage limit and budget, must be those of the CUDA
    sources."""
    # the TMA routes' source and the mma_sync / FMA one
    src = _cu("elk_matmul.cu") + _cu("elk_matmul_sync.cu")
    macro = re.search(r"#define ELK_MATMUL_TILES\(F\)((?:.*\\\n)*.*)", src)
    tiles = {(int(a), int(b))
             for a, b in re.findall(r"F\((\d+), (\d+)\)", macro.group(1))}
    assert tiles == {(bm, bn) for bm in h100.TILE_M for bn in h100.TILE_N}
    assert int(re.search(r"constexpr int kStages = (\d+);", src).group(1)) \
        == h100.STAGES
    assert int(re.search(r"constexpr int kPadBytes = (\d+);", src).group(1)) \
        == h100.ROW_PAD_BYTES
    rules = re.findall(r"kThreads = BM >= (\d+) \? (\d+) : (\d+);", src)
    assert len(rules) == 2          # the bf16 and the fp32 kernel
    for edge, big, small in rules:
        for bm in h100.TILE_M:
            assert h100.block_threads(bm) == int(
                big if bm >= int(edge) else small)
    mma = f"m{h100.MMA_M}n{h100.MMA_N}k{h100.MMA_K}"
    assert f"mma.sync.aligned.{mma}.row.col.f32.bf16" in src

    # the TMA routes: (consumer warpgroups, bn) instances
    want = {(bm // h100.WGMMA_M, bn) for bm in h100.WG_TILE_M
            for bn in h100.WG_TILE_N if h100.wg_acc_fits(bm, bn)}
    # the fp32 "fma" routes' tiles, stages and threads
    line = re.search(r"#define ELK_FMA_TILES\(F\)(.*)", src).group(1)
    assert tuple((int(a), int(b)) for a, b in
                 re.findall(r"F\((\d+), (\d+)\)", line)) == h100.FMA_TILES
    assert int(re.search(r"constexpr int kF32Stages = (\d+);", src).group(1)) \
        == h100.FMA_STAGES
    assert "kThreads = BM * BN >= 128 * 128 ? 256 : 128;" in src
    assert h100.fma_threads(128, 128) == 256 and h100.fma_threads(64, 128) \
        == 128
    # the realigning producer's widths, one consumer warpgroup
    line = re.search(r"#define ELK_REALIGN_TILES\(F\)(.*)", src).group(1)
    assert {(int(a), int(b)) for a, b in
            re.findall(r"F\((\d+), (\d+)\)", line)} \
        == {(1, bn) for bn in h100.REALIGN_TILE_N}
    for name, macro in (("elk_matmul.cu", "ELK_TMA_TILES"),
                        ("fused_mlp.cu", "FUSED_MLP_PASS2_TILES")):
        line = re.search(rf"#define {macro}\(F\)(.*)", _cu(name)).group(1)
        assert {(int(a), int(b)) for a, b in
                re.findall(r"F\((\d+), (\d+)\)", line)} == want, name
    hdr = _cu("hopper_gemm.cuh")

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", hdr).group(1))

    assert const("kBK") == h100.WG_BK
    assert const("kSmemBudget") == h100.SMEM_PER_BLOCK
    assert const("kSmemReserve") == h100.WG_SMEM_RESERVE
    assert const("kMaxStages") == h100.WG_MAX_STAGES
    assert const("kMaxSplits") == h100.MAX_SPLITS
    # stages_for as the header writes it, against the plan's
    assert "wg == 1 ? kSmemBudget / 2 - 1024 : kSmemBudget" in hdr
    # every instance, and the MLP's gated pass 1 (two b tiles a stage)
    for bm, bn, nb in [(64 * wg, bn, 1) for wg, bn in want] + [(128, 128, 2)]:
        stage = bm * 64 * 2 + nb * bn * 64 * 2
        budget = (h100.SMEM_PER_BLOCK // 2 - 1024 if bm == 64
                  else h100.SMEM_PER_BLOCK)
        header = min((budget - const("kSmemReserve")) // stage,
                     const("kMaxStages"))
        assert h100.wg_stages(bm, bn, nb)[0] == header, (bm, bn, nb)
    for bn in h100.WG_TILE_N:
        assert f"wgmma.mma_async.sync.aligned.m64n{bn}k16.f32.bf16.bf16" \
            in hdr
    assert "setmaxnreg.dec.sync.aligned.u32 40" in hdr
    assert "setmaxnreg.inc.sync.aligned.u32 232" in hdr
    assert h100.WGMMA_ACC_REGS == {128: 128, 64: 64}
    # the persistent x^T dy instances: their tiles, the epilogue tile's
    # padding, the ring beside it (xt_stages_for), the block order's groups
    line = re.search(r"#define ELK_XT_TILES\(F\)(.*)", _cu("elk_matmul.cu"))
    assert {(int(a), int(b)) for a, b in
            re.findall(r"F\((\d+), (\d+)\)", line.group(1))} \
        == {(bm // 64, bn) for bm, bn in h100.XT_TILES}
    assert const("kEpiPad") == h100.XT_EPI_PAD
    assert const("kGroupM") == h100.GROUP_M
    assert ("(wg == 1 ? kSmemBudget / 2 - 1024 : kSmemBudget) - 64 * wg * "
            "(bn * 2 + kEpiPad)") in hdr
    for bm, bn in h100.XT_TILES:
        wg, stage = bm // 64, (bm + bn) * 64 * 2
        budget = (h100.SMEM_PER_BLOCK // 2 - 1024 if wg == 1
                  else h100.SMEM_PER_BLOCK) - bm * (bn * 2 + const("kEpiPad"))
        header = min((budget - const("kSmemReserve")) // stage,
                     const("kMaxStages"))
        assert h100.xt_stages(bm, bn) == (header, 2 if wg == 1 else 1)
    assert "hg::GemmCfg<WG, BN, 1, false, true, false, false, false, true>" \
        in _cu("elk_matmul.cu")


# qwen3-14b's products, bf16: (m, n) with K = 5120 -> route
SERVING_ROUTES = {(m, n): ("wgmma" if m >= 64 else "splitk")
                  for m in (8, 32, 256, 4096) for n in (5120, 1024, 151936)
                  if n != 151936 or m <= 32}
# the same in fp32: "fma", and "fma_splitk" where the (16, 32) tiles of k/v
# (32 at a decode step, 64 at 32 rows) leave SMs without a block
FP32_ROUTES = {mn: ("fma_splitk" if mn in ((8, 1024), (32, 1024)) else "fma")
               for mn in SERVING_ROUTES}


@pytest.mark.parametrize("mn", sorted(SERVING_ROUTES))
def test_route_of_serving_shapes_pinned(mn):
    m, n = mn
    x = torch.empty((m, 5120), dtype=torch.bfloat16)
    y = torch.empty((5120, n), dtype=torch.bfloat16)
    assert mk.route_of(x, y) == SERVING_ROUTES[mn]
    # a tied head (the transpose of an (n, K) tensor) takes the same route
    assert mk.route_of(x, torch.empty((n, 5120), dtype=torch.bfloat16).t()) \
        == SERVING_ROUTES[mn]
    assert mk.route_of(x.float(), y.float()) == FP32_ROUTES[mn]


@pytest.mark.parametrize("mnk", SWEEP)
def test_route_of_the_sweep_shapes(mnk):
    """The reference's sweep: rows of 70 (K) or 129 (n) bf16 elements do
    not start on 16 bytes, so TMA cannot take them: mma_sync; the others
    take the TMA routes by their rows."""
    m, n, k = mnk
    x = torch.empty((m, k), dtype=torch.bfloat16)
    y = torch.empty((k, n), dtype=torch.bfloat16)
    want = ("mma_sync" if k % 8 or n % 8 else
            "wgmma" if m >= 64 else "splitk")
    assert mk.route_of(x, y) == want
    # y as the transpose of an (n, k) tensor: its rows are k long
    yt = torch.empty((n, k), dtype=torch.bfloat16).t()
    assert mk.route_of(x, yt) == ("mma_sync" if k % 8 else
                                  "wgmma" if m >= 64 else "splitk")


def test_route_of_strided_x():
    """A row stride TMA takes (3 K) keeps the TMA route; a base 2 bytes off
    16 does not."""
    y = torch.empty((64, 40), dtype=torch.bfloat16)
    x3 = torch.empty((100, 3, 64), dtype=torch.bfloat16)[:, 1, :]
    assert mk.route_of(x3, y) == "wgmma"
    assert mk.route_of(x3[:8], y) == "splitk"
    off = torch.empty((100, 65), dtype=torch.bfloat16)[:, 1:]
    assert mk.route_of(off, y) == "mma_sync"


def _both(arch: str, dtype: str = "float32"):
    jcfg = dataclasses.replace(jax_smoke_config(arch), dtype=dtype,
                               param_dtype=dtype)
    tcfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype,
                               param_dtype=dtype)
    jparams = jtfm.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, jparams, tcfg, params_from_jax(
        jax.tree.map(np.asarray, jparams), tcfg, device="cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_linear_with_bias_matches_jax(dtype):
    tx, jx = _pair((2, 7, 48), dtype, 4)
    tw, jw = _pair((48, 24), dtype, 5)
    tb, jb = _pair((24,), dtype, 6)
    _check(layers.linear(tx, tw, tb), jlayers.linear(jx, jw, jb), dtype)
    _check(layers.linear(tx, tw), jlayers.linear(jx, jw), dtype)


@pytest.mark.parametrize("arch", ["gemma_7b", "qwen3_14b"])
def test_logits_tied_and_untied_match_jax(arch):
    """gemma-7b ties its embeddings (the LM head is ``embed.t()``, a
    transposed view); qwen3-14b has its own head."""
    jcfg, jparams, tcfg, tparams = _both(arch)
    assert tcfg.tie_embeddings == (arch == "gemma_7b")
    tx, jx = _pair((2, 3, tcfg.d_model), "float32", 7)
    _check(tfm._logits(tparams, tcfg, tx), jtfm._logits(jparams, jcfg, jx),
           "float32")


@pytest.mark.parametrize("arch", ["qwen3_14b", "gemma_7b"])
def test_every_projection_and_the_head_go_through_ops_matmul(arch,
                                                               monkeypatch):
    """One ``ops.matmul`` call for each of q, k, v, o in every layer and one
    for the LM head, on each of the four passes."""
    cfg = get_smoke_config(arch)
    params = tfm.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    calls = []

    def counting(x, y, **kw):
        calls.append(tuple(y.shape))
        return matmul(x, y, **kw)

    monkeypatch.setattr(layers, "matmul", counting)
    per_pass = 4 * cfg.num_layers + 1
    with torch.inference_mode():
        cache = tfm.init_cache(cfg, tfm.CacheSpec(16, 2), "cpu")
        tokens = torch.randint(0, cfg.vocab_size, (2, 5),
                               generator=torch.Generator().manual_seed(1))
        counts = []
        logits, cache = tfm.prefill(params, cfg, tokens, cache)
        counts.append(len(calls))
        tfm.decode_step(params, cfg, tokens[:, 0], cache)
        counts.append(len(calls))
        slots = tfm.init_cache(cfg, tfm.CacheSpec(16, 2, per_slot=True),
                               "cpu")
        tfm.chunk_prefill(params, cfg, tokens[:, :3], slots)
        counts.append(len(calls))
        tfm.decode_slots(params, cfg, tokens[:, 3], slots)
        counts.append(len(calls))
    assert counts == [per_pass * i for i in range(1, 5)]
    head = (cfg.d_model, cfg.vocab_size)
    assert calls.count(head) == 4


# ---------------------------------------------------------------------------
# the routes TMA cannot take alone: the realigned y, and fp32
# ---------------------------------------------------------------------------

HYMBA_D, HYMBA_VOCAB, HYMBA_BC = 1600, 32001, 32


@pytest.mark.parametrize("m, route", [(1, "splitk_realign"),
                                      (8, "splitk_realign"),
                                      (63, "splitk_realign"),
                                      (64, "wgmma_realign"),
                                      (4096, "wgmma_realign")])
def test_route_of_hymba_head_is_realigned(m, route):
    """hymba-1.5b's untied LM head, (1600, 32001): rows 64002 bytes apart,
    which TMA refuses, so its tiles are loaded and realigned by the
    producer, on one consumer warpgroup; a tied head of the same shape (y
    K-major) and an x TMA refuses stay on mma_sync."""
    x = torch.empty((m, HYMBA_D), dtype=torch.bfloat16)
    y = torch.empty((HYMBA_D, HYMBA_VOCAB), dtype=torch.bfloat16)
    assert mk.route_of(x, y) == route
    plan = mk.plan_of(x, y)
    assert (plan.bm, plan.bn, plan.splits) == (64, 128, 1)
    assert mk.route_for(m, HYMBA_VOCAB, HYMBA_D, torch.bfloat16, HYMBA_D,
                        HYMBA_VOCAB) == route
    tied = torch.empty((HYMBA_VOCAB, HYMBA_D), dtype=torch.bfloat16).t()
    assert mk.route_of(x, tied) == ("wgmma" if m >= 64 else "splitk")
    odd_x = torch.empty((m, HYMBA_D + 1), dtype=torch.bfloat16)[:, 1:]
    assert mk.route_of(odd_x, y) == "mma_sync"


def test_route_of_unaligned_y_base_is_realigned():
    """A view of a weight whose base lies 2 bytes off 16: contiguous, or a
    column view of a wider weight on a row stride TMA would take or on an
    odd one."""
    x = torch.empty((8, 200), dtype=torch.bfloat16)
    flat = torch.empty(200 * 1000 + 1, dtype=torch.bfloat16)
    for y in (flat[1:].view(200, 1000),
              torch.empty((200, 1032), dtype=torch.bfloat16)[:, 1:1001],
              torch.empty((200, 1025), dtype=torch.bfloat16)[:, 1:]):
        assert y.data_ptr() % 16
        assert mk.route_of(x, y) == "splitk_realign"
        assert mk.route_of(torch.empty((100, 200), dtype=torch.bfloat16),
                           y) == "wgmma_realign"


# hymba-1.5b's fp32 products (w_dt 1600 x 1600, w_bc 1600 x 32) at a decode
# step, a chunk of 256 and a prefill: (m, n) -> (route, bm, bn, bk, tiles,
# splits, K tiles a split)
HYMBA_FP32_PLANS = {
    (8, 32): ("fma_splitk", 16, 32, 256, 1, 7, 1),
    (8, 1600): ("fma_splitk", 16, 32, 128, 50, 3, 5),
    (256, 32): ("fma_splitk", 16, 32, 256, 16, 7, 1),
    (256, 1600): ("fma", 32, 64, 64, 200, 1, 25),
    (4096, 32): ("fma", 16, 32, 128, 256, 1, 13),
    (4096, 1600): ("fma", 128, 128, 32, 416, 1, 50),
}


@pytest.mark.parametrize("mn", sorted(HYMBA_FP32_PLANS))
def test_fp32_plan_pinned_at_hymba_shapes(mn):
    """The fp32 plan from the shapes and the card alone: the tile that
    covers the SMs with the fewest bytes, else the smallest with K split
    over a cluster (at most MAX_SPLITS, every split a share, the last
    shorter); the ring of FMA_STAGES within the budget."""
    m, n = mn
    p = h100.smem_plan(m, n, HYMBA_D, dtype_bytes=4)
    assert (p.route, p.bm, p.bn, p.bk, p.tiles, p.splits,
            p.k_per_split) == HYMBA_FP32_PLANS[mn]
    k_tiles = -(-HYMBA_D // p.bk)
    assert (p.splits - 1) * p.k_per_split < k_tiles <= p.splits * p.k_per_split
    assert p.smem_bytes <= h100.SMEM_PER_BLOCK and p.stages == h100.FMA_STAGES
    assert (p.bm, p.bn) in h100.FMA_TILES and p.splits <= h100.MAX_SPLITS
    x = torch.empty((m, HYMBA_D))
    y = torch.empty((HYMBA_D, n))
    assert mk.route_of(x, y) == p.route
    # a forced block shape keeps the mma_sync kernel's FMA and its plan
    assert mk.plan_for(m, n, HYMBA_D, torch.float32,
                       mma_sync=True).route == "mma_sync"


@pytest.mark.parametrize("m, n, k, bk, splits", [
    (8, 32, 400, 32, 7),        # w_bc scaled down: 13 K tiles in 7 splits
    (8, 200, 200, 32, 3),       # w_dt scaled down
    (17, 64, 160, 16, 8),       # a ragged row tile, every split one tile
    (5, 40, 100, 64, 2),        # K ragged against the tile
])
def test_split_ref_matches_jax_kernel(m, n, k, bk, splits):
    """The plain split-and-combine version of "fma_splitk" (each split's
    partial in fp32, added in rank order) against the JAX ``elk_matmul`` in
    interpret mode and its oracle, fp32, the kernel tests' bound ``TOL *
    (max|ref| + 1)``; against ``matmul_ref`` within 1e-5 of it (the same
    sums in another order)."""
    from repro_torch.kernels.elk_matmul.ref import matmul_ref, matmul_split_ref
    tx, jx = _pair((m, k), "float32", 11)
    ty, jy = _pair((k, n), "float32", 12)
    got = matmul_split_ref(tx, ty, bk=bk, splits=splits)
    assert got.shape == (m, n) and got.dtype == torch.float32
    _check(got, jax_elk_matmul(jx, jy, bm=64, bn=64, bk=64, interpret=True),
           "float32")
    _check(got, jax_matmul_ref(jx, jy), "float32")
    ref = matmul_ref(tx, ty)
    assert float((got - ref).abs().max()) <= 1e-5 * (
        float(ref.abs().max()) + 1.0)
    # one split is the plain product
    assert torch.equal(matmul_split_ref(tx, ty, bk=bk, splits=1), ref)


# ---------------------------------------------------------------------------
# x^T dy: route "wgmma_xt", its plan and the persistent kernel's schedule
# ---------------------------------------------------------------------------

# (tokens, m, n): qwen3-14b's weight gradients at 4096 tokens (k/v, q/o,
# the LM head, the MLP's dw_down), gemma-7b's tied head, and the edges of
# the schedule: fewer tiles than SMs, a few more, a ragged m and n, K no
# multiple of 64
XT_SHAPES = [(4096, 5120, 1024), (4096, 5120, 5120), (4096, 5120, 151936),
             (4096, 17408, 5120), (4096, 3072, 256000), (60, 100, 70),
             (33, 129, 257), (257, 200, 328), (513, 64, 136),
             (512, 256, 384), (4096, 32, 200), (64, 512, 1024),
             (1000, 2176, 1920), (4096, 1700, 2500), (512, 32, 2048),
             (1000, 2176, 1024)]
# the plans of the timed x^T dy rows of chip_smoke.py: (bm, bn, clusters of
# the last wave, K tiles of a piece, blocks, tiles split)
XT_PLANS = {(4096, 5120, 1024): (128, 128, 1, 64, 132, 0),
            (4096, 5120, 5120): (128, 256, 2, 32, 132, 8),
            (4096, 5120, 151936): (128, 256, 1, 64, 132, 0),
            (4096, 17408, 5120): (128, 256, 1, 64, 132, 0),
            (512, 32, 2048): (64, 128, 8, 1, 128, 16),
            (1000, 2176, 1024): (128, 128, 4, 4, 120, 16)}


@pytest.mark.parametrize("k, m, n", XT_SHAPES)
def test_xt_plan_and_schedule_cover_every_tile_once(k, m, n):
    """The x^T dy plan: a tile of ``XT_TILES``, its ring and epilogue tile
    within the budget of the blocks an SM holds, at most MAX_SPLITS blocks a
    cluster, no more blocks than the SMs hold; its schedule is
    ``xt_schedule``'s, and the kernel's walk (``xt_units``) takes every
    (output tile, K tile) once, every block as many whole tiles as any
    other (one fewer where the last wave is ragged and not split), a split
    tile a cluster's, each rank a piece of K."""
    p = h100.smem_plan(m, n, k, x_trans=True)
    assert p.route == "wgmma_xt" and (p.bm, p.bn) in h100.XT_TILES
    stages, per_sm = h100.xt_stages(p.bm, p.bn)
    assert (p.stages, p.blocks_per_sm) == (stages, per_sm) and stages >= 2
    assert p.smem_bytes <= (h100.SMEM_PER_BLOCK // 2 - h100.SMEM_BLOCK_RESERVE
                            if per_sm == 2 else h100.SMEM_PER_BLOCK)
    resident = h100.xt_resident(h100.h100_sxm(), per_sm, p.splits)
    assert 1 <= p.splits <= h100.MAX_SPLITS and p.grid <= resident
    k_tiles = -(-k // h100.WG_BK)
    sched = h100.xt_schedule_of(p)
    assert sched == h100.xt_schedule(p.tiles, k_tiles, resident, p.splits)
    units = h100.xt_units(sched, k_tiles)
    seen = np.zeros((p.tiles, k_tiles), np.int64)
    for blk in units:
        for tile, k0, nk in blk:
            assert nk >= 1 and 0 <= tile < p.tiles
            seen[tile, k0:k0 + nk] += 1
    assert (seen == 1).all()
    whole = [sum(1 for t, _, _ in blk if t < sched.full) for blk in units]
    assert max(whole) - min(whole) <= (1 if p.splits == 1 else 0)
    for b, blk in enumerate(units):
        pieces = [u for u in blk if u[0] >= sched.full]
        assert len(pieces) <= 1 and (not pieces or blk[-1] == pieces[0])
        if pieces:
            assert pieces[0][0] == sched.full + b // p.splits
    if (k, m, n) in XT_PLANS:
        assert (p.bm, p.bn, p.splits, p.k_per_split, p.grid, p.tail) \
            == XT_PLANS[(k, m, n)]


def test_xt_schedule_rule():
    """``xt_schedule``: one block a tile up to the resident blocks, then
    whole waves; a split only of a short last wave (its tiles no more than
    the clusters), every rank of a cluster a K tile."""
    one = h100.xt_schedule(160, 64, 132, 1)
    assert (one.grid, one.full, one.tail, one.splits) == (132, 160, 0, 1)
    four = h100.xt_schedule(160, 64, 132, 4)
    assert (four.grid, four.full, four.tail, four.per) == (132, 132, 28, 16)
    assert h100.xt_schedule(160, 64, 130, 5) is None          # 30 > 26
    assert h100.xt_schedule(264, 64, 132, 2) is None          # no short wave
    assert h100.xt_schedule(200, 64, 132, 2) is None          # 68 > 66
    assert h100.xt_schedule(10, 3, 132, 4) is None            # a rank idle
    few = h100.xt_schedule(10, 64, 128, 8)
    assert (few.grid, few.full, few.tail, few.per) == (80, 0, 10, 8)
    # the blocks the H100 holds in clusters: whole clusters, never more
    # than the SMs hold; any other chip: the SMs' share
    for per_sm, row in h100.XT_RESIDENT.items():
        for s, blocks in enumerate(row, 1):
            assert blocks % s == 0 and blocks <= h100.SMS * per_sm
            assert h100.xt_resident(h100.h100_sxm(), per_sm, s) == blocks
    chip = dataclasses.replace(h100.h100_sxm(), num_cores=10)
    assert h100.xt_resident(chip, 1, 3) == 9


@pytest.mark.parametrize("mn", sorted(SERVING_ROUTES))
def test_xt_plan_cached_apart_from_the_forward(mn):
    """x read transposed takes its own plan, cached under its own key: the
    forward's plan at the serving shapes is the one it was, and x^T dy of
    the same (m, n, K) takes route "wgmma_xt"."""
    m, n = mn
    fwd = mk.plan_for(m, n, 5120, torch.bfloat16)
    xt = mk.plan_for(m, n, 5120, torch.bfloat16, x_trans=True)
    assert fwd.route == SERVING_ROUTES[mn] and xt.route == "wgmma_xt"
    assert fwd == h100.smem_plan(m, n, 5120)
    assert mk.plan_for(m, n, 5120, torch.bfloat16) is fwd
    x = torch.empty((5120, m), dtype=torch.bfloat16)
    dy = torch.empty((5120, n), dtype=torch.bfloat16)
    assert mk.plan_of(x.t(), dy) == xt
    assert mk.route_of(torch.empty((m, 5120), dtype=torch.bfloat16),
                       torch.empty((5120, n), dtype=torch.bfloat16)) \
        == SERVING_ROUTES[mn]
    # fp32 and strides TMA refuses keep their routes
    assert mk.route_of(torch.empty((5120, m)).t(), torch.empty((5120, n))) \
        in ("fma", "fma_splitk")
    odd = torch.empty((5120, m + 1), dtype=torch.bfloat16)[:, :m]
    assert mk.route_of(odd.t(), dy) == "mma_sync"


@pytest.mark.parametrize("k, m, n, cores", [
    (300, 384, 320, 4),     # 9 tiles on 4 SMs: two waves, one tile split
    (513, 64, 136, 4),      # 2 tiles, each split over 3 blocks (K 9 tiles)
    (200, 260, 700, 4),     # no split: 30 tiles dealt out over 8 blocks
    (130, 100, 70, 132),    # one tile, K split over 3 blocks, K ragged
])
def test_xt_split_ref_matches_jax_kernel(k, m, n, cores):
    """The plain mirror of route "wgmma_xt"'s sums (``matmul_xt_split_ref``:
    whole tiles one fp32 sum, split tiles' pieces added in rank order)
    under the plan for a card of ``cores`` SMs (few SMs, so that small
    shapes have waves and a split last one) against the JAX
    ``elk_matmul`` of the transposed x in interpret mode and its oracle,
    fp32, the kernel tests' bound; against ``matmul_ref`` within 1e-5 of
    it (the same sums in another order), equal where nothing is split."""
    from repro_torch.kernels.elk_matmul.ref import (matmul_ref,
                                                    matmul_xt_split_ref)
    chip = dataclasses.replace(h100.h100_sxm(), num_cores=cores)
    plan = h100.smem_plan(m, n, k, x_trans=True, chip=chip)
    tx, jx = _pair((k, m), "float32", 13)
    ty, jy = _pair((k, n), "float32", 14)
    got = matmul_xt_split_ref(tx.t(), ty, plan)
    assert got.shape == (m, n) and got.dtype == torch.float32
    _check(got, jax_elk_matmul(jx.T, jy, bm=64, bn=64, bk=64,
                               interpret=True), "float32")
    _check(got, jax_matmul_ref(jx.T, jy), "float32")
    ref = matmul_ref(tx.t(), ty)
    assert float((got - ref).abs().max()) <= 1e-5 * (
        float(ref.abs().max()) + 1.0)
    if plan.tail == 0:
        assert torch.equal(got, ref)
    else:
        assert plan.splits > 1
