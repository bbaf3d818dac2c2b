"""The gradients of the port's three kernel ops, against JAX's.

Each op (``elk_matmul.ops.matmul``, ``fused_mlp.ops.fused_mlp``,
``flash_attention.ops.flash_attn``) is an autograd Function whose backward
runs a hand-written kernel on the card and its plain version on a CPU
tensor.  Here, on the CPU: each plain backward against ``jax.grad`` of the
reference's counterpart on the same numpy inputs (the einsum of
``layers.linear``, ``kernels/fused_mlp/ref.fused_mlp_ref``,
``layers.gqa_attention`` with the reference's mask); each Function under
``torch.autograd.gradcheck`` in float64; the forward's log-sum-exp; the
serving paths bypassing the Functions; and the constants of the CUDA
sources that the wrappers repeat.

Tolerances: fp32, 2e-5 * (max|ref| + 1) for the products (one fp32 sum
each, in other orders), 1e-4 * (max|ref| + 1) for attention (softmax
recomputed from the log-sum-exp, exp of a difference of fp32 numbers).
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fused_mlp.ref import fused_mlp_ref as jax_fused_mlp_ref
from repro.models import layers as jlayers
from repro_torch.chip import h100
from repro_torch.kernels.elk_matmul import ops as matmul_ops
from repro_torch.kernels.elk_matmul.ops import matmul
from repro_torch.kernels.elk_matmul.ref import matmul2_ref, matmul_bwd_ref
from repro_torch.kernels.flash_attention import kernel as fk
from repro_torch.kernels.flash_attention.ops import flash_attn
from repro_torch.kernels.flash_attention.ref import (mha_bwd_ref, mha_lse_ref,
                                                     mha_ref)
from repro_torch.kernels.fused_mlp import kernel as mk
from repro_torch.kernels.fused_mlp.ops import fused_mlp
from repro_torch.kernels.fused_mlp.ref import fused_mlp_bwd_ref

CSRC = Path(fk.__file__).resolve().parents[1] / "csrc"


def _rng(seed=0):
    return np.random.default_rng(seed)


def _assert_close(got: torch.Tensor, want, tol: float):
    want = np.asarray(want, np.float32)
    err = float(np.max(np.abs(got.detach().float().numpy() - want)))
    assert err <= tol * (float(np.max(np.abs(want))) + 1.0), err


@pytest.mark.parametrize("m,k,n", [(7, 13, 5), (64, 96, 33), (1, 8, 16)])
def test_matmul_bwd_ref_matches_jax(m, k, n):
    r = _rng()
    x, y, dy = (r.normal(size=s).astype(np.float32)
                for s in ((m, k), (k, n), (m, n)))
    _, vjp = jax.vjp(lambda a, b: jnp.einsum("md,df->mf", a, b), x, y)
    jdx, jdy = vjp(dy)
    dx, dw = matmul_bwd_ref(*(torch.from_numpy(t) for t in (x, y, dy)))
    _assert_close(dx, jdx, 2e-5)
    _assert_close(dw, jdy, 2e-5)
    # the two-part product of the MLP's dx: one sum of both
    x2, y2 = r.normal(size=(m, k)).astype(np.float32), \
        r.normal(size=(k, n)).astype(np.float32)
    two = matmul2_ref(*(torch.from_numpy(t) for t in (x, y, x2, y2)))
    _assert_close(two, x @ y + x2 @ y2, 2e-5)


MLPS = [("silu", True, False), ("gelu", False, True), ("relu", False, False),
        ("gelu", True, False)]


@pytest.mark.parametrize("act,gated,bias", MLPS)
def test_fused_mlp_bwd_ref_matches_jax(act, gated, bias):
    r = _rng(1)
    d, ff, dout, lead = 24, 40, 24, (2, 5)
    x = r.normal(size=(*lead, d)).astype(np.float32)
    w_up = (r.normal(size=(d, ff)) * d ** -0.5).astype(np.float32)
    w_down = (r.normal(size=(ff, dout)) * ff ** -0.5).astype(np.float32)
    w_gate = (r.normal(size=(d, ff)) * d ** -0.5).astype(np.float32) \
        if gated else None
    b_up = r.normal(size=(ff,)).astype(np.float32) * 0.1 if bias else None
    b_down = r.normal(size=(dout,)).astype(np.float32) * 0.1 if bias else None
    dy = r.normal(size=(*lead, dout)).astype(np.float32)
    names = ["x", "w_up", "w_down"] + (["w_gate"] if gated else []) \
        + (["b_up", "b_down"] if bias else [])
    vals = {"x": x, "w_up": w_up, "w_down": w_down, "w_gate": w_gate,
            "b_up": b_up, "b_down": b_down}

    def f(*args):
        kw = dict(zip(names, args))
        return jax_fused_mlp_ref(kw.pop("x"), kw.pop("w_up"),
                                 kw.pop("w_down"), act=act, **kw)

    _, vjp = jax.vjp(f, *(vals[n] for n in names))
    want = dict(zip(names, vjp(dy)))
    t = {n: None if v is None else torch.from_numpy(v)
         for n, v in vals.items()}
    got = fused_mlp_bwd_ref(t["x"], t["w_up"], t["w_down"],
                            torch.from_numpy(dy), w_gate=t["w_gate"],
                            b_up=t["b_up"], b_down=t["b_down"], act=act)
    for n in names:
        _assert_close(got[n], want[n], 2e-5)
    assert all(got[n] is None for n in set(got) - set(names))


ATTN = [  # b, hq, hkv, sq, sk, d, causal, window
    (2, 4, 4, 9, 9, 16, True, 0),
    (1, 5, 1, 12, 12, 8, True, 4),
    (2, 8, 2, 7, 7, 16, False, 0),
    (1, 7, 1, 5, 13, 8, False, 0),      # cross-attention, Sq != Sk
    (1, 2, 2, 37, 37, 256, True, 0),    # gemma-7b's head dim, G 1, ragged S
]


@pytest.mark.parametrize("case", ATTN)
def test_mha_bwd_ref_matches_jax(case):
    b, hq, hkv, sq, sk, d, causal, window = case
    r = _rng(2)
    q = r.normal(size=(b, hq, sq, d)).astype(np.float32)
    k = r.normal(size=(b, hkv, sk, d)).astype(np.float32)
    v = r.normal(size=(b, hkv, sk, d)).astype(np.float32)
    dout = r.normal(size=(b, hq, sq, d)).astype(np.float32)
    spec = jlayers.AttnSpec(num_heads=hq, num_kv_heads=hkv, head_dim=d,
                            causal=causal, sliding_window=window)
    bias = jlayers.attn_mask_bias(spec, jnp.arange(sq), jnp.arange(sk))
    jout, vjp = jax.vjp(lambda a, bb, c: jlayers.gqa_attention(
        a, bb, c, bias, spec), q, k, v)
    jdq, jdk, jdv = vjp(dout)
    tq, tk, tv, tdo = (torch.from_numpy(t) for t in (q, k, v, dout))
    out, lse = mha_lse_ref(tq, tk, tv, causal=causal, window=window)
    _assert_close(out, jout, 1e-5)
    assert torch.equal(out, mha_ref(tq, tk, tv, causal=causal,
                                    window=window))
    dq, dk, dv = mha_bwd_ref(tq, tk, tv, out, tdo, lse, causal=causal,
                             window=window)
    for got, want in ((dq, jdq), (dk, jdk), (dv, jdv)):
        _assert_close(got, want, 1e-4)


def test_lse_of_a_row_with_no_live_key_is_inf_and_its_gradient_zero():
    """A row with no live key (here: a window of 1 cut off by nothing, and
    the causal mask on Sq > Sk is refused) has output 0; its lse is +inf
    so that the backward's exp(s - lse) is 0 on it."""
    q = torch.randn(1, 2, 4, 8)
    k = torch.randn(1, 2, 4, 8)
    v = torch.randn(1, 2, 4, 8)
    out, lse = mha_lse_ref(q, k, v, causal=True, window=1)
    assert torch.isfinite(lse).all()     # the diagonal is always live
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * 8 ** -0.5
    assert torch.allclose(lse, s.diagonal(dim1=2, dim2=3), atol=1e-6)
    dead = torch.full_like(lse, float("inf"))
    dq, dk, dv = mha_bwd_ref(q, k, v, torch.zeros_like(out),
                             torch.randn_like(out), dead, causal=True)
    assert not dq.any() and not dk.any() and not dv.any()


def _f64(*shape):
    return torch.randn(*shape, dtype=torch.float64, requires_grad=True)


@pytest.mark.parametrize("case", [
    (1, 2, 2, 5, 5, 8, True, 0), (1, 3, 1, 6, 6, 8, True, 3),
    (1, 4, 2, 4, 4, 8, False, 0), (1, 2, 1, 3, 5, 8, False, 0)])
def test_flash_attn_gradcheck(case):
    b, hq, hkv, sq, sk, d, causal, window = case
    torch.manual_seed(0)
    assert torch.autograd.gradcheck(
        lambda q, k, v: flash_attn(q, k, v, causal=causal, window=window),
        (_f64(b, hq, sq, d), _f64(b, hkv, sk, d), _f64(b, hkv, sk, d)))


@pytest.mark.parametrize("act,gated,bias", MLPS)
def test_fused_mlp_gradcheck(act, gated, bias):
    torch.manual_seed(1)
    x, w_up, w_down = _f64(2, 3, 6), _f64(6, 10), _f64(10, 5)
    if gated:
        assert torch.autograd.gradcheck(
            lambda x, u, d, g: fused_mlp(x, u, d, w_gate=g, act=act),
            (x, w_up, w_down, _f64(6, 10)))
    else:
        kw = (_f64(10), _f64(5)) if bias else ()
        assert torch.autograd.gradcheck(
            lambda x, u, d, *b: fused_mlp(x, u, d, b_up=b[0] if b else None,
                                          b_down=b[1] if b else None,
                                          act=act),
            (x, w_up, w_down, *kw))


def test_matmul_gradcheck():
    torch.manual_seed(2)
    assert torch.autograd.gradcheck(matmul, (_f64(5, 6), _f64(6, 7)))
    # a tied head: y the transpose of an (n, k) tensor
    assert torch.autograd.gradcheck(lambda x, e: matmul(x, e.t()),
                                    (_f64(5, 6), _f64(7, 6)))


def test_serving_paths_bypass_the_functions(monkeypatch):
    """Under inference mode (every serving phase) or with no operand that
    requires grad, the ops call the kernel or its plain version directly:
    no autograd Function, no log-sum-exp, the serving routes untouched."""
    def refuse(*a, **k):
        raise AssertionError("an autograd Function ran")

    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.fused_mlp import ops as mlp_ops
    for mod, name in ((matmul_ops, "_Matmul"), (mlp_ops, "_FusedMlp"),
                      (flash_ops, "_FlashAttn")):
        monkeypatch.setattr(getattr(mod, name), "apply", refuse)
    w = torch.randn(6, 7, requires_grad=True)
    with torch.inference_mode():
        matmul(torch.randn(3, 6), w)
        fused_mlp(torch.randn(3, 6), w, torch.randn(7, 6))
        q = torch.randn(1, 2, 4, 8)
        flash_attn(q, q, q)
    with torch.no_grad():
        matmul(torch.randn(3, 6), w)
    matmul(torch.randn(3, 6), torch.randn(6, 7))


def test_backward_wrappers_refuse_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA tensor"):
        mk.fused_mlp_bwd_kernel(torch.zeros(4, 8), torch.zeros(8, 16),
                                torch.zeros(16, 8), torch.zeros(4, 8))
    q = torch.zeros(1, 2, 4, 8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fk.flash_attention_bwd_kernel(q, q, q, q, q, torch.zeros(1, 2, 4))


def test_bwd_routes():
    x = torch.empty(64, 128, dtype=torch.bfloat16)
    w_up = torch.empty(128, 256, dtype=torch.bfloat16)
    w_down = torch.empty(256, 128, dtype=torch.bfloat16)
    assert mk.bwd_route_of(x, w_up, w_down) == "fused"
    assert mk.bwd_route_of(x, w_up, w_down, w_up) == "fused"
    assert mk.bwd_route_of(x.float(), w_up.float(), w_down.float()) == "fma"
    assert mk.bwd_route_of(torch.empty(64, 100, dtype=torch.bfloat16),
                           torch.empty(100, 36, dtype=torch.bfloat16),
                           torch.empty(36, 100, dtype=torch.bfloat16)) \
        == "fma"
    # attention: "wgmma" for bf16 at its head dims, "mma_sync" for the other
    # bf16 ones, "fma" for fp32 at any
    for d in fk.BWD_HEAD_DIMS:
        q = torch.empty(1, 2, 4, d, dtype=torch.bfloat16)
        want = "wgmma" if d in fk.BWD_WGMMA_HEAD_DIMS else "mma_sync"
        assert fk.bwd_route_of(q) == want
        assert fk.bwd_route_of(q.float()) == "fma"
    assert set(fk.BWD_WGMMA_HEAD_DIMS) <= set(fk.BWD_HEAD_DIMS)
    assert {fk.bwd_route_of(torch.empty(1, 2, 4, d, dtype=torch.bfloat16))
            for d in (16, 32)} == {"mma_sync"}
    assert set(fk.BWD_ROUTES) == {"wgmma", "mma_sync", "fma"}
    assert set(mk.BWD_ROUTES) == {"fused", "fma"}


def test_bwd_constants_are_what_the_kernels_compile():
    """The head dims each backward route of attention compiles, the
    constants of route "wgmma" and the tile of the fused MLP pass are the
    Python plans'; the forward's launcher takes the lse buffer; the
    FMA tile kernel's epilogue modes are the header's; the MLP's two weight
    gradients are the mainloop's instance with x^T as A and two outputs."""
    src = (CSRC / "flash_attention_bwd.cu").read_text()
    cases = {int(c) for c in re.findall(r"case (\d+): return launch_mma<",
                                        src)}
    assert cases == set(fk.BWD_MMA_HEAD_DIMS)
    assert set(fk.BWD_HEAD_DIMS) <= set(fk.MMA_HEAD_DIMS)
    assert set(fk.BWD_HEAD_DIMS) == \
        set(fk.BWD_MMA_HEAD_DIMS) | set(fk.BWD_WGMMA_HEAD_DIMS)
    wg = (CSRC / "flash_attention_bwd_wgmma.cu").read_text()
    assert {int(c) for c in re.findall(r"case (\d+): return launch<", wg)} \
        == set(fk.BWD_WGMMA_HEAD_DIMS)
    dims = re.search(r"static_assert\((D == 64(?: \|\| D == \d+)*),", wg)
    assert {int(d) for d in re.findall(r"D == (\d+)", dims.group(1))} \
        == set(fk.BWD_WGMMA_HEAD_DIMS)

    def const(name, text=wg):
        return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))

    assert const("kBwdBlockRows") == fk.BWD_BLOCK_ROWS
    assert const("kBwdTile") == fk.BWD_TILE
    assert const("kBwdDqThreads") == fk.BWD_DQ_THREADS == 2 * 128 + 32
    assert const("kBwdDkvThreads") == fk.BWD_DKV_THREADS == 2 * 128 + 32
    assert const("kBwdDqStages") == fk.BWD_DQ_STAGES
    assert const("kBwdDkvStages") == fk.BWD_DKV_STAGES
    assert const("kBwdSplitStages") == fk.BWD_SPLIT_STAGES
    # 72-112 in the layout of 128, 256 in its own
    assert "d <= 64 ? 64 : d <= 128 ? 128 : 256" in wg
    assert "static constexpr bool SPLIT = D > 128;" in wg
    rs = (CSRC / "wgmma_rs.cuh").read_text()
    for d in fk.BWD_WGMMA_HEAD_DIMS:
        assert f"wgmma.mma_async.sync.aligned.m64n{d}k16.f32.bf16.bf16" in rs
    assert "float* lse, int b," in (CSRC / "flash_attention.cu").read_text()
    hdr = (CSRC / "hopper_gemm.cuh").read_text()
    assert "kEpiPre = 3, kEpiDeriv = 4" in hdr
    mlp = (CSRC / "fused_mlp_bwd.cu").read_text()
    assert "using WGrad = hg::GemmCfg<2, 128, 2, false, true, true>;" in mlp
    assert const("kFusedBN", mlp) == mk.FUSED_BN
    assert re.search(r"static constexpr int BN = kFusedBN, BM = (\d+),",
                     mlp).group(1) == str(mk.FUSED_BM)
    assert {g for g in re.findall(r"launch_fused<FusedCfg<(true|false)>>",
                                  mlp)} == {"true", "false"}


def test_bwd_launchers_take_one_argument_list():
    """Both libraries of attention's backward export a launcher of the same
    parameter types, the list ``_bwd_lib`` declares (10 pointers, 6 ints,
    12 strides, causal, window, scale, dtype, passes, stream), so one call
    in the wrapper serves every route; the pass bits are the wrapper's."""
    def params(text, name):
        body = re.search(rf"int {name}\(([^)]*)\)", text).group(1)
        kinds = []
        for p in body.split(","):
            p = p.strip()
            kinds.append("ptr" if "*" in p else p.rsplit(" ", 1)[0])
        return kinds

    old = params((CSRC / "flash_attention_bwd.cu").read_text(),
                 "flash_attention_bwd_launch")
    wg = (CSRC / "flash_attention_bwd_wgmma.cu").read_text()
    assert params(wg, "flash_attention_bwd_wgmma_launch") == old
    assert old == (["ptr"] * 10 + ["int"] * 6 + ["long long"] * 12
                   + ["int"] * 2 + ["float", "int", "int", "ptr"])
    for text in (wg, (CSRC / "flash_attention_bwd.cu").read_text()):
        assert "constexpr int kPassDq = 1;" in text
        assert "constexpr int kPassDkv = 2;" in text
    assert (fk.BWD_PASS_DQ, fk.BWD_PASS_DKV) == (1, 2)


def test_new_bwd_instances_fit_shared_memory():
    """Every instance this backward compiles fits the 232,448 bytes a block
    may take, by the Python plans: route "wgmma"'s two passes at each head
    dim, the fused MLP pass (gated and plain) with its outputs staged over
    its ring, the weight gradients' instance."""
    budget = h100.SMEM_PER_BLOCK
    assert budget == 232448
    assert 256 in fk.BWD_WGMMA_HEAD_DIMS
    for d in fk.BWD_WGMMA_HEAD_DIMS:
        dq, dkv = fk.bwd_wgmma_smem(d)
        assert dq <= budget and dkv <= budget, d
    bn = mk.FUSED_BN
    for gated in (True, False):
        stages, smem = mk.fused_bwd_plan(gated)
        assert 2 <= stages <= h100.WG_MAX_STAGES and smem <= budget
        ring = stages * (mk.FUSED_BM + (2 if gated else 1) * bn) * 64 * 2
        assert 3 * mk.FUSED_BM * (bn + 8) * 2 <= ring
    stages, _ = h100.wg_stages(128, 128, 2)
    assert h100.wg_smem_bytes(128, 128, stages, 2) <= budget
