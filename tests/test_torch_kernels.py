"""Plain PyTorch versions of the port's kernels against the JAX oracles.

The CUDA kernel itself runs only on the card and is held to
``composed_ref`` there by ``chip_smoke.py``.  Here, on the CPU, the same
numpy inputs go through the port's plain versions and the reference's
oracles, and ``composed_ref`` is held to the reference's Pallas kernel in
interpret mode: so the oracle the card compares against is itself pinned
to the TPU kernel it replaces.  The two-pass route's function
(``two_pass_ref``) is ``composed_ref`` bit for bit in fp32 and close to the
Pallas kernel in bf16; the route each shape takes is pinned.

Tolerances: fp32 1e-5 * (max|ref| + 1) between oracles (same arithmetic,
different summation order); bf16 6e-2 * (max|ref| + 1) (bf16 rounds at
different places in the two frameworks); against the Pallas kernel the
kernel tests' ``TOL`` (fp32 2e-4, bf16 6e-2, scaled the same way).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.elk_matmul.ref import matmul_ref as jax_matmul_ref
from repro.kernels.fused_mlp.kernel import fused_mlp_kernel as pallas_kernel
from repro.kernels.fused_mlp.ref import composed_ref as jax_composed_ref
from repro.kernels.fused_mlp.ref import fused_mlp_ref as jax_fused_mlp_ref
from repro_torch.kernels.dispatch import dispatch
from repro_torch.kernels.elk_matmul.ref import matmul_ref
from repro_torch.kernels.fused_mlp.kernel import (SPLIT_FF_MAX_M,
                                                  fused_mlp_kernel,
                                                  plan_splits, route_of)
from repro_torch.kernels.fused_mlp.ops import fused_mlp
from repro_torch.kernels.fused_mlp.ref import (composed_ref, fused_mlp_ref,
                                               two_pass_ref)

ORACLE_TOL = {"float32": 1e-5, "bfloat16": 6e-2}
KERNEL_TOL = {"float32": 2e-4, "bfloat16": 6e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# (M, D, FF, gated, bias, act): the sweep of the reference's kernel test
MLP_CASES = [
    (128, 128, 256, True, False, "silu"),     # GLU, block-aligned
    (64, 96, 200, True, False, "silu"),       # GLU, non-multiple of bf
    (100, 80, 144, False, True, "relu"),      # plain + biases, ragged m
    (33, 64, 257, False, False, "gelu"),      # plain, everything ragged
    (48, 64, 128, True, False, "silu"),       # the model-MLP parity shape
]


def _pair(a: np.ndarray, dtype: str):
    """One numpy array as (jax array, torch tensor) of ``dtype``."""
    return jnp.asarray(a, JDT[dtype]), torch.from_numpy(a).to(TDT[dtype])


def _err(out: torch.Tensor, ref) -> tuple[float, float]:
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    err = float(np.max(np.abs(out.to(torch.float32).numpy() - ref)))
    return err, float(np.max(np.abs(ref))) + 1.0


def _mlp_inputs(case, dtype, lead=None, seed=0):
    m, d, ff, gated, bias, act = case
    rng = np.random.default_rng(seed)
    arrays = {"x": rng.normal(size=(lead or (m,)) + (d,)),
              "w_up": rng.normal(size=(d, ff)) / np.sqrt(d),
              "w_down": rng.normal(size=(ff, d)) / np.sqrt(ff)}
    if gated:
        arrays["w_gate"] = rng.normal(size=(d, ff)) / np.sqrt(d)
    if bias:
        arrays["b_up"] = rng.normal(size=(ff,))
        arrays["b_down"] = rng.normal(size=(d,))
    pairs = {k: _pair(v.astype(np.float32), dtype) for k, v in arrays.items()}
    jargs = {k: v[0] for k, v in pairs.items()}
    targs = {k: v[1] for k, v in pairs.items()}
    return ((jargs.pop("x"), jargs.pop("w_up"), jargs.pop("w_down")), jargs,
            (targs.pop("x"), targs.pop("w_up"), targs.pop("w_down")), targs)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mnk", [(128, 128, 128), (256, 64, 512),
                                 (100, 60, 70), (33, 129, 257)])
def test_matmul_ref(mnk, dtype):
    m, n, k = mnk
    rng = np.random.default_rng(0)
    jx, tx = _pair(rng.normal(size=(m, k)).astype(np.float32), dtype)
    jy, ty = _pair(rng.normal(size=(k, n)).astype(np.float32), dtype)
    out = matmul_ref(tx, ty)
    assert out.dtype == TDT[dtype] and out.shape == (m, n)
    err, scale = _err(out, jax_matmul_ref(jx, jy))
    assert err <= ORACLE_TOL[dtype] * scale, (mnk, dtype, err)
    assert matmul_ref(tx, ty, out_dtype=torch.float32).dtype == torch.float32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", MLP_CASES)
def test_fused_mlp_refs(case, dtype):
    jpos, jkw, tpos, tkw = _mlp_inputs(case, dtype)
    act = case[-1]
    for port, ref in ((fused_mlp_ref, jax_fused_mlp_ref),
                      (composed_ref, jax_composed_ref)):
        out = port(*tpos, act=act, **tkw)
        assert out.dtype == TDT[dtype]
        err, scale = _err(out, ref(*jpos, act=act, **jkw))
        assert err <= ORACLE_TOL[dtype] * scale, (port.__name__, case, err)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", MLP_CASES)
def test_composed_ref_vs_pallas_kernel(case, dtype):
    """The oracle the CUDA kernel is held to agrees with the TPU kernel
    (interpret mode) that the CUDA kernel replaces."""
    jpos, jkw, tpos, tkw = _mlp_inputs(case, dtype)
    act = case[-1]
    ref = pallas_kernel(*jpos, act=act, bm=32, bf=128, interpret=True, **jkw)
    err, scale = _err(composed_ref(*tpos, act=act, **tkw), ref)
    assert err <= KERNEL_TOL[dtype] * scale, (case, dtype, err)


def test_refs_batched_lead_dims():
    case = (80, 64, 160, True, False, "silu")
    jpos, jkw, tpos, tkw = _mlp_inputs(case, "float32", lead=(2, 40))
    for port, ref in ((fused_mlp_ref, jax_fused_mlp_ref),
                      (composed_ref, jax_composed_ref)):
        out = port(*tpos, act="silu", **tkw)
        assert out.shape == (2, 40, 64)
        err, scale = _err(out, ref(*jpos, act="silu", **jkw))
        assert err <= ORACLE_TOL["float32"] * scale


@pytest.mark.parametrize("case", MLP_CASES)
def test_fused_mlp_on_cpu_takes_plain_path(case):
    """A CPU tensor never reaches the kernel wrapper: same bits as
    ``fused_mlp_ref``, and the launch count stays."""
    _, _, tpos, tkw = _mlp_inputs(case, "float32")
    before = fused_mlp_kernel.launches
    out = fused_mlp(*tpos, act=case[-1], **tkw)
    assert torch.equal(out, fused_mlp_ref(*tpos, act=case[-1], **tkw))
    assert fused_mlp_kernel.launches == before


def test_dispatch_goes_by_device():
    x = torch.zeros(2)
    assert dispatch(x, lambda: "kernel", lambda: "plain") == "plain"
    with pytest.raises(ValueError, match="no kernel route"):
        dispatch(torch.zeros(2, device="meta"), lambda: 0, lambda: 1)


def test_kernel_wrapper_refuses_cpu_tensors():
    """The wrapper launches or raises; it has no plain path of its own."""
    _, _, tpos, tkw = _mlp_inputs(MLP_CASES[0], "float32")
    with pytest.raises(ValueError, match="CUDA tensor"):
        fused_mlp_kernel(*tpos, tkw["w_gate"])


@pytest.mark.parametrize("breakage, error, says", [
    ("dtype", TypeError, "float32 or bfloat16"),
    ("w_up_shape", ValueError, "w_up has shape"),
    ("w_down_shape", ValueError, "w_down has shape"),
    ("one_bias", ValueError, "both or not at all"),
    ("gate_and_bias", ValueError, "takes no biases"),
    ("act", ValueError, "unknown activation"),
    ("strided", ValueError, "w_up is not contiguous"),
    ("mixed_dtype", TypeError, "w_down is torch.float32"),
])
def test_kernel_wrapper_rejects(breakage, error, says):
    """Checks run before anything touches the card; ``meta`` tensors stand
    in for CUDA tensors so the checks are reachable here."""
    class OnCard(torch.Tensor):
        is_cuda = True

    def t(*shape, dtype=torch.bfloat16):
        return torch.empty(shape, dtype=dtype, device="meta"
                           ).as_subclass(OnCard)

    x, w_up, w_down = t(4, 16), t(16, 32), t(32, 16)
    kw = {}
    if breakage == "dtype":
        x, w_up, w_down = (t(4, 16, dtype=torch.float16),
                           t(16, 32, dtype=torch.float16),
                           t(32, 16, dtype=torch.float16))
    elif breakage == "w_up_shape":
        w_up = t(15, 32)
    elif breakage == "w_down_shape":
        w_down = t(31, 16)
    elif breakage == "one_bias":
        kw["b_up"] = t(32)
    elif breakage == "gate_and_bias":
        kw.update(w_gate=t(16, 32), b_up=t(32), b_down=t(16))
    elif breakage == "act":
        kw["act"] = "tanh"
    elif breakage == "strided":
        w_up = t(32, 16).t()
    elif breakage == "mixed_dtype":
        w_down = t(32, 16, dtype=torch.float32)
    with pytest.raises(error, match=says):
        fused_mlp_kernel(x, w_up, w_down, **kw)


def test_plan_splits_covers_every_chunk():
    for m, ff, bm, bf, per_sm in [(8, 17408, 16, 64, 4),
                                  (4096, 17408, 128, 256, 1),
                                  (33, 257, 32, 64, 4), (100, 144, 128, 256, 1),
                                  (1, 1, 16, 64, 4), (10 ** 6, 300, 128, 256, 1)]:
        per_split, splits = plan_splits(m, ff, bm, bf, per_sm)
        chunks = -(-ff // bf)
        assert per_split >= 1 and splits >= 1
        assert (splits - 1) * per_split < chunks <= splits * per_split
    # decode: one row tile, the splits fill the card; prefill: few splits
    assert plan_splits(8, 17408, 16, 64, 4) == (1, 272)
    assert plan_splits(4096, 17408, 128, 256, 1) == (17, 4)


# qwen3-14b's MLP (d 5120, ff 17408), bf16: rows -> route
MLP_SERVING_ROUTES = {8: "two_pass", 32: "two_pass", 256: "two_pass",
                      4096: "two_pass"}


@pytest.mark.parametrize("m", sorted(MLP_SERVING_ROUTES))
def test_route_of_serving_shapes_pinned(m):
    bf = torch.bfloat16
    x = torch.empty((m, 5120), dtype=bf)
    w_up, w_gate = torch.empty((5120, 17408), dtype=bf), torch.empty(
        (5120, 17408), dtype=bf)
    w_down = torch.empty((17408, 5120), dtype=bf)
    assert route_of(x, w_up, w_down, w_gate) == MLP_SERVING_ROUTES[m]
    assert route_of(x.float(), w_up.float(), w_down.float(),
                    w_gate.float()) == "fma"


def test_route_of_crossover_and_tma_rules():
    """R (``SPLIT_FF_MAX_M``) is the crossover chip_smoke.py measured; the
    two-pass route also needs what TMA takes (d, ff, d_out multiples of 8,
    bases on 16 bytes)."""
    assert SPLIT_FF_MAX_M == 0
    bf = torch.bfloat16

    def route(m, d, ff, gated=True, offset=0):
        x = torch.empty((m * d + offset,), dtype=bf)[offset:].view(m, d)
        w = torch.empty((d, ff), dtype=bf)
        return route_of(x, w, torch.empty((ff, d), dtype=bf),
                        w if gated else None)

    for m in (1, 8, 17, 4096):
        assert route(m, 64, 128) == "two_pass"
        assert route(m, 64, 128, gated=False) == "two_pass"
    for m, d, ff, gated, _, _ in MLP_CASES:
        want = ("two_pass" if m > SPLIT_FF_MAX_M and d % 8 == 0
                and ff % 8 == 0 else "split_ff")
        assert route(m, d, ff, gated) == want, (m, d, ff)
    assert route(200, 80, 257) == "split_ff"     # rows of 514 bytes
    assert route(200, 80, 144, offset=1) == "split_ff"   # base off 16 bytes


@pytest.mark.parametrize("case", MLP_CASES)
def test_two_pass_ref_is_composed_ref_in_fp32(case):
    _, _, tpos, tkw = _mlp_inputs(case, "float32")
    act = case[-1]
    assert torch.equal(two_pass_ref(*tpos, act=act, **tkw),
                       composed_ref(*tpos, act=act, **tkw))


@pytest.mark.parametrize("case", MLP_CASES)
def test_two_pass_ref_vs_pallas_kernel_bf16(case):
    """h formed in fp32 and rounded once, then the down product: within the
    kernel tests' bf16 tolerance of the TPU kernel in interpret mode."""
    jpos, jkw, tpos, tkw = _mlp_inputs(case, "bfloat16")
    act = case[-1]
    ref = pallas_kernel(*jpos, act=act, bm=32, bf=128, interpret=True, **jkw)
    out = two_pass_ref(*tpos, act=act, **tkw)
    assert out.dtype == torch.bfloat16 and out.shape == tpos[0].shape[:-1] + (
        tpos[2].shape[1],)
    err, scale = _err(out, ref)
    assert err <= KERNEL_TOL["bfloat16"] * scale, (case, err)


def test_kernel_wrapper_rejects_an_unknown_route():
    class OnCard(torch.Tensor):
        is_cuda = True

    def t(*shape):
        return torch.empty(shape, dtype=torch.bfloat16, device="meta"
                           ).as_subclass(OnCard)

    with pytest.raises(ValueError, match="unknown route"):
        fused_mlp_kernel(t(4, 16), t(16, 32), t(32, 16), route="one_pass")
