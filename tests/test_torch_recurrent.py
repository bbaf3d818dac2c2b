"""The port's recurrences against the reference's, function by function, on
the CPU: RWKV6's ``wkv_step``, ``wkv_sequence``, ``time_mix``,
``channel_mix`` and ``rwkv_block`` (``models/rwkv.py``), and the SSM
branch's ``ssm_scan`` and ``ssm_branch`` (``models/ssm.py``).

Inputs are numpy draws from a seed, fp32 on both sides; layer parameters
are the reference's (``rwkv_layer_params``, ``ssm_params``) with their
constants replaced by draws, so that every parameter matters.  Tolerance:
relative 1e-5 (the two frameworks sum in different orders).  A sequence
run in two halves with the state carried must equal one pass.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import rwkv as jrwkv
from repro.models import ssm as jssm
from repro_torch.configs import get_smoke_config
from repro_torch.models import rwkv, ssm
from repro_torch.models import transformer as tfm

RTOL = 1e-5


def _close(got, ref) -> None:
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    assert np.max(np.abs(got - ref)) <= RTOL * (np.max(np.abs(ref)) + 1e-30)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def _cfg(arch: str):
    tcfg = dataclasses.replace(get_smoke_config(arch), dtype="float32",
                               param_dtype="float32")
    jcfg = dataclasses.replace(jax_smoke_config(arch), dtype="float32",
                               param_dtype="float32")
    return jcfg, tcfg


def _drawn(params: dict, rng, scale: float = 0.3) -> dict:
    """The reference's parameters with every leaf a fresh draw of its
    shape (norm scales, decay, bonus and the SSM's constants included)."""
    return {k: jnp.asarray(rng.normal(size=v.shape) * scale, jnp.float32)
            for k, v in params.items()}


def _rwkv_params(seed: int = 0):
    jcfg, tcfg = _cfg("rwkv6_7b")
    p = _drawn(jrwkv.rwkv_layer_params(jax.random.PRNGKey(seed), jcfg,
                                       jnp.float32),
               np.random.default_rng(seed))
    return jcfg, tcfg, p, {k: _t(v) for k, v in p.items()}


def _ssm_params(seed: int = 0):
    jcfg, tcfg = _cfg("hymba_1_5b")
    p = _drawn(jssm.ssm_params(jax.random.PRNGKey(seed), jcfg, jnp.float32),
               np.random.default_rng(seed))
    return jcfg, tcfg, p, {k: _t(v) for k, v in p.items()}


def test_wkv_step():
    rng = np.random.default_rng(1)
    b, h, d = 2, 3, 8
    state = rng.normal(size=(b, h, d, d))
    r, k, v = (rng.normal(size=(b, h, d)) for _ in range(3))
    w = rng.uniform(0.2, 0.99, size=(b, h, d))
    u = rng.normal(size=(h, d))
    jargs = [jnp.asarray(a, jnp.float32) for a in (state, r, k, v, w, u)]
    ref_state, ref_y = jrwkv.wkv_step(*jargs)
    got_state, got_y = rwkv.wkv_step(*map(_t, (state, r, k, v, w, u)))
    _close(got_state, ref_state)
    _close(got_y, ref_y)


@pytest.mark.parametrize("s", [1, 7])
def test_wkv_sequence_and_halves(s):
    rng = np.random.default_rng(2)
    b, h, d = 2, 2, 8
    r, k, v = (rng.normal(size=(b, h, s, d)) for _ in range(3))
    w = rng.uniform(0.2, 0.99, size=(b, h, s, d))
    u = rng.normal(size=(h, d))
    state = rng.normal(size=(b, h, d, d))
    jargs = [jnp.asarray(a, jnp.float32) for a in (r, k, v, w, u, state)]
    ref_y, ref_state = jrwkv.wkv_sequence(*jargs)
    targs = list(map(_t, (r, k, v, w, u, state)))
    y, st = rwkv.wkv_sequence(*targs)
    _close(y, ref_y)
    _close(st, ref_state)
    # two halves with the state carried: the same as one pass
    cut = s // 2
    halves = [[t[:, :, sl] for t in targs[:4]]
              for sl in (slice(0, cut), slice(cut, s))]
    y1, st1 = rwkv.wkv_sequence(*halves[0], targs[4], targs[5])
    y2, st2 = rwkv.wkv_sequence(*halves[1], targs[4], st1)
    _close(torch.cat([y1, y2], dim=2), ref_y)
    _close(st2, ref_state)


@pytest.mark.parametrize("with_state", [False, True])
def test_time_mix_and_channel_mix(with_state):
    jcfg, tcfg, jp, tp = _rwkv_params(3)
    rng = np.random.default_rng(4)
    b, s, d = 2, 6, tcfg.d_model
    h = tcfg.num_heads
    x = rng.normal(size=(b, s, d))
    state = (rng.normal(size=(b, h, d // h, d // h)) * 0.5
             if with_state else None)
    ref_out, ref_state = jrwkv.time_mix(
        jnp.asarray(x, jnp.float32), jp, jcfg,
        None if state is None else jnp.asarray(state, jnp.float32))
    out, new_state = rwkv.time_mix(_t(x), tp, tcfg,
                                   None if state is None else _t(state))
    _close(out, ref_out)
    _close(new_state, ref_state)
    _close(rwkv.channel_mix(_t(x), tp, tcfg),
           jrwkv.channel_mix(jnp.asarray(x, jnp.float32), jp, jcfg))


def test_rwkv_block_and_halves():
    jcfg, tcfg, jp, tp = _rwkv_params(5)
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 8, tcfg.d_model))
    ref_x, ref_state = jrwkv.rwkv_block(jnp.asarray(x, jnp.float32), jp,
                                        jcfg)
    got_x, got_state = rwkv.rwkv_block(_t(x), tp, tcfg)
    _close(got_x, ref_x)
    _close(got_state, ref_state)
    xa, sa = rwkv.rwkv_block(_t(x[:, :3]), tp, tcfg)
    xb, sb = rwkv.rwkv_block(_t(x[:, 3:]), tp, tcfg, sa)
    _close(torch.cat([xa, xb], dim=1), ref_x)
    _close(sb, ref_state)


@pytest.mark.parametrize("s", [5, 150])
def test_ssm_scan_and_halves(s):
    """Past ``SCAN_CHUNK`` steps (150 = two chunks and a tail) the decay
    and input terms are built a chunk at a time: the same values as the
    reference's whole-sequence tensors."""
    rng = np.random.default_rng(7)
    b, d, n = 2, 6, 4
    x = rng.normal(size=(b, s, d))
    dt = rng.uniform(0.01, 0.5, size=(b, s, d))
    b_t, c_t = (rng.normal(size=(b, s, n)) for _ in range(2))
    a = -rng.uniform(0.1, 2.0, size=(d, n))
    d_skip = rng.normal(size=(d,))
    state = rng.normal(size=(b, d, n))
    jargs = [jnp.asarray(v, jnp.float32)
             for v in (x, dt, b_t, c_t, a, d_skip, state)]
    ref_y, ref_state = jssm.ssm_scan(*jargs)
    targs = list(map(_t, (x, dt, b_t, c_t, a, d_skip, state)))
    y, st = ssm.ssm_scan(*targs)
    _close(y, ref_y)
    _close(st, ref_state)
    cut = s // 2 + 1
    first = [t[:, :cut] for t in targs[:4]]
    second = [t[:, cut:] for t in targs[:4]]
    y1, st1 = ssm.ssm_scan(*first, *targs[4:6], targs[6])
    y2, st2 = ssm.ssm_scan(*second, *targs[4:6], st1)
    _close(torch.cat([y1, y2], dim=1), ref_y)
    _close(st2, ref_state)


@pytest.mark.parametrize("with_state", [False, True])
def test_ssm_branch(with_state):
    jcfg, tcfg, jp, tp = _ssm_params(8)
    rng = np.random.default_rng(9)
    b, s, d = 2, 7, tcfg.d_model
    x = rng.normal(size=(b, s, d))
    state = (rng.normal(size=(b, d, tcfg.ssm_state))
             if with_state else None)
    ref_out, ref_state = jssm.ssm_branch(
        jnp.asarray(x, jnp.float32), jp, jcfg,
        None if state is None else jnp.asarray(state, jnp.float32))
    out, new_state = ssm.ssm_branch(_t(x), tp, tcfg,
                                    None if state is None else _t(state))
    _close(out, ref_out)
    _close(new_state, ref_state)


def test_parameters_have_the_reference_shapes_and_constants():
    """``rwkv_layer_params`` and ``ssm_params`` as the port draws them:
    the reference's shapes, and its constants (decay 0.5, bonus 0,
    dt_bias -4, a_log 0, d_skip 1)."""
    for arch, draw, jdraw in (
            ("rwkv6_7b", rwkv.rwkv_layer_params, jrwkv.rwkv_layer_params),
            ("hymba_1_5b", ssm.ssm_params, jssm.ssm_params)):
        jcfg, tcfg = _cfg(arch)
        init = tfm._Init(torch.Generator().manual_seed(0),
                         torch.device("cpu"), torch.float32)
        got = draw(init, tcfg)
        ref = jdraw(jax.random.PRNGKey(0), jcfg, jnp.float32)
        assert set(got) == set(ref)
        for key, val in ref.items():
            assert tuple(got[key].shape) == val.shape, key
            if float(jnp.std(val)) == 0.0:      # a constant of the reference
                np.testing.assert_array_equal(got[key].numpy(),
                                              np.asarray(val))
