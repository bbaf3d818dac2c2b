"""Mamba-style selective-scan branch of the port (hymba-1.5b's SSM heads).

Counterpart of ``src/repro/models/ssm.py``.  Per channel a state vector of
size N with data-dependent (dt, B, C):

    h_t = exp(dt_t * A) * h_{t-1} + dt_t * B_t * x_t
    y_t = C_t . h_t + D * x_t

The reference scans over time with ``lax.scan`` (no Pallas kernel); here it
is a plain fp32 loop over time.  The reference builds ``exp(dt A)`` and
``dt B x`` for the whole sequence first, (B, S, d, N) each: at B 8, S 512,
d 1600, N 16 that is 420 MB apiece in fp32.  ``ssm_scan`` builds them for
``SCAN_CHUNK`` steps at a time instead, with the same elementwise ops, so
the values are the same and the memory is a chunk's.  ``w_dt`` and ``w_bc``
are cast to fp32 and multiplied in fp32, as the reference does: on the card
``layers.linear`` takes them to ``elk_matmul``'s fp32 route (FMA, no TF32).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import linear, stand_in

SCAN_CHUNK = 64   # time steps whose decay and input terms are built at once


def ssm_scan(x, dt, b_t, c_t, a, d_skip, state):
    """x: (B,S,d) fp32; dt: (B,S,d); b_t/c_t: (B,S,N); a: (d,N);
    state: (B,d,N).  Returns (y (B,S,d), final_state).  On the meta
    device no step runs (``layers.stand_in``): the dry run counts the scan
    analytically."""
    if x.device.type == "meta":
        return stand_in((x, state), x, dt, b_t, c_t, a, d_skip, state)
    ys = []
    for t0 in range(0, x.shape[1], SCAN_CHUNK):
        sl = slice(t0, t0 + SCAN_CHUNK)
        da = torch.exp(dt[:, sl, :, None] * a)                    # (B,T,d,N)
        dbx = dt[:, sl, :, None] * b_t[:, sl, None, :] * x[:, sl, :, None]
        for t in range(da.shape[1]):
            state = da[:, t] * state + dbx[:, t]
            ys.append(torch.einsum("bdn,bn->bd", state, c_t[:, t0 + t]))
    if not ys:                      # no step: the scan's empty output
        return torch.zeros_like(x), state
    y = torch.stack(ys, dim=1) + d_skip * x                       # (B,S,d)
    return y, state


def ssm_branch(x: torch.Tensor, p: dict, cfg: ModelConfig,
               state: Optional[torch.Tensor] = None):
    """x: (B,S,d_model) -> (out, new_state (B,d,N) fp32)."""
    b, s, d = x.shape
    n = cfg.ssm_state
    f32 = torch.float32
    xz = linear(x, p["w_in"])                                     # (B,S,2d)
    xi, z = torch.chunk(xz, 2, dim=-1)
    xi = xi.to(f32).contiguous()
    dt = torch.nn.functional.softplus(linear(xi, p["w_dt"].to(f32))
                                      + p["dt_bias"].to(f32))
    bc = linear(xi, p["w_bc"].to(f32))                            # (B,S,2N)
    b_t, c_t = torch.chunk(bc, 2, dim=-1)
    a = -torch.exp(p["a_log"].to(f32))                            # (d,N)
    if state is None:
        state = torch.zeros((b, d, n), dtype=f32, device=x.device)
    y, new_state = ssm_scan(xi, dt, b_t, c_t, a, p["d_skip"].to(f32), state)
    out = linear(y.to(x.dtype) * torch.nn.functional.silu(z), p["w_out"])
    return out, new_state


def ssm_params(init, cfg: ModelConfig) -> dict:
    """The SSM branch's parameters with the reference's shapes and scales,
    drawn by ``transformer._Init``."""
    d, n = cfg.d_model, cfg.ssm_state
    s = d ** -0.5
    return {
        "w_in": init.normal((d, 2 * d), s),
        "w_dt": init.normal((d, d), s * 0.1),
        "dt_bias": init.full((d,), -4.0),     # softplus ~= 0.018
        "w_bc": init.normal((d, 2 * n), s),
        "a_log": init.zeros((d, n)),          # A = -1
        "d_skip": init.full((d,), 1.0),
        "w_out": init.normal((d, d), s),
    }
