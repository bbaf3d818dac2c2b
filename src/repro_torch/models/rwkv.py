"""RWKV6 "Finch" time-mix and channel-mix of the port (rwkv6-7b).

Counterpart of ``src/repro/models/rwkv.py``.  Data-dependent decay WKV
recurrence, per head with state S in R^{D x D}:

    y_t = r_t @ (S_t + diag(u) k_t v_t^T)
    S_{t+1} = diag(w_t) S_t + k_t v_t^T          w_t = exp(-exp(ww_t))

The reference runs the sequence as a ``lax.scan`` over time (no Pallas
kernel); here it is a plain fp32 loop over time of the same few tensor ops,
which on the card runs as PyTorch's own kernels, one small launch each, a
pass of S steps a layer.  The products around it (r, k, v, g, decay, o and
the channel mix's two) are ``layers.linear`` calls, so they reach
``kernels/elk_matmul`` on the card.  ``ln_x`` is the ``1 + scale`` RMS norm
over all of d (the reference's stand-in for RWKV's per-head group norm).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import linear, rms_norm, stand_in


def wkv_step(state: torch.Tensor, r, k, v, w, u):
    """One recurrence step.  state: (B,H,D,D); r,k,v,w: (B,H,D); u: (H,D).
    Returns (new_state, y (B,H,D))."""
    kv = k[..., :, None] * v[..., None, :]              # (B,H,D,D)
    y = torch.einsum("bhd,bhde->bhe", r, state + u[..., :, None] * kv)
    new_state = w[..., :, None] * state + kv
    return new_state, y


def wkv_sequence(r, k, v, w, u, state):
    """r,k,v,w: (B,H,S,D) fp32; u: (H,D); state: (B,H,D,D).
    Returns (y (B,H,S,D), final_state).  On the meta device no step
    runs (``layers.stand_in``): the dry run counts the recurrence
    analytically."""
    if r.device.type == "meta":
        return stand_in((r, state), r, k, v, w, u, state)
    ys = []
    for t in range(r.shape[2]):
        state, y = wkv_step(state, r[:, :, t], k[:, :, t], v[:, :, t],
                            w[:, :, t], u)
        ys.append(y)
    if not ys:                      # no step: the scan's empty output
        return torch.zeros_like(r), state
    return torch.stack(ys, dim=2), state


def time_mix(x: torch.Tensor, p: dict, cfg: ModelConfig,
             state: Optional[torch.Tensor] = None):
    """x: (B, S, d).  Returns (out (B,S,d), new_state (B,H,D,D) fp32)."""
    b, s, d = x.shape
    h = cfg.num_heads
    hd = d // h

    def heads(t):
        return t.reshape(b, s, h, hd).transpose(1, 2)      # (B,H,S,D)

    f32 = torch.float32
    r = heads(linear(x, p["w_r"])).to(f32)
    k = heads(linear(x, p["w_k"])).to(f32)
    v = heads(linear(x, p["w_v"])).to(f32)
    g = linear(x, p["w_g"])
    # data-dependent decay: per-channel base decay + token-conditioned delta
    ww = p["decay"].to(f32).reshape(h, hd)[None, :, None, :] \
        + heads(linear(x, p["w_decay"])).to(f32)
    w = torch.exp(-torch.exp(ww))
    u = p["bonus"].to(f32).reshape(h, hd)
    if state is None:
        state = torch.zeros((b, h, hd, hd), dtype=f32, device=x.device)
    y, new_state = wkv_sequence(r, k, v, w, u, state)
    y = y.transpose(1, 2).reshape(b, s, d)
    y = rms_norm(y.to(x.dtype), p["ln_x"], cfg.norm_eps)
    out = linear(y * torch.nn.functional.silu(g), p["w_o"])
    return out, new_state


def channel_mix(x: torch.Tensor, p: dict, cfg: ModelConfig) -> torch.Tensor:
    """relu(x @ w_ck)^2 @ w_cv: two ``layers.linear`` calls, as the
    reference's (not the fused MLP: relu squared is not one of its
    activations)."""
    k = torch.relu(linear(x, p["w_ck"])) ** 2
    return linear(k, p["w_cv"])


def rwkv_layer_params(init, cfg: ModelConfig) -> dict:
    """One RWKV layer's parameters with the reference's shapes and scales,
    drawn by ``transformer._Init``."""
    d, ff = cfg.d_model, cfg.d_ff
    s = d ** -0.5
    return {
        "ln1": init.zeros((d,)),
        "ln2": init.zeros((d,)),
        "ln_x": init.zeros((d,)),
        "w_r": init.normal((d, d), s),
        "w_k": init.normal((d, d), s),
        "w_v": init.normal((d, d), s),
        "w_g": init.normal((d, d), s),
        "w_o": init.normal((d, d), s),
        "w_decay": init.normal((d, d), s * 0.1),
        "decay": init.full((d,), 0.5),
        "bonus": init.zeros((d,)),
        "w_ck": init.normal((d, ff), s),
        "w_cv": init.normal((ff, d), ff ** -0.5),
    }


def rwkv_block(x: torch.Tensor, p: dict, cfg: ModelConfig,
               state: Optional[torch.Tensor] = None):
    """One RWKV layer: (x + time mix, then + channel mix, new_state)."""
    h, new_state = time_mix(rms_norm(x, p["ln1"], cfg.norm_eps), p, cfg,
                            state)
    x = x + h
    x = x + channel_mix(rms_norm(x, p["ln2"], cfg.norm_eps), p, cfg)
    return x, new_state
