"""Dense decoder of the port: the lock-step serving path.

Counterpart of ``src/repro/models/transformer.py``, cut to what greedy
serving of a dense decoder runs: ``init_params``, ``init_cache``,
``prefill`` and ``decode_step`` over the dense / GQA / SWA / qk-norm /
GeGLU layer.  MoE, RWKV, hybrid-SSM, enc-dec and VLM families, the
per-slot cache, the int8 cache and ``forward_train`` are still to be
ported (ROADMAP.md, Queue 1) and raise ``NotImplementedError``.

What differs from the reference, by design:

* Parameters are one dictionary per layer (``params["layers"][i]``); the
  reference stacks them over scan blocks for ``lax.scan``.  Here the
  decoder is a Python loop over layers.  ``convert.params_from_jax``
  unstacks a reference pytree into this layout.
* The cache is **updated in place**, the counterpart of the reference
  donating it to the compiled step: ``prefill`` and ``decode_step`` write
  into the tensors of the cache they are given and return that same
  dictionary.  ``cache["pos"]`` is a Python int (one position for the
  whole lock-step batch), so a decode step reads nothing back from the
  card.
* There is no ``mesh`` argument: the port runs on one GPU.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (AttnSpec, apply_rope, attn_mask_bias,
                                       chunked_gqa_attention, gqa_attention,
                                       linear, mlp, qk_head_norm, rms_norm,
                                       rope_tables)

POS_SENTINEL = 2 ** 30   # tag of cache slots not yet written


# ---------------------------------------------------------------------------
# structure
# ---------------------------------------------------------------------------

def _require_dense(cfg: ModelConfig) -> None:
    unported = [name for name, on in (
        ("MoE", cfg.moe_experts), ("RWKV", cfg.rwkv),
        ("hybrid SSM", cfg.hybrid_parallel_ssm),
        ("encoder-decoder", cfg.encoder_layers),
        ("frontend", cfg.frontend != "none")) if on]
    if unported:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(unported)} not ported yet "
            "(ROADMAP.md, Queue 1, 'Other model families')")


def layer_kinds(cfg: ModelConfig) -> list[str]:
    _require_dense(cfg)
    return ["dense"] * cfg.num_layers


def block_structure(cfg: ModelConfig) -> tuple[int, int, int]:
    """(prefix_len, period, n_blocks) of the reference's scan layout; for
    a dense decoder no prefix and one layer per block.  The port loops
    over layers and needs this only to unstack reference parameters."""
    _require_dense(cfg)
    return 0, 1, cfg.num_layers


def attn_spec(cfg: ModelConfig) -> AttnSpec:
    return AttnSpec(
        num_heads=cfg.num_heads,
        num_kv_heads=cfg.num_kv_heads,
        head_dim=cfg.resolved_head_dim,
        causal=True,
        sliding_window=(cfg.sliding_window
                        if cfg.swa_layers == "all" else 0),
        qk_norm=cfg.qk_norm,
    )


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

class _Init:
    """Draws parameters on ``device`` from one ``torch.Generator``."""

    def __init__(self, generator: torch.Generator, device: torch.device,
                 dtype: torch.dtype):
        self.generator, self.device, self.dtype = generator, device, dtype

    def normal(self, shape: tuple, scale: float) -> torch.Tensor:
        t = torch.randn(shape, generator=self.generator, device=self.device,
                        dtype=self.dtype)
        return t.mul_(scale)

    def zeros(self, shape: tuple) -> torch.Tensor:
        return torch.zeros(shape, device=self.device, dtype=self.dtype)


def _attn_params(init: _Init, cfg: ModelConfig) -> dict:
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    nq, nkv = cfg.num_heads, cfg.num_kv_heads
    s = d ** -0.5
    p = {
        "w_q": init.normal((d, nq * hd), s),
        "w_k": init.normal((d, nkv * hd), s),
        "w_v": init.normal((d, nkv * hd), s),
        "w_o": init.normal((nq * hd, d), (nq * hd) ** -0.5),
    }
    if cfg.qkv_bias:
        p["b_q"] = init.zeros((nq * hd,))
        p["b_k"] = init.zeros((nkv * hd,))
        p["b_v"] = init.zeros((nkv * hd,))
    if cfg.qk_norm:
        p["q_norm"] = init.zeros((hd,))
        p["k_norm"] = init.zeros((hd,))
    return p


def _mlp_params(init: _Init, cfg: ModelConfig) -> dict:
    d, ff = cfg.d_model, cfg.d_ff
    s_in, s_ff = d ** -0.5, ff ** -0.5
    if cfg.gated_mlp:
        return {"w_gate": init.normal((d, ff), s_in),
                "w_up": init.normal((d, ff), s_in),
                "w_down": init.normal((ff, d), s_ff)}
    p = {"w_up": init.normal((d, ff), s_in),
         "w_down": init.normal((ff, d), s_ff)}
    if cfg.qkv_bias:   # opt-style fc biases travel with qkv_bias configs
        p["b_up"] = init.zeros((ff,))
        p["b_down"] = init.zeros((d,))
    return p


def decoder_layer_params(init: _Init, cfg: ModelConfig) -> dict:
    d = cfg.d_model
    return {"ln1": init.zeros((d,)), "ln2": init.zeros((d,)),
            "attn": _attn_params(init, cfg), "mlp": _mlp_params(init, cfg)}


def resolve_device(device) -> torch.device:
    """The device an entry point runs on.  ``"cuda"`` is the default of
    every entry point and raises when no card is there: the CPU is never
    taken in its place, only when the caller names it."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run the plain PyTorch path on the CPU")
    return device


def init_params(generator: torch.Generator, cfg: ModelConfig,
                device="cuda") -> dict:
    """Random parameters with the reference's scales (``d**-0.5`` for
    projections and embeddings, zeros for norm scales and biases), each
    tensor drawn on ``device`` in ``cfg.param_dtype``: nothing is staged
    on the host.  ``generator`` must live on ``device``."""
    _require_dense(cfg)
    device = resolve_device(device)
    init = _Init(generator, device, getattr(torch, cfg.param_dtype))
    d, v = cfg.d_model, cfg.vocab_size
    params: dict = {"embed": init.normal((v, d), d ** -0.5),
                    "final_norm": init.zeros((d,))}
    if not cfg.tie_embeddings:
        params["lm_head"] = init.normal((d, v), d ** -0.5)
    params["layers"] = [decoder_layer_params(init, cfg)
                        for _ in range(cfg.num_layers)]
    return params


# ---------------------------------------------------------------------------
# serving cache
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CacheSpec:
    capacity: int                  # KV slots per layer (ring buffer)
    batch: int
    kv_dtype: Any = torch.bfloat16
    per_slot: bool = False         # per-request slots: not ported yet


def init_cache(cfg: ModelConfig, spec: CacheSpec, device="cuda") -> dict:
    """Ring KV cache ``(L, B, Hkv, C, hd)`` with ``slot_pos (C,)`` tags
    (``POS_SENTINEL`` = unwritten) and ``pos`` (Python int)."""
    _require_dense(cfg)
    if spec.per_slot:
        raise NotImplementedError(
            "per-slot caches not ported yet (ROADMAP.md, Queue 1, "
            "'Slot path + continuous batching')")
    if spec.kv_dtype == torch.int8:
        raise NotImplementedError(
            "int8 KV cache not ported yet (ROADMAP.md, Queue 1, "
            "'Other model families')")
    device = resolve_device(device)
    kv_shape = (cfg.num_layers, spec.batch, cfg.num_kv_heads, spec.capacity,
                cfg.resolved_head_dim)
    return {
        "pos": 0,
        "k": torch.zeros(kv_shape, dtype=spec.kv_dtype, device=device),
        "v": torch.zeros(kv_shape, dtype=spec.kv_dtype, device=device),
        "slot_pos": torch.full((spec.capacity,), POS_SENTINEL,
                               dtype=torch.int32, device=device),
    }


# ---------------------------------------------------------------------------
# layer application
# ---------------------------------------------------------------------------

def _project_qkv(x, p, cfg: ModelConfig):
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    nq, nkv = cfg.num_heads, cfg.num_kv_heads

    def heads(t, n):
        return t.reshape(b, s, n, hd).transpose(1, 2)

    q = heads(linear(x, p["w_q"], p.get("b_q")), nq)
    k = heads(linear(x, p["w_k"], p.get("b_k")), nkv)
    v = heads(linear(x, p["w_v"], p.get("b_v")), nkv)
    if cfg.qk_norm:
        q = qk_head_norm(q, p["q_norm"], cfg.norm_eps)
        k = qk_head_norm(k, p["k_norm"], cfg.norm_eps)
    return q, k, v


def _self_attention_full(x, p, cfg: ModelConfig, spec: AttnSpec,
                         sin, cos, positions):
    """Prefill attention over the whole sequence (q-chunked so the live
    score tile stays bounded).  Returns (out, k, v)."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(x, p, cfg)
    q = apply_rope(q, sin, cos)
    k = apply_rope(k, sin, cos)
    out = chunked_gqa_attention(q, k, v, spec, positions, positions,
                                chunk=cfg.attn_chunk)
    out = out.transpose(1, 2).reshape(b, s, -1)
    return linear(out, p["w_o"]), k, v


def _self_attention_decode(x, p, cfg: ModelConfig, spec: AttnSpec,
                           k_cache, v_cache, ctx: dict):
    """x: (B,1,d), one token at absolute position ``ctx["pos"]`` against
    the ring cache (B,Hkv,C,hd).  The new K/V row is written **in place**
    at slot ``pos % C`` before attention.  The rope tables and the mask
    are the same for every layer and come ready in ``ctx``."""
    b, s, _ = x.shape
    c = k_cache.shape[2]
    q, k_new, v_new = _project_qkv(x, p, cfg)          # (B,H,1,hd)
    q = apply_rope(q, ctx["sin"], ctx["cos"])
    k_new = apply_rope(k_new, ctx["sin"], ctx["cos"])
    slot = ctx["pos"] % c
    k_cache[:, :, slot:slot + 1, :] = k_new.to(k_cache.dtype)
    v_cache[:, :, slot:slot + 1, :] = v_new.to(v_cache.dtype)
    out = gqa_attention(q, k_cache.to(q.dtype), v_cache.to(q.dtype),
                        ctx["bias"], spec)
    out = out.transpose(1, 2).reshape(b, s, -1)
    return linear(out, p["w_o"])


def _fill_ring(buf: torch.Tensor, val: torch.Tensor, total_seq: int) -> None:
    """Write a prefill's last-C tokens into the ring ``buf`` (in place)
    with the true ring layout: position ``p`` lands at slot ``p % C``, so
    later decode steps evict exactly the token leaving the window.  Slots
    the prompt does not reach are zeroed."""
    c = buf.shape[2]
    s = val.shape[2]           # = min(total_seq, c)
    if s < c:
        val = torch.nn.functional.pad(val, (0, 0, 0, c - s))
    shift = (total_seq - s) % c
    if shift:
        val = torch.roll(val, shift, dims=2)
    buf.copy_(val)


def _decoder_layer(x, p, cfg: ModelConfig, spec: AttnSpec, ctx: dict,
                   layer_cache: Optional[dict]):
    """Apply one dense decoder layer; the layer's cache slices (views of
    the cache tensors) are written in place."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if ctx["mode"] == "decode":
        attn_out = _self_attention_decode(
            h, p["attn"], cfg, spec, layer_cache["k"], layer_cache["v"], ctx)
    else:
        attn_out, k, v = _self_attention_full(
            h, p["attn"], cfg, spec, ctx["sin"], ctx["cos"],
            ctx["positions"])
        if layer_cache is not None:   # prefill: write the cache
            c = layer_cache["k"].shape[2]
            s = k.shape[2]
            _fill_ring(layer_cache["k"], k[:, :, -c:, :], s)
            _fill_ring(layer_cache["v"], v[:, :, -c:, :], s)
    x = x + attn_out
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + mlp(h2, p["mlp"], cfg)


def _run_decoder(params, cfg: ModelConfig, x, ctx, cache):
    """The decoder as a Python loop over layers (the reference scans over
    stacked blocks); each layer gets views of its cache slices."""
    spec = attn_spec(cfg)
    for li, p in enumerate(params["layers"]):
        lc = None if cache is None else {"k": cache["k"][li],
                                         "v": cache["v"][li]}
        x = _decoder_layer(x, p, cfg, spec, ctx, lc)
    return x


# ---------------------------------------------------------------------------
# full forward passes
# ---------------------------------------------------------------------------

def _embed(params, cfg: ModelConfig, tokens):
    x = params["embed"][tokens]
    if cfg.scale_embed:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype,
                             device=x.device)
    return x


def _logits(params, cfg: ModelConfig, x):
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings:
        return torch.matmul(x, params["embed"].t())
    return torch.matmul(x, params["lm_head"])


def prefill(params, cfg: ModelConfig, tokens: torch.Tensor,
            cache: dict) -> tuple[torch.Tensor, dict]:
    """Process the prompt (B, S), fill ``cache`` in place, return the
    last token's logits (B, 1, V) and the same cache."""
    _require_dense(cfg)
    x = _embed(params, cfg, tokens)
    s = x.shape[1]
    positions = torch.arange(s, device=x.device)
    sin, cos = rope_tables(positions, cfg.resolved_head_dim, cfg.rope_theta)
    ctx = {"mode": "prefill", "sin": sin, "cos": cos, "positions": positions}
    x = _run_decoder(params, cfg, x, ctx, cache)
    cap = cache["slot_pos"].shape[0]
    idx = torch.arange(cap, device=x.device)
    if s <= cap:
        slot_pos = torch.where(idx < s, idx, POS_SENTINEL)
    else:       # ring layout: slot j holds position p=start+((j-start)%C)
        start = s - cap
        slot_pos = start + (idx - start) % cap
    cache["slot_pos"].copy_(slot_pos)
    cache["pos"] = s
    return _logits(params, cfg, x[:, -1:, :]), cache


def decode_step(params, cfg: ModelConfig, token: torch.Tensor,
                cache: dict) -> tuple[torch.Tensor, dict]:
    """One serving step: token (B,) -> (logits (B,1,V), the same cache,
    advanced in place by one position)."""
    _require_dense(cfg)
    x = _embed(params, cfg, token[:, None])
    pos = cache["pos"]
    # tag the new token's slot *before* attention
    cache["slot_pos"][pos % cache["slot_pos"].shape[0]] = pos
    pos_t = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    sin, cos = rope_tables(pos_t, cfg.resolved_head_dim, cfg.rope_theta)
    ctx = {"mode": "decode", "pos": pos, "sin": sin, "cos": cos,
           "bias": attn_mask_bias(attn_spec(cfg), pos_t, cache["slot_pos"])}
    x = _run_decoder(params, cfg, x, ctx, cache)
    cache["pos"] = pos + 1
    return _logits(params, cfg, x), cache
