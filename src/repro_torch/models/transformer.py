"""Decoder of the port: lock-step and slot-batched serving.

Counterpart of ``src/repro/models/transformer.py``, cut to what greedy
serving of a decoder runs: ``init_params``, ``init_cache``, ``prefill``
and ``decode_step`` (lock-step), ``decode_slots``, ``chunk_prefill`` and
the slot cache operations (continuous batching), over the dense / GQA /
SWA / qk-norm / GeGLU layer and the MoE layer (``models/moe.py``, with a
shared expert; capacity dropping at prefill, dropless at decode and on the
slot path, which chunked prefill runs on).  RWKV, hybrid-SSM, enc-dec and
VLM families, the int8 cache and ``forward_train`` are still to be ported
(ROADMAP.md, Queue 1, item 9) and raise ``NotImplementedError``.

What differs from the reference, by design:

* Parameters are one dictionary per layer (``params["layers"][i]``); the
  reference stacks them over scan blocks for ``lax.scan``.  Here the
  decoder is a Python loop over layers.  ``convert.params_from_jax``
  unstacks a reference pytree into this layout.
* The cache is **updated in place**, the counterpart of the reference
  donating it to the compiled step: ``prefill``, ``decode_step``,
  ``decode_slots``, ``chunk_prefill``, ``cache_insert_slot`` and
  ``cache_evict_slot`` write into the tensors of the cache they are given
  and return that same dictionary (``cache_extract_slot`` returns a
  copy).  In the lock-step cache ``cache["pos"]`` is a Python int (one
  position for the whole batch), so a decode step reads nothing back from
  the card; in the per-slot cache it is an int32 tensor (B,) on the device.
* Attention goes through the kernel ops on both devices: one new token
  against the cache (both decode steps) through ``kernels/decode_attention``,
  a prefill and a chunk of a prompt through ``kernels/flash_attention``
  (the reference's promise at its ``transformer.py:274``).  The ops launch
  the hand-written kernels on CUDA tensors and run their plain versions on
  CPU tensors, so the model itself never branches on the device.  So do
  the q/k/v/o projections and the LM head (``_logits``): ``layers.linear``
  runs them through ``kernels/elk_matmul``, where the reference has
  einsums and leaves its Pallas matmul without a caller.
* The layer loop is a parameter: ``prefill``, ``decode_step``,
  ``decode_slots`` and ``chunk_prefill`` take ``decoder=`` in place of
  ``_run_decoder``, which is how ``serve/stream.py`` streams the layer
  weights through every pass.
* There is no ``mesh`` argument: the port runs on one GPU.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.kernels.decode_attention.ops import decode_attn
from repro_torch.kernels.flash_attention.ops import flash_attn, flash_attn_pos
from repro_torch.models import moe as moe_mod
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (AttnSpec, apply_rope, linear, mlp,
                                       qk_head_norm, rms_norm, rope_tables)

POS_SENTINEL = 2 ** 30   # tag of cache slots not yet written


# ---------------------------------------------------------------------------
# structure
# ---------------------------------------------------------------------------

def _require_ported(cfg: ModelConfig) -> None:
    unported = [name for name, on in (
        ("RWKV", cfg.rwkv), ("hybrid SSM", cfg.hybrid_parallel_ssm),
        ("encoder-decoder", cfg.encoder_layers),
        ("frontend", cfg.frontend != "none")) if on]
    if unported:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(unported)} not ported yet "
            "(ROADMAP.md, Queue 1, item 9)")


def layer_kinds(cfg: ModelConfig) -> list[str]:
    _require_ported(cfg)
    return ["moe" if cfg.is_moe_layer(i) else "dense"
            for i in range(cfg.num_layers)]


def block_structure(cfg: ModelConfig) -> tuple[int, int, int]:
    """(prefix_len, period, n_blocks) of the reference's scan layout:
    prefix layers unrolled (kimi's dense first layer), then n_blocks of
    ``period`` layers (llama4's dense / MoE alternation: 2).  The port
    loops over layers and needs this only to unstack reference
    parameters."""
    kinds = layer_kinds(cfg)
    prefix = cfg.moe_first_dense if cfg.moe_experts else 0
    period = max(cfg.moe_every, 1) if cfg.moe_experts else 1
    prefix += (len(kinds) - prefix) % period   # a ragged tail grows it
    body = kinds[prefix:]
    assert all(body[i] == body[i % period] for i in range(len(body)))
    return prefix, period, len(body) // period


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


def _mlp_params(init: _Init, cfg: ModelConfig, ff: int) -> dict:
    d = cfg.d_model
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


def decoder_layer_params(init: _Init, cfg: ModelConfig, kind: str) -> dict:
    d = cfg.d_model
    p = {"ln1": init.zeros((d,)), "ln2": init.zeros((d,)),
         "attn": _attn_params(init, cfg)}
    if kind == "moe":
        p["moe"] = moe_mod.moe_params(init, cfg)
        if cfg.moe_shared_d_ff:
            p["shared_mlp"] = _mlp_params(init, cfg, cfg.moe_shared_d_ff)
    else:
        p["mlp"] = _mlp_params(init, cfg, cfg.d_ff)
    return p


class _MetaInit(_Init):
    """The shapes and types of ``_Init``'s draws, nothing allocated."""

    def __init__(self, dtype: torch.dtype):
        super().__init__(None, torch.device("meta"), dtype)

    def normal(self, shape: tuple, scale: float) -> torch.Tensor:
        return torch.empty(shape, device=self.device, dtype=self.dtype)


def layer_shapes(cfg: ModelConfig) -> list[dict]:
    """Every layer's parameters as ``init_params`` draws them, as meta
    tensors: their structure, shapes and types, nothing allocated."""
    init = _MetaInit(getattr(torch, cfg.param_dtype))
    return [decoder_layer_params(init, cfg, kind) for kind in layer_kinds(cfg)]


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
                device="cuda", *, collect_layers=list) -> dict:
    """Random parameters with the reference's scales (``d**-0.5`` for
    projections and embeddings, zeros for norm scales and biases), each
    tensor drawn on ``device`` in ``cfg.param_dtype``: nothing is staged
    on the host.  ``generator`` must live on ``device``.
    ``collect_layers`` takes the layers as an iterator that draws each
    when asked, and its result becomes ``params["layers"]``
    (``serve/stream.init_streamed_params`` moves each to the host before
    the next is drawn)."""
    _require_ported(cfg)
    device = resolve_device(device)
    init = _Init(generator, device, getattr(torch, cfg.param_dtype))
    d, v = cfg.d_model, cfg.vocab_size
    params: dict = {"embed": init.normal((v, d), d ** -0.5),
                    "final_norm": init.zeros((d,))}
    if not cfg.tie_embeddings:
        params["lm_head"] = init.normal((d, v), d ** -0.5)
    params["layers"] = collect_layers(decoder_layer_params(init, cfg, kind)
                                      for kind in layer_kinds(cfg))
    return params


# ---------------------------------------------------------------------------
# serving cache
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CacheSpec:
    capacity: int                  # KV slots per layer (ring buffer)
    batch: int
    kv_dtype: Any = torch.bfloat16
    per_slot: bool = False         # independent per-request slots
                                   # (pos: (B,), slot_pos: (B, C))


def init_cache(cfg: ModelConfig, spec: CacheSpec, device="cuda") -> dict:
    """Ring KV cache ``(L, B, Hkv, C, hd)`` with ``slot_pos`` tags
    (``POS_SENTINEL`` = unwritten).  Lock-step: ``slot_pos (C,)`` and
    ``pos`` a Python int; per-slot: ``slot_pos (B, C)`` and ``pos`` an
    int32 tensor (B,), both on the device."""
    _require_ported(cfg)
    if spec.kv_dtype == torch.int8:
        raise NotImplementedError(
            "int8 KV cache not ported yet (ROADMAP.md, Queue 1, item 9)")
    device = resolve_device(device)
    kv_shape = (cfg.num_layers, spec.batch, cfg.num_kv_heads, spec.capacity,
                cfg.resolved_head_dim)
    tags = ((spec.batch, spec.capacity) if spec.per_slot
            else (spec.capacity,))
    return {
        "pos": (torch.zeros((spec.batch,), dtype=torch.int32, device=device)
                if spec.per_slot else 0),
        "k": torch.zeros(kv_shape, dtype=spec.kv_dtype, device=device),
        "v": torch.zeros(kv_shape, dtype=spec.kv_dtype, device=device),
        "slot_pos": torch.full(tags, POS_SENTINEL, dtype=torch.int32,
                               device=device),
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


def _self_attention_full(x, p, cfg: ModelConfig, spec: AttnSpec, sin, cos):
    """Prefill attention over the whole sequence at positions 0..S-1,
    through ``flash_attn`` (causal, the spec's window and scale).  On the
    card the kernel reads q through its strides and writes its output into
    (B, S, Hq, D) storage, so the reshape for ``w_o`` is a view.
    Returns (out, k, v)."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(x, p, cfg)
    q = apply_rope(q, sin, cos)
    k = apply_rope(k, sin, cos).contiguous()
    v = v.contiguous()
    out = flash_attn(q, k, v, causal=spec.causal,
                     window=spec.sliding_window, scale=spec.scale)
    out = out.transpose(1, 2).reshape(b, s, -1)
    return linear(out, p["w_o"]), k, v


def _self_attention_decode(x, p, cfg: ModelConfig, spec: AttnSpec,
                           k_cache, v_cache, ctx: dict):
    """x: (B,1,d), one token at absolute position ``ctx["pos"]`` against
    the ring cache (B,Hkv,C,hd).  The new K/V row is written **in place**
    at slot ``pos % C`` before attention.  The rope tables are the same
    for every layer and come ready in ``ctx``.  Attention is ``decode_attn``
    with the Pallas kernel's own signature (``slot_pos (C,)``, scalar
    position)."""
    b, s, _ = x.shape
    c = k_cache.shape[2]
    q, k_new, v_new = _project_qkv(x, p, cfg)          # (B,H,1,hd)
    q = apply_rope(q, ctx["sin"], ctx["cos"])
    k_new = apply_rope(k_new, ctx["sin"], ctx["cos"])
    slot = ctx["pos"] % c
    k_cache[:, :, slot:slot + 1, :] = k_new.to(k_cache.dtype)
    v_cache[:, :, slot:slot + 1, :] = v_new.to(v_cache.dtype)
    out = decode_attn(q.reshape(b, spec.num_heads, spec.head_dim),
                      k_cache, v_cache, ctx["slot_pos"], ctx["pos"],
                      window=spec.sliding_window, scale=spec.scale)
    return linear(out.reshape(b, s, -1), p["w_o"])


def _self_attention_slots(x, p, cfg: ModelConfig, spec: AttnSpec,
                          k_cache, v_cache, ctx: dict):
    """Per-slot cached attention: every batch row sits at its own absolute
    position.  x: (B,T,d), ``ctx["positions"]`` (B,T) per-row token
    positions, ``ctx["slot_pos"]`` (B,C) per-row ring tags (already
    updated for this step's writes), caches (B,Hkv,C,hd).  Serves both the
    continuous-batching decode step (T=1, B=slots) and chunked prefill
    (B=1, T=chunk).  The T new K/V rows are written **in place** into each
    row's ring slots.  At T=1 attention is ``decode_attn`` with per-row
    positions; at T>1 ``flash_attn_pos`` with the chunk's positions
    against the ring's tags, on the ring as it is stored (no widened
    copy), its output in (B, T, Hq, D) storage."""
    b, t, _ = x.shape
    c = k_cache.shape[2]
    positions = ctx["positions"]
    q, k_new, v_new = _project_qkv(x, p, cfg)          # (B,H,T,hd)
    q = apply_rope(q, ctx["sin"], ctx["cos"])
    k_new = apply_rope(k_new, ctx["sin"], ctx["cos"])
    rows = torch.arange(b, device=x.device)[:, None]   # (B,1)
    slots = (positions % c).long()                     # (B,T), distinct (T<=C)
    k_cache[rows, :, slots, :] = k_new.to(k_cache.dtype).transpose(1, 2)
    v_cache[rows, :, slots, :] = v_new.to(v_cache.dtype).transpose(1, 2)
    if t == 1:
        out = decode_attn(q.reshape(b, spec.num_heads, spec.head_dim),
                          k_cache, v_cache, ctx["slot_pos"], ctx["q_pos"],
                          window=spec.sliding_window, scale=spec.scale)
        return linear(out.reshape(b, t, -1), p["w_o"])
    out = flash_attn_pos(q, k_cache, v_cache, positions,
                         ctx["slot_pos"], causal=spec.causal,
                         window=spec.sliding_window, scale=spec.scale)
    out = out.transpose(1, 2).reshape(b, t, -1)     # a view on the card
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


def _ffn(x, p, cfg: ModelConfig, mode: str):
    """The layer's FFN: the MLP, or (a layer with ``p["moe"]``) the MoE
    FFN over the flattened tokens plus the shared expert's MLP.  Capacity
    dropping at prefill; dropless at decode and in ``slots`` mode (the
    continuous decode step and chunked prefill)."""
    if "moe" not in p:
        return mlp(x, p["mlp"], cfg)
    b, s, d = x.shape
    out = moe_mod.moe_ffn(x.reshape(b * s, d), p["moe"], cfg,
                          dropless=mode in ("decode", "slots"))
    out = out.reshape(b, s, d)
    if cfg.moe_shared_d_ff:
        out = out + mlp(x, p["shared_mlp"], cfg)
    return out


def _decoder_layer(x, p, cfg: ModelConfig, spec: AttnSpec, ctx: dict,
                   layer_cache: Optional[dict]):
    """Apply one decoder layer (dense or MoE, by its parameters); the
    layer's cache slices (views of the cache tensors) are written in
    place."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if ctx["mode"] == "decode":
        attn_out = _self_attention_decode(
            h, p["attn"], cfg, spec, layer_cache["k"], layer_cache["v"], ctx)
    elif ctx["mode"] == "slots":
        attn_out = _self_attention_slots(
            h, p["attn"], cfg, spec, layer_cache["k"], layer_cache["v"], ctx)
    else:
        attn_out, k, v = _self_attention_full(
            h, p["attn"], cfg, spec, ctx["sin"], ctx["cos"])
        if layer_cache is not None:   # prefill: write the cache
            c = layer_cache["k"].shape[2]
            s = k.shape[2]
            _fill_ring(layer_cache["k"], k[:, :, -c:, :], s)
            _fill_ring(layer_cache["v"], v[:, :, -c:, :], s)
    x = x + attn_out
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + _ffn(h2, p, cfg, ctx["mode"])


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
        return linear(x, params["embed"].t())
    return linear(x, params["lm_head"])


def prefill(params, cfg: ModelConfig, tokens: torch.Tensor,
            cache: dict, *, decoder=None) -> tuple[torch.Tensor, dict]:
    """Process the prompt (B, S), fill ``cache`` in place, return the
    last token's logits (B, 1, V) and the same cache.  ``decoder`` runs
    the layers (default ``_run_decoder``)."""
    _require_ported(cfg)
    x = _embed(params, cfg, tokens)
    s = x.shape[1]
    positions = torch.arange(s, device=x.device)
    sin, cos = rope_tables(positions, cfg.resolved_head_dim, cfg.rope_theta)
    ctx = {"mode": "prefill", "sin": sin, "cos": cos}
    x = (decoder or _run_decoder)(params, cfg, x, ctx, cache)
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
                cache: dict, *, decoder=None) -> tuple[torch.Tensor, dict]:
    """One serving step: token (B,) -> (logits (B,1,V), the same cache,
    advanced in place by one position).  ``decoder`` runs the layers."""
    _require_ported(cfg)
    x = _embed(params, cfg, token[:, None])
    pos = cache["pos"]
    # tag the new token's slot *before* attention
    cache["slot_pos"][pos % cache["slot_pos"].shape[0]] = pos
    pos_t = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    sin, cos = rope_tables(pos_t, cfg.resolved_head_dim, cfg.rope_theta)
    ctx = {"mode": "decode", "pos": pos, "sin": sin, "cos": cos,
           "slot_pos": cache["slot_pos"]}
    x = (decoder or _run_decoder)(params, cfg, x, ctx, cache)
    cache["pos"] = pos + 1
    return _logits(params, cfg, x), cache


# ---------------------------------------------------------------------------
# slot-addressable serving (continuous batching)
# ---------------------------------------------------------------------------

def _tag_slots(slot_pos: torch.Tensor, positions: torch.Tensor) -> None:
    """Tag each row's ring slots with this step's absolute positions, in
    place.  slot_pos: (B,C), positions: (B,T); T <= C keeps the slots
    distinct."""
    c = slot_pos.shape[1]
    slot_pos.scatter_(1, (positions % c).long(), positions)


def _slots_ctx(cfg: ModelConfig, cache: dict,
               positions: torch.Tensor) -> dict:
    """Tag the ring (in place) and build what every layer shares: rope
    tables, the tags and the query positions (the attention ops mask by
    the tags themselves)."""
    _tag_slots(cache["slot_pos"], positions)
    sin, cos = rope_tables(positions, cfg.resolved_head_dim, cfg.rope_theta)
    return {"mode": "slots", "positions": positions, "sin": sin, "cos": cos,
            "slot_pos": cache["slot_pos"], "q_pos": positions[:, 0]}


def decode_slots(params, cfg: ModelConfig, token: torch.Tensor,
                 cache: dict, *, decoder=None) -> tuple[torch.Tensor, dict]:
    """One continuous-batching step: token (B,) against a per-slot cache
    (``CacheSpec(per_slot=True)``: pos (B,), slot_pos (B,C)).  Every slot
    advances by one token at its *own* position -> (logits (B,1,V), the
    same cache, advanced in place).  ``decoder`` runs the layers."""
    _require_ported(cfg)
    x = _embed(params, cfg, token[:, None])
    positions = cache["pos"][:, None] + 0               # (B,1), a copy
    ctx = _slots_ctx(cfg, cache, positions)
    x = (decoder or _run_decoder)(params, cfg, x, ctx, cache)
    cache["pos"] += 1
    return _logits(params, cfg, x), cache


def chunk_prefill(params, cfg: ModelConfig, tokens: torch.Tensor,
                  cache: dict, *, decoder=None) -> tuple[torch.Tensor, dict]:
    """Advance a per-slot cache by a chunk of T prompt tokens, in place.

    tokens: (B,T) starting at each row's ``cache["pos"]``.  Attention runs
    against the ring cache (earlier chunks' K/V plus this chunk's, tagged
    by absolute position), so while the prompt fits the ring any chunking
    gives the same result as a single pass.  Returns (last-token logits
    (B,1,V), the same cache).  ``decoder`` runs the layers."""
    _require_ported(cfg)
    b, t = tokens.shape
    if t > cache["slot_pos"].shape[1]:
        raise ValueError(f"chunk of {t} tokens exceeds cache capacity "
                         f"{cache['slot_pos'].shape[1]}")
    x = _embed(params, cfg, tokens)
    positions = cache["pos"][:, None] + torch.arange(
        t, dtype=torch.int32, device=x.device)[None, :]
    ctx = _slots_ctx(cfg, cache, positions)
    x = (decoder or _run_decoder)(params, cfg, x, ctx, cache)
    cache["pos"] += t
    return _logits(params, cfg, x[:, -1:, :]), cache


def _slot_batch_axis(key: str) -> int:
    """Axis of the request/slot dim in a cache leaf."""
    return 0 if key in ("pos", "slot_pos") else 1


def cache_insert_slot(cache: dict, slot: int, req_cache: dict) -> dict:
    """Insert a prefilled single-request cache (batch 1) into ``slot`` of a
    per-slot batch cache, in place.  Shapes must agree except the
    slot/batch dim."""
    for key, buf in cache.items():
        buf.narrow(_slot_batch_axis(key), slot, 1).copy_(req_cache[key])
    return cache


def cache_extract_slot(cache: dict, slot: int) -> dict:
    """Inverse of ``cache_insert_slot``: one request's batch-1 cache (KV
    ring plus ``pos``/``slot_pos``), as a **copy**: the slot cache is
    mutated in place afterwards."""
    return {key: buf.narrow(_slot_batch_axis(key), slot, 1).clone()
            for key, buf in cache.items()}


def cache_evict_slot(cache: dict, slot: int) -> dict:
    """Free a slot in place: reset its position and mask every ring tag so
    the stale K/V is unreachable.  The K/V buffers are left as they are."""
    cache["pos"][slot] = 0
    cache["slot_pos"][slot] = POS_SENTINEL
    return cache
