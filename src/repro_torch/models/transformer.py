"""Decoder of the port: training, lock-step and slot-batched serving.

Counterpart of ``src/repro/models/transformer.py``: ``init_params``,
``forward_train`` and ``loss_fn`` (training: the whole sequence, remat per
layer), ``init_cache``, ``prefill`` and ``decode_step`` (lock-step),
``decode_slots``, ``chunk_prefill`` and the slot cache operations
(continuous batching), over every family of the
reference: the dense / GQA / SWA / qk-norm / GeGLU layer, the MoE layer
(``models/moe.py``, with a shared expert; capacity dropping at prefill,
dropless at decode and on the slot path, which chunked prefill runs on),
the RWKV6 layer (``models/rwkv.py``, its recurrent state in the cache and
no KV ring), the hybrid layer's parallel SSM branch (``models/ssm.py``,
its state beside the ring), the encoder-decoder (whisper: ``_encode`` over
stub frame embeddings, cross-attention K/V filled at prefill) and the VLM
(stub patch embeddings ahead of the prompt).  The frontends' stubs are
``models/frontends.py``.  The serving cache is the reference's in bf16,
fp32 or int8 (``CacheSpec.kv_dtype``; int8 with a bf16 scale a slot and kv
head, the reference's ``k_scale``/``v_scale``).  Enc-dec models take no
per-slot cache, as in the reference.  Training differentiates through the
same kernels as serving: ``linear``, ``mlp`` and ``flash_attn`` are
autograd Functions whose backward is a hand-written kernel on the card
(and the plain version's gradient on the CPU).

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
* An int8 ring is quantized as the reference quantizes it (``quantize_kv``
  of ``kernels/kv_quant``), but on the decode steps and chunks the new rows
  go into the ring through ``kv_quant.ops.quantize_into`` (one kernel a
  layer on the card, K's rope applied inside it: the model passes K as the
  projection leaves it, with the rope tables), and the attention ops read the int8 ring and its
  scales themselves: nothing dequantizes the ring in the model, where the
  reference dequantizes the whole ring every step before it attends.
* There is no ``mesh`` argument: the port runs on one GPU.
* ``forward_train`` remats each layer with
  ``torch.utils.checkpoint.checkpoint(use_reentrant=False)``, the
  counterpart of the reference's ``jax.checkpoint`` of a scan block (a
  block is one layer here); ``remat=False`` gives the same values.  Under
  remat the forward kernels of a layer launch twice a step.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.decode_attention.ops import decode_attn
from repro_torch.kernels.flash_attention.ops import flash_attn, flash_attn_pos
from repro_torch.kernels.kv_quant.ops import quantize_into
from repro_torch.kernels.kv_quant.ref import KVScales, quantize_kv
from repro_torch.models import moe as moe_mod
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (AttnSpec, apply_rope, linear, mlp,
                                       mlp_params, qk_head_norm, rms_norm,
                                       rope_tables, softmax_xent)

POS_SENTINEL = 2 ** 30   # tag of cache slots not yet written
DEC_POSITIONS = 4096     # rows of an enc-dec model's learned decoder positions


# ---------------------------------------------------------------------------
# structure
# ---------------------------------------------------------------------------

def layer_kinds(cfg: ModelConfig) -> list[str]:
    if cfg.rwkv:
        return ["rwkv"] * cfg.num_layers
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

    def full(self, shape: tuple, value: float) -> torch.Tensor:
        return torch.full(shape, value, device=self.device, dtype=self.dtype)


def _attn_params(init: _Init, cfg: ModelConfig, cross: bool = False) -> dict:
    """Attention projections; a cross-attention's (``cross``) have no
    biases, as the reference's."""
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
    if cfg.qkv_bias and not cross:
        p["b_q"] = init.zeros((nq * hd,))
        p["b_k"] = init.zeros((nkv * hd,))
        p["b_v"] = init.zeros((nkv * hd,))
    if cfg.qk_norm:
        p["q_norm"] = init.zeros((hd,))
        p["k_norm"] = init.zeros((hd,))
    return p


def decoder_layer_params(init: _Init, cfg: ModelConfig, kind: str) -> dict:
    """One decoder layer of ``kind`` ("dense", "moe" or "rwkv"): norms,
    attention and the FFN; a hybrid config's SSM branch (``ssm``); an
    enc-dec config's cross-attention and its norm (``xattn``, ``ln_x``)."""
    if kind == "rwkv":
        return rwkv_mod.rwkv_layer_params(init, cfg)
    d = cfg.d_model
    p = {"ln1": init.zeros((d,)), "ln2": init.zeros((d,)),
         "attn": _attn_params(init, cfg)}
    if kind == "moe":
        p["moe"] = moe_mod.moe_params(init, cfg)
        if cfg.moe_shared_d_ff:
            p["shared_mlp"] = mlp_params(init, cfg, d, cfg.moe_shared_d_ff)
    else:
        p["mlp"] = mlp_params(init, cfg, d, cfg.d_ff)
    if cfg.hybrid_parallel_ssm:
        p["ssm"] = ssm_mod.ssm_params(init, cfg)
    if cfg.encoder_layers:
        p["ln_x"] = init.zeros((d,))
        p["xattn"] = _attn_params(init, cfg, cross=True)
    return p


def encoder_layer_params(init: _Init, cfg: ModelConfig) -> dict:
    d = cfg.d_model
    return {"ln1": init.zeros((d,)), "ln2": init.zeros((d,)),
            "attn": _attn_params(init, cfg),
            "mlp": mlp_params(init, cfg, d, cfg.d_ff)}


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
    projections and embeddings, zeros for norm scales and biases, the
    reference's constants for RWKV's decay and the SSM's), each tensor
    drawn on ``device`` in ``cfg.param_dtype``: nothing is staged on the
    host.  ``generator`` must live on ``device``.  ``collect_layers`` takes
    the layers as an iterator that draws each when asked, and its result
    becomes ``params["layers"]`` (``serve/stream.init_streamed_params``
    moves each to the host before the next is drawn).  An enc-dec config
    also gets ``encoder`` (a list of layers), ``enc_norm``, ``enc_pos``
    and ``dec_pos``, the learned decoder position table of
    ``DEC_POSITIONS`` rows."""
    device = resolve_device(device)
    init = _Init(generator, device, getattr(torch, cfg.param_dtype))
    return _params(init, cfg, collect_layers, DEC_POSITIONS)


def param_shapes(cfg: ModelConfig, decode_positions: int = 0) -> dict:
    """``init_params``' tree as meta tensors: the structure, shapes and
    types, nothing drawn or allocated (the counterpart of the reference's
    ``jax.eval_shape`` of ``init_params``).  ``decode_positions`` sizes an
    enc-dec model's decoder position table (0: ``DEC_POSITIONS``), as the
    reference's ``init_params`` argument does."""
    init = _MetaInit(getattr(torch, cfg.param_dtype))
    return _params(init, cfg, list, decode_positions or DEC_POSITIONS)


def _params(init: _Init, cfg: ModelConfig, collect_layers,
            dec_positions: int) -> dict:
    """The parameter tree drawn by ``init``, in ``init_params``' order."""
    d, v = cfg.d_model, cfg.vocab_size
    params: dict = {"embed": init.normal((v, d), d ** -0.5),
                    "final_norm": init.zeros((d,))}
    if not cfg.tie_embeddings:
        params["lm_head"] = init.normal((d, v), d ** -0.5)
    params["layers"] = collect_layers(decoder_layer_params(init, cfg, kind)
                                      for kind in layer_kinds(cfg))
    if cfg.encoder_layers:
        params["encoder"] = [encoder_layer_params(init, cfg)
                             for _ in range(cfg.encoder_layers)]
        params["enc_norm"] = init.zeros((d,))
        params["enc_pos"] = init.normal((max(cfg.encoder_seq, 1), d), 0.02)
        params["dec_pos"] = init.normal((dec_positions, d), 0.02)
    return params


# ---------------------------------------------------------------------------
# serving cache
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CacheSpec:
    capacity: int                  # KV slots per layer (ring buffer)
    batch: int
    kv_dtype: Any = torch.bfloat16   # bf16 | fp32 | int8 (quantized)
    per_slot: bool = False         # independent per-request slots
                                   # (pos: (B,), slot_pos: (B, C))


def init_cache(cfg: ModelConfig, spec: CacheSpec, device="cuda") -> dict:
    """The reference's serving cache, leaf for leaf.  Attention configs: a
    ring KV cache ``k``/``v`` ``(L, B, Hkv, C, hd)`` with ``slot_pos`` tags
    (``POS_SENTINEL`` = unwritten); an int8 ring also ``k_scale``/``v_scale``
    ``(L, B, Hkv, C, 1)`` bf16 zeros (an unwritten slot dequantizes to 0).
    RWKV: no ring, ``rwkv_state``
    ``(L, B, H, d/H, d/H)`` fp32.  Hybrid SSM: ``ssm_state``
    ``(L, B, d, N)`` fp32 beside the ring.  Enc-dec: ``cross_k``/``cross_v``
    ``(L, B, Hkv, E, hd)`` bf16 zeros, which ``prefill`` replaces with K/V
    in the activation type, as the reference's does.  Lock-step:
    ``slot_pos (C,)`` and ``pos`` a Python int; per-slot: ``slot_pos
    (B, C)`` and ``pos`` an int32 tensor (B,), both on the device; an
    enc-dec config takes no per-slot cache (``ValueError``, the
    reference's)."""
    if spec.per_slot and cfg.encoder_layers:
        raise ValueError("per-slot caches do not support enc-dec models")
    device = resolve_device(device)
    L, B, C = cfg.num_layers, spec.batch, spec.capacity
    hd, nkv = cfg.resolved_head_dim, cfg.num_kv_heads
    f32 = torch.float32
    cache: dict = {"pos": (torch.zeros((B,), dtype=torch.int32,
                                       device=device)
                           if spec.per_slot else 0)}
    if not cfg.rwkv:
        kv_shape = (L, B, nkv, C, hd)
        cache["k"] = torch.zeros(kv_shape, dtype=spec.kv_dtype, device=device)
        cache["v"] = torch.zeros(kv_shape, dtype=spec.kv_dtype, device=device)
        if spec.kv_dtype == torch.int8:
            for key in ("k_scale", "v_scale"):
                cache[key] = torch.zeros((*kv_shape[:4], 1),
                                         dtype=torch.bfloat16, device=device)
        cache["slot_pos"] = torch.full((B, C) if spec.per_slot else (C,),
                                       POS_SENTINEL, dtype=torch.int32,
                                       device=device)
    else:
        h = cfg.num_heads
        cache["rwkv_state"] = torch.zeros(
            (L, B, h, cfg.d_model // h, cfg.d_model // h), dtype=f32,
            device=device)
    if cfg.hybrid_parallel_ssm:
        cache["ssm_state"] = torch.zeros((L, B, cfg.d_model, cfg.ssm_state),
                                         dtype=f32, device=device)
    if cfg.encoder_layers:
        cross = (L, B, nkv, cfg.encoder_seq, hd)
        cache["cross_k"] = torch.zeros(cross, dtype=torch.bfloat16,
                                       device=device)
        cache["cross_v"] = torch.zeros(cross, dtype=torch.bfloat16,
                                       device=device)
    return cache


_LAYER_CACHE_KEYS = ("k", "v", "k_scale", "v_scale", "rwkv_state",
                     "ssm_state", "cross_k", "cross_v")


def layer_slices(cache: Optional[dict], li: int) -> Optional[dict]:
    """Layer ``li``'s slices of the cache leaves it has (views, written in
    place by the layer), or None without a cache."""
    if cache is None:
        return None
    return {key: cache[key][li] for key in _LAYER_CACHE_KEYS if key in cache}


# ---------------------------------------------------------------------------
# layer application
# ---------------------------------------------------------------------------

def _heads(t: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    """(B, S, n hd) -> (B, n, S, hd), a view."""
    b, s, _ = t.shape
    return t.reshape(b, s, n, hd).transpose(1, 2)


def _project_qkv(x, p, cfg: ModelConfig):
    hd = cfg.resolved_head_dim
    nq, nkv = cfg.num_heads, cfg.num_kv_heads
    q = _heads(linear(x, p["w_q"], p.get("b_q")), nq, hd)
    k = _heads(linear(x, p["w_k"], p.get("b_k")), nkv, hd)
    v = _heads(linear(x, p["w_v"], p.get("b_v")), nkv, hd)
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


def _kv_scales(layer_cache: dict) -> KVScales:
    """An int8 ring's scales (k_scale, v_scale), or None."""
    if "k_scale" not in layer_cache:
        return None
    return layer_cache["k_scale"], layer_cache["v_scale"]


def _self_attention_decode(x, p, cfg: ModelConfig, spec: AttnSpec,
                           layer_cache: dict, ctx: dict):
    """x: (B,1,d), one token at absolute position ``ctx["pos"]`` against
    the ring cache (B,Hkv,C,hd).  The new K/V row is written **in place**
    at slot ``pos % C`` before attention (an int8 ring: quantized, with its
    scales).  The rope tables are the same for every layer and come ready
    in ``ctx``.  Attention is ``decode_attn`` with the Pallas kernel's own
    signature (``slot_pos (C,)``, scalar position)."""
    b, s, _ = x.shape
    k_cache, v_cache = layer_cache["k"], layer_cache["v"]
    scales = _kv_scales(layer_cache)
    q, k_new, v_new = _project_qkv(x, p, cfg)          # (B,H,1,hd)
    q = apply_rope(q, ctx["sin"], ctx["cos"])
    if scales is not None:   # K's rope inside the quantizing launch
        quantize_into(k_new, v_new, k_cache, v_cache, *scales, ctx["pos"],
                      ctx["sin"], ctx["cos"])
    else:
        k_new = apply_rope(k_new, ctx["sin"], ctx["cos"])
        slot = ctx["pos"] % k_cache.shape[2]
        k_cache[:, :, slot:slot + 1, :] = k_new.to(k_cache.dtype)
        v_cache[:, :, slot:slot + 1, :] = v_new.to(v_cache.dtype)
    out = decode_attn(q.reshape(b, spec.num_heads, spec.head_dim),
                      k_cache, v_cache, ctx["slot_pos"], ctx["pos"],
                      window=spec.sliding_window, scale=spec.scale,
                      kv_scales=scales)
    return linear(out.reshape(b, s, -1), p["w_o"])


def _self_attention_slots(x, p, cfg: ModelConfig, spec: AttnSpec,
                          layer_cache: dict, ctx: dict):
    """Per-slot cached attention: every batch row sits at its own absolute
    position.  x: (B,T,d), ``ctx["positions"]`` (B,T) per-row token
    positions, ``ctx["slot_pos"]`` (B,C) per-row ring tags (already
    updated for this step's writes), caches (B,Hkv,C,hd).  Serves both the
    continuous-batching decode step (T=1, B=slots) and chunked prefill
    (B=1, T=chunk).  The T new K/V rows are written **in place** into each
    row's ring slots (an int8 ring: quantized, with their scales, the
    chunk's own rows among those it attends to).  At T=1 attention is
    ``decode_attn`` with per-row positions; at T>1 ``flash_attn_pos`` with
    the chunk's positions against the ring's tags, on the ring as it is
    stored (no widened copy), its output in (B, T, Hq, D) storage."""
    b, t, _ = x.shape
    k_cache, v_cache = layer_cache["k"], layer_cache["v"]
    scales = _kv_scales(layer_cache)
    positions = ctx["positions"]
    q, k_new, v_new = _project_qkv(x, p, cfg)          # (B,H,T,hd)
    q = apply_rope(q, ctx["sin"], ctx["cos"])
    if scales is not None:   # K's rope inside the quantizing launch
        quantize_into(k_new, v_new, k_cache, v_cache, *scales, positions,
                      ctx["sin"], ctx["cos"])
    else:
        k_new = apply_rope(k_new, ctx["sin"], ctx["cos"])
        rows = torch.arange(b, device=x.device)[:, None]   # (B,1)
        slots = (positions % k_cache.shape[2]).long()      # (B,T), distinct
        k_cache[rows, :, slots, :] = k_new.to(k_cache.dtype).transpose(1, 2)
        v_cache[rows, :, slots, :] = v_new.to(v_cache.dtype).transpose(1, 2)
    if t == 1:
        out = decode_attn(q.reshape(b, spec.num_heads, spec.head_dim),
                          k_cache, v_cache, ctx["slot_pos"], ctx["q_pos"],
                          window=spec.sliding_window, scale=spec.scale,
                          kv_scales=scales)
        return linear(out.reshape(b, t, -1), p["w_o"])
    out = flash_attn_pos(q, k_cache, v_cache, positions,
                         ctx["slot_pos"], causal=spec.causal,
                         window=spec.sliding_window, scale=spec.scale,
                         kv_scales=scales)
    out = out.transpose(1, 2).reshape(b, t, -1)     # a view on the card
    return linear(out, p["w_o"])


def _cross_attention(x, p, cfg: ModelConfig, ck, cv):
    """Cross-attention of the decoder tokens x (B, S, d) to the encoder's
    K/V (B, Hkv, E, hd), bidirectional, through ``flash_attn`` with
    Sq = S (a prefill's prompt, or 1 at decode) against Sk = E and no
    positions."""
    b, s, _ = x.shape
    q = _heads(linear(x, p["w_q"]), cfg.num_heads, cfg.resolved_head_dim)
    out = flash_attn(q, ck, cv, causal=False)
    return linear(out.transpose(1, 2).reshape(b, s, -1), p["w_o"])


def _cross_kv(enc_out, p, cfg: ModelConfig, layer_cache: Optional[dict]):
    """A layer's cross-attention K/V of ``enc_out`` (B, E, d), written into
    its cache slices (in place) and returned; without a cache (training)
    new contiguous tensors, as the reference projects them in each layer."""
    nkv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    k = _heads(linear(enc_out, p["w_k"]), nkv, hd)
    v = _heads(linear(enc_out, p["w_v"]), nkv, hd)
    if layer_cache is None:
        return k.contiguous(), v.contiguous()
    ck, cv = layer_cache["cross_k"], layer_cache["cross_v"]
    ck.copy_(k)
    cv.copy_(v)
    return ck, cv


def _encode(params, cfg: ModelConfig, enc_embeds: torch.Tensor):
    """Whisper's encoder over precomputed (stub) frame embeddings
    (B, E, d): learned positions, then bidirectional self-attention
    (``flash_attn``, no rope) and the MLP a layer, and the final norm."""
    x = enc_embeds + params["enc_pos"][None, :enc_embeds.shape[1], :]
    for p in params["encoder"]:
        b, s, _ = x.shape
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        q, k, v = _project_qkv(h, p["attn"], cfg)
        out = flash_attn(q, k.contiguous(), v.contiguous(), causal=False)
        x = x + linear(out.transpose(1, 2).reshape(b, s, -1),
                       p["attn"]["w_o"])
        x = x + mlp(rms_norm(x, p["ln2"], cfg.norm_eps), p["mlp"], cfg)
    return rms_norm(x, params["enc_norm"], cfg.norm_eps)


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
    dropping at prefill and in training; dropless at decode and in
    ``slots`` mode (the continuous decode step and chunked prefill)."""
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
    """Apply one decoder layer (RWKV by the config; dense or MoE by its
    parameters; with the config's SSM branch and cross-attention); the
    layer's cache slices (views of the cache tensors) are written in
    place."""
    if cfg.rwkv:
        state = layer_cache["rwkv_state"] if layer_cache else None
        x, new_state = rwkv_mod.rwkv_block(x, p, cfg, state)
        if layer_cache is not None:
            layer_cache["rwkv_state"].copy_(new_state)
        return x
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if ctx["mode"] == "decode":
        attn_out = _self_attention_decode(h, p["attn"], cfg, spec,
                                          layer_cache, ctx)
    elif ctx["mode"] == "slots":
        attn_out = _self_attention_slots(h, p["attn"], cfg, spec,
                                         layer_cache, ctx)
    else:
        attn_out, k, v = _self_attention_full(
            h, p["attn"], cfg, spec, ctx["sin"], ctx["cos"])
        if layer_cache is not None:   # prefill: write the cache
            c = layer_cache["k"].shape[2]
            s = k.shape[2]
            kw, vw = k[:, :, -c:, :], v[:, :, -c:, :]
            if "k_scale" in layer_cache:   # the reference's int8 ring fill
                (kw, ks), (vw, vs) = quantize_kv(kw), quantize_kv(vw)
                _fill_ring(layer_cache["k_scale"], ks, s)
                _fill_ring(layer_cache["v_scale"], vs, s)
            _fill_ring(layer_cache["k"], kw, s)
            _fill_ring(layer_cache["v"], vw, s)
    if cfg.hybrid_parallel_ssm:
        state = layer_cache["ssm_state"] if layer_cache else None
        ssm_out, new_state = ssm_mod.ssm_branch(h, p["ssm"], cfg, state)
        attn_out = attn_out + ssm_out
        if layer_cache is not None:
            layer_cache["ssm_state"].copy_(new_state)
    x = x + attn_out
    if cfg.encoder_layers:
        if ctx.get("enc_out") is not None:     # prefill: fill the cache
            ck, cv = _cross_kv(ctx["enc_out"], p["xattn"], cfg, layer_cache)
        else:
            ck, cv = layer_cache["cross_k"], layer_cache["cross_v"]
        hx = rms_norm(x, p["ln_x"], cfg.norm_eps)
        x = x + _cross_attention(hx, p["xattn"], cfg, ck, cv)
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + _ffn(h2, p, cfg, ctx["mode"])


def _run_decoder(params, cfg: ModelConfig, x, ctx, cache):
    """The decoder as a Python loop over layers (the reference scans over
    stacked blocks); each layer gets views of its cache slices."""
    spec = attn_spec(cfg)
    for li, p in enumerate(params["layers"]):
        x = _decoder_layer(x, p, cfg, spec, ctx, layer_slices(cache, li))
    return x


def _run_decoder_train(params, cfg: ModelConfig, x, ctx, remat: bool):
    """The decoder in training: no cache, each layer under
    ``checkpoint(use_reentrant=False)`` when ``remat`` (its activations
    recomputed in the backward, as the reference's ``jax.checkpoint``; an
    enc-dec model's ``enc_out`` reaches the layers through ``ctx``, and its
    cross K/V are projected inside each layer as the reference's
    ``_run_decoder_with_cross`` does)."""
    spec = attn_spec(cfg)
    for p in params["layers"]:
        if remat:
            x = checkpoint(lambda x, p=p: _decoder_layer(x, p, cfg, spec, ctx,
                                                         None),
                           x, use_reentrant=False)
        else:
            x = _decoder_layer(x, p, cfg, spec, ctx, None)
    return x


# ---------------------------------------------------------------------------
# full forward passes
# ---------------------------------------------------------------------------

def _embed(params, cfg: ModelConfig, tokens, embeds=None):
    """Token embeddings (scaled where the config says), with a VLM's patch
    embeddings ``embeds`` (B, P, d) ahead of them."""
    x = params["embed"][tokens]
    if cfg.scale_embed:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype,
                             device=x.device)
    if embeds is not None and cfg.frontend == "vision_stub":
        x = torch.cat([embeds.to(device=x.device, dtype=x.dtype), x], dim=1)
    return x


def _logits(params, cfg: ModelConfig, x):
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings:
        return linear(x, params["embed"].t())
    return linear(x, params["lm_head"])


def forward_train(params, cfg: ModelConfig, tokens: torch.Tensor,
                  embeds: Optional[torch.Tensor] = None,
                  enc_embeds: Optional[torch.Tensor] = None,
                  remat: bool = True) -> torch.Tensor:
    """Causal forward over (B, S) tokens -> (B, S[, +patches], V) logits,
    differentiable (the reference's ``forward_train``).  A VLM's ``embeds``
    (B, P, d) go ahead of the tokens; an enc-dec config runs ``enc_embeds``
    (B, E, d) through the encoder and adds its decoder positions.
    ``remat`` recomputes each layer in the backward."""
    x = _embed(params, cfg, tokens, embeds)
    s = x.shape[1]
    positions = torch.arange(s, device=x.device)
    sin, cos = rope_tables(positions, cfg.resolved_head_dim, cfg.rope_theta)
    ctx = {"mode": "train", "sin": sin, "cos": cos}
    if cfg.encoder_layers:
        if enc_embeds is None:
            raise ValueError(f"{cfg.name} is an encoder-decoder model: "
                             "forward_train needs enc_embeds")
        ctx["enc_out"] = _encode(params, cfg, enc_embeds.to(x.device))
        x = x + params["dec_pos"][None, :s, :]
    x = _run_decoder_train(params, cfg, x, ctx, remat)
    return _logits(params, cfg, x)


def loss_fn(params, cfg: ModelConfig, batch: dict,
            remat: bool = True) -> torch.Tensor:
    """Mean next-token cross-entropy of ``batch`` (``tokens``, ``labels``,
    optional ``mask``, ``embeds``, ``enc_embeds``): the reference's
    ``loss_fn``.  A VLM's logits are cut to the text (the last
    ``labels.shape[1]`` positions).  No MoE load-balance term, as the
    reference adds none."""
    logits = forward_train(params, cfg, batch["tokens"],
                           embeds=batch.get("embeds"),
                           enc_embeds=batch.get("enc_embeds"), remat=remat)
    labels = batch["labels"]
    if logits.shape[1] != labels.shape[1]:   # vision prefix: score text only
        logits = logits[:, -labels.shape[1]:, :]
    return softmax_xent(logits, labels, batch.get("mask"))


def prefill(params, cfg: ModelConfig, tokens: torch.Tensor,
            cache: dict, *, embeds: Optional[torch.Tensor] = None,
            enc_embeds: Optional[torch.Tensor] = None,
            decoder=None) -> tuple[torch.Tensor, dict]:
    """Process the prompt (B, S), fill ``cache`` in place, return the
    last token's logits (B, 1, V) and the same cache.  A VLM's ``embeds``
    (B, P, d) go ahead of the prompt (P + S positions); an enc-dec
    config's ``enc_embeds`` (B, E, d) run through the encoder, whose
    output every layer projects to its cross-attention K/V in the cache
    (``cross_k``/``cross_v`` take the activation type, as the
    reference's), and the decoder positions are added.  ``decoder`` runs
    the layers (default ``_run_decoder``)."""
    x = _embed(params, cfg, tokens, embeds)
    s = x.shape[1]
    positions = torch.arange(s, device=x.device)
    sin, cos = rope_tables(positions, cfg.resolved_head_dim, cfg.rope_theta)
    ctx = {"mode": "prefill", "sin": sin, "cos": cos}
    if cfg.encoder_layers:
        if enc_embeds is None:
            raise ValueError(f"{cfg.name} is an encoder-decoder model: "
                             "prefill needs enc_embeds")
        enc_out = _encode(params, cfg, enc_embeds.to(x.device))
        for key in ("cross_k", "cross_v"):
            buf = cache[key]
            shape = (*buf.shape[:3], enc_out.shape[1], buf.shape[4])
            if buf.dtype != enc_out.dtype or tuple(buf.shape) != shape:
                cache[key] = torch.empty(shape, dtype=enc_out.dtype,
                                         device=buf.device)
        ctx["enc_out"] = enc_out
        x = x + params["dec_pos"][None, :s, :]
    x = (decoder or _run_decoder)(params, cfg, x, ctx, cache)
    if "slot_pos" in cache:
        cap = cache["slot_pos"].shape[0]
        idx = torch.arange(cap, device=x.device)
        if s <= cap:
            slot_pos = torch.where(idx < s, idx, POS_SENTINEL)
        else:   # ring layout: slot j holds position p=start+((j-start)%C)
            start = s - cap
            slot_pos = start + (idx - start) % cap
        cache["slot_pos"].copy_(slot_pos)
    cache["pos"] = s
    return _logits(params, cfg, x[:, -1:, :]), cache


def decode_step(params, cfg: ModelConfig, token: torch.Tensor,
                cache: dict, *, decoder=None) -> tuple[torch.Tensor, dict]:
    """One serving step: token (B,) -> (logits (B,1,V), the same cache,
    advanced in place by one position).  ``decoder`` runs the layers."""
    x = _embed(params, cfg, token[:, None])
    pos = cache["pos"]
    if cfg.encoder_layers:
        npos = params["dec_pos"].shape[0]
        x = x + params["dec_pos"][min(pos, npos - 1)][None, None, :]
    if "slot_pos" in cache:   # tag the new token's slot *before* attention
        cache["slot_pos"][pos % cache["slot_pos"].shape[0]] = pos
    pos_t = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    sin, cos = rope_tables(pos_t, cfg.resolved_head_dim, cfg.rope_theta)
    ctx = {"mode": "decode", "pos": pos, "sin": sin, "cos": cos,
           "slot_pos": cache.get("slot_pos")}
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
    """Tag the ring, where the cache has one (in place), and build what
    every layer shares: rope tables, the tags and the query positions (the
    attention ops mask by the tags themselves)."""
    if "slot_pos" in cache:
        _tag_slots(cache["slot_pos"], positions)
    sin, cos = rope_tables(positions, cfg.resolved_head_dim, cfg.rope_theta)
    return {"mode": "slots", "positions": positions, "sin": sin, "cos": cos,
            "slot_pos": cache.get("slot_pos"), "q_pos": positions[:, 0]}


def decode_slots(params, cfg: ModelConfig, token: torch.Tensor,
                 cache: dict, *, decoder=None) -> tuple[torch.Tensor, dict]:
    """One continuous-batching step: token (B,) against a per-slot cache
    (``CacheSpec(per_slot=True)``: pos (B,), slot_pos (B,C)).  Every slot
    advances by one token at its *own* position -> (logits (B,1,V), the
    same cache, advanced in place).  ``decoder`` runs the layers.  Enc-dec
    models raise ``ValueError``, as in the reference."""
    if cfg.encoder_layers:
        raise ValueError("decode_slots does not support enc-dec models")
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
    (B,1,V), the same cache).  ``decoder`` runs the layers.  Enc-dec
    models raise ``ValueError``, as in the reference."""
    if cfg.encoder_layers:
        raise ValueError("chunk_prefill does not support enc-dec models")
    b, t = tokens.shape
    if "slot_pos" in cache and t > cache["slot_pos"].shape[1]:
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
    ring, recurrent states, ``pos``/``slot_pos``), as a **copy**: the slot cache is
    mutated in place afterwards."""
    return {key: buf.narrow(_slot_batch_axis(key), slot, 1).clone()
            for key, buf in cache.items()}


def cache_evict_slot(cache: dict, slot: int) -> dict:
    """Free a slot in place: reset its position and mask every ring tag so
    the stale K/V is unreachable.  The K/V buffers and recurrent states are
    left as they are (``cache_insert_slot`` overwrites every leaf)."""
    cache["pos"][slot] = 0
    if "slot_pos" in cache:
        cache["slot_pos"][slot] = POS_SENTINEL
    return cache
