"""Model-layer primitives of the port (counterpart of ``models/layers.py``).

Plain functions on tensors and parameter dictionaries: bf16 activations
with fp32 accumulation in norms, softmax and attention logits, as in the
reference.  Layouts are the reference's: weights are ``(in, out)``,
attention keeps ``(batch, heads, seq, head_dim)``.  The reference's
``mesh`` arguments and sharding constraints are dropped: the port runs on
one GPU.

Norms, rope and the masked reference attention are plain PyTorch ops, as
the reference leaves them to XLA.  Two primitives reach hand-written
kernels on the card: ``linear`` (every q/k/v/o projection, and through
``transformer._logits`` the LM head) goes through ``kernels/elk_matmul``,
route and tiles from ``chip/h100.smem_plan``, and ``mlp`` through
``kernels/fused_mlp``; on CPU tensors both take their plain versions.
(The model's attention reaches ``kernels/decode_attention`` and
``kernels/flash_attention`` from ``transformer.py``.)  All three kernel
ops are autograd Functions with hand-written backward kernels on the card,
so training runs through them.  ``softmax_xent`` is the training loss, in
plain PyTorch as the reference leaves it to XLA; ``mlp_params`` draws an
MLP's weights (``transformer.init_params`` calls it).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.kernels.elk_matmul.ops import matmul
from repro_torch.kernels.fused_mlp.ops import fused_mlp
from repro_torch.kernels.fused_mlp.ref import act_fn as _act  # noqa: F401  (the reference's name, kept on this module)
from repro_torch.models.config import ModelConfig

_POS_PAD = 2 ** 30   # position given to padded query rows (attend to all)


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMS norm in fp32; scales by ``1 + scale`` for every architecture."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.to(torch.float32))).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * scale.to(torch.float32)
            + bias.to(torch.float32)).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_tables(positions: torch.Tensor, head_dim: int,
                theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(sin, cos) tables for integer ``positions`` (any leading shape)."""
    half = head_dim // 2
    exponent = torch.arange(half, dtype=torch.float32,
                            device=positions.device) / half
    freqs = 1.0 / (theta ** exponent)
    ang = positions.to(torch.float32)[..., None] * freqs     # (..., half)
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x: torch.Tensor, sin: torch.Tensor,
               cos: torch.Tensor) -> torch.Tensor:
    """x: (B, H, S, D); sin/cos: (B, S, D/2) or (S, D/2).  The head dim is
    split in halves (not interleaved)."""
    if sin.dim() == 2:
        sin, cos = sin[None, None], cos[None, None]
    else:
        sin, cos = sin[:, None], cos[:, None]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AttnSpec:
    """Static attention behaviour derived from a ModelConfig."""
    num_heads: int
    num_kv_heads: int
    head_dim: int
    causal: bool = True
    sliding_window: int = 0      # 0 = full
    qk_norm: bool = False
    softmax_scale: Optional[float] = None

    @property
    def scale(self) -> float:
        return self.softmax_scale or self.head_dim ** -0.5


def attn_mask_bias(spec: AttnSpec, q_pos: torch.Tensor,
                   k_pos: torch.Tensor) -> torch.Tensor:
    """Additive fp32 bias (Q, K): 0 where attendable, -inf where masked.

    q_pos/k_pos are absolute token positions, so the same code serves
    prefill (q_pos == k_pos grid) and decode (single q position against a
    cache whose live region is position-tagged)."""
    dq, dk = q_pos[:, None], k_pos[None, :]
    ok = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                    device=q_pos.device)
    if spec.causal:
        ok &= dk <= dq
    if spec.sliding_window:
        ok &= dk > dq - spec.sliding_window
    bias = torch.zeros(ok.shape, dtype=torch.float32, device=q_pos.device)
    return bias.masked_fill_(~ok, float("-inf"))


def gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  bias: Optional[torch.Tensor], spec: AttnSpec
                  ) -> torch.Tensor:
    """Reference GQA attention.

    q: (B, Hq, Sq, D);  k/v: (B, Hkv, Sk, D);  bias: (Sq, Sk) or None.
    Grouped heads are folded by reshaping q to (B, Hkv, G, Sq, D) so the
    kv tensors are never materialized per q head.  Logits and softmax are
    fp32 (q and k are widened for the product, as the reference asks XLA
    for an fp32 result); probabilities are cast to ``v.dtype``."""
    b, hq, sq, d = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    qg = q.reshape(b, hkv, g * sq, d).to(torch.float32)
    logits = torch.matmul(qg, k.to(torch.float32).transpose(-1, -2))
    logits = logits.reshape(b, hkv, g, sq, k.shape[2]) * spec.scale
    if bias is not None:
        logits = logits + bias
    # rows that are fully masked (cache slots beyond the window) give NaN
    # in the softmax; they must come out as zeros
    probs = torch.softmax(logits, dim=-1)
    probs = torch.nan_to_num_(probs, nan=0.0)
    out = torch.matmul(probs.to(v.dtype).reshape(b, hkv, g * sq, -1), v)
    return out.reshape(b, hq, sq, d)


def chunked_gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          spec: AttnSpec, q_pos: torch.Tensor,
                          k_pos: torch.Tensor, *, chunk: int = 512
                          ) -> torch.Tensor:
    """Memory-bounded attention: q is processed in chunks so the live score
    tile is (..., chunk, Sk) instead of (..., Sq, Sk).  A ragged tail is
    padded with query rows at a far position and cut off again."""
    b, hq, sq, d = q.shape
    if chunk <= 0 or sq <= chunk:
        return gqa_attention(q, k, v, attn_mask_bias(spec, q_pos, k_pos),
                             spec)
    n = -(-sq // chunk)
    pad = n * chunk - sq
    if pad:
        q = torch.nn.functional.pad(q, (0, 0, 0, pad))
        q_pos = torch.nn.functional.pad(q_pos, (0, pad), value=_POS_PAD)
    outs = []
    for i in range(n):
        sl = slice(i * chunk, (i + 1) * chunk)
        bias = attn_mask_bias(spec, q_pos[sl], k_pos)
        outs.append(gqa_attention(q[:, :, sl], k, v, bias, spec))
    return torch.cat(outs, dim=2)[:, :, :sq, :]


def qk_head_norm(x: torch.Tensor, scale: torch.Tensor,
                 eps: float) -> torch.Tensor:
    """Per-head RMS norm on q/k (qwen3). x: (B, H, S, D), scale: (D,)."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + scale.to(torch.float32))
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Projections & MLP
# ---------------------------------------------------------------------------

def linear(x: torch.Tensor, w: torch.Tensor,
           b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (..., d) @ w (d, f) [+ b] through ``kernels/elk_matmul``: the
    leading dimensions are flattened into the product's rows and the bias
    added after, as the reference's einsum does.  ``w`` may be the
    transposed view of an (f, d) tensor (a tied embedding)."""
    lead = x.shape[:-1]
    out = matmul(x.reshape(-1, x.shape[-1]), w).reshape(*lead, w.shape[-1])
    if b is not None:
        out = out + b.to(out.dtype)
    return out


def mlp(x: torch.Tensor, p: dict, cfg: ModelConfig) -> torch.Tensor:
    """MLP block through ``kernels/fused_mlp``: on the card the whole
    up-proj -> activation -> down-proj chain is one call of the
    hand-written kernel (a few rows keep the intermediate in shared memory;
    many write it once to device memory between two products, the
    kernel's routes); on CPU tensors it is the einsum composition of the
    reference's CPU path."""
    if not x.is_contiguous():
        x = x.contiguous()
    if cfg.gated_mlp:
        return fused_mlp(x, p["w_up"], p["w_down"], w_gate=p["w_gate"],
                         act=cfg.mlp_act)
    return fused_mlp(x, p["w_up"], p["w_down"], b_up=p.get("b_up"),
                     b_down=p.get("b_down"), act=cfg.mlp_act)


def mlp_params(init, cfg: ModelConfig, d: int, ff: int) -> dict:
    """An MLP's weights with the reference's scales, drawn by ``init`` (the
    initialiser of ``transformer.init_params``: ``normal(shape, scale)``
    and ``zeros(shape)`` on its device and type): GLU ``w_gate``, ``w_up``
    (d, ff) and ``w_down`` (ff, d); plain ``w_up``, ``w_down`` and, with
    ``qkv_bias``, the fc biases."""
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


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------

def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 mask: Optional[torch.Tensor] = None,
                 z_loss: float = 0.0) -> torch.Tensor:
    """Mean token cross-entropy in fp32; optional z-loss regularizer and
    token mask (the reference's ``softmax_xent``)."""
    lf = logits.to(torch.float32)
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
    nll = lse - gold
    if z_loss:
        nll = nll + z_loss * lse ** 2
    if mask is not None:
        m = mask.to(torch.float32)
        return torch.sum(nll * m) / torch.clamp(torch.sum(m), min=1.0)
    return torch.mean(nll)


class _StandIn(torch.autograd.Function):
    """Empty outputs that autograd connects to the inputs, computing
    nothing, forward or backward (``stand_in``)."""

    @staticmethod
    def forward(ctx, likes, *inputs):
        ctx.likes = [(t.shape, t.dtype, t.device) for t in inputs]
        return tuple(torch.empty(shape, dtype=dt, device=dev)
                     for shape, dt, dev in likes)

    @staticmethod
    def backward(ctx, *grads):
        return (None, *(torch.empty(shape, dtype=dt, device=dev)
                        for shape, dt, dev in ctx.likes))


def stand_in(likes: tuple, *inputs: torch.Tensor) -> tuple:
    """Tensors of ``likes``' shapes and types, connected for autograd to
    ``inputs``, with no operation run: on the meta device, the dry run's
    stand-in for a recurrence over time, whose work it adds from the
    reference's analytic count (``launch/dryrun._recurrence_correction``)
    instead of walking hundreds of thousands of steps."""
    return _StandIn.apply([(t.shape, t.dtype, t.device) for t in likes],
                          *inputs)
