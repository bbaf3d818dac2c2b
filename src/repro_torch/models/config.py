"""Composable architecture configuration of the PyTorch port.

The port's own copy of the reference's ``ModelConfig``
(``src/repro/models/config.py``): the port imports nothing of the JAX
package, so it keeps what it needs of that module here.  Field names,
defaults and ``param_count`` are the reference's, so a config of one side
describes the same model on the other.  Only the dense-decoder fields are
read by the port so far; the MoE / SSM / enc-dec fields are kept so that
the configs stay comparable field by field.
"""

from __future__ import annotations

import dataclasses
from typing import Literal, Optional

Family = Literal["dense", "moe", "ssm", "hybrid", "audio", "vlm"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    num_layers: int
    d_model: int
    num_heads: int               # query heads (0 for attention-free)
    num_kv_heads: int            # kv heads (GQA); == num_heads for MHA
    d_ff: int
    vocab_size: int

    head_dim: int = 0            # 0 -> d_model // num_heads
    qkv_bias: bool = False
    qk_norm: bool = False        # RMS-norm on per-head q and k (qwen3)
    gated_mlp: bool = True       # SwiGLU/GeGLU two-matrix gate
    mlp_act: Literal["silu", "gelu", "relu"] = "silu"
    tie_embeddings: bool = False
    scale_embed: bool = False    # multiply embeddings by sqrt(d_model) (gemma)
    norm_eps: float = 1e-6
    rope_theta: float = 10_000.0
    sliding_window: int = 0      # 0 -> full attention; >0 -> SWA width
    # which layers use SWA: "all", "none", or every-k pattern like hymba
    swa_layers: Literal["all", "none"] = "none"

    # --- MoE -----------------------------------------------------------
    moe_experts: int = 0         # 0 -> dense FFN
    moe_top_k: int = 1
    moe_d_ff: int = 0            # per-expert hidden (0 -> d_ff)
    moe_shared_d_ff: int = 0     # shared-expert hidden (0 -> no shared expert)
    moe_every: int = 1           # MoE on layers i % moe_every == moe_offset
    moe_offset: int = 0
    moe_first_dense: int = 0     # first k layers dense (kimi/deepseek style)
    moe_capacity_factor: float = 1.25

    # --- SSM / RWKV / hybrid --------------------------------------------
    ssm_state: int = 0           # mamba-style state size per channel
    rwkv: bool = False           # RWKV6 wkv recurrence instead of attention
    hybrid_parallel_ssm: bool = False  # hymba: attn heads ∥ mamba heads

    # --- encoder-decoder / frontends -------------------------------------
    encoder_layers: int = 0      # >0 -> enc-dec (whisper)
    encoder_seq: int = 0         # fixed encoder length (whisper: 1500 frames)
    frontend: Literal["none", "audio_stub", "vision_stub"] = "none"
    vision_patches: int = 0      # VLM: patch-embedding count prepended to text

    # --- numerics ---------------------------------------------------------
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"

    # --- lowering knobs (not architecture) --------------------------------
    # Python-loop instead of lax.scan for layer blocks / attention chunks:
    # used by the dry-run accounting variants (XLA cost_analysis counts a
    # while body once, not x trip count) and by reduced-L extrapolation.
    unroll_scan: bool = False
    # q-chunk size for the memory-bounded attention path (0 = single shot)
    attn_chunk: int = 512

    # ---- derived ----------------------------------------------------------
    @property
    def attn_free(self) -> bool:
        return self.rwkv

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.num_heads, 1)

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k: SSM, hybrid, or sliding-window attention."""
        return self.rwkv or self.hybrid_parallel_ssm or (
            self.sliding_window > 0 and self.swa_layers == "all")

    def is_moe_layer(self, i: int) -> bool:
        if not self.moe_experts:
            return False
        if i < self.moe_first_dense:
            return False
        return (i - self.moe_offset) % self.moe_every == 0

    def moe_hidden(self) -> int:
        return self.moe_d_ff or self.d_ff

    # -- parameter counts (exact, used for roofline MODEL_FLOPS) -----------
    def param_count(self, active_only: bool = False) -> int:
        d, ff, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.resolved_head_dim
        nq, nkv = self.num_heads, self.num_kv_heads
        total = v * d                                   # embed
        if not self.tie_embeddings:
            total += v * d                              # lm head
        enc = self.encoder_layers
        for i in range(self.num_layers):
            total += 2 * d                              # ln weights
            if self.rwkv:
                # time-mix: r,k,v,g,o (d x d) + decay/bonus + lora-ish mixers
                total += 5 * d * d + 4 * d
                total += 2 * d * ff                     # channel mix (k, v)
                continue
            if self.num_heads:
                total += d * (nq * hd) + (nq * hd) * d  # q, o
                total += 2 * d * (nkv * hd)             # k, v
                if self.qkv_bias:
                    total += (nq + 2 * nkv) * hd
            if self.hybrid_parallel_ssm:
                # mamba branch: in-proj (x,z), dt/B/C proj, out-proj
                total += 2 * d * d + d * (2 * self.ssm_state + d // 16) + d * d
            if self.is_moe_layer(i):
                e = self.moe_experts if not active_only else self.moe_top_k
                mff = self.moe_hidden()
                nmat = 3 if self.gated_mlp else 2
                total += e * nmat * d * mff
                total += d * self.moe_experts           # router (always dense)
                if self.moe_shared_d_ff:
                    total += nmat * d * self.moe_shared_d_ff
            else:
                nmat = 3 if self.gated_mlp else 2
                total += nmat * d * ff
        for _ in range(enc):
            total += 2 * d
            total += 4 * d * d                          # self-attn q,k,v,o
            total += 2 * d * ff                         # (whisper mlp non-gated)
        if enc:  # decoder cross-attention
            total += self.num_layers * 4 * d * d
        return int(total)

    def active_param_count(self) -> int:
        return self.param_count(active_only=True)
