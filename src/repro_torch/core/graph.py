"""Operator graph extraction (the paper's ONNX-frontend equivalent, §5.1).

Builds the per-model operator list the ELK scheduler consumes, with per-op
iteration spaces, FLOPs, HBM load bytes and input tensor sharing structure.
The same ``ModelConfig`` drives the JAX runtime, so the graph and the real
model agree on shapes by construction.

Conventions
-----------
* ``Op.dims`` is the partitionable iteration space (e.g. ``(M, N, K)`` for a
  matmul).  ``reduce_dims`` indexes reduction dims within ``dims``.
* Each input ``TensorSpec.dims`` lists which iteration dims the tensor spans;
  cores whose tiles differ only in non-spanned dims *share* the tensor —
  that sharing group size ``g`` is what drives broadcast-vs-shift tradeoffs
  (paper Fig. 3).
* ``from_hbm`` marks data loaded from off-chip memory (weights, KV cache,
  recurrent state).  Activations flowing between ops stay on-chip
  (the ICCA chip's large SRAM holds whole intermediates, paper §8).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Literal, Optional

from repro_torch.models.config import ModelConfig

Phase = Literal["decode", "prefill", "train_fwd"]


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    name: str
    dims: tuple[int, ...]          # indices into Op.dims spanned by this tensor
    bytes_total: int               # whole-tensor bytes (all cores combined)
    from_hbm: bool

    def tile_bytes(self, split: tuple[int, ...]) -> int:
        """Per-tile bytes under a dim split (ceil per spanned dim)."""
        q = 1
        for d in self.dims:
            q *= split[d]
        return -(-self.bytes_total // max(q, 1))


@dataclasses.dataclass(frozen=True)
class Op:
    name: str
    kind: Literal["matmul", "vector"]
    layer: int                     # -1 for embed / head / frontends
    dims: tuple[int, ...]
    reduce_dims: tuple[int, ...]
    flops: float
    inputs: tuple[TensorSpec, ...]
    out_bytes: int
    # MoE late binding (§7 "Apply ELK to MoE"): preload may not start before
    # this op index has finished executing (the router).  -1 = no constraint.
    preload_dep: int = -1

    @property
    def hbm_bytes(self) -> int:
        return sum(t.bytes_total for t in self.inputs if t.from_hbm)

    @property
    def act_bytes(self) -> int:
        return sum(t.bytes_total for t in self.inputs if not t.from_hbm)


@dataclasses.dataclass(frozen=True)
class OpGraph:
    model: str
    phase: Phase
    ops: tuple[Op, ...]
    layer_span: tuple[int, int]    # [start, end) op indices of layer 0
    num_layers: int                # identical-layer count (for §4.4 pruning)

    def __len__(self) -> int:
        return len(self.ops)

    def hbm_heavy_threshold(self) -> float:
        """§4.4: reorder only ops whose HBM tensor size is above average."""
        total = sum(op.hbm_bytes for op in self.ops)
        return total / max(len(self.ops), 1)

    def hbm_heavy(self, idx: int) -> bool:
        return self.ops[idx].hbm_bytes > self.hbm_heavy_threshold()


# ---------------------------------------------------------------------------
# builders
# ---------------------------------------------------------------------------

def _mm(name: str, layer: int, m: int, n: int, k: int, *,
        w_hbm: bool = True, bias: bool = False, dt: int = 2,
        act_name: str = "x", extra_flop_k: int = 0,
        preload_dep: int = -1) -> Op:
    """A (m,k)@(k,n) matmul; weight loaded from HBM unless ``w_hbm=False``."""
    flops = 2.0 * m * n * (k + extra_flop_k)
    inputs = [
        TensorSpec(act_name, (0, 2), m * k * dt, False),
        TensorSpec("w", (2, 1), k * n * dt, w_hbm),
    ]
    if bias:
        inputs.append(TensorSpec("b", (1,), n * dt, w_hbm))
    return Op(name, "matmul", layer, (m, n, k), (2,), flops,
              tuple(inputs), m * n * dt, preload_dep)


def _bmm_attn(name: str, layer: int, rows: int, heads: int, ctx: int,
              head_dim: int, kv_bytes: int, *, kv_hbm: bool,
              score: bool, dt: int = 2) -> Op:
    """Attention BMM: iteration space (rows*heads, ctx), inner dim head_dim.

    ``score=True`` is q@K^T (output = the (rows*heads, ctx) score matrix, no
    reduction over ctx); ``score=False`` is scores@V (ctx reduced, output =
    (rows*heads, head_dim)).  The KV tensor spans *both* dims: per paper
    §3.2 the KV cache has no data reuse among requests, so no core shares it
    (each core streams its own slice) — its broadcast fraction is moot but
    its preload footprint is real."""
    flops = 2.0 * rows * heads * ctx * head_dim
    out = (rows * heads * ctx * dt) if score else (rows * heads * head_dim * dt)
    inputs = (
        TensorSpec("q", (0,), rows * heads * head_dim * dt, False),
        TensorSpec("kv", (0, 1), kv_bytes, kv_hbm),
    )
    reduce = () if score else (1,)
    return Op(name, "matmul", layer, (rows * heads, ctx), reduce, flops,
              inputs, out)


def _vec(name: str, layer: int, tokens: int, width: int, *,
         flop_mult: float = 8.0, hbm_bytes: int = 0, dt: int = 2) -> Op:
    """Elementwise / softmax / norm op over (tokens, width)."""
    n = tokens * width
    inputs = [TensorSpec("x", (0,), n * dt, False)]
    if hbm_bytes:
        inputs.append(TensorSpec("w", (1,), hbm_bytes, True))
    return Op(name, "vector", layer, (tokens, width), (), flop_mult * n,
              tuple(inputs), n * dt)


def build_graph(cfg: ModelConfig, *, batch: int, seq: int,
                phase: Phase = "decode") -> OpGraph:
    """Build the operator list for one step of ``phase``.

    decode:    one new token per request; ctx = ``seq`` (KV read from HBM).
    prefill:   full-sequence forward; attention O(seq^2), weights from HBM.
    train_fwd: like prefill over batch*seq tokens (paper Fig. 24 examines the
               forward pass of training; bwd has the same structure).
    """
    dt = 2  # bf16
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    nq, nkv = cfg.num_heads, cfg.num_kv_heads

    if phase == "decode":
        rows, ctx = batch, seq
    else:
        rows, ctx = batch * seq, seq

    ops: list[Op] = []

    def idx() -> int:
        return len(ops)

    # ---- embedding ---------------------------------------------------------
    emb_rows = rows if cfg.frontend == "none" else rows
    ops.append(_vec("embed", -1, emb_rows, d,
                    hbm_bytes=min(cfg.vocab_size, emb_rows) * d * dt))
    if cfg.vision_patches and phase != "decode":
        ops.append(_vec("vision_patches", -1, batch * cfg.vision_patches, d,
                        hbm_bytes=0))

    # ---- encoder (whisper) -------------------------------------------------
    enc_ctx = cfg.encoder_seq or 0
    if cfg.encoder_layers:
        erows = batch * enc_ctx
        for li in range(cfg.encoder_layers):
            L = -1  # encoder ops are outside the identical-decoder-layer span
            ops.append(_vec(f"enc{li}.ln1", L, erows, d))
            ops.append(_mm(f"enc{li}.qkv", L, erows, 3 * d, d, bias=True))
            ops.append(_bmm_attn(f"enc{li}.score", L, erows, nq, enc_ctx, hd,
                                 batch * enc_ctx * d * dt, kv_hbm=False,
                                 score=True))
            ops.append(_vec(f"enc{li}.softmax", L, erows * nq, enc_ctx))
            ops.append(_bmm_attn(f"enc{li}.attnv", L, erows, nq, enc_ctx, hd,
                                 batch * enc_ctx * d * dt, kv_hbm=False,
                                 score=False))
            ops.append(_mm(f"enc{li}.o", L, erows, d, d))
            ops.append(_vec(f"enc{li}.ln2", L, erows, d))
            ops.append(_mm(f"enc{li}.fc1", L, erows, cfg.d_ff, d, bias=True))
            ops.append(_mm(f"enc{li}.fc2", L, erows, d, cfg.d_ff, bias=True))

    # ---- decoder layers ----------------------------------------------------
    layer_start = idx()
    layer_end = layer_start
    for li in range(cfg.num_layers):
        if cfg.rwkv:
            _rwkv_layer(ops, cfg, li, rows, dt)
        else:
            _attn_layer(ops, cfg, li, rows, ctx, batch, phase, dt)
            if cfg.hybrid_parallel_ssm:
                _ssm_branch(ops, cfg, li, rows, batch, dt)
            if cfg.encoder_layers:
                _cross_attn(ops, cfg, li, rows, batch, enc_ctx, dt)
            _mlp(ops, cfg, li, rows, dt)
        if li == 0:
            layer_end = idx()

    # ---- head --------------------------------------------------------------
    head_rows = batch if phase == "decode" else rows
    ops.append(_vec("final_norm", -1, head_rows, d))
    ops.append(_mm("lm_head", -1, head_rows, cfg.vocab_size, d))

    return OpGraph(cfg.name, phase, tuple(ops), (layer_start, layer_end),
                   cfg.num_layers)


def _attn_layer(ops: list[Op], cfg: ModelConfig, li: int, rows: int,
                ctx: int, batch: int, phase: Phase, dt: int) -> None:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    nq, nkv = cfg.num_heads, cfg.num_kv_heads
    win = cfg.sliding_window if (cfg.sliding_window and
                                 cfg.swa_layers == "all") else 0
    actx = min(ctx, win) if win else ctx
    if phase != "decode":
        # causal average context length
        actx = min(ctx, win) if win else ctx
        eff_ctx = actx if win else max(ctx // 2, 1)
    else:
        eff_ctx = actx

    ops.append(_vec(f"l{li}.ln1", li, rows, d))
    ops.append(_mm(f"l{li}.q", li, rows, nq * hd, d, bias=cfg.qkv_bias))
    ops.append(_mm(f"l{li}.kv", li, rows, 2 * nkv * hd, d, bias=cfg.qkv_bias))
    extra = 4.0 if cfg.qk_norm else 2.0  # rope (+qk rmsnorm)
    ops.append(_vec(f"l{li}.rope", li, rows, (nq + nkv) * hd,
                    flop_mult=extra))
    kv_bytes = batch * nkv * eff_ctx * hd * dt
    kv_hbm = phase == "decode"   # decode streams the KV cache from HBM
    ops.append(_bmm_attn(f"l{li}.score", li, rows, nq, eff_ctx, hd,
                         kv_bytes, kv_hbm=kv_hbm, score=True, dt=dt))
    ops.append(_vec(f"l{li}.softmax", li, rows * nq, eff_ctx, flop_mult=6.0))
    ops.append(_bmm_attn(f"l{li}.attnv", li, rows, nq, eff_ctx, hd,
                         kv_bytes, kv_hbm=kv_hbm, score=False, dt=dt))
    ops.append(_mm(f"l{li}.o", li, rows, d, nq * hd))


def _ssm_branch(ops: list[Op], cfg: ModelConfig, li: int, rows: int,
                batch: int, dt: int) -> None:
    """Hymba's parallel mamba branch (in/out proj + selective scan)."""
    d, st = cfg.d_model, cfg.ssm_state
    ops.append(_mm(f"l{li}.ssm_in", li, rows, 2 * d, d))
    # selective scan: state (d x st) per request read+written each step
    state_bytes = batch * d * st * 4  # fp32 state
    n = rows * d
    inputs = (TensorSpec("x", (0,), n * dt, False),
              TensorSpec("state", (0,), state_bytes, True))
    ops.append(Op(f"l{li}.ssm_scan", "vector", li, (rows, d), (),
                  10.0 * n * st, inputs, n * dt))
    ops.append(_mm(f"l{li}.ssm_out", li, rows, d, d))


def _cross_attn(ops: list[Op], cfg: ModelConfig, li: int, rows: int,
                batch: int, enc_ctx: int, dt: int) -> None:
    d, hd, nq = cfg.d_model, cfg.resolved_head_dim, cfg.num_heads
    ops.append(_vec(f"l{li}.ln_x", li, rows, d))
    ops.append(_mm(f"l{li}.xq", li, rows, d, d))
    kv_bytes = batch * enc_ctx * d * dt
    ops.append(_bmm_attn(f"l{li}.xscore", li, rows, nq, enc_ctx, hd,
                         kv_bytes, kv_hbm=True, score=True, dt=dt))
    ops.append(_vec(f"l{li}.xsoftmax", li, rows * nq, enc_ctx, flop_mult=6.0))
    ops.append(_bmm_attn(f"l{li}.xattnv", li, rows, nq, enc_ctx, hd,
                         kv_bytes, kv_hbm=True, score=False, dt=dt))
    ops.append(_mm(f"l{li}.xo", li, rows, d, d))


def _mlp(ops: list[Op], cfg: ModelConfig, li: int, rows: int, dt: int) -> None:
    d = cfg.d_model
    ops.append(_vec(f"l{li}.ln2", li, rows, d))
    if cfg.is_moe_layer(li):
        e, k = cfg.moe_experts, cfg.moe_top_k
        mff = cfg.moe_hidden()
        router_idx = len(ops)
        ops.append(_mm(f"l{li}.router", li, rows, e, d))
        # tokens*topk rows through touched experts; weights = touched experts
        touched = min(e, rows * k)
        nmat = 3 if cfg.gated_mlp else 2
        w_bytes = touched * nmat * d * mff * dt
        m = rows * k
        flops = 2.0 * m * nmat * d * mff
        inputs = (TensorSpec("x", (0, 2), m * d * dt, False),
                  TensorSpec("w_experts", (2, 1), w_bytes, True))
        ops.append(Op(f"l{li}.experts", "matmul", li, (m, mff, d), (2,),
                      flops, inputs, m * d * dt, preload_dep=router_idx))
        if cfg.moe_shared_d_ff:
            sff = cfg.moe_shared_d_ff
            nm = 3 if cfg.gated_mlp else 2
            ops.append(_mm(f"l{li}.shared_up", li, rows, (nm - 1) * sff, d))
            ops.append(_vec(f"l{li}.shared_act", li, rows, sff, flop_mult=4.0))
            ops.append(_mm(f"l{li}.shared_down", li, rows, d, sff))
    else:
        ff = cfg.d_ff
        if cfg.gated_mlp:
            ops.append(_mm(f"l{li}.gate_up", li, rows, 2 * ff, d))
            ops.append(_vec(f"l{li}.act", li, rows, ff, flop_mult=4.0))
            ops.append(_mm(f"l{li}.down", li, rows, d, ff))
        else:
            ops.append(_mm(f"l{li}.fc1", li, rows, ff, d,
                           bias=cfg.qkv_bias))
            ops.append(_vec(f"l{li}.act", li, rows, ff, flop_mult=2.0))
            ops.append(_mm(f"l{li}.fc2", li, rows, d, ff,
                           bias=cfg.qkv_bias))


def _rwkv_layer(ops: list[Op], cfg: ModelConfig, li: int, rows: int,
                dt: int) -> None:
    d, ff = cfg.d_model, cfg.d_ff
    nh = cfg.num_heads
    hd = d // max(nh, 1)
    ops.append(_vec(f"l{li}.ln1", li, rows, d))
    for proj in ("r", "k", "v", "g"):
        ops.append(_mm(f"l{li}.{proj}", li, rows, d, d))
    # wkv recurrence: per-head state hd x hd read+written (fp32)
    state_bytes = rows * nh * hd * hd * 4
    n = rows * d
    inputs = (TensorSpec("rkv", (0,), 3 * n * dt, False),
              TensorSpec("state", (0,), state_bytes, True))
    ops.append(Op(f"l{li}.wkv", "vector", li, (rows, d), (),
                  16.0 * rows * nh * hd * hd, inputs, n * dt))
    ops.append(_mm(f"l{li}.out", li, rows, d, d))
    ops.append(_vec(f"l{li}.ln2", li, rows, d))
    ops.append(_mm(f"l{li}.cm_k", li, rows, ff, d))
    ops.append(_vec(f"l{li}.cm_act", li, rows, ff, flop_mult=2.0))
    ops.append(_mm(f"l{li}.cm_v", li, rows, d, ff))
