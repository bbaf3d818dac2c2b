"""Mixture-of-experts FFN of the port (llama4-maverick, kimi-k2).

Counterpart of ``src/repro/models/moe.py``: top-k routing with
softmax-renormalised gates, capacity-factor dropping (an assignment past
its expert's capacity gets a combine weight of zero), ``dropless`` at
decode and on the slot path.  The slot of an assignment is its rank among
the assignments to the same expert, in (token, k) order, as the
reference's cumulative sum over the one-hot dispatch gives it.

What differs from the reference, by design:

* The reference scatters every token into an (E, C, d) buffer and runs
  the expert products as einsums over all of it, a fixed compute shape for
  XLA.  Here only the assignments that were kept are gathered, grouped by
  expert in slot order, and each expert with rows runs its three products
  on those rows (``torch.matmul``, as the reference leaves them to XLA
  outside any Pallas kernel).  The outputs are the reference's: a row's
  products do not depend on the other rows of its expert, and a dropped
  or empty slot contributes zeros on both sides.  At decode (dropless,
  C = T k) the reference's buffer would be mostly zeros; a chunk of 256
  tokens of kimi-k2 would make it 11 GB.
* The router is ``layers.linear``, so on the card it runs on the
  ``elk_matmul`` kernel, like every projection of the port.
* Ties in the router: ``lax.top_k`` gives the lower expert index first,
  ``torch.topk`` promises no order among equal values; a stable
  descending sort does what ``lax.top_k`` does.
* No ``mesh`` argument: one GPU, so no expert-parallel placement.
* Grouping the rows reads their count per expert back to the host once a
  layer (the number of products to run).  Right after that read-back the
  experts with rows are known, and ``moe_ffn`` asks the layer's experts
  for exactly those: ``p["experts"]``, where the layer streams
  (``serve/stream.LayerExperts``, which fetches them into the device's
  expert buffer, the paper's §7 late-bound preload), or
  ``ResidentExperts`` over ``p``'s own (E, ...) tensors.
* On the meta device (the dry run's count) there are no counts to read
  back: every expert runs at capacity, on C rows gathered from the tokens
  (``_at_capacity``), which is what the reference's static (E, C, d)
  shapes make XLA count; a streamed layer fetches all its experts.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.fused_mlp.ref import act_fn
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import linear


def capacity(tokens: int, experts: int, top_k: int, factor: float) -> int:
    cap = int(tokens * top_k * factor / experts) + 1
    # never below top_k (tiny smoke shapes must route) and never beyond
    # tokens*top_k (the dropless bound — more slots can't be used)
    return min(max(cap, top_k), tokens * top_k)


def router_weights(logits: torch.Tensor, top_k: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k routing with softmax-renormalized gates.

    logits: (T, E) -> gates (T, k) fp32, idx (T, k) int32.  Equal logits
    go to the lower expert index first, as ``lax.top_k`` orders them."""
    lf = logits.to(torch.float32)
    vals, idx = torch.sort(lf, dim=-1, descending=True, stable=True)
    gates = torch.softmax(vals[..., :top_k], dim=-1)
    return gates, idx[..., :top_k].to(torch.int32)


def expert_slots(flat_e: torch.Tensor, experts: int
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """For the (T k,) expert ids of the assignments in (token, k) order:
    ``order``, the assignments grouped by expert and in that order within
    an expert; ``slot``, each grouped assignment's rank in its expert;
    ``counts``, the assignments of every expert."""
    flat_e = flat_e.long()
    order = torch.sort(flat_e, stable=True).indices
    counts = torch.bincount(flat_e, minlength=experts)
    starts = torch.cumsum(counts, 0) - counts
    slot = torch.arange(flat_e.numel(), device=flat_e.device) - starts[
        flat_e[order]]
    return order, slot, counts


class ResidentExperts:
    """The experts of a layer whose (E, d, ff) / (E, ff, d) tensors lie in
    ``p``: one round of every expert asked for, expert ``e``'s weights the
    ``e``-th slices."""

    def __init__(self, p: dict):
        self.p = p

    def rounds(self, experts: list[int]):
        yield experts

    def weights(self, e: int) -> dict:
        return {k: self.p[k][e] for k in ("w_gate", "w_up", "w_down")
                if k in self.p}


def _expert(x: torch.Tensor, w: dict, cfg: ModelConfig) -> torch.Tensor:
    """An expert's FFN (weights ``w``) on its rows, in the products' type."""
    act = act_fn(cfg.mlp_act)
    if cfg.gated_mlp:
        h = act(torch.matmul(x, w["w_gate"])) * torch.matmul(x, w["w_up"])
    else:
        h = act(torch.matmul(x, w["w_up"]))
    return torch.matmul(h, w["w_down"])


def moe_ffn(x: torch.Tensor, p: dict, cfg: ModelConfig,
            capacity_factor: float | None = None,
            dropless: bool = False) -> torch.Tensor:
    """x: (T, d) token-major.  p: router (d,E), and w_gate/w_up (E,d,ff),
    w_down (E,ff,d) or ``experts``, the accessor of a streamed layer's.
    ``dropless`` sizes capacity so no assignment is ever dropped (decode and
    the slot path: C = T k)."""
    t, d = x.shape
    e, k = cfg.moe_experts, cfg.moe_top_k
    cf = capacity_factor or cfg.moe_capacity_factor
    c = t * k if dropless else capacity(t, e, k, cf)

    if x.device.type == "meta":
        return _at_capacity(x, p, cfg, c)
    logits = linear(x, p["router"])                          # (T, E)
    gates, idx = router_weights(logits, k)                   # (T, k)
    order, slot, counts = expert_slots(idx.reshape(t * k), e)
    order = order[slot < c]            # an assignment past capacity drops
    rows_of = torch.clamp(counts, max=c).tolist()
    experts = p["experts"] if "experts" in p else ResidentExperts(p)
    xs = x[order // k]                 # the kept rows, grouped by expert
    outs, off = [], 0
    for group in experts.rounds([ex for ex, n in enumerate(rows_of) if n]):
        for ex in group:
            n = rows_of[ex]
            outs.append(_expert(xs[off:off + n], experts.weights(ex), cfg))
            off += n
    rows = x.new_zeros((t * k, d))
    rows[order] = torch.cat(outs)
    out = torch.einsum("tk,tkd->td", gates,
                       rows.reshape(t, k, d).to(torch.float32))
    return out.to(x.dtype)


def moe_params(init, cfg: ModelConfig) -> dict:
    """The reference's ``moe_params`` drawn by ``init.normal(shape,
    scale)`` (``transformer._Init``): router (d, E) and the experts'
    w_gate / w_up (E, d, ff) and w_down (E, ff, d)."""
    d, e = cfg.d_model, cfg.moe_experts
    ff = cfg.moe_hidden()
    s_in, s_ff = d ** -0.5, ff ** -0.5
    p = {"router": init.normal((d, e), s_in)}
    if cfg.gated_mlp:
        p["w_gate"] = init.normal((e, d, ff), s_in)
    p["w_up"] = init.normal((e, d, ff), s_in)
    p["w_down"] = init.normal((e, ff, d), s_ff)
    return p


def aux_load_balance_loss(logits: torch.Tensor, idx: torch.Tensor,
                          num_experts: int) -> torch.Tensor:
    """Switch-style load-balance auxiliary loss (mean_prob . mean_assign . E)."""
    probs = torch.softmax(logits.to(torch.float32), dim=-1)      # (T, E)
    assign = torch.nn.functional.one_hot(
        idx[..., 0].long(), num_experts).to(torch.float32)
    return num_experts * torch.mean(probs.mean(0) * assign.mean(0))


def _at_capacity(x: torch.Tensor, p: dict, cfg: ModelConfig,
                 c: int) -> torch.Tensor:
    """``moe_ffn`` on meta tensors: the router, then every expert on ``c``
    gathered rows, (E, C, ·) products, and the combine of the first T k
    rows; shapes and work only (no data on the meta device)."""
    t, d = x.shape
    e, k = cfg.moe_experts, cfg.moe_top_k
    gates, _ = router_weights(linear(x, p["router"]), k)
    if "experts" in p:                   # streamed: fetch them all
        acc = p["experts"]
        one = None
        for group in acc.rounds(list(range(e))):
            one = one or acc.weights(group[0])
        w = {n: v.new_empty((e, *v.shape)) for n, v in one.items()}
    else:
        w = {n: p[n] for n in ("w_gate", "w_up", "w_down") if n in p}
    rows = torch.empty((e * c,), dtype=torch.long, device=x.device)
    y = _expert(x[rows].reshape(e, c, d), w, cfg)            # (E, C, d)
    y = y.reshape(e * c, d)[:t * k].reshape(t, k, d)
    out = torch.einsum("tk,tkd->td", gates, y.to(torch.float32))
    return out.to(x.dtype)
