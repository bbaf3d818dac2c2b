"""Operations and bytes that the benchmark's passes need, from their shapes.

This is the yardstick's arithmetic, kept apart from the program: it counts
the work a pass needs, not the launches the port happens to make, so that a
later fusion or kernel swap is read against the same work.  Rules:

* every input byte is read once and every output byte written once (bf16,
  2 bytes an element); a product's least time is the larger of its
  operations over the peak rate and its bytes over the peak bandwidth;
* an MLP is one operation: its input, weights and biases read, its output
  written (the intermediate is the operation's own business);
* attention counts the score and value products over the keys each query
  may see: ``p + 1`` for a causal query at position ``p``, at most the
  window; it reads Q, the live K and V once and writes O;
* serving counts the LM head only where logits are needed: one row on a
  prompt's last chunk and one a live slot on a decode step;
* training under per-layer remat runs each layer's forward twice: the
  roofline counts both (``train_step``), model FLOPs (``train_model_flops``)
  count one forward and a backward of twice its products, 6 x parameters x
  tokens plus attention forward and backward.  The attention backward is
  counted at 2.5 forwards (the score product recomputed, then dV, dP, dQ,
  dK), the products' backward at 2 (dX and dW).

``Work`` adds up per family (``matmul``, ``attention``): FLOPs, bytes and
the least time at the peaks of ``peaks.json``.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

BYTES = 2   # bf16

PEAKS = json.loads((Path(__file__).resolve().parent
                    / "peaks.json").read_text())


@dataclasses.dataclass
class Work:
    """Operations, bytes and least seconds of one family's work."""
    flops: float = 0.0
    bytes: float = 0.0
    min_s: float = 0.0

    def add(self, flops: float, nbytes: float, times: float = 1.0) -> None:
        self.flops += times * flops
        self.bytes += times * nbytes
        self.min_s += times * least_seconds(flops, nbytes)


def least_seconds(flops: float, nbytes: float, peaks: dict = PEAKS) -> float:
    return max(flops / peaks["bf16_flops_per_s"],
               nbytes / peaks["hbm_bytes_per_s"])


def product(m: int, k: int, n: int, bias: bool = False) -> tuple[int, int]:
    """(m, k) @ (k, n) [+ bias (n,)]: (FLOPs, bytes)."""
    return 2 * m * k * n, BYTES * (m * k + k * n + m * n + (n if bias else 0))


def dims(model: dict) -> dict:
    """The sizes the counts need, from a configuration file's ``model``."""
    heads = model["num_heads"]
    hd = model.get("head_dim") or model["d_model"] // heads
    return {"d": model["d_model"], "hq": heads, "hkv": model["num_kv_heads"],
            "hd": hd, "ff": model["d_ff"], "vocab": model["vocab_size"],
            "layers": model["num_layers"],
            "gated": model.get("gated_mlp", True),
            "bias": model.get("qkv_bias", False),
            "window": (model.get("sliding_window", 0)
                       if model.get("swa_layers") == "all" else 0)}


def layer_products(m: dict, rows: int) -> list[tuple[int, int]]:
    """One layer's products over ``rows`` tokens: q, k, v, o and the MLP
    (one operation)."""
    d, hd, ff = m["d"], m["hd"], m["ff"]
    ops = [product(rows, d, m["hq"] * hd, m["bias"]),
           product(rows, d, m["hkv"] * hd, m["bias"]),
           product(rows, d, m["hkv"] * hd, m["bias"]),
           product(rows, m["hq"] * hd, d)]
    n_in = 2 if m["gated"] else 1
    flops = 2 * rows * d * ff * (n_in + 1)
    nbytes = BYTES * (rows * d + (n_in + 1) * d * ff + rows * d)
    if m["bias"] and not m["gated"]:
        nbytes += BYTES * (ff + d)
    ops.append((flops, nbytes))
    return ops


def layer_params(m: dict) -> int:
    """Weights of one layer's products (norms left out)."""
    d, hd = m["d"], m["hd"]
    attn = d * (m["hq"] + 2 * m["hkv"]) * hd + m["hq"] * hd * d
    return attn + (3 if m["gated"] else 2) * d * m["ff"]


def keys_seen(m: dict, position: int) -> int:
    """Keys a query at ``position`` attends to (causal, windowed)."""
    n = position + 1
    return min(n, m["window"]) if m["window"] else n


def keys_seen_sum(m: dict, start: int, count: int) -> int:
    """Sum of ``keys_seen`` over positions start .. start + count - 1."""
    def full(a: int, b: int) -> int:            # sum of p + 1 for p in [a, b)
        return (b * (b + 1) - a * (a + 1)) // 2
    end = start + count
    w = m["window"]
    if not w:
        return full(start, end)
    edge = min(max(w - 1, start), end)          # positions < w - 1 see p + 1
    return full(start, edge) + (end - edge) * w


def attention(m: dict, start: int, count: int, batch: int = 1
              ) -> tuple[int, int]:
    """One layer's causal attention for ``count`` queries at positions
    ``start`` .. of ``batch`` sequences: (FLOPs, bytes)."""
    hq, hkv, hd = m["hq"], m["hkv"], m["hd"]
    flops = 4 * batch * hq * hd * keys_seen_sum(m, start, count)
    live = start + count
    if m["window"]:
        live = min(live, m["window"] + count - 1)
    nbytes = BYTES * batch * hd * (2 * hq * count + 2 * hkv * live)
    return flops, nbytes


def chunk_pass(m: dict, start: int, tokens: int, final: bool
               ) -> dict[str, Work]:
    """A prefill chunk of ``tokens`` prompt tokens from ``start``."""
    mm, at = Work(), Work()
    for _ in range(m["layers"]):
        for f, b in layer_products(m, tokens):
            mm.add(f, b)
        at.add(*attention(m, start, tokens))
    if final:
        mm.add(*product(1, m["d"], m["vocab"]))
    return {"matmul": mm, "attention": at}


def decode_pass(m: dict, positions: list[int]) -> dict[str, Work]:
    """A decode step over the live slots, each feeding one token at its
    position."""
    mm, at = Work(), Work()
    rows = len(positions)
    if not rows:
        return {"matmul": mm, "attention": at}
    for _ in range(m["layers"]):
        for f, b in layer_products(m, rows):
            mm.add(f, b)
        for p in positions:
            at.add(*attention(m, p, 1))
    mm.add(*product(rows, m["d"], m["vocab"]))
    return {"matmul": mm, "attention": at}


def pass_work(m: dict, p: dict) -> dict[str, Work]:
    """The work of one recorded pass (``kind`` "chunk", "decode" or
    "train")."""
    if p["kind"] == "chunk":
        return chunk_pass(m, p["start"], p["tokens"], p["final"])
    if p["kind"] == "decode":
        return decode_pass(m, p["positions"])
    if p["kind"] == "train":
        return train_step(m, p["batch"], p["seq"])
    raise ValueError(f"unknown pass kind {p['kind']!r}")


def train_step(m: dict, batch: int, seq: int) -> dict[str, Work]:
    """One training step under per-layer remat: each layer's forward twice
    (the step and its recompute), the backward at 2 forwards for products
    and 2.5 for attention; the LM head forward once and its backward."""
    rows = batch * seq
    mm, at = Work(), Work()
    for _ in range(m["layers"]):
        for f, b in layer_products(m, rows):
            mm.add(f, b, times=4)
        at.add(*attention(m, 0, seq, batch), times=4.5)
    mm.add(*product(rows, m["d"], m["vocab"]), times=3)
    return {"matmul": mm, "attention": at}


def train_model_flops(m: dict, batch: int, seq: int) -> float:
    """6 x parameters x tokens (the layers' products and the LM head) plus
    attention forward and backward (3 forwards), without the recompute."""
    rows = batch * seq
    params = m["layers"] * layer_params(m) + m["d"] * m["vocab"]
    attn = m["layers"] * attention(m, 0, seq, batch)[0]
    return 6.0 * params * rows + 3.0 * attn
