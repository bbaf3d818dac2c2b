"""The weights of a cell, drawn from its seed on the device.

One ``torch.randn`` call on a ``torch.Generator`` of the device fills a flat
buffer of the parameter type (bf16) with every parameter; each leaf is a
view of its stretch, scaled in place.  The same seed gives the same bytes
on the same kind of device, so the reference draws the weights again after
the program's run instead of reading anything the program held.  The tree is the port's layout of a
dense decoder (``embed``, ``final_norm``, ``lm_head``, ``layers[i]`` with
``ln1``, ``ln2``, ``attn`` and ``mlp``), which the reference reads too.

Scales: fan-in ** -0.5 for every matrix and the embedding, as the port
initialises them; norm scales (applied as ``1 + scale``) 0.1 and biases
0.05 times a normal draw, so that neither is a no-op in the comparison.
"""

from __future__ import annotations

import torch

NORM_SCALE = 0.1
BIAS_SCALE = 0.05


def leaf_specs(model: dict) -> list[tuple[str, tuple, float]]:
    """(path, shape, scale) of every parameter, in the tree's order."""
    d, v = model["d_model"], model["vocab_size"]
    heads, kv = model["num_heads"], model["num_kv_heads"]
    hd = model.get("head_dim") or d // heads
    ff = model["d_ff"]
    bias = model.get("qkv_bias", False)
    gated = model.get("gated_mlp", True)
    specs = [("embed", (v, d), d ** -0.5),
             ("final_norm", (d,), NORM_SCALE)]
    if not model.get("tie_embeddings", False):
        specs.append(("lm_head", (d, v), d ** -0.5))
    for i in range(model["num_layers"]):
        pre = f"layers/{i}/"
        specs += [(pre + "ln1", (d,), NORM_SCALE),
                  (pre + "ln2", (d,), NORM_SCALE),
                  (pre + "attn/w_q", (d, heads * hd), d ** -0.5),
                  (pre + "attn/w_k", (d, kv * hd), d ** -0.5),
                  (pre + "attn/w_v", (d, kv * hd), d ** -0.5),
                  (pre + "attn/w_o", (heads * hd, d), (heads * hd) ** -0.5)]
        if bias:
            specs += [(pre + "attn/b_q", (heads * hd,), BIAS_SCALE),
                      (pre + "attn/b_k", (kv * hd,), BIAS_SCALE),
                      (pre + "attn/b_v", (kv * hd,), BIAS_SCALE)]
        if gated:
            specs.append((pre + "mlp/w_gate", (d, ff), d ** -0.5))
        specs += [(pre + "mlp/w_up", (d, ff), d ** -0.5),
                  (pre + "mlp/w_down", (ff, d), ff ** -0.5)]
        if bias and not gated:
            specs += [(pre + "mlp/b_up", (ff,), BIAS_SCALE),
                      (pre + "mlp/b_down", (d,), BIAS_SCALE)]
    return specs


def param_count(model: dict) -> int:
    total = 0
    for _, shape, _ in leaf_specs(model):
        n = 1
        for s in shape:
            n *= s
        total += n
    return total


def draw(model: dict, seed: int, device) -> dict:
    """The parameter tree of ``model`` drawn from ``seed`` on ``device`` in
    the configuration's ``param_dtype``: one flat buffer, one draw; each
    leaf a tensor of its own for autograd (``detach`` of a view: the
    storage is shared, the leaf is not a view)."""
    dtype = getattr(torch, model["param_dtype"])
    specs = leaf_specs(model)
    gen = torch.Generator(device=device).manual_seed(seed_u64(seed))
    flat = torch.randn((param_count(model),), generator=gen, device=device,
                       dtype=dtype)
    tree: dict = {}
    off = 0
    for path, shape, scale in specs:
        n = 1
        for s in shape:
            n *= s
        leaf = flat[off:off + n].view(shape).detach()
        leaf.mul_(scale)
        off += n
        _put(tree, path.split("/"), leaf)
    tree["layers"] = [tree["layers"][str(i)]
                      for i in range(model["num_layers"])]
    return tree


def seed_u64(seed: int) -> int:
    """Any whole number as a seed a ``torch.Generator`` takes."""
    return int(seed) & (2 ** 63 - 1)


def _put(tree: dict, keys: list[str], leaf) -> None:
    for k in keys[:-1]:
        tree = tree.setdefault(k, {})
    tree[keys[-1]] = leaf
