"""Carries the reference's parameters and caches over to the port.

``jax.random`` and ``torch.Generator`` give different numbers from one
seed, so parity runs on converted weights: the caller turns the
reference's pytree into numpy arrays (``np.asarray`` on each leaf) and
hands it here.  This module imports neither ``jax`` nor the JAX package;
it sees numpy only.  bfloat16 leaves arrive as ``ml_dtypes`` arrays and
are reinterpreted bit for bit, never rounded; float32 leaves pass as is.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import block_structure, resolve_device
from repro_torch.tree import tree_map


def tensor_from_numpy(a: Any, device, dtype: Optional[torch.dtype] = None
                      ) -> torch.Tensor:
    """One numpy leaf as a tensor on ``device``.  A bfloat16 array
    (``ml_dtypes``, what ``np.asarray`` gives for a bf16 JAX array) keeps
    its bits through a 16-bit integer view; anything else goes through
    ``torch.from_numpy``."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(device=device, dtype=dtype or t.dtype)


def params_from_jax(tree: dict, cfg: ModelConfig, device="cuda",
                    dtype: Optional[torch.dtype] = None) -> dict:
    """The reference's parameter pytree (numpy leaves) in the port's
    layout: ``params["blocks"][slot]`` is stacked over ``n_blocks`` there
    and comes after ``params["prefix"]``; here every layer is its own
    dictionary in ``params["layers"]``.  An enc-dec config's stacked
    ``encoder`` becomes a list of layers the same way; ``enc_norm``,
    ``enc_pos`` and ``dec_pos`` pass as they are.  ``dtype`` casts every
    leaf (default: as stored).  Any tree of the parameters' structure
    converts the same way: gradients (``jax.grad`` of the reference's
    ``loss_fn``) and the optimizer's moments (``opt_state_from_jax``)."""
    device = resolve_device(device)
    prefix, period, n_blocks = block_structure(cfg)

    def leaf(a):
        return tensor_from_numpy(a, device, dtype)

    def unstack(stacked, n):
        return [tree_map(lambda a, i=i: leaf(np.asarray(a)[i]), stacked)
                for i in range(n)]

    layers = [tree_map(leaf, p) for p in tree["prefix"]]
    if len(layers) != prefix or len(tree["blocks"]) != period:
        raise ValueError("parameter tree does not match the config's "
                         "block structure")
    for b in range(n_blocks):
        for slot in range(period):
            layers.append(tree_map(lambda a, b=b: leaf(np.asarray(a)[b]),
                                   tree["blocks"][slot]))
    out = {k: leaf(v) for k, v in tree.items()
           if k not in ("prefix", "blocks", "encoder")}
    out["layers"] = layers
    if "encoder" in tree:
        out["encoder"] = unstack(tree["encoder"], cfg.encoder_layers)
    return out


def opt_state_from_jax(state: dict, cfg: ModelConfig, device="cuda") -> dict:
    """The reference's AdamW state (``step``, ``m``, ``v``; numpy leaves)
    as the port's: the step a Python int, the moments unstacked as
    ``params_from_jax`` unstacks the parameters, in their stored type."""
    return {"step": int(np.asarray(state["step"])),
            "m": params_from_jax(state["m"], cfg, device),
            "v": params_from_jax(state["v"], cfg, device)}


# the reference's cache leaves besides ``pos``, all stacked over layers
# except ``slot_pos``; an int8 ring's scales are bf16
_CACHE_KEYS = ("k", "v", "k_scale", "v_scale", "slot_pos", "rwkv_state",
               "ssm_state", "cross_k", "cross_v")
_SCALE_KEYS = ("k_scale", "v_scale")


def cache_from_jax(tree: dict, device="cuda") -> dict:
    """The reference's cache (numpy leaves) as a port cache: lock-step
    (``pos`` a scalar, ``slot_pos (C,)``) or per-slot (``pos (B,)``,
    ``slot_pos (B, C)``); the leaves it has of K/V (an int8 ring stays int8,
    its ``k_scale``/``v_scale`` come as bf16, from bf16 bit for bit or from
    ``cache_to_numpy``'s float32, which holds them exactly), ``rwkv_state``,
    ``ssm_state`` and ``cross_k``/``cross_v``, each in its own type."""
    device = resolve_device(device)
    pos = np.asarray(tree["pos"])
    out = {"pos": (int(pos) if pos.ndim == 0
                   else tensor_from_numpy(pos, device, torch.int32))}
    for key in _CACHE_KEYS:
        if key in tree:
            out[key] = tensor_from_numpy(
                tree[key], device,
                torch.bfloat16 if key in _SCALE_KEYS else None)
    return out


def cache_to_numpy(cache: dict) -> dict:
    """A port cache as numpy arrays under the reference's keys, for
    comparison with the reference's cache: K/V and cross K/V widened to
    float32 (an int8 ring kept as int8), an int8 ring's scales widened to
    float32 (exactly), tags int32, states as they are (float32)."""
    pos = cache["pos"]
    out = {"pos": (pos.cpu().numpy() if isinstance(pos, torch.Tensor)
                   else np.int32(pos))}
    for key in _CACHE_KEYS:
        if key in cache:
            t = cache[key]
            keep = key == "slot_pos" or t.dtype == torch.int8
            out[key] = (t if keep else t.to(torch.float32)).cpu().numpy()
    return out
