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


def _map(tree: Any, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(v, fn) for v in tree]
    return fn(tree)


def params_from_jax(tree: dict, cfg: ModelConfig, device="cuda",
                    dtype: Optional[torch.dtype] = None) -> dict:
    """The reference's parameter pytree (numpy leaves) in the port's
    layout: ``params["blocks"][slot]`` is stacked over ``n_blocks`` there
    and comes after ``params["prefix"]``; here every layer is its own
    dictionary in ``params["layers"]``.  ``dtype`` casts every leaf
    (default: as stored)."""
    device = resolve_device(device)
    prefix, period, n_blocks = block_structure(cfg)

    def leaf(a):
        return tensor_from_numpy(a, device, dtype)

    layers = [_map(p, leaf) for p in tree["prefix"]]
    if len(layers) != prefix or len(tree["blocks"]) != period:
        raise ValueError("parameter tree does not match the config's "
                         "block structure")
    for b in range(n_blocks):
        for slot in range(period):
            layers.append(_map(tree["blocks"][slot],
                               lambda a, b=b: leaf(np.asarray(a)[b])))
    out = {k: leaf(v) for k, v in tree.items()
           if k not in ("prefix", "blocks")}
    out["layers"] = layers
    return out


def cache_from_jax(tree: dict, device="cuda") -> dict:
    """The reference's cache (numpy leaves) as a port cache: lock-step
    (``pos`` a scalar, ``slot_pos (C,)``) or per-slot (``pos (B,)``,
    ``slot_pos (B, C)``).  K/V are stacked over layers on both sides."""
    device = resolve_device(device)
    pos = np.asarray(tree["pos"])
    return {
        "pos": (int(pos) if pos.ndim == 0
                else tensor_from_numpy(pos, device, torch.int32)),
        "k": tensor_from_numpy(tree["k"], device),
        "v": tensor_from_numpy(tree["v"], device),
        "slot_pos": tensor_from_numpy(tree["slot_pos"], device, torch.int32),
    }


def cache_to_numpy(cache: dict) -> dict:
    """A port cache as numpy arrays (K/V widened to float32) under the
    reference's keys, for comparison with the reference's cache."""
    pos = cache["pos"]
    return {
        "pos": (pos.cpu().numpy() if isinstance(pos, torch.Tensor)
                else np.int32(pos)),
        "k": cache["k"].to(torch.float32).cpu().numpy(),
        "v": cache["v"].to(torch.float32).cpu().numpy(),
        "slot_pos": cache["slot_pos"].cpu().numpy(),
    }
