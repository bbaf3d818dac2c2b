"""Sharding rules for the (pod, data, model) production mesh.

Counterpart of ``src/repro/distributed/sharding.py``, with the same rules
(``_RULES``, copied) and the same axis roles:

* ``pod``   -- pure data parallelism across pods;
* ``data``  -- within-pod data parallelism, and the ZeRO / FSDP axis;
* ``model`` -- tensor parallelism (attention and MLP dims, the vocabulary),
  expert parallelism for MoE, the KV sequence when heads do not divide.

A spec is a plain tuple with one entry a dimension: an axis name, a tuple
of axis names, or None, as the reference's ``PartitionSpec``.  The rules
read only ``mesh.shape``.  The port runs on one GPU, where every spec is
trivially met; on the production mesh, which the card cannot host, the
specs give the per-device shard of every leaf (``local_shape``,
``local_bytes``): the counterpart of the argument bytes of the reference's
``memory_analysis()``.

The reference's paths run over its stacked layout (``prefix/i/...``,
``blocks/slot/...`` with a leading block dim, a stacked ``encoder/...``);
the port's parameters are a list of layers.  ``reference_path`` maps each
port leaf to its reference leaf as ``convert.params_from_jax`` does, and
``param_specs`` drops the stacked leading dim from the spec.  That dim is
never sharded by any rule.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Optional

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import block_structure

Spec = tuple

# preferred (regex over '/'-joined path) -> spec builder.  ``d`` below means
# "shard this dim over the model axis".  Dims count from the *end* so the
# stacked-blocks leading dim never shifts patterns.
_RULES: list[tuple[str, tuple[Optional[str], ...]]] = [
    # name pattern                      spec for the trailing dims
    (r"embed$",                         ("model", None)),     # (V, d)
    (r"lm_head$",                       (None, "model")),     # (d, V)
    (r"(dec|enc)_pos$",                 (None, None)),
    (r"attn/w_[qkv]$",                  (None, "model")),
    (r"attn/w_o$",                      ("model", None)),
    (r"attn/b_[qkv]$",                  ("model",)),
    (r"xattn/w_[qkv]$",                 (None, "model")),
    (r"xattn/w_o$",                     ("model", None)),
    (r"(mlp|shared_mlp)/w_(gate|up)$",  (None, "model")),
    (r"(mlp|shared_mlp)/w_down$",       ("model", None)),
    (r"(mlp|shared_mlp)/b_up$",         ("model",)),
    (r"(mlp|shared_mlp)/b_down$",       (None,)),
    (r"moe/router$",                    (None, None)),
    (r"moe/w_(gate|up)$",               ("model", None, None)),  # (E,d,ff): EP
    (r"moe/w_down$",                    ("model", None, None)),
    # rwkv time-mix / channel-mix
    (r"w_[rkvg]$",                      (None, "model")),
    (r"w_decay$",                       (None, "model")),
    (r"w_o$",                           ("model", None)),
    (r"w_ck$",                          (None, "model")),
    (r"w_cv$",                          ("model", None)),
    # hymba ssm branch
    (r"ssm/w_in$",                      (None, "model")),
    (r"ssm/w_out$",                     ("model", None)),
    (r"ssm/w_dt$",                      (None, "model")),
    (r"ssm/w_bc$",                      (None, None)),
]


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh, the reference's ``NamedSharding``."""
    mesh: Any
    spec: Spec


def _axis_size(mesh, name: Optional[str]) -> int:
    if name is None:
        return 1
    return mesh.shape[name]


def param_pspec(path: str, shape: tuple[int, ...], mesh,
                fsdp: bool = False, layout: str = "tp") -> Spec:
    """Spec for one parameter at its *reference* path and stacked shape
    (the reference's function, line for line).  Leading stacked-block dims
    are unsharded; ``fsdp`` shards a ``blocks`` leaf's largest unsharded
    trailing dim over data; ``layout='fsdp2d'`` shards a block weight's
    largest dim over the joint (data, model) axes."""
    if layout == "fsdp2d" and path.split("/")[0] in ("blocks", "prefix") \
            and len(shape) >= 2:
        dims = list(shape)
        lead = 1 if path.split("/")[0] == "blocks" else 0
        body = dims[lead:]
        order = sorted(range(len(body)), key=lambda i: -body[i])
        d_sz = _axis_size(mesh, "data")
        m_sz = _axis_size(mesh, "model")
        spec: list = [None] * len(body)
        best = order[0]
        if body[best] % (d_sz * m_sz) == 0:
            spec[best] = ("data", "model")
        else:
            for i in order:
                if body[i] % d_sz == 0:
                    spec[i] = "data"
                    break
            for i in order:
                if spec[i] is None and body[i] % m_sz == 0:
                    spec[i] = "model"
                    break
        return (*([None] * lead), *spec)

    trailing: tuple[Optional[str], ...] = ()
    for pat, spec in _RULES:
        if re.search(pat, path):
            trailing = spec
            break
    # validate divisibility; drop the axis if it doesn't divide
    trailing = tuple(
        (ax if ax and shape[len(shape) - len(trailing) + i]
         % _axis_size(mesh, ax) == 0 else None)
        for i, ax in enumerate(trailing))
    lead_n = len(shape) - len(trailing)
    lead: list[Optional[str]] = [None] * lead_n
    if fsdp and lead_n >= 1 and path.split("/")[0] == "blocks":
        cand = [i for i, ax in enumerate(trailing) if ax is None]
        sizes = shape[lead_n:]
        cand = [i for i in cand
                if sizes[i] % _axis_size(mesh, "data") == 0 and sizes[i] > 1]
        if cand:
            best = max(cand, key=lambda i: sizes[i])
            trailing = tuple("data" if i == best else ax
                             for i, ax in enumerate(trailing))
    return (*lead, *trailing)


def reference_path(path: str, cfg: ModelConfig) -> tuple[str, int]:
    """A port parameter path and the reference path of the same leaf, with
    the size of the reference's stacked leading dim (0: not stacked):
    ``layers/i/...`` is ``prefix/i/...`` for the prefix layers and
    ``blocks/slot/...`` stacked over ``n_blocks`` after them;
    ``encoder/i/...`` is ``encoder/...`` stacked over the encoder layers."""
    parts = path.split("/")
    if parts[0] == "layers":
        prefix, period, n_blocks = block_structure(cfg)
        i = int(parts[1])
        if i < prefix:
            return "/".join(["prefix", str(i)] + parts[2:]), 0
        slot = (i - prefix) % period
        return "/".join(["blocks", str(slot)] + parts[2:]), n_blocks
    if parts[0] == "encoder":
        return "/".join(["encoder"] + parts[2:]), cfg.encoder_layers
    return path, 0


def _map_with_path(fn, tree: Any, prefix: str = "") -> Any:
    """``fn(path, leaf)`` at every leaf of a nested dict / list, the
    structure kept (paths as ``tree.tree_items`` writes them)."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, f"{prefix}/{k}" if prefix else k)
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_with_path(fn, v, f"{prefix}/{i}" if prefix else str(i))
                for i, v in enumerate(tree)]
    return fn(prefix, tree)


def _zip_leaves(tree: Any, specs: Any):
    """(leaf, spec) pairs of a tree and its spec tree, following the
    tree's structure (dicts, lists and tuples such as a step's arguments;
    a spec, itself a tuple, is never descended)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _zip_leaves(v, specs[k])
    elif isinstance(tree, (list, tuple)):
        for v, s in zip(tree, specs):
            yield from _zip_leaves(v, s)
    elif tree is not None:
        yield tree, specs


def param_specs(params: Any, mesh, fsdp: bool = False, layout: str = "tp",
                *, cfg: ModelConfig) -> Any:
    """The spec of every leaf of the port's parameter tree: the reference
    rule at the leaf's reference path, without the stacked leading dim."""
    def one(path, leaf):
        if not isinstance(leaf, torch.Tensor):
            return ()                      # a LayerStream: its own window
        ref, stacked = reference_path(path, cfg)
        shape = ((stacked,) if stacked else ()) + tuple(leaf.shape)
        spec = param_pspec(ref, shape, mesh, fsdp, layout)
        return spec[1:] if stacked else spec
    return _map_with_path(one, params)


def param_shardings(params: Any, mesh, fsdp: bool = False,
                    layout: str = "tp", *, cfg: ModelConfig) -> Any:
    return _map_with_path(
        lambda _, spec: NamedSharding(mesh, spec),
        param_specs(params, mesh, fsdp, layout, cfg=cfg))


# ---------------------------------------------------------------------------
# activations / batches / caches
# ---------------------------------------------------------------------------

def batch_axes(mesh) -> tuple[str, ...]:
    """Mesh axes that jointly shard the global batch."""
    return tuple(ax for ax in ("pod", "data") if ax in mesh.shape)


def batch_pspec(mesh) -> Spec:
    return (batch_axes(mesh),)


def batch_specs(batch: Any, mesh) -> Any:
    """Batch dict specs: dim 0 = global batch on (pod, data)."""
    bp = batch_axes(mesh)
    return _map_with_path(
        lambda _, leaf: (bp, *([None] * (leaf.dim() - 1))), batch)


def batch_shardings(batch: Any, mesh) -> Any:
    return _map_with_path(lambda _, spec: NamedSharding(mesh, spec),
                          batch_specs(batch, mesh))


def cache_pspec(key: str, shape: tuple[int, ...], mesh) -> Spec:
    """Serving cache spec (the reference's).  KV tensors (L, B, Hkv, C,
    hd): batch over (pod, data); heads over model when divisible, otherwise
    the cache length C over model (sequence parallelism)."""
    bp = batch_axes(mesh)
    dp = 1
    for a in bp:
        dp *= mesh.shape[a]
    m = mesh.shape.get("model", 1)

    def b_ax(B):
        return bp if B % max(dp, 1) == 0 else None

    if key in ("k", "v", "k_scale", "v_scale", "cross_k", "cross_v"):
        L, B, H, C, D = shape
        if H % m == 0:
            return (None, b_ax(B), "model", None, None)
        if C % m == 0:
            return (None, b_ax(B), None, "model", None)
        return (None, b_ax(B), None, None, None)
    if key == "rwkv_state":        # (L, B, H, D, D)
        L, B, H, *_ = shape
        h_ax = "model" if H % m == 0 else None
        return (None, b_ax(B), h_ax, None, None)
    if key == "ssm_state":         # (L, B, d, N)
        L, B, d, _ = shape
        d_ax = "model" if d % m == 0 else None
        return (None, b_ax(B), d_ax, None)
    if key == "slot_pos":
        return (None,)
    return ()                      # pos scalar etc.


def cache_specs(cache: dict, mesh) -> dict:
    return {key: cache_pspec(key, tuple(getattr(leaf, "shape", ())), mesh)
            for key, leaf in cache.items()}


def cache_shardings(cache: dict, mesh) -> dict:
    return {key: NamedSharding(mesh, spec)
            for key, spec in cache_specs(cache, mesh).items()}


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, ())


def constrain_batch(x: torch.Tensor, mesh) -> torch.Tensor:
    """The reference constrains a (B, ...) activation's batch dim onto
    (pod, data).  The port runs on a mesh of one device, where every
    placement is already met: the identity."""
    return x


# ---------------------------------------------------------------------------
# per-device shards
# ---------------------------------------------------------------------------

def _axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def local_shape(shape: tuple[int, ...], spec: Spec, mesh) -> tuple[int, ...]:
    """The per-device shard of a leaf of ``shape`` under ``spec``: each dim
    divided by the product of its axes' sizes (rounded up, as a padded
    shard would be; the rules only shard dims that divide)."""
    out = []
    for i, n in enumerate(shape):
        div = 1
        if i < len(spec):
            for a in _axes(spec[i]):
                div *= mesh.shape[a]
        out.append(-(-n // div))
    return tuple(out)


def local_bytes(tree: Any, specs: Any, mesh) -> int:
    """Per-device bytes of a tree of tensors under its spec tree.  A leaf
    that is no tensor counts its ``device_bytes`` (a ``LayerStream``: its
    window and expert buffer on the device) or nothing (a Python int)."""
    total = 0
    for leaf, spec in _zip_leaves(tree, specs):
        if isinstance(leaf, torch.Tensor):
            n = leaf.element_size()
            for s in local_shape(tuple(leaf.shape), spec, mesh):
                n *= s
            total += n
        else:
            total += int(getattr(leaf, "device_bytes", 0))
    return total
