"""Dry-run cells: (arch x shape x mesh) -> the port's step and its inputs.

Counterpart of ``src/repro/launch/specs.py``.  ``params_struct``,
``cache_struct`` and ``input_specs`` give meta tensors (the counterpart of
``jax.eval_shape`` and ``ShapeDtypeStruct``: structure, shapes and types,
nothing allocated).  ``build_cell`` returns the port's own step for one
cell and its inputs, as meta tensors for counting
(``launch/hlo_analysis.count_step``) or drawn on a device from a seed for
measuring, with the spec trees of the inputs on the mesh
(``distributed/sharding.py``):

* ``train_4k``      the training step (``train/step.jit_train_step``:
  microbatched forward and backward, AdamW)
* ``prefill_32k``   ``transformer.prefill`` (the prompt pass filling the cache)
* ``decode_32k``    ``transformer.decode_step`` (one token, a 32k int8 ring),
  or in mode ``elk``, when the weights do not fit (``needs_fsdp``), the
  streamed decode of ``serve/stream.py``
* ``long_500k``     one token at 512k context (sub-quadratic archs only)

The reference's ``unroll`` has no meaning here: PyTorch runs a step eagerly,
layer by layer, and every layer is counted (XLA counts a scan body once).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.chip import h100
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.distributed.sharding import (batch_axes, batch_specs,
                                              cache_specs, param_specs)
from repro_torch.models import transformer as tfm
from repro_torch.models.config import ModelConfig
from repro_torch.models.frontends import frontend_embeddings
from repro_torch.optim import adamw
from repro_torch.serve import stream
from repro_torch.train.step import jit_train_step
from repro_torch.tree import tree_leaves

META = torch.device("meta")


@dataclasses.dataclass(frozen=True)
class ShapeCase:
    name: str
    kind: str          # train | prefill | decode
    seq: int
    batch: int


SHAPES = {
    "train_4k": ShapeCase("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeCase("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeCase("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeCase("long_500k", "decode", 524_288, 1),
}


def eligible(cfg: ModelConfig, shape: str) -> tuple[bool, str]:
    if shape == "long_500k" and not cfg.sub_quadratic:
        return False, ("full attention at 512k context: O(L^2) attention "
                       "and O(L) bf16 KV exceed any replica HBM budget "
                       "(assignment rule: run for SSM/hybrid/SWA only)")
    return True, ""


def all_cells() -> list[tuple[str, str]]:
    return [(a, s) for a in ARCH_IDS for s in SHAPES]


# ---------------------------------------------------------------------------
# meta-tensor builders
# ---------------------------------------------------------------------------

def params_struct(cfg: ModelConfig, decode_positions: int = 0) -> dict:
    return tfm.param_shapes(cfg, decode_positions=decode_positions)


def _frontends(cfg: ModelConfig, b: int) -> dict:
    out = {}
    if cfg.frontend == "vision_stub":
        out["embeds"] = torch.empty((b, cfg.vision_patches, cfg.d_model),
                                    dtype=torch.bfloat16, device=META)
    if cfg.frontend == "audio_stub":
        out["enc_embeds"] = torch.empty((b, cfg.encoder_seq, cfg.d_model),
                                        dtype=torch.bfloat16, device=META)
    return out


def input_specs(cfg: ModelConfig, case: ShapeCase) -> dict:
    """Model-input stand-ins for one shape case (tokens/labels or serving
    tensors), frontend stubs included, as meta tensors."""
    b, s = case.batch, case.seq
    i32 = torch.int32
    if case.kind == "train":
        return {"tokens": torch.empty((b, s), dtype=i32, device=META),
                "labels": torch.empty((b, s), dtype=i32, device=META),
                **_frontends(cfg, b)}
    if case.kind == "prefill":
        return {"tokens": torch.empty((b, s), dtype=i32, device=META),
                **_frontends(cfg, b)}
    return {"token": torch.empty((b,), dtype=i32, device=META)}


def cache_capacity(cfg: ModelConfig, case: ShapeCase) -> int:
    cap = case.seq
    if cfg.sliding_window and cfg.swa_layers == "all":
        cap = min(cap, cfg.sliding_window)
    return cap


def cache_struct(cfg: ModelConfig, case: ShapeCase, kv_dtype,
                 device=META) -> dict:
    return tfm.init_cache(cfg, tfm.CacheSpec(
        capacity=cache_capacity(cfg, case), batch=case.batch,
        kv_dtype=kv_dtype), device=device)


def model_flops(cfg: ModelConfig, case: ShapeCase) -> float:
    """The useful-FLOPs yardstick: 6*N*D train, 2*N_active*D inference."""
    n = cfg.active_param_count() if cfg.moe_experts else cfg.param_count()
    if case.kind == "train":
        return 6.0 * n * case.batch * case.seq
    if case.kind == "prefill":
        return 2.0 * n * case.batch * case.seq
    return 2.0 * n * case.batch          # one token per request


def needs_fsdp(cfg: ModelConfig, mesh, hbm_bytes: float = h100.HBM_BYTES
               ) -> bool:
    """The ELK §4.3 capacity decision (the reference's rule): the weights
    stay resident when their bf16 tensor-parallel shard fits a quarter of
    a device's memory (``hbm_bytes``: the H100's 80 GB here, the TPU's
    16 GiB in the reference); otherwise they are held sharded over data,
    and a decode streams them (on one card: from host memory)."""
    m = mesh.shape.get("model", 1)
    resident = cfg.param_count() * 2 / m
    return resident > 0.25 * hbm_bytes


# ---------------------------------------------------------------------------
# cell builders
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Cell:
    arch: str
    shape: str
    fn: Any                    # the port's step
    args: tuple                # meta tensors, or drawn on a device
    in_specs: tuple            # a spec tree per argument
    meta: dict                 # model_flops, params, notes
    train: bool = False


def _dp(mesh) -> int:
    dp = 1
    for a in batch_axes(mesh):
        dp *= mesh.shape[a]
    return dp


def _token_spec(mesh, batch: int) -> tuple:
    return (batch_axes(mesh),) if batch % max(_dp(mesh), 1) == 0 else ()


def _full_ring(cache: dict, pos: int) -> None:
    """Tag a lock-step ring as holding positions pos - C .. pos - 1 in the
    ring layout (slot p % C), in place, and set the next position: a decode
    step at ``pos`` attends over a full context."""
    cache["pos"] = pos
    if "slot_pos" in cache:
        tags = cache["slot_pos"]
        c = tags.shape[0]
        idx = torch.arange(c, dtype=torch.int32, device=tags.device)
        tags.copy_(pos - c + torch.remainder(idx - (pos - c), c))


def _draw(cfg: ModelConfig, device, seed: int) -> dict:
    gen = torch.Generator(device).manual_seed(seed)
    return tfm.init_params(gen, cfg, device)


def _tokens(shape: tuple, cfg: ModelConfig, device, seed: int
            ) -> torch.Tensor:
    gen = torch.Generator(device).manual_seed(seed)
    return torch.randint(0, cfg.vocab_size, shape, generator=gen,
                         device=device, dtype=torch.int32)


def build_cell(arch: str, shape: str, mesh, *, mode: str = "elk",
               prefetch_depth: int = 2, grad_accum: Optional[int] = None,
               num_layers_override: Optional[int] = None,
               batch_override: Optional[int] = None,
               device=META, seed: int = 0) -> Cell:
    """mode: 'elk' = the framework defaults realising the paper's technique
    (FSDP specs and, for weights that do not fit, streamed decode); 'gspmd'
    = the plain tensor-parallel resident baseline.  The overrides build the
    reduced-depth / reduced-batch variants a card can run; the FSDP /
    streaming decision and the moments' type stay the full model's (the
    reference decides them on the reduced config), so that a variant runs
    the step the full depth runs.  ``device``:
    meta (the default: shapes, nothing allocated) or a device to draw the
    weights (seed ``seed``) and inputs on."""
    cfg = get_config(arch)
    case = SHAPES[shape]
    # the capacity decisions are the full model's, so that a reduced-depth
    # variant runs the step the full depth runs
    fsdp = mode == "elk" and needs_fsdp(cfg, mesh)
    sdt = "bfloat16" if cfg.param_count() > 1e11 else "float32"
    if num_layers_override is not None:
        cfg = dataclasses.replace(cfg, num_layers=num_layers_override)
    if batch_override is not None:
        case = dataclasses.replace(case, batch=batch_override)
    ok, why = eligible(cfg, shape)
    if not ok:
        raise ValueError(f"cell ({arch},{shape}) ineligible: {why}")
    device = torch.device(device)
    meta_dev = device.type == "meta"
    dp = _dp(mesh)
    meta = {"model_flops": model_flops(cfg, case),
            "params": cfg.param_count(),
            "active_params": cfg.active_param_count(),
            "mode": mode, "dp": dp, "layers": cfg.num_layers,
            "batch": case.batch}
    meta["fsdp"] = fsdp

    if case.kind == "train":
        # default microbatch: 8 sequences per data shard
        ga = grad_accum or max(1, case.batch // (dp * 8))
        meta["grad_accum"] = ga
        ocfg = adamw.AdamWConfig(state_dtype=sdt)
        meta["opt_state_dtype"] = sdt
        layout = "fsdp2d" if (mode == "elk" and not cfg.moe_experts) \
            else "tp"
        meta["layout"] = layout
        batch = input_specs(cfg, case)
        params = params_struct(cfg) if meta_dev else _draw(cfg, device, seed)
        if not meta_dev:
            batch = {"tokens": _tokens((case.batch, case.seq), cfg, device,
                                       seed + 1),
                     "labels": _tokens((case.batch, case.seq), cfg, device,
                                       seed + 2),
                     **frontend_embeddings(cfg, case.batch, seed, device)}
        for t in tree_leaves(params):
            t.requires_grad_(True)
        step, specs = jit_train_step(cfg, mesh, ocfg, params, batch,
                                     grad_accum=ga, compression="none",
                                     fsdp=fsdp, layout=layout)
        opt = adamw.init_state(params, ocfg)
        return Cell(arch, shape, step, (params, opt, batch, None),
                    (specs["params"], specs["opt"], specs["batch"], None),
                    meta, train=True)

    kv_dtype = torch.int8 if shape == "decode_32k" and not cfg.rwkv \
        else torch.bfloat16
    meta["kv_dtype"] = str(kv_dtype).replace("torch.", "")
    dec_pos = case.seq + 8 if cfg.encoder_layers else 0
    shapes = params_struct(cfg, decode_positions=dec_pos)
    p_specs = param_specs(shapes, mesh, fsdp=fsdp, cfg=cfg)
    cache = cache_struct(cfg, case, kv_dtype, device)
    c_specs = cache_specs(cache, mesh)

    if case.kind == "prefill":
        ins = input_specs(cfg, case)
        if not meta_dev:
            ins = {"tokens": _tokens((case.batch, case.seq), cfg, device,
                                     seed + 1),
                   **frontend_embeddings(cfg, case.batch, seed, device)}
        params = shapes if meta_dev else _draw(cfg, device, seed)
        b_specs = batch_specs(ins, mesh)

        def prefill_fn(params, tokens, cache, embeds=None, enc_embeds=None):
            return tfm.prefill(params, cfg, tokens, cache, embeds=embeds,
                               enc_embeds=enc_embeds)

        args = (params, ins["tokens"], cache, ins.get("embeds"),
                ins.get("enc_embeds"))
        return Cell(arch, shape, prefill_fn, args,
                    (p_specs, b_specs["tokens"], c_specs,
                     b_specs.get("embeds"), b_specs.get("enc_embeds")), meta)

    # decode / long-context decode over a full ring; streaming only pays
    # off for weights too large to stay resident (the same ELK decision)
    _full_ring(cache, case.seq - 1)
    streamed = mode == "elk" and fsdp and stream.streams(cfg, "elk_stream")
    meta["streamed"] = streamed
    if streamed:
        meta["prefetch_depth"] = prefetch_depth
        if meta_dev:
            params = dict(shapes)
            params["layers"] = stream.LayerStream(shapes["layers"], META,
                                                  prefetch_depth)
        else:
            params = stream.init_streamed_params(
                torch.Generator(device).manual_seed(seed), cfg, device,
                prefetch_depth)
        # a decode step's experts: at most the rows' picks, at most E
        params["layers"].reserve_experts(
            min(cfg.moe_experts, case.batch * cfg.moe_top_k))
        p_specs = {**p_specs, "layers": ()}

        def decode_fn(params, token, cache):
            return stream.streaming_decode_step(params, cfg, token, cache,
                                                prefetch=prefetch_depth)
    else:
        params = shapes if meta_dev else _draw(cfg, device, seed)

        def decode_fn(params, token, cache):
            return tfm.decode_step(params, cfg, token, cache)

    token = (input_specs(cfg, case)["token"] if meta_dev
             else _tokens((case.batch,), cfg, device, seed + 1))
    return Cell(arch, shape, decode_fn, (params, token, cache),
                (p_specs, _token_spec(mesh, case.batch), c_specs), meta)

