"""Dry run of every (arch x shape x mesh) cell: counted on the meta device,
measured on the card.

Counterpart of ``src/repro/launch/dryrun.py``.  The reference lowers and
compiles every cell under the production mesh on 512 placeholder host
devices (its ``XLA_FLAGS`` device forcing, which has no PyTorch
counterpart) and records ``memory_analysis()``, ``cost_analysis()`` and the
parsed collectives.  Here, for each cell:

1. **count** (``run_cell``): the cell's step (``launch/specs.build_cell``)
   at full depth and the cell's own batch runs once on meta tensors under
   ``hlo_analysis.count_step``; no card is needed.  Per-device figures on
   the ``single``/``multi`` meshes are the global counts divided by the
   mesh's devices (an even split, as the reference's ``roofline_fraction``
   reads them), the argument bytes ``sharding.local_bytes`` of the
   arguments under their specs.  The WKV and SSM recurrences do not run on
   meta (``layers.stand_in``): their work is the reference's analytic
   ``_recurrence_correction`` from the port's ``core/graph`` copy.  MoE
   layers count every expert at capacity (``models/moe._at_capacity``).
2. **measure** (``run_cell_accounting``, unless ``--count-only``): the step
   runs on the card at the reference's two reduced depths (prefix + 1 and
   prefix + 3 periods, ``transformer.block_structure``), timed by CUDA
   events with its peak memory, and both extrapolate linearly in blocks
   to full depth, as the reference's accounting does.  A variant that
   would not fit 80 GB runs at a smaller batch (a training step: one
   microbatch, and the optimizer timed apart) and the record's
   ``reduced`` lists every such cut and how the time was scaled back.

Records (the reference's keys, ``fits_80gb`` for ``fits_16gb``) go to
``experiments/dryrun_torch/`` (listed in ``.gitignore``); the reference's
``experiments/dryrun/`` is never written.  Resumable: a cell with a record
is read back unless ``--force``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \\
      --count-only --device cpu
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3_14b \\
      --shape decode_32k --mesh single
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import Optional

import torch

from repro_torch.chip import h100
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.distributed.sharding import local_bytes
from repro_torch.launch.hlo_analysis import (COLLECTIVES_NOTE, combine,
                                             count_step, memory_summary,
                                             roofline)
from repro_torch.launch.mesh import (Mesh, make_production_mesh,
                                     mesh_num_devices)
from repro_torch.launch.specs import (SHAPES, build_cell, eligible,
                                      model_flops)
from repro_torch.models import transformer as tfm
from repro_torch.optim import adamw
from repro_torch.train.step import make_loss_fn, value_and_grad
from repro_torch.tree import tree_items, tree_leaves

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")
CARD_BUDGET = 0.75 * h100.HBM_BYTES   # a measured variant's estimated peak

NOTE = ("counted on the meta device: the port's kernels as their own work "
        "(kernels/cost.py), PyTorch's operations by their operands; WKV/SSM "
        "recurrences from the reference's analytic count; MoE experts at "
        "capacity; a training step of several microbatches counted as one "
        "times grad_accum; per-device FLOPs and bytes an even split of the "
        "global count; " + COLLECTIVES_NOTE)


def cell_path(arch: str, shape: str, mesh_name: str, mode: str,
              out_dir: str = OUT_DIR) -> str:
    tag = f"{arch}__{shape}__{mesh_name}" + ("" if mode == "elk"
                                             else f"__{mode}")
    return os.path.join(out_dir, tag + ".json")


def make_mesh(mesh_name: str) -> Mesh:
    """``single`` / ``multi``: the production meshes (abstract); ``local``:
    the (1, 1) mesh of the one card."""
    if mesh_name == "local":
        return Mesh(("data", "model"), (1, 1))
    return make_production_mesh(multi_pod=mesh_name == "multi")


def _plan_prefetch_depth(cfg, shape: str) -> int:
    """Prefetch depth from the ELK scheduler (the port's ``pod_plan``
    copy, its defaults as the reference's): repeat cells for the same
    arch/shape reuse one plan."""
    from repro_torch.core.integration import pod_plan
    case = SHAPES[shape]
    knobs = pod_plan(cfg, batch=case.batch, seq=case.seq, phase="decode")
    return max(knobs.prefetch_depth, 1)


def _recurrence_correction(cfg, batch: int, seq: int, phase: str,
                           train_mult: float = 4.0) -> tuple[float, float]:
    """Analytic FLOPs/bytes of the time recurrences (WKV / SSM scans), the
    reference's: on the meta device they run no step.  Returns (flops,
    bytes) to add; train multiplies by ~4 (fwd + remat-recompute + bwd)."""
    if not (cfg.rwkv or cfg.hybrid_parallel_ssm):
        return 0.0, 0.0
    from repro_torch.core.graph import build_graph
    g = build_graph(cfg, batch=batch, seq=seq,
                    phase="train_fwd" if phase == "train" else phase)
    fl = by = 0.0
    for op in g.ops:
        if op.name.endswith(".wkv") or op.name.endswith(".ssm_scan"):
            fl += op.flops
            by += op.hbm_bytes + op.act_bytes + op.out_bytes
    mult = train_mult if phase == "train" else 1.0
    return fl * mult, by * mult


def _score_bytes(cfg, case) -> float:
    """Analytic HBM bytes of materialized attention score/softmax tensors
    (the reference's): fp32 scores, one write + one read each for scores
    and probs; x4 for train.  The port's count is the flash kernel's, which
    keeps them on chip: ``roofline`` adds them, ``roofline_flash`` not."""
    from repro_torch.core.graph import build_graph
    g = build_graph(cfg, batch=case.batch, seq=case.seq,
                    phase="train_fwd" if case.kind == "train"
                    else case.kind)
    total = 0.0
    for op in g.ops:
        nm = op.name.rsplit(".", 1)[-1]
        if nm in ("score", "softmax", "xscore", "xsoftmax"):
            total += op.out_bytes * 2 * 2.0      # fp32, write+read
    return total * (4.0 if case.kind == "train" else 1.0)


def explained_flops(cfg, case) -> float:
    """The product FLOPs a count of a dense cell's step should show, from
    ``model_flops``' rule (2 N T, 6 N T in training) over the parameters
    ``init_params`` draws (``param_count`` misses some of RWKV's, the
    SSM's and whisper's): without the embedding (a lookup: no product),
    the LM head over the last token only at prefill, and in training the
    forward that remat runs again (2 N_layers T) and the MLP backward
    kernel's recompute of its up (and gate) products."""
    leaves = list(tree_items(tfm.param_shapes(cfg)))
    n = sum(t.numel() for _, t in leaves)
    vd = cfg.vocab_size * cfg.d_model
    head = 0 if cfg.tie_embeddings else vd
    layers = n - vd - head
    tokens = case.batch * (case.seq if case.kind != "decode" else 1)
    if case.kind == "train":
        ups = sum(t.numel() for path, t in leaves
                  if path.endswith(("mlp/w_up", "mlp/w_gate")))
        return (8.0 * layers + 2.0 * ups + 6.0 * vd) * tokens
    heads = case.batch if case.kind == "prefill" else tokens
    return 2.0 * layers * tokens + 2.0 * vd * heads


def count_cell(arch: str, shape: str, mesh, *, mode: str = "elk",
               prefetch_depth: int = 2, **overrides) -> tuple:
    """(cell, its count) of one cell on the meta device.  A training step
    of ``ga`` > 1 microbatches runs ``ga`` identical forward and backward
    passes: one microbatch's step is counted, and its update alone, and
    the step is ``ga`` x the first less ``ga - 1`` updates, plus the
    accumulation's adds (an fp32 or bf16 buffer a parameter, read and
    written, and the gradient read, ``ga - 1`` times)."""
    cell = build_cell(arch, shape, mesh, mode=mode,
                      prefetch_depth=prefetch_depth, **overrides)
    ga = cell.meta.get("grad_accum", 1)
    if ga == 1:
        return cell, count_step(cell.fn, cell.args, train=cell.train)
    kw = {**overrides, "grad_accum": 1,
          "batch_override": cell.meta["batch"] // ga}
    one = build_cell(arch, shape, mesh, mode=mode,
                     prefetch_depth=prefetch_depth, **kw)
    micro = count_step(one.fn, one.args, train=True)
    params, opt = one.args[:2]
    ocfg = adamw.AdamWConfig(state_dtype=cell.meta["opt_state_dtype"])
    update = count_step(adamw.apply_update, (params, params, opt, ocfg),
                        train=True)
    count = combine([(ga, micro), (1 - ga, update)])
    acc = 2 if cell.meta["params"] > 1e11 else 4     # train/step's rule
    count.bytes += (ga - 1) * cell.meta["params"] * (2 * acc + 2)
    return cell, count


def _rooflines(cfg, case, count, n_chips: int) -> tuple:
    cf, cb = _recurrence_correction(cfg, case.batch, case.seq, case.kind)
    flops = (count.flops + cf) / n_chips
    byts = (count.bytes + cb) / n_chips
    saved = _score_bytes(cfg, case) / n_chips
    mf = model_flops(cfg, case)
    return (roofline(flops, byts + saved, mf, n_chips),
            roofline(flops, byts, mf, n_chips),
            {"flops": cf, "bytes": cb}, saved)


def run_cell(arch: str, shape: str, mesh_name: str, *, mode: str = "elk",
             prefetch_depth: int = 2, force: bool = False,
             extra_tag: str = "", out_dir: str = OUT_DIR) -> dict:
    """Count one cell on the meta device and write its record.
    ``prefetch_depth=0`` asks the ELK scheduler."""
    os.makedirs(out_dir, exist_ok=True)
    path = cell_path(arch, shape, mesh_name, mode, out_dir)
    if extra_tag:
        path = path.replace(".json", f"__{extra_tag}.json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)

    cfg = get_config(arch)
    case = SHAPES[shape]
    ok, why = eligible(cfg, shape)
    rec = {"arch": arch, "shape": shape, "mesh": mesh_name, "mode": mode}
    if not ok:
        rec.update(status="skipped", reason=why)
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        return rec
    if prefetch_depth <= 0:
        prefetch_depth = _plan_prefetch_depth(cfg, shape)

    mesh = make_mesh(mesh_name)
    n_chips = mesh_num_devices(mesh)
    t0 = time.perf_counter()
    try:
        cell, count = count_cell(arch, shape, mesh, mode=mode,
                                 prefetch_depth=prefetch_depth)
        rf, rf_flash, corr, saved = _rooflines(cfg, case, count, n_chips)
        mem = memory_summary(local_bytes(cell.args, cell.in_specs, mesh))
        rec.update(
            status="ok", count_s=time.perf_counter() - t0, memory=mem,
            fits_80gb=mem["total_hbm_bytes"] <= h100.HBM_BYTES,
            roofline=rf.to_dict(), roofline_flash=rf_flash.to_dict(),
            collectives=None, count=count.to_dict(),
            recurrence_correction=corr, flash_saved_bytes=saved,
            grad_accum=cell.meta.get("grad_accum"), meta=cell.meta,
            note=NOTE)
        print(f"[ok] {arch:28s} {shape:12s} {mesh_name:6s} "
              f"count={rec['count_s']:5.1f}s "
              f"args/dev={mem['total_hbm_bytes'] / 2**30:8.2f}GiB "
              f"dom={rf_flash.dominant:8s} "
              f"bound={rf_flash.bound_s * 1e3:10.3f}ms "
              f"roofline={rf_flash.roofline_fraction:6.1%}")
    except Exception as e:  # noqa: BLE001 -- record the failure, keep sweeping
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-4000:])
        print(f"[ERR] {arch} {shape} {mesh_name}: {type(e).__name__}: {e}")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


# ---------------------------------------------------------------------------
# measuring on the card
# ---------------------------------------------------------------------------

def _estimate_peak(cfg, case, arg_bytes: int, layers: int) -> float:
    """A rough peak of a variant, to choose a batch that fits: its
    arguments, and beyond them the gradients and the logits (fp32 and their
    gradient) of a training microbatch, the MLP intermediate and a few
    activations of a prefill, the logits of a decode step."""
    tokens = case.batch * (case.seq if case.kind != "decode" else 1)
    d, ff = cfg.d_model, max(cfg.d_ff, cfg.moe_shared_d_ff or 0)
    if case.kind == "train":
        grads = arg_bytes / 6                      # bf16 of 12 bytes a param
        return (arg_bytes + grads + tokens * cfg.vocab_size * 12
                + tokens * d * 2 * layers + tokens * (16 * d + 6 * ff) * 2)
    if case.kind == "prefill":
        return arg_bytes + tokens * (2 * ff * 2 + 24 * d * 2)
    return arg_bytes + tokens * cfg.vocab_size * 4


def _card_batch(arch: str, shape: str, mesh, mode: str, nl: int,
                batch: int, prefetch_depth: int, ga: int = 1) -> int:
    """The largest batch (halving from ``batch``) whose variant of ``nl``
    layers the estimate fits in ``CARD_BUDGET``."""
    cfg = dataclasses.replace(get_config(arch), num_layers=nl)
    while batch > 1:
        cell = build_cell(arch, shape, mesh, mode=mode,
                          prefetch_depth=prefetch_depth,
                          num_layers_override=nl, batch_override=batch,
                          grad_accum=ga)
        case = dataclasses.replace(SHAPES[shape], batch=batch)
        args = local_bytes(cell.args, cell.in_specs, mesh)
        if _estimate_peak(cfg, case, args, nl) <= CARD_BUDGET:
            break
        batch //= 2
    return batch


def _time_ms(fn, device: torch.device, iters: int) -> float:
    """Mean ms of ``fn()`` over ``iters`` calls after one warm-up call: CUDA
    events on a card, the host clock elsewhere."""
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(iters):
            fn()
        t1.record()
        torch.cuda.synchronize(device)
        return t0.elapsed_time(t1) / iters
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t) * 1e3 / iters


def measure_variant(arch: str, shape: str, *, nl: int, batch: int,
                    mode: str, prefetch_depth: int, device,
                    iters: int = 2) -> dict:
    """One reduced variant on ``device``: the cell's step at ``nl`` layers
    and ``batch`` (a training step: one microbatch, grad_accum 1), its
    arguments drawn from seed 0; the argument bytes on the device (the
    allocator's) beside ``local_bytes`` of the same tree on the (1, 1)
    mesh, the step's ms and peak bytes, a training step's forward and
    backward alone, and the count of the same variant on meta."""
    device = torch.device(device)
    mesh = make_mesh("local")
    kw = dict(mode=mode, prefetch_depth=prefetch_depth,
              num_layers_override=nl, batch_override=batch)
    train = SHAPES[shape].kind == "train"
    if train:
        kw["grad_accum"] = 1
    _, count = count_cell(arch, shape, mesh, **kw)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated(device)
    cell = build_cell(arch, shape, mesh, device=device, **kw)
    out = {"layers": nl, "batch": batch,
           "arg_bytes_local": local_bytes(cell.args, cell.in_specs, mesh),
           "arg_tensors": _tensor_count(cell.args),
           "count": {"flops": count.flops, "bytes": count.bytes,
                     "host_bytes": count.host_bytes,
                     "attention_flops": count.attention_flops()}}
    cfg = get_config(arch)
    rf = roofline(count.flops, count.bytes, 0.0, 1)
    out["bound_ms"] = rf.bound_s * 1e3
    out["dominant"] = rf.dominant
    if cuda:
        torch.cuda.synchronize(device)
        out["arg_bytes_card"] = torch.cuda.memory_allocated(device) - base
        torch.cuda.reset_peak_memory_stats(device)
    grad = torch.enable_grad() if train else torch.inference_mode()
    with grad:
        out["ms"] = _time_ms(lambda: cell.fn(*cell.args), device, iters)
        if cuda:
            out["peak_bytes"] = torch.cuda.max_memory_allocated(device) - base
        if train:
            lf = make_loss_fn(dataclasses.replace(cfg, num_layers=nl))
            out["fwd_bwd_ms"] = _time_ms(
                lambda: value_and_grad(lf, cell.args[0], cell.args[2]),
                device, iters)
    del cell
    if cuda:
        torch.cuda.empty_cache()
    return out


def _tensor_count(tree) -> int:
    return sum(isinstance(t, torch.Tensor) for t in tree_leaves(tree))


def _extrapolate(vs: list[dict], key: str, n_blocks_full: int) -> float:
    if len(vs) == 1 or vs[0]["n_blocks"] == vs[-1]["n_blocks"]:
        return vs[-1][key]
    a, b = vs[0], vs[-1]
    slope = (b[key] - a[key]) / (b["n_blocks"] - a["n_blocks"])
    return max(b[key] + slope * (n_blocks_full - b["n_blocks"]), 0.0)


def run_cell_accounting(arch: str, shape: str, mesh_name: str = "local", *,
                        mode: str = "elk", prefetch_depth: int = 2,
                        force: bool = False, device="cuda",
                        out_dir: str = OUT_DIR, iters: int = 2) -> dict:
    """Measure one cell on ``device`` (the card): the two reduced-depth
    variants, extrapolated linearly in blocks to full depth, the batch cut
    where a variant would not fit and the time scaled back to the cell's
    batch; the record's ``roofline_fraction`` is ``model_flops`` over the
    peak times that time, its ``reduced`` the cuts.  The mesh is the one
    card's (1, 1): ``mesh_name`` only names the record."""
    device = tfm.resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    path = cell_path(arch, shape, mesh_name, mode, out_dir).replace(
        ".json", "__acct.json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)
    cfg = get_config(arch)
    case = SHAPES[shape]
    ok, why = eligible(cfg, shape)
    rec = {"arch": arch, "shape": shape, "mesh": mesh_name, "mode": mode,
           "kind": "accounting", "device": (torch.cuda.get_device_name(device)
                                            if device.type == "cuda"
                                            else str(device))}
    if not ok:
        rec.update(status="skipped", reason=why)
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        return rec
    if prefetch_depth <= 0:
        prefetch_depth = _plan_prefetch_depth(cfg, shape)
    mesh = make_mesh("local")
    prefix, period, n_blocks_full = tfm.block_structure(cfg)
    train = case.kind == "train"
    t0 = time.perf_counter()
    try:
        full, count = count_cell(arch, shape, mesh, mode=mode,
                                 prefetch_depth=prefetch_depth)
        ga = full.meta.get("grad_accum", 1)
        micro = case.batch // ga
        reduced = []
        variants = []
        depths = sorted({min(1, n_blocks_full), min(3, n_blocks_full)})
        # one batch for both depths: the one the deeper variant fits
        b = _card_batch(arch, shape, mesh, mode, prefix + depths[-1] * period,
                        micro, prefetch_depth, ga=1 if train else None)
        for nb in depths:
            nl = prefix + nb * period
            v = measure_variant(arch, shape, nl=nl, batch=b, mode=mode,
                                prefetch_depth=prefetch_depth,
                                device=device, iters=iters)
            v["n_blocks"] = nb
            if train:     # the step at ga microbatches of the cell's size
                opt = v["ms"] - v["fwd_bwd_ms"]
                v["opt_ms"] = opt
                v["cell_ms"] = ga * v["fwd_bwd_ms"] * micro / b + opt
            else:
                v["cell_ms"] = v["ms"] * micro / b
            variants.append(v)
        lo, hi = variants[0], variants[-1]
        reduced.append(
            f"depth: {lo['layers']} and {hi['layers']} of {cfg.num_layers} "
            f"layers measured, extrapolated linearly in blocks")
        if train:
            reduced.append(
                f"grad_accum {ga} -> 1: one microbatch of {hi['batch']} of "
                f"{micro} sequences measured; the step's time is {ga} x its "
                f"forward and backward x {micro}/{hi['batch']} plus the "
                f"optimizer's (step - forward/backward)")
        elif hi["batch"] != case.batch:
            reduced.append(
                f"batch {case.batch} -> {hi['batch']} to fit 80 GB: time x "
                f"{case.batch}/{hi['batch']}; memory at the measured batch")
        ms = _extrapolate(variants, "cell_ms", n_blocks_full)
        peak = (_extrapolate(variants, "peak_bytes", n_blocks_full)
                if "peak_bytes" in hi else None)
        args = _extrapolate(variants, "arg_bytes_local", n_blocks_full)
        rf, rf_flash, corr, saved = _rooflines(cfg, case, count, 1)
        mem = memory_summary(int(args), None if peak is None
                             else int(peak))
        rec.update(
            status="ok", measure_s=time.perf_counter() - t0,
            ms=ms, memory=mem,
            fits_80gb=mem["total_hbm_bytes"] <= h100.HBM_BYTES,
            roofline=rf.to_dict(), roofline_flash=rf_flash.to_dict(),
            roofline_fraction=rf_flash.fraction_at(ms / 1e3),
            collectives=None, count=count.to_dict(),
            recurrence_correction=corr, flash_saved_bytes=saved,
            variants=variants, grad_accum=ga, reduced=reduced,
            meta=full.meta, note=NOTE)
        print(f"[acct] {arch:28s} {shape:12s} ms={ms:10.3f} "
              f"bound={rf_flash.bound_s * 1e3:10.3f}ms "
              f"hbm={mem['total_hbm_bytes'] / 1e9:7.2f}GB "
              f"roofline={rec['roofline_fraction']:6.1%}")
    except Exception as e:  # noqa: BLE001
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-4000:])
        print(f"[ERR acct] {arch} {shape} {mesh_name}: {e}")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", choices=ARCH_IDS + ["all"], default="all")
    ap.add_argument("--shape", choices=list(SHAPES) + ["all"], default="all")
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--mode", choices=["elk", "gspmd"], default="elk")
    ap.add_argument("--prefetch-depth", type=int, default=2,
                    help="0 = derive per cell from the ELK scheduler")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="alias for --arch all --shape all --mesh both")
    ap.add_argument("--device", default="cuda",
                    help="where the cells are measured: cuda (the default) "
                    "or cpu (the plain path)")
    ap.add_argument("--count-only", action="store_true",
                    help="count on the meta device only: no card needed")
    ap.add_argument("--out-dir", default=OUT_DIR)
    args = ap.parse_args(argv)
    if not args.count_only:
        tfm.resolve_device(args.device)   # refuses before any work

    archs = ARCH_IDS if args.arch == "all" or args.all else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" or args.all else [args.shape]
    meshes = (["single", "multi"] if args.mesh == "both" or args.all
              else [args.mesh])
    tally = {"ok": 0, "skipped": 0, "error": 0}
    for mesh_name in meshes:
        for arch in archs:
            for shape in shapes:
                rec = run_cell(arch, shape, mesh_name, mode=args.mode,
                               prefetch_depth=args.prefetch_depth,
                               force=args.force, out_dir=args.out_dir)
                tally[rec.get("status", "error")] += 1
    if not args.count_only:
        for arch in archs:
            for shape in shapes:
                rec = run_cell_accounting(
                    arch, shape, mode=args.mode,
                    prefetch_depth=args.prefetch_depth, force=args.force,
                    device=args.device, out_dir=args.out_dir)
                tally[rec.get("status", "error")] += 1
    print(f"\ndry-run complete: {tally['ok']} ok, {tally['skipped']} skipped "
          f"(documented), {tally['error']} errors")
    if tally["error"]:
        raise SystemExit(1)
    return tally


if __name__ == "__main__":
    main()
