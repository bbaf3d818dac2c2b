#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts and is right on the GPU.

    python3 chip_smoke.py

Needs one NVIDIA Hopper card, ``nvcc`` and nothing from the network.  It
imports the port (``src/repro_torch``) only, never ``jax`` or the JAX
package, and runs these phases; any failure ends the run with a non-zero
exit code and no result line:

1. device   a CUDA device must be there; prints the card's name and power
            limit as ``nvidia-smi`` gives them.
2. build    compiles every ``src/repro_torch/kernels/csrc/*.cu`` with
            ``nvcc`` for sm_90a into ``build/`` (one process per source,
            all started together).
3. kernels  holds each hand-written kernel (fused MLP, decode attention)
            against its plain PyTorch version on the card, at the
            reference's sweep shapes and at the shapes the serving paths
            give it, and times kernel, plain version and a library
            yardstick with CUDA events.
4. parity   the smoke config in fp32 on the same seeded weights, on the CPU
            (plain path) and on the card (kernel path): ``ServeEngine``'s
            lock-step ``generate`` and ``ContinuousBatcher.run`` over a
            mixed trace give equal greedy tokens; last logits close.
5. serve    lock-step: full-width qwen3-14b (bf16, random weights from
            seed 0), batch 8, prompts of 512 tokens, 16 greedy steps
            through ``ServeEngine.generate``.
6. serve-trace  continuous batching: the same model and weights, 8 slots of
            2048, 16 mixed requests (prompts 128-1024, 16-64 new tokens)
            through ``ContinuousBatcher.run``.

Each serving path runs with the kernels' launch counts set to 0 just
before it and read just after, and fails if a kernel of the path was not
launched as often as its layers and steps say.  Then one JSON line about
the kernels, the card's name and power limit, and as the last line
``{"ok": true, "device": {...}}``.

Bounds use datasheet constants of the H100 SXM: 3.35 TB/s of device
memory, 989 TFLOP/s dense bf16 on the tensor cores, 67 TFLOP/s fp32.
``--layers N`` cuts the depth of the lock-step serve phase (never the
width, never the continuous path).  ``--profile`` adds a ``torch.profiler``
trace of three lock-step decode steps, one prefill and three slot-batched
steps: the device's busy time and idle share and the kernels that take the
most device time, printed and written to ``build/profile/``.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.metadata
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.decode_attention.kernel import \
    decode_attention_kernel  # noqa: E402
from repro_torch.kernels.decode_attention.ops import decode_attn  # noqa: E402
from repro_torch.kernels.decode_attention.ref import (  # noqa: E402
    decode_attention_ref, live_mask)
from repro_torch.kernels.fused_mlp.kernel import fused_mlp_kernel  # noqa: E402
from repro_torch.kernels.fused_mlp.ops import fused_mlp  # noqa: E402
from repro_torch.kernels.fused_mlp.ref import composed_ref  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.layers import rms_norm  # noqa: E402
from repro_torch.serve.batcher import (ContinuousBatcher,  # noqa: E402
                                       _chunk_len, make_trace, summarize)
from repro_torch.serve.engine import ServeConfig, ServeEngine  # noqa: E402

# datasheet, H100 SXM
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

# fused MLP: |kernel - plain| <= TOL * (max|plain| + 1), the reference's
# kernel-test bound.  fp32: the kernel sums in chunks and splits, the plain
# version in one product.  bf16: the kernel rounds the intermediate once, the
# plain version rounds gate and up before the activation as well.
TOL = {torch.float32: 2e-4, torch.bfloat16: 6e-2}
# decode attention: |kernel - plain| <= ATTN_TOL * max|plain|.  Both sides
# compute in fp32 from the same inputs and differ only in the order of their
# sums; in bf16 also in the output's one rounding, which can land one unit in
# the last place apart: at most 2**-7 of the value, under 8e-3 of the largest.
ATTN_TOL = {torch.float32: 2e-4, torch.bfloat16: 8e-3}

# (M, D, FF, gated, bias, act): the reference's kernel sweep
SWEEP = [
    (128, 128, 256, True, False, "silu"),
    (64, 96, 200, True, False, "silu"),
    (100, 80, 144, False, True, "relu"),
    (33, 64, 257, False, False, "gelu"),
]

BATCH, PROMPT_LEN, STEPS, CACHE = 8, 512, 16, 1024

# the continuous-batching phase
SLOTS, SLOT_CACHE, PREFILL_CHUNK = 8, 2048, 256
TRACE = dict(prompt_lens=(128, 384, 700, 1024), max_new=(16, 32, 48, 64),
             seed=0)
TRACE_N = 16
SENTINEL = 2 ** 30

# (B, Hq, Hkv, C, D, window, pos): the reference's decode-attention sweep
ATTN_SWEEP = [
    (2, 8, 2, 128, 32, 0, 100),        # partial cache
    (1, 4, 4, 256, 16, 64, 300),       # ring buffer + window
    (2, 2, 1, 64, 64, 0, 64),          # exactly full cache
]


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def smi_name_and_limit() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` over ``iters`` calls, by CUDA events.
    The calls are queued behind some milliseconds of other device work, so
    that the host, however slow, is ahead of the device while they run and
    no gap between two launches is counted."""
    for _ in range(warmup):
        fn()
    busy = torch.zeros(8192, 8192, device="cuda", dtype=torch.bfloat16)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    for _ in range(8):          # about 1.5 ms each on an H100
        torch.matmul(busy, busy)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# phase 3: kernels
# ---------------------------------------------------------------------------

def mlp_inputs(gen, lead, d, ff, gated, bias, dtype):
    def normal(*shape, scale=1.0):
        t = torch.randn(shape, generator=gen, device="cuda",
                        dtype=torch.float32) * scale
        return t.to(dtype)

    x = normal(*lead, d)
    w_up = normal(d, ff, scale=d ** -0.5)
    w_down = normal(ff, d, scale=ff ** -0.5)
    kw = {}
    if gated:
        kw["w_gate"] = normal(d, ff, scale=d ** -0.5)
    if bias:
        kw["b_up"] = normal(ff)
        kw["b_down"] = normal(d)
    return x, w_up, w_down, kw


def mlp_bound_ms(m, d, ff, dout, gated, bias, dtype) -> tuple[float, str]:
    """Least time for the function: each input read once, the output
    written once, at the memory rate; its products at the peak rate."""
    size = torch.empty((), dtype=dtype).element_size()
    elems = m * d + d * ff * (2 if gated else 1) + ff * dout + m * dout
    if bias:
        elems += ff + dout
    t_bytes = elems * size / HBM_BYTES_PER_S
    flops = 2 * m * ff * (d * (2 if gated else 1) + dout)
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def check_mlp(x, w_up, w_down, kw, act) -> tuple[float, float]:
    """(max abs error, error over tolerance) of the kernel against
    ``composed_ref`` on these inputs; fails the run beyond tolerance."""
    out = fused_mlp(x, w_up, w_down, act=act, **kw)
    torch.cuda.synchronize()
    ref = composed_ref(x, w_up, w_down, act=act, **kw)
    if out.shape != ref.shape or out.dtype != ref.dtype:
        fail(f"fused_mlp gave {tuple(out.shape)} {out.dtype}, plain version "
             f"{tuple(ref.shape)} {ref.dtype}")
    if not torch.isfinite(out.to(torch.float32)).all():
        fail(f"fused_mlp output not finite at x{tuple(x.shape)}")
    ref32 = ref.to(torch.float32)
    err = float((out.to(torch.float32) - ref32).abs().max()) if out.numel() else 0.0
    tol = TOL[x.dtype] * (float(ref32.abs().max()) + 1.0 if out.numel() else 1.0)
    if err > tol:
        fail(f"fused_mlp disagrees with composed_ref: x{tuple(x.shape)} "
             f"ff={w_up.shape[1]} {x.dtype} act={act} "
             f"variant={'glu' if 'w_gate' in kw else 'bias' if kw else 'plain'}: "
             f"max abs err {err:.3e} > tol {tol:.3e}")
    return err, err / tol


def kernels_phase(cfg) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(1234)
    worst, cases = 0.0, 0
    for dtype in (torch.float32, torch.bfloat16):
        for m, d, ff, gated, bias, act in SWEEP:
            x, w_up, w_down, kw = mlp_inputs(gen, (m,), d, ff, gated, bias, dtype)
            worst = max(worst, check_mlp(x, w_up, w_down, kw, act)[1])
            cases += 1
    # leading dims are flattened
    x, w_up, w_down, kw = mlp_inputs(gen, (2, 40), 64, 160, True, False,
                                     torch.float32)
    worst = max(worst, check_mlp(x, w_up, w_down, kw, "silu")[1])
    # m == 0 gives zeros of the right shape without a launch
    before = fused_mlp_kernel.launches
    empty = fused_mlp(x[:, :0], w_up, w_down, act="silu", **kw)
    if tuple(empty.shape) != (2, 0, 64) or fused_mlp_kernel.launches != before:
        fail(f"fused_mlp on m == 0 gave {tuple(empty.shape)}")
    cases += 2
    say(f"[kernels] fused_mlp: {cases} sweep cases inside tolerance "
        f"(worst err/tol {worst:.3f})")

    # the two shapes the serving path gives it, full width, bf16
    if cfg.mlp_act != "silu" or not cfg.gated_mlp:
        fail("the library yardstick is written for the silu GLU")
    d, ff, dtype = cfg.d_model, cfg.d_ff, torch.bfloat16
    x_all, w_up, w_down, kw = mlp_inputs(gen, (BATCH * PROMPT_LEN,), d, ff,
                                         cfg.gated_mlp, False, dtype)
    shapes = []
    for label, m, iters in (("decode", BATCH, 20),
                            ("prefill", BATCH * PROMPT_LEN, 5)):
        x = x_all[:m].contiguous()
        err, over = check_mlp(x, w_up, w_down, kw, cfg.mlp_act)
        worst = max(worst, over)
        cases += 1
        act = torch.nn.functional.silu

        def library():
            return torch.matmul(act(torch.matmul(x, kw["w_gate"]))
                                * torch.matmul(x, w_up), w_down)

        bound, bound_by = mlp_bound_ms(m, d, ff, d, True, False, dtype)
        shapes.append({
            "shape": label, "m": m, "d": d, "ff": ff, "dtype": "bfloat16",
            "max_abs_err": err,
            "ms": time_ms(lambda: fused_mlp(x, w_up, w_down, act=cfg.mlp_act,
                                            **kw), iters),
            "plain_ms": time_ms(lambda: composed_ref(
                x, w_up, w_down, act=cfg.mlp_act, **kw), 3, warmup=1),
            "bound_ms": bound, "bound_by": bound_by,
            "library_ms": time_ms(library, iters),
        })
        say(f"[kernels] fused_mlp {label} m={m}: " + json.dumps(shapes[-1]))
    decode = shapes[0]
    return {
        "name": "fused_mlp", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_mlp.cu",
        "replaces": "src/repro/kernels/fused_mlp/kernel.py:38",
        "launches": 0,
        # the scalar keys are the decode shape's (most launches on the
        # path); "shapes" holds both
        "max_abs_err": decode["max_abs_err"], "ms": decode["ms"],
        "plain_ms": decode["plain_ms"], "bound_ms": decode["bound_ms"],
        "bound_by": decode["bound_by"], "library_ms": decode["library_ms"],
        "kernel_ms": decode["ms"],
        "cases": cases, "max_err_over_tol": worst, "shapes": shapes,
    }


def ring_tags(c: int, pos: int) -> torch.Tensor:
    """slot_pos of a ring after ``pos`` tokens (position p at slot p % C)."""
    idx = torch.arange(c, device="cuda")
    if pos <= c:
        return torch.where(idx < pos, idx, SENTINEL).to(torch.int32)
    start = pos - c
    return (start + (idx - start) % c).to(torch.int32)


def attn_inputs(gen, b, hq, hkv, c, d, dtype):
    def normal(*shape):
        return torch.randn(shape, generator=gen, device="cuda",
                           dtype=torch.float32).to(dtype)
    return normal(b, hq, d), normal(b, hkv, c, d), normal(b, hkv, c, d)


def check_attn(q, k, v, slot_pos, q_pos, window=0, dead_rows=()
               ) -> tuple[float, float]:
    """(max abs error, error over tolerance) of the kernel against
    ``decode_attention_ref`` on these inputs; fails the run beyond
    tolerance, or if a row with no live slot is not exactly zero."""
    out = decode_attn(q, k, v, slot_pos, q_pos, window=window)
    torch.cuda.synchronize()
    ref = decode_attention_ref(q, k, v, slot_pos, q_pos, window=window)
    where = (f"q{tuple(q.shape)} cache{tuple(k.shape)} {q.dtype}/{k.dtype} "
             f"slot_pos{tuple(slot_pos.shape)} window={window}")
    if out.shape != ref.shape or out.dtype != ref.dtype:
        fail(f"decode_attention gave {tuple(out.shape)} {out.dtype}, plain "
             f"version {tuple(ref.shape)} {ref.dtype} at {where}")
    if not torch.isfinite(out.to(torch.float32)).all():
        fail(f"decode_attention output not finite at {where}")
    for row in dead_rows:
        if out[row].any():
            fail(f"decode_attention row {row} has no live slot but is not "
                 f"zero at {where}")
    ref32 = ref.to(torch.float32)
    err = float((out.to(torch.float32) - ref32).abs().max())
    tol = ATTN_TOL[q.dtype] * float(ref32.abs().max())
    if err > tol:
        fail(f"decode_attention disagrees with decode_attention_ref at "
             f"{where}: max abs err {err:.3e} > tol {tol:.3e}")
    return err, err / tol if tol else 0.0


def attn_bound_ms(q, k, slot_pos, q_pos, window) -> tuple[float, float, str]:
    """(bound over the live slots, bound over the whole ring, by what).
    Bytes: q read and the output written once, K and V of the slots this
    data attends to, the tags; operations: two products over those slots.
    The kernel reads the whole ring; the first bound is what the function
    needs, the second what reading every slot costs at the memory rate."""
    b, hq, d = q.shape
    hkv, c = k.shape[1], k.shape[2]
    live = int(live_mask(slot_pos, q_pos, b, window).sum())    # row-slots
    size = k.element_size()
    fixed = 2 * q.numel() * q.element_size() + slot_pos.numel() * 4
    t_live = (fixed + 2 * live * hkv * d * size) / HBM_BYTES_PER_S
    t_ring = (fixed + 2 * k.numel() * size) / HBM_BYTES_PER_S
    t_ops = 4 * live * hq * d / PEAK_FLOPS[k.dtype]
    return (max(t_live, t_ops) * 1e3, max(t_ring, t_ops) * 1e3,
            "bytes" if t_live >= t_ops else "operations")


def attention_phase(cfg) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(4321)
    # worst error over tolerance, and that error, by the query's type
    worst = {"float32": (0.0, 0.0), "bfloat16": (0.0, 0.0)}
    cases = 0

    def case(q, *args, **kw):
        nonlocal cases
        err, over = check_attn(q, *args, **kw)
        key = str(q.dtype).split(".")[1]
        worst[key] = max(worst[key], (over, err))
        cases += 1
        return err

    for dtype in (torch.float32, torch.bfloat16):
        # the reference's sweep, in the Pallas kernel's own signature
        for b, hq, hkv, c, d, win, pos in ATTN_SWEEP:
            q, k, v = attn_inputs(gen, b, hq, hkv, c, d, dtype)
            case(q, k, v, ring_tags(c, pos), pos, win)
        # per-row tags and positions; row 3 was evicted (nothing live)
        q, k, v = attn_inputs(gen, 4, 10, 2, 200, 32, dtype)
        qp = torch.tensor([5, 130, 350, 0], dtype=torch.int32, device="cuda")
        tags = torch.stack([ring_tags(200, int(p) + 1) for p in qp.tolist()])
        tags[3] = SENTINEL
        for win in (0, 48):
            case(q, k, v, tags, qp, win, dead_rows=(3,))
        # one position for every row, as an int and as a tensor on the card
        case(q, k, v, tags[0].contiguous(), 5)
        case(q, k, v, tags[0].contiguous(),
             torch.tensor(5, dtype=torch.int32, device="cuda"))
        # every slot masked: zeros (the Pallas kernel's -1e30 would not)
        dead = torch.full((200,), SENTINEL, dtype=torch.int32, device="cuda")
        case(q, k, v, dead, 100, dead_rows=(0, 1, 2, 3))
        # head dims of the configs: 80 (h2o-danube), 256 (gemma), groups of
        # 1, 5, 16 and 20 (more than one block's rows), C not a multiple of
        # the tile, and a ring of more tiles than the kernel lists (it then
        # reads each split's own range of tiles)
        for b, hq, hkv, c, d, pos in ((2, 32, 8, 300, 80, 250),
                                      (2, 16, 16, 130, 256, 200),
                                      (1, 16, 1, 100, 256, 60),
                                      (2, 40, 8, 1000, 128, 999),
                                      (1, 40, 2, 77, 128, 40),
                                      (1, 4, 1, 66000, 16, 70000)):
            q, k, v = attn_inputs(gen, b, hq, hkv, c, d, dtype)
            case(q, k, v, ring_tags(c, pos), pos - 1)
    # fp32 query against a bf16 cache (fp32 weights, default bf16 KV)
    q, k, v = attn_inputs(gen, 2, 8, 2, 128, 32, torch.float32)
    case(q, k.to(torch.bfloat16), v.to(torch.bfloat16), ring_tags(128, 90),
         89)
    say(f"[kernels] decode_attention: {cases} sweep cases inside tolerance "
        f"(worst err/tol and its err: {json.dumps(worst)})")

    # the two shapes the serving paths give it, full width, bf16
    hq, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    dtype = torch.bfloat16
    shapes = []
    lock_pos = PROMPT_LEN + STEPS // 2           # a mid-run lock-step step
    slot_pos_now = [p + 20 for p in TRACE["prompt_lens"] * 2]
    for label, b, c in (("lock-step", BATCH, CACHE),
                        ("continuous", SLOTS, SLOT_CACHE)):
        q, k, v = attn_inputs(gen, b, hq, hkv, c, d, dtype)
        if label == "lock-step":
            tags, qp = ring_tags(c, lock_pos + 1), lock_pos
        else:
            qp = torch.tensor(slot_pos_now, dtype=torch.int32, device="cuda")
            tags = torch.stack([ring_tags(c, p + 1) for p in slot_pos_now])
        err = case(q, k, v, tags, qp)
        mask = live_mask(tags, qp, b)[:, None, None, :]     # (B,1,1,C)
        q4 = q[:, :, None, :]

        def library():
            return torch.nn.functional.scaled_dot_product_attention(
                q4, k, v, attn_mask=mask, enable_gqa=True)

        bound, ring_bound, bound_by = attn_bound_ms(q, k, tags, qp, 0)
        shapes.append({
            "shape": label, "b": b, "hq": hq, "hkv": hkv, "c": c, "d": d,
            "dtype": "bfloat16",
            "live_slots": int(live_mask(tags, qp, b).sum()),
            "max_abs_err": err,
            "ms": time_ms(lambda: decode_attn(q, k, v, tags, qp), 50),
            "plain_ms": time_ms(lambda: decode_attention_ref(q, k, v, tags,
                                                             qp), 5,
                                warmup=1),
            "bound_ms": bound, "bound_by": bound_by,
            "ring_bound_ms": ring_bound,
            "library_ms": time_ms(library, 50),
        })
        say(f"[kernels] decode_attention {label}: " + json.dumps(shapes[-1]))
    main = shapes[1]
    return {
        "name": "decode_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention/kernel.py:37",
        "launches": 0,
        # the scalar keys are the continuous path's shape (this slice's
        # own); "shapes" holds both
        "max_abs_err": main["max_abs_err"], "ms": main["ms"],
        "kernel_ms": main["ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": main["library_ms"],
        "cases": cases, "max_err_over_tol": max(w for w, _ in worst.values()),
        "worst_by_dtype": worst, "shapes": shapes,
    }


# ---------------------------------------------------------------------------
# phase 4: CPU (plain path) against the card (kernel path)
# ---------------------------------------------------------------------------

def parity_phase() -> None:
    cfg = dataclasses.replace(get_smoke_config("qwen3_14b"), dtype="float32",
                              param_dtype="float32")
    params = tfm.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    scfg = ServeConfig(batch=2, cache_capacity=32, kv_dtype="float32")
    engines = {dev: ServeEngine(cfg, params, scfg, device=dev)
               for dev in ("cpu", "cuda")}
    prompts = torch.randint(0, cfg.vocab_size, (2, 12),
                            generator=torch.Generator().manual_seed(1))
    before = fused_mlp_kernel.launches
    toks = {dev: eng.generate(prompts, steps=8).cpu()
            for dev, eng in engines.items()}
    if fused_mlp_kernel.launches - before != cfg.num_layers * 8:
        fail("the card's engine did not go through the fused_mlp kernel")
    if not torch.equal(toks["cpu"], toks["cuda"]):
        fail(f"greedy tokens differ between CPU and card:\n{toks['cpu']}\n"
             f"{toks['cuda']}")
    # last-step logits, both fed the CPU run's tokens
    last = {}
    for dev, eng in engines.items():
        logits, cache = eng.prefill(prompts)
        for step in range(7):
            logits, cache = eng.decode(toks["cpu"][:, 12 + step], cache)
        last[dev] = logits.to(torch.float32).cpu()
    err = float((last["cpu"] - last["cuda"]).abs().max())
    tol = 2e-4 * (float(last["cpu"].abs().max()) + 1.0)
    if err > tol:
        fail(f"last-step logits differ: {err:.3e} > {tol:.3e}")
    # ties go to the first index on the card as on the CPU
    rows = torch.zeros(3, 300)
    rows[0, [7, 200]] = 3.0
    rows[2, [150, 151]] = 2.0
    if torch.argmax(rows.cuda(), dim=-1).tolist() != [7, 0, 150]:
        fail("torch.argmax on the card does not pick the first maximum")
    say(f"[parity] smoke qwen3 fp32: tokens equal on CPU and card, "
        f"last-step logits max abs diff {err:.3e} (tol {tol:.3e})")

    # continuous batching: the same trace through both engines' batchers
    scfg = ServeConfig(batch=2, cache_capacity=32, prefill_chunk=8,
                       kv_dtype="float32")
    engines = {dev: ServeEngine(cfg, params, scfg, device=dev)
               for dev in ("cpu", "cuda")}
    done = {}
    for dev, eng in engines.items():
        before = decode_attention_kernel.launches
        comps = ContinuousBatcher(eng).run(make_trace(
            6, vocab_size=cfg.vocab_size))
        done[dev] = {c.rid: c.tokens for c in comps}
        launched = decode_attention_kernel.launches - before
        if (dev == "cuda") != (launched > 0):
            fail(f"the {dev} batcher launched decode_attention {launched} "
                 "times")
    if sorted(done["cpu"]) != list(range(6)) or any(
            not np.array_equal(done["cpu"][r], done["cuda"][r])
            for r in done["cpu"]):
        fail(f"continuous-batching tokens differ between CPU and card:\n"
             f"{done['cpu']}\n{done['cuda']}")
    say("[parity] smoke qwen3 fp32: ContinuousBatcher tokens equal on CPU "
        "and card for 6 mixed requests")


# ---------------------------------------------------------------------------
# phase 5: full-width serving
# ---------------------------------------------------------------------------

def record_launches(rows: list[dict], path: str, mlp: int, attn: int
                    ) -> None:
    """Add one path's launch counts to the kernels' rows."""
    for row, n in zip(rows, (mlp, attn)):
        row.setdefault("launches_by_path", {})[path] = n
        row["launches"] += n


def draw_params(cfg) -> dict:
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    params = tfm.init_params(torch.Generator(device=dev).manual_seed(0), cfg, dev)
    torch.cuda.synchronize()
    say(f"[serve] {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, bf16; weights drawn on the "
        f"card in {time.perf_counter() - t0:.1f}s")
    return params


def serve_phase(cfg, params: dict, kernel_rows: list[dict],
                profile: bool) -> None:
    dev = torch.device("cuda")
    torch.cuda.reset_peak_memory_stats()
    eng = ServeEngine(cfg, params, ServeConfig(batch=BATCH, cache_capacity=CACHE))
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT_LEN), device=dev,
                            generator=torch.Generator(device=dev).manual_seed(1))
    eng.generate(prompts, steps=2)          # warm-up
    torch.cuda.synchronize()

    # the lock-step path, with the kernels' counts at 0 before and read after
    fused_mlp_kernel.launches = 0
    decode_attention_kernel.launches = 0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = eng.generate(prompts, steps=STEPS)
    end.record()
    torch.cuda.synchronize()
    launches = fused_mlp_kernel.launches
    attn_launches = decode_attention_kernel.launches
    gen_ms = start.elapsed_time(end)
    record_launches(kernel_rows, "lock-step", launches, attn_launches)
    if launches != cfg.num_layers * STEPS:
        fail(f"fused_mlp launched {launches} times on the serving path, "
             f"expected {cfg.num_layers} layers x {STEPS} passes")
    if attn_launches != cfg.num_layers * (STEPS - 1):
        fail(f"decode_attention launched {attn_launches} times on the "
             f"serving path, expected {cfg.num_layers} layers x "
             f"{STEPS - 1} decode steps")
    if tuple(out.shape) != (BATCH, PROMPT_LEN + STEPS):
        fail(f"generate gave shape {tuple(out.shape)}")
    if not torch.equal(out[:, :PROMPT_LEN], prompts):
        fail("generate did not keep the prompts")
    if int(out.min()) < 0 or int(out.max()) >= cfg.vocab_size:
        fail("generated token outside the vocabulary")

    # prefill and decode timed apart; logits finite; cache updated in place
    logits, cache = eng.prefill(prompts)
    prefill_ms = time_ms(lambda: eng.prefill(prompts, cache), 2, warmup=0)
    logits, cache = eng.prefill(prompts, cache)
    if not torch.isfinite(logits).all():
        fail("prefill logits not finite")
    first = torch.argmax(logits[:, -1, :], dim=-1)
    if not torch.equal(first, out[:, PROMPT_LEN]):
        fail("prefill's greedy token differs from generate's")
    ptrs = (cache["k"].data_ptr(), cache["v"].data_ptr(),
            cache["slot_pos"].data_ptr())
    tok = first
    start.record()
    for step in range(STEPS - 1):
        logits, cache = eng.decode(tok, cache)
        tok = torch.argmax(logits[:, -1, :], dim=-1)
        if not torch.equal(tok, out[:, PROMPT_LEN + 1 + step]):
            fail(f"decode step {step} differs from generate's token")
    end.record()
    torch.cuda.synchronize()
    decode_ms = start.elapsed_time(end) / (STEPS - 1)
    if not torch.isfinite(logits).all():
        fail("last decode logits not finite")
    if ptrs != (cache["k"].data_ptr(), cache["v"].data_ptr(),
                cache["slot_pos"].data_ptr()) or cache["pos"] != PROMPT_LEN + STEPS - 1:
        fail("the KV cache was not updated in place")

    # layer 0's MLP on the live weights and a live activation
    p0 = params["layers"][0]
    h = rms_norm(params["embed"][prompts], p0["ln2"], cfg.norm_eps)
    _, over = check_mlp(h, p0["mlp"]["w_up"], p0["mlp"]["w_down"],
                        {"w_gate": p0["mlp"]["w_gate"]}, cfg.mlp_act)
    say(f"[serve] layer 0 MLP on live weights: err/tol {over:.3f}")
    say("[serve] " + json.dumps({
        "model": cfg.name, "layers": cfg.num_layers, "batch": BATCH,
        "prompt_len": PROMPT_LEN, "steps": STEPS, "cache": CACHE,
        "prefill_ms": prefill_ms, "decode_ms_per_token": decode_ms,
        "generate_ms": gen_ms,
        "tokens_per_s": BATCH * STEPS / (gen_ms * 1e-3),
        "decode_tokens_per_s": BATCH / (decode_ms * 1e-3),
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        "fused_mlp_launches": launches,
        "decode_attention_launches": attn_launches,
        "sample": out[0, PROMPT_LEN:].tolist()}))
    if profile:
        profile_phase(eng, prompts,
                      {"prefill": prefill_ms, "decode": decode_ms})


# ---------------------------------------------------------------------------
# phase 6: continuous batching at full width
# ---------------------------------------------------------------------------

def trace_phase(cfg, params: dict, kernel_rows: list[dict],
                profile: bool) -> None:
    torch.cuda.reset_peak_memory_stats()
    scfg = ServeConfig(batch=SLOTS, cache_capacity=SLOT_CACHE,
                       prefill_chunk=PREFILL_CHUNK)
    eng = ServeEngine(cfg, params, scfg)
    vocab = cfg.vocab_size
    ContinuousBatcher(eng).run(make_trace(        # warm-up
        4, vocab_size=vocab, prompt_lens=(16, 48), max_new=(2, 5), seed=1))
    torch.cuda.synchronize()
    cache = eng.slot_cache
    ptrs = {k: cache[k].data_ptr() for k in ("k", "v", "pos", "slot_pos")}

    # every decode step timed by CUDA events around it (the batcher reads
    # the tokens back each tick, so the events do not hold it up); the tags
    # and position of every slot kept as the request leaves it
    step, evict = eng.step, eng.evict_slot
    events, last_tags = [], {}

    def timed_step(tokens):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        out = step(tokens)
        ev[1].record()
        events.append(ev)
        return out

    def kept_evict(slot, **kw):
        last_tags[slot] = (cache["slot_pos"][slot].clone(),
                           int(cache["pos"][slot]))
        return evict(slot, **kw)

    eng.step, eng.evict_slot = timed_step, kept_evict
    trace = make_trace(TRACE_N, vocab_size=vocab, **TRACE)
    bat = ContinuousBatcher(eng)
    fused_mlp_kernel.launches = 0
    decode_attention_kernel.launches = 0
    t0 = time.perf_counter()
    comps = bat.run(trace)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    mlp_n, attn_n = fused_mlp_kernel.launches, decode_attention_kernel.launches
    eng.step, eng.evict_slot = step, evict
    record_launches(kernel_rows, "continuous", mlp_n, attn_n)

    chunks = 0
    for r in trace:
        off = 0
        while off < len(r.prompt):
            off += _chunk_len(len(r.prompt) - off, bat.chunk_budget)
            chunks += 1
    layers = cfg.num_layers
    if attn_n != layers * bat.decode_ticks:
        fail(f"decode_attention launched {attn_n} times in the trace, "
             f"expected {layers} layers x {bat.decode_ticks} decode ticks")
    if mlp_n != layers * (bat.decode_ticks + chunks):
        fail(f"fused_mlp launched {mlp_n} times in the trace, expected "
             f"{layers} layers x ({bat.decode_ticks} decode ticks + "
             f"{chunks} prefill chunks)")
    if len(comps) != TRACE_N or sorted(c.rid for c in comps) != list(
            range(TRACE_N)):
        fail(f"{len(comps)} of {TRACE_N} requests completed")
    by_rid = {r.rid: r for r in trace}
    for c in comps:
        r = by_rid[c.rid]
        if c.tokens.shape != (len(r.prompt) + r.max_new_tokens,):
            fail(f"request {c.rid} has {c.tokens.shape[0]} tokens, expected "
                 f"{len(r.prompt)} + {r.max_new_tokens}")
        if not np.array_equal(c.tokens[:len(r.prompt)], r.prompt):
            fail(f"request {c.rid} did not keep its prompt")
        if c.tokens.min() < 0 or c.tokens.max() >= vocab:
            fail(f"request {c.rid} has a token outside the vocabulary")
    if eng.slot_cache is not cache or ptrs != {
            k: cache[k].data_ptr() for k in ptrs}:
        fail("the slot cache was not updated in place")

    # layer 0's attention on the rings the requests left behind
    unused = (torch.full((SLOT_CACHE,), SENTINEL, dtype=torch.int32,
                         device="cuda"), 0)         # a slot no request took
    kept = [last_tags.get(s, unused) for s in range(SLOTS)]
    tags = torch.stack([t for t, _ in kept])
    q_pos = torch.tensor([p - 1 for _, p in kept], dtype=torch.int32,
                         device="cuda")
    q = torch.randn((SLOTS, cfg.num_heads, cfg.resolved_head_dim),
                    generator=torch.Generator(device="cuda").manual_seed(5),
                    device="cuda").to(torch.bfloat16)
    err, over = check_attn(q, cache["k"][0], cache["v"][0], tags, q_pos,
                           tfm.attn_spec(cfg).sliding_window,
                           dead_rows=[s for s in range(SLOTS)
                                      if s not in last_tags])
    say(f"[serve-trace] layer 0 attention on the rings of {len(last_tags)} "
        f"slots: err {err:.3e}, err/tol {over:.3f}")

    step_ms = [a.elapsed_time(b) for a, b in events]
    stats = summarize(comps, wall)
    stats.update({
        "model": cfg.name, "layers": layers, "slots": SLOTS,
        "cache": SLOT_CACHE, "prefill_chunk": PREFILL_CHUNK,
        "ticks": bat.ticks, "decode_ticks": bat.decode_ticks,
        "prefill_chunks": chunks,
        "decode_ms_per_tick": sum(step_ms) / len(step_ms),
        "decode_ms_per_tick_min": min(step_ms),
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        "fused_mlp_launches": mlp_n, "decode_attention_launches": attn_n,
        "finish_order": [c.rid for c in comps]})
    say("[serve-trace] " + json.dumps(stats))
    if profile:
        profile_steps(eng, last_tags)


def profile_steps(eng: ServeEngine, last_tags: dict) -> None:
    """Three slot-batched decode steps under ``torch.profiler``, in the
    form of the lock-step ones, on live rings: every slot's tags and
    position are put back as its last request left them (its K/V is still
    in the ring), so attention reads what the trace's last ticks read."""
    cache = eng.slot_cache
    for slot, (tags, pos) in last_tags.items():
        cache["slot_pos"][slot] = tags
        cache["pos"][slot] = pos
    tokens = torch.zeros((SLOTS,), dtype=torch.int64, device="cuda")

    def step3():
        for _ in range(3):
            eng.step(tokens)

    step3()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step3()
    torch.cuda.synchronize()
    profile_passes("step", 3, step3, (time.perf_counter() - t0) * 1e3 / 3)


def profile_passes(label: str, passes: int, fn, wall_ms: float) -> None:
    """``fn`` (``passes`` passes) under ``torch.profiler``: summed device
    time of its kernels beside the wall time of one pass measured without
    the profiler, and the top kernels by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    out_dir = ROOT / "build" / "profile"
    out_dir.mkdir(parents=True, exist_ok=True)
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    rows = sorted(((e.self_device_time_total, e.count, e.key)
                   for e in events if e.device_type == DeviceType.CUDA),
                  reverse=True)
    if not rows:
        fail("torch.profiler recorded no device kernels")
    device_ms = sum(r[0] for r in rows) * 1e-3 / passes
    launches = sum(r[1] for r in rows) // passes
    say("[profile] " + json.dumps({
        "pass": label, "wall_ms": wall_ms, "device_busy_ms": device_ms,
        "device_idle_share": 1.0 - device_ms / wall_ms,
        "device_kernels": launches}))
    for us, count, key in rows[:8]:
        say(f"[profile]   {us * 1e-3 / passes:9.3f} ms  "
            f"x{count // passes:<5d} {key[:90]}")
    (out_dir / f"profile_{label}.txt").write_text(
        events.table(sort_by="self_cuda_time_total", row_limit=40))


def profile_phase(eng: ServeEngine, prompts: torch.Tensor,
                  wall_ms: dict) -> None:
    """Where a lock-step decode step and a prefill spend their time."""
    def decode3(cache, tok):
        for _ in range(3):
            logits, cache = eng.decode(tok, cache)
            tok = torch.argmax(logits[:, -1, :], dim=-1)

    logits, cache = eng.prefill(prompts)
    tok = torch.argmax(logits[:, -1, :], dim=-1)
    profile_passes("decode", 3, lambda: decode3(cache, tok), wall_ms["decode"])
    profile_passes("prefill", 1, lambda: eng.prefill(prompts, cache),
                   wall_ms["prefill"])


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, default=0,
                    help="depth of the lock-step serve phase (0 = the "
                    "model's own); the continuous phase keeps full depth")
    ap.add_argument("--profile", action="store_true",
                    help="also trace decode steps, a prefill and slot steps")
    args = ap.parse_args()

    # phase 1: device
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs the GPU")
    card = smi_name_and_limit()
    nvcc = subprocess.run([_build.nvcc_path(), "--version"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    try:
        triton = importlib.metadata.version("triton")
    except importlib.metadata.PackageNotFoundError:
        triton = "absent"
    say(f"[device] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, triton {triton} (unused), "
        f"nvcc: {nvcc.splitlines()[-2]} / {nvcc.splitlines()[-1]}")

    # phase 2: build
    t0 = time.perf_counter()
    logs = _build.build_all(verbose=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "error" in line.lower():
                say(f"[build] {name}: {line.strip()}")
    say(f"[build] {len(logs)} source(s) {sorted(logs)} built with nvcc for "
        f"sm_90a in {time.perf_counter() - t0:.1f}s")

    # the plain versions are the reference: full fp32 products, no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("qwen3_14b")
    lock_cfg = cfg
    if args.layers:
        lock_cfg = dataclasses.replace(cfg, num_layers=args.layers)
    say(f"[serve] lock-step depth {lock_cfg.num_layers} of {cfg.num_layers}; "
        f"continuous depth {cfg.num_layers}")
    with torch.inference_mode():
        rows = [kernels_phase(cfg), attention_phase(cfg)]
        parity_phase()
        params = draw_params(cfg)
        serve_phase(lock_cfg, {**params,
                               "layers": params["layers"][:lock_cfg.num_layers]},
                    rows, args.profile)
        trace_phase(cfg, params, rows, args.profile)

    for row in rows:
        for path, n in row["launches_by_path"].items():
            if n < 1:
                fail(f"kernel {row['name']} was never launched on the "
                     f"{path} path")
    say(json.dumps({"kernels": rows}))
    say(card)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
