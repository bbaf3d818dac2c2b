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
            ``nvcc`` for sm_90a into ``build/`` (one process per source).
3. kernels  holds each hand-written kernel against its plain PyTorch
            version on the card, at the reference's sweep shapes and at
            the shapes the serving path gives it, and times kernel, plain
            version and a library yardstick with CUDA events.
4. parity   the smoke config in fp32 on the same seeded weights, through
            ``ServeEngine`` on the CPU (plain path) and on the card
            (kernel path): equal greedy tokens, close logits.
5. serve    full-width qwen3-14b (bf16, random weights from seed 0),
            batch 8, prompts of 512 tokens, 16 greedy steps through
            ``ServeEngine.generate``, with the kernels' launch counts set
            to 0 just before and read just after.

Then one JSON line about the kernels, the card's name and power limit,
and as the last line ``{"ok": true, "device": {...}}``.

Bounds use datasheet constants of the H100 SXM: 3.35 TB/s of device
memory, 989 TFLOP/s dense bf16 on the tensor cores, 67 TFLOP/s fp32.
``--layers N`` cuts the depth of the serve phase (never the width).
``--profile`` adds a ``torch.profiler`` trace of three decode steps and one
prefill after the serve phase: the device's busy time and idle share and
the kernels that take the most device time, printed and written to
``build/profile/``.
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

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.fused_mlp.kernel import fused_mlp_kernel  # noqa: E402
from repro_torch.kernels.fused_mlp.ops import fused_mlp  # noqa: E402
from repro_torch.kernels.fused_mlp.ref import composed_ref  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.layers import rms_norm  # noqa: E402
from repro_torch.serve.engine import ServeConfig, ServeEngine  # noqa: E402

# datasheet, H100 SXM
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

# |kernel - plain| <= TOL * (max|plain| + 1).  fp32: the kernel sums ff in
# chunks and splits, the plain version in one product.  bf16: the kernel
# rounds the intermediate once, the plain version rounds gate and up before
# the activation as well.
TOL = {torch.float32: 2e-4, torch.bfloat16: 6e-2}

# (M, D, FF, gated, bias, act): the reference's kernel sweep
SWEEP = [
    (128, 128, 256, True, False, "silu"),
    (64, 96, 200, True, False, "silu"),
    (100, 80, 144, False, True, "relu"),
    (33, 64, 257, False, False, "gelu"),
]

BATCH, PROMPT_LEN, STEPS, CACHE = 8, 512, 16, 1024


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
        "cases": cases, "max_err_over_tol": worst, "shapes": shapes,
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


# ---------------------------------------------------------------------------
# phase 5: full-width serving
# ---------------------------------------------------------------------------

def serve_phase(cfg, kernel_rows: list[dict], profile: bool) -> None:
    dev = torch.device("cuda")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = tfm.init_params(torch.Generator(device=dev).manual_seed(0), cfg, dev)
    torch.cuda.synchronize()
    say(f"[serve] {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, bf16; weights drawn on the "
        f"card in {time.perf_counter() - t0:.1f}s")
    eng = ServeEngine(cfg, params, ServeConfig(batch=BATCH, cache_capacity=CACHE))
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT_LEN), device=dev,
                            generator=torch.Generator(device=dev).manual_seed(1))
    eng.generate(prompts, steps=2)          # warm-up
    torch.cuda.synchronize()

    # the main path, with the kernels' counts at 0 before and read after
    fused_mlp_kernel.launches = 0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = eng.generate(prompts, steps=STEPS)
    end.record()
    torch.cuda.synchronize()
    launches = fused_mlp_kernel.launches
    gen_ms = start.elapsed_time(end)
    kernel_rows[0]["launches"] = launches
    if launches != cfg.num_layers * STEPS:
        fail(f"fused_mlp launched {launches} times on the serving path, "
             f"expected {cfg.num_layers} layers x {STEPS} passes")
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
        "sample": out[0, PROMPT_LEN:].tolist()}))
    if profile:
        profile_phase(eng, prompts,
                      {"prefill": prefill_ms, "decode": decode_ms})


def profile_phase(eng: ServeEngine, prompts: torch.Tensor,
                  wall_ms: dict) -> None:
    """Where a decode step and a prefill spend their time: the summed
    device time of their kernels (``torch.profiler``) beside the wall time
    measured without the profiler, and the top kernels by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def decode3(cache, tok):
        for _ in range(3):
            logits, cache = eng.decode(tok, cache)
            tok = torch.argmax(logits[:, -1, :], dim=-1)

    logits, cache = eng.prefill(prompts)
    tok = torch.argmax(logits[:, -1, :], dim=-1)
    out_dir = ROOT / "build" / "profile"
    out_dir.mkdir(parents=True, exist_ok=True)
    for label, passes, fn in (("decode", 3, lambda: decode3(cache, tok)),
                              ("prefill", 1,
                               lambda: eng.prefill(prompts, cache))):
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
            "pass": label, "wall_ms": wall_ms[label],
            "device_busy_ms": device_ms,
            "device_idle_share": 1.0 - device_ms / wall_ms[label],
            "device_kernels": launches}))
        for us, count, key in rows[:8]:
            say(f"[profile]   {us * 1e-3 / passes:9.3f} ms  "
                f"x{count // passes:<5d} {key[:90]}")
        (out_dir / f"profile_{label}.txt").write_text(
            events.table(sort_by="self_cuda_time_total", row_limit=40))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, default=0,
                    help="depth of the serve phase (0 = the model's own)")
    ap.add_argument("--profile", action="store_true",
                    help="also trace decode steps and a prefill")
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
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    with torch.inference_mode():
        rows = [kernels_phase(cfg)]
        parity_phase()
        serve_phase(cfg, rows, args.profile)

    for row in rows:
        if row["launches"] < 1:
            fail(f"kernel {row['name']} was never launched on the main path")
    say(json.dumps({"kernels": rows}))
    say(card)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
