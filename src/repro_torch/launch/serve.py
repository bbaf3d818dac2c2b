"""Serving launcher of the port, greedy.

Lock-step batch:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-14b \
      --batch 8 --prompt-len 512 --steps 16 --cache 1024

Continuous batching over a mixed-length request trace (tok/s + request
latency percentiles, optionally against the static-batching baseline):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-14b \
      --batch 8 --trace 16 --cache 2048 --prefill-chunk 256

Runs on the GPU unless ``--device cpu`` is given (``--smoke`` makes that
bearable).  Weights are random, drawn on the device from seed 0; prompts
from seed 1, traces from ``--trace-seed``.  The reference launcher's
``--mode elk_stream``, ``--prefetch-depth 0`` (planner-derived knobs),
``--kv-dtype int8``, ``--oversub``, ``--prefix-cache-mb``, ``--stacked-gb``,
``--fleet`` and ``--pipeline-pod`` are not ported yet (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.models import transformer as tfm
from repro_torch.serve.engine import ServeConfig, ServeEngine


def _run_trace(eng: ServeEngine, args, vocab: int) -> dict:
    from repro_torch.serve.batcher import (ContinuousBatcher, make_trace,
                                           run_static_trace, summarize)

    trace = make_trace(args.trace, vocab_size=vocab,
                       arrival_spacing_s=args.arrival_spacing,
                       seed=args.trace_seed, burst=args.burst,
                       sys_prompt_len=args.sys_prompt_len,
                       sys_prompt_frac=args.sys_prompt_frac)
    # a short warm-up so that the numbers are steady-state serving (on the
    # card it also builds the kernels)
    warm = make_trace(min(4, args.trace), vocab_size=vocab,
                      seed=args.trace_seed + 1)
    ContinuousBatcher(eng).run(warm)

    bat = ContinuousBatcher(eng)
    t0 = time.perf_counter()
    completions = bat.run(trace)
    stats = {"continuous": summarize(completions, time.perf_counter() - t0)}
    stats["continuous"]["ticks"] = bat.ticks
    stats["continuous"]["decode_ticks"] = bat.decode_ticks
    order = [c.rid for c in completions]
    print(f"continuous: {stats['continuous']}  finish order: {order}")

    if args.compare_static:
        run_static_trace(eng, warm)
        t0 = time.perf_counter()
        static = run_static_trace(eng, trace)
        stats["static"] = summarize(static, time.perf_counter() - t0)
        print(f"static:     {stats['static']}")
    return stats


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True,
                    help=f"one of {ARCH_IDS} (dashed aliases ok)")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--cache", type=int, default=256)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--trace", type=int, default=0, metavar="N",
                    help="serve an N-request mixed-length trace through the "
                    "continuous batcher instead of one lock-step batch")
    ap.add_argument("--trace-seed", type=int, default=0)
    ap.add_argument("--arrival-spacing", type=float, default=0.0,
                    help="seconds between request arrivals (0 = all at once)")
    ap.add_argument("--burst", type=int, default=1,
                    help="requests per arrival group")
    ap.add_argument("--sys-prompt-len", type=int, default=0,
                    help="length of a shared system prompt")
    ap.add_argument("--sys-prompt-frac", type=float, default=0.0)
    ap.add_argument("--prefill-chunk", type=int, default=32,
                    help="most prompt tokens a scheduler tick prefills")
    ap.add_argument("--compare-static", action="store_true",
                    help="also run the trace through the static baseline")
    ap.add_argument("--json-out", default="",
                    help="write the trace statistics to this file")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    device = tfm.resolve_device(args.device)
    scfg = ServeConfig(batch=args.batch, cache_capacity=args.cache,
                       prefill_chunk=args.prefill_chunk)
    params = tfm.init_params(
        torch.Generator(device=device).manual_seed(0), cfg, device)
    eng = ServeEngine(cfg, params, scfg, device)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")

    if args.trace > 0:
        stats = _run_trace(eng, args, cfg.vocab_size)
        stats["device"] = name
        if args.json_out:
            with open(args.json_out, "w") as f:
                json.dump(stats, f, indent=1)
            print(f"wrote {args.json_out}")
        return
    prompts = torch.randint(
        0, cfg.vocab_size, (args.batch, args.prompt_len), device=device,
        generator=torch.Generator(device=device).manual_seed(1))

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    sync()
    t0 = time.perf_counter()
    out = eng.generate(prompts, steps=args.steps)
    sync()
    dt = time.perf_counter() - t0
    print(f"[{name}] generated {args.steps} tokens x {args.batch} requests "
          f"in {dt:.2f}s ({args.steps * args.batch / dt:.1f} tok/s, first "
          f"call: kernel build and warm-up included); "
          f"sample: {out[0, -args.steps:].tolist()}")


if __name__ == "__main__":
    main()
