"""Serving launcher of the port: one lock-step batch, greedy.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-14b \
      --batch 8 --prompt-len 512 --steps 16 --cache 1024

Runs on the GPU unless ``--device cpu`` is given (``--smoke`` makes that
bearable).  Weights are random, drawn on the device from seed 0; prompts
from seed 1.  The reference launcher's ``--mode elk_stream``,
``--prefetch-depth 0`` (planner-derived knobs), ``--trace`` (continuous
batching), ``--fleet`` and ``--pipeline-pod`` are not ported yet
(ROADMAP.md, Queue 1).
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.models import transformer as tfm
from repro_torch.serve.engine import ServeConfig, ServeEngine


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
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    device = tfm.resolve_device(args.device)
    scfg = ServeConfig(batch=args.batch, cache_capacity=args.cache)
    params = tfm.init_params(
        torch.Generator(device=device).manual_seed(0), cfg, device)
    eng = ServeEngine(cfg, params, scfg, device)
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
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"[{name}] generated {args.steps} tokens x {args.batch} requests "
          f"in {dt:.2f}s ({args.steps * args.batch / dt:.1f} tok/s, first "
          f"call: kernel build and warm-up included); "
          f"sample: {out[0, -args.steps:].tolist()}")


if __name__ == "__main__":
    main()
