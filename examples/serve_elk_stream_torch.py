"""Serve a model with the PyTorch port's ELK weight-streaming engine and
check that the gather-ahead window (the paper's preload number, chosen by
the port's copy of the ELK scheduler) changes scheduling but never results.

    PYTHONPATH=src python examples/serve_elk_stream_torch.py [--device cpu]

Runs on the GPU (the port's hand-written kernels) unless ``--device cpu``
is given (the plain PyTorch path).  The weights are random, from seed 0.
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.chip.h100 import h100_host
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.integration import pod_plan
from repro_torch.models import transformer as tfm
from repro_torch.serve.engine import ServeConfig, ServeEngine

ARCH = "llama4_maverick_400b_a17b"      # MoE: experts are late-bound preloads


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = tfm.resolve_device(args.device)

    # 1. ask the ELK compiler for the knobs of the full config on one H100
    knobs = pod_plan(get_config(ARCH), batch=8, seq=2048, phase="decode",
                     chip=h100_host())
    print(f"ELK scheduler decisions for {ARCH} on one H100:")
    print(f"  prefetch_depth (preload number) = {knobs.prefetch_depth}")
    print(f"  resident_fraction (preload-state f) = "
          f"{knobs.resident_fraction:.3f} -> fsdp={knobs.fsdp}")

    # 2. serve the smoke-scale config with those knobs, resident and streamed
    cfg = get_smoke_config(ARCH)
    params = tfm.init_params(torch.Generator(device=device).manual_seed(0),
                             cfg, device)
    prompts = torch.randint(
        0, cfg.vocab_size, (4, 12), device=device,
        generator=torch.Generator(device=device).manual_seed(1))

    outs = {}
    for mode in ("gspmd", "elk_stream"):
        eng = ServeEngine(cfg, params, ServeConfig(
            batch=4, cache_capacity=64, mode=mode,
            prefetch_depth=max(knobs.prefetch_depth, 1)), device)
        outs[mode] = eng.generate(prompts, steps=8).cpu()
        print(f"{mode:11s}: {outs[mode][0, -8:].tolist()}")

    assert torch.equal(outs["gspmd"], outs["elk_stream"])
    print("gather-ahead streaming == resident baseline: exact match")


if __name__ == "__main__":
    main()
