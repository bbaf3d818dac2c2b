"""Serving launcher of the port, greedy.

Lock-step batch, by default in the reference launcher's default mode
``elk_stream`` with the knobs chosen by the ELK planner on one H100
(``chip/h100.h100_host()``; prints ``ELK scheduler: prefetch_depth=N
prefill_chunk=M``): the layer weights live in pinned host memory and stream
onto the card through a window of N layers:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-14b \
      --batch 8 --prompt-len 512 --steps 16 --cache 1024

``--mode gspmd`` keeps the weights resident; ``--prefetch-depth N`` (N > 0)
sets the window by hand instead of asking the planner.  The MoE configs
(llama4-maverick-400b-a17b, kimi-k2-1t-a32b) stream too: their dense and MoE
layers share the window, each in its own layout, and an MoE layer's experts
are copied after its router, only those it picked, into an expert buffer
sized for the largest pass.  Under ``elk_stream`` the launcher prints the
window and the expert buffer it allocated.  Every architecture id of the
reference serves in both modes: rwkv6-7b (recurrent state, no KV ring) and
hymba-1.5b (SSM state beside the ring) stream like the others; internvl2-1b
and whisper-tiny take stub frontends (256 patch embeddings ahead of the
prompt; 1500 frame embeddings through the encoder), drawn from seed 0 as
the reference's ``generate`` draws them; whisper-tiny, an encoder-decoder
model, is not streamed, as in the reference, and stays resident under
``elk_stream`` (the engine says so), and the continuous batcher refuses it
(no per-slot cache, the reference's ``ValueError``).

Continuous batching over a mixed-length request trace (tok/s + request
latency percentiles, optionally against the static-batching baseline):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-14b \
      --batch 8 --trace 16 --cache 2048 --prefill-chunk 256

Oversubscribed, with KV offload to host memory and prefix reuse: up to K x
the slots in flight, a prefix store of M MB for a shared system prompt
(on one H100 the planner's K is 1, host memory being an unbounded tier, so
K is given):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-14b \
      --batch 8 --trace 24 --cache 2048 --prefill-chunk 256 --oversub 2 \
      --prefix-cache-mb 4096 --sys-prompt-len 512 --sys-prompt-frac 0.5

Runs on the GPU unless ``--device cpu`` is given (``--smoke`` makes that
bearable).  Weights are random, drawn on the device from seed 0 (under
``elk_stream`` one layer at a time, each moved to the host before the
next); prompts from seed 1, traces from ``--trace-seed``.  On the GPU the
process's peak device memory, start-up included, is printed.  ``--kv-dtype
int8`` serves from the reference's int8 KV cache (a bf16 scale a slot and kv
head; the attention kernels read the int8 ring themselves) in every mode
above, and the planner sizes its knobs by that ring's bytes.

A fleet of N pods behind the SLO-aware router, serving the same trace on
the virtual clock after the continuous run (``serve/fleet.py``): N mixed
replicas, or with ``--disagg`` one prefill pod and N - 1 decode pods, each
finished prefill migrating as a host copy of its request cache;
``--ttft-slo-ms`` sheds requests whose predicted TTFT exceeds the target.
The pods share the engine's weights (the resident tensors, or under
``elk_stream`` its one layer stream).  Every pass runs for real; the times
in the fleet's summary are virtual, priced by ``PodCosts``:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-14b \
      --mode gspmd --batch 8 --trace 16 --cache 2048 --prefill-chunk 256 \
      --fleet 2 --disagg

``--pipeline-pod GROUPS`` plans on a TPU v5e pod of GROUPS chip islands
with the joint hybrid search and sizes admission from its steady-state
interval; ``--stacked-gb G`` plans on an SRAM-only IPU pod with G GB of
stacked DRAM (an all-finite hierarchy: the plan's K > 1, a slot-spill cost
and a prefix store).  Both are the reference's modelled pods: the
``steady_interval``, ``slot_spill`` and K they print are the planner's
figures for that pod, not times taken on the H100, where the engine runs
with the knobs they give.  ``--production-mesh`` builds the reference's
(16, 16) mesh, which one GPU cannot host: the run is refused with that
mesh's device-count error.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Optional

import torch

from repro_torch.chip.config import GB, ipu_mk2, tpu_v5e_pod_hier
from repro_torch.chip.h100 import h100_host
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import transformer as tfm
from repro_torch.serve import stream
from repro_torch.serve.engine import ServeConfig, ServeEngine, elk_serve_config


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

    prefix_store = None
    if args.prefix_cache_mb > 0:
        from repro_torch.serve.prefix import PrefixStore
        prefix_store = PrefixStore(args.prefix_cache_mb << 20)
    oversub = args.oversub if args.oversub > 0 else None
    bat = ContinuousBatcher(eng, oversub=oversub, prefix_store=prefix_store)
    t0 = time.perf_counter()
    completions = bat.run(trace)
    stats = {"continuous": summarize(completions, time.perf_counter() - t0)}
    cont = stats["continuous"]
    cont["ticks"] = bat.ticks
    cont["decode_ticks"] = bat.decode_ticks
    cont["oversub"] = round(bat.oversub, 3)
    cont["spill_events"] = len(bat.spill_events)
    cont["planned_spill_s"] = round(bat.planned_spill_s, 6)
    if bat.prefix is not None:
        cont["prefix_hits"] = bat.prefix_hits
        cont["prefix_tokens_saved"] = bat.prefix_tokens_saved
    order = [c.rid for c in completions]
    print(f"continuous: {stats['continuous']}  finish order: {order}")

    if args.compare_static:
        run_static_trace(eng, warm)
        t0 = time.perf_counter()
        static = run_static_trace(eng, trace)
        stats["static"] = summarize(static, time.perf_counter() - t0)
        print(f"static:     {stats['static']}")

    if args.fleet > 0:
        stats["fleet"] = _run_fleet(eng, args, vocab)
        print(f"fleet:      {stats['fleet']}")
    return stats


def _run_fleet(eng: ServeEngine, args, vocab: int, *, trace=None,
               keep: Optional[list] = None) -> dict:
    """Serve the trace (the launcher's, or ``trace``) on an ``--fleet N``
    pod fleet over the virtual clock (scheduling deltas, not wall time): N
    mixed replicas, or ``--disagg`` 1 prefill + N-1 decode pods with
    migrations; ``--ttft-slo-ms`` arms shedding.  The pods share
    ``eng.params``: the resident tensors, or under ``elk_stream`` the one
    ``LayerStream``.  Pods tick one at a time on the host, so one stream
    serves them all, and ``reserve_experts`` only grows its expert buffer,
    so a prefill pod's larger passes over an MoE config are safe.  The
    router is appended to ``keep`` when given (its completions, for a
    caller that checks them)."""
    from repro_torch.serve.batcher import make_trace
    from repro_torch.serve.engine import PREFILL_SAT
    from repro_torch.serve.fleet import FleetPod, FleetRouter, PodCosts

    def pod(role):
        # elk_serve_config's role sizing, on the launcher's scfg
        chunk = eng.scfg.prefill_chunk
        if role == "prefill":
            chunk = min(PREFILL_SAT, eng.scfg.cache_capacity)
        elif role == "decode":
            chunk = min(16, eng.scfg.cache_capacity)
        scfg = dataclasses.replace(eng.scfg, prefill_chunk=chunk)
        return FleetPod(ServeEngine(eng.cfg, eng.params, scfg, eng.device),
                        role, costs=PodCosts.from_serve_config(scfg))

    roles = (["prefill"] + ["decode"] * (args.fleet - 1)
             if args.disagg and args.fleet > 1
             else ["mixed"] * args.fleet)
    router = FleetRouter([pod(r) for r in roles],
                         ttft_slo_s=args.ttft_slo_ms * 1e-3)
    if trace is None:
        trace = make_trace(args.trace, vocab_size=vocab,
                           arrival_spacing_s=args.arrival_spacing,
                           seed=args.trace_seed, burst=args.burst,
                           sys_prompt_len=args.sys_prompt_len,
                           sys_prompt_frac=args.sys_prompt_frac)
    router.run(trace)
    if keep is not None:
        keep.append(router)
    out = router.summary()
    out["disagg"] = bool(args.disagg and args.fleet > 1)
    out["ttft_slo_ms"] = args.ttft_slo_ms
    return out


def serve_config(cfg, args) -> ServeConfig:
    """The launcher's ``ServeConfig``: under ``elk_stream`` with
    ``--prefetch-depth 0`` the knobs the ELK planner chooses for the config
    served, on one H100 (``h100_host``), or on the modelled pod that
    ``--pipeline-pod`` / ``--stacked-gb`` name (the reference's); printed
    as the reference's launcher prints them.  Else the knobs given."""
    if args.mode == "elk_stream" and args.prefetch_depth <= 0:
        pod = h100_host()
        if args.pipeline_pod > 0:
            pod = tpu_v5e_pod_hier(groups=args.pipeline_pod)
        elif args.stacked_gb > 0:
            pod = ipu_mk2().with_stacked_dram(int(args.stacked_gb * GB))
        scfg = elk_serve_config(cfg, batch=args.batch,
                                cache_capacity=args.cache,
                                kv_dtype=args.kv_dtype,
                                pipeline=args.pipeline_pod > 0, pod=pod)
        msg = (f"ELK scheduler: prefetch_depth={scfg.prefetch_depth} "
               f"prefill_chunk={scfg.prefill_chunk}")
        if scfg.steady_interval_s:
            msg += (f" steady_interval="
                    f"{scfg.steady_interval_s * 1e3:.3f}ms")
        if scfg.oversub > 1.0:
            msg += (f" oversub K={scfg.oversub:.2f} "
                    f"slot_spill={scfg.slot_spill_s * 1e6:.1f}us "
                    f"prefix_cache={scfg.prefix_cache_bytes >> 20}MB")
        if args.pipeline_pod > 0 or args.stacked_gb > 0:
            msg += (f" (planned on the modelled pod {pod.name}; the "
                    "planner's figures for that pod, not times taken on "
                    "the H100)")
        print(msg)
        if args.prefill_chunk:
            scfg.prefill_chunk = args.prefill_chunk
        return scfg
    return ServeConfig(batch=args.batch, cache_capacity=args.cache,
                       mode=args.mode,
                       prefetch_depth=max(args.prefetch_depth, 1),
                       kv_dtype=args.kv_dtype,
                       prefill_chunk=args.prefill_chunk or 32)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True,
                    help=f"one of {ARCH_IDS} (dashed aliases ok)")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--mode", default="elk_stream",
                    choices=["gspmd", "elk_stream"])
    ap.add_argument("--prefetch-depth", type=int, default=0,
                    help="0 = ask the ELK scheduler (core.integration) on "
                    "one H100 (chip.h100.h100_host)")
    ap.add_argument("--pipeline-pod", type=int, default=0, metavar="GROUPS",
                    help="plan on a modelled TPU v5e pod of GROUPS chip "
                    "islands with the joint hybrid search and size admission "
                    "from its steady-state interval (0 = one H100)")
    ap.add_argument("--stacked-gb", type=float, default=0.0,
                    help="plan on a modelled SRAM-only IPU pod with this "
                    "much stacked DRAM (an all-finite hierarchy: K > 1, KV "
                    "offload and a prefix store)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--cache", type=int, default=256)
    ap.add_argument("--kv-dtype", default="bfloat16",
                    choices=["bfloat16", "int8"])
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
    ap.add_argument("--oversub", type=float, default=0.0,
                    help="admission multiplier K over the physical slots, "
                    "requests beyond them parked in host memory (0 = the "
                    "plan's K, which is 1 on one H100)")
    ap.add_argument("--prefix-cache-mb", type=int, default=0,
                    help="prefix-KV store budget in MB, in host memory "
                    "(0 = the plan's, none on one H100)")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="most prompt tokens a scheduler tick prefills (0 = "
                    "the planner's under elk_stream with --prefetch-depth 0, "
                    "else 32)")
    ap.add_argument("--compare-static", action="store_true",
                    help="also run the trace through the static baseline")
    ap.add_argument("--fleet", type=int, default=0, metavar="N",
                    help="also serve the trace on an N-pod fleet behind the "
                    "SLO-aware router, ticked on the virtual clock")
    ap.add_argument("--disagg", action="store_true",
                    help="disaggregate the --fleet pods: 1 prefill pod + "
                    "N-1 decode pods with priced KV migrations (default: N "
                    "mixed replicas)")
    ap.add_argument("--ttft-slo-ms", type=float, default=0.0,
                    help="shed fleet requests whose predicted TTFT exceeds "
                    "this target (0 = admit everything)")
    ap.add_argument("--json-out", default="",
                    help="write the trace statistics to this file")
    ap.add_argument("--production-mesh", action="store_true",
                    help="the reference's (16, 16) mesh: needs 256 "
                    "devices, refused on one GPU")
    return ap.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.production_mesh:
        make_production_mesh().devices           # raises: 256 devices
    device = tfm.resolve_device(args.device)
    # plan against the config actually served
    scfg = serve_config(cfg, args)
    gen = torch.Generator(device=device).manual_seed(0)
    if stream.streams(cfg, scfg.mode):
        # each layer goes to pinned host memory as it is drawn: the card
        # never holds the decoder, so a model larger than the card serves
        params = stream.init_streamed_params(gen, cfg, device,
                                             scfg.prefetch_depth)
    else:
        params = tfm.init_params(gen, cfg, device)
    eng = ServeEngine(cfg, params, scfg, device)
    if eng.streamed:
        ls = eng.params["layers"]
        print(f"elk_stream: prefetch_depth={scfg.prefetch_depth}; window of "
              f"{ls.depth} buffers of {ls.layer_bytes} bytes; expert buffer "
              f"of {ls.expert_slots} experts of {ls.expert_bytes} bytes; "
              f"{ls.host_bytes} bytes of host memory")
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")

    if args.trace > 0:
        stats = _run_trace(eng, args, cfg.vocab_size)
        stats["device"] = name
        if device.type == "cuda":
            stats["max_memory_allocated_bytes"] = (
                torch.cuda.max_memory_allocated(device))
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
    peak = (f"; peak device memory {torch.cuda.max_memory_allocated(device)}"
            " bytes" if device.type == "cuda" else "")
    print(f"[{name}] generated {args.steps} tokens x {args.batch} requests "
          f"in {dt:.2f}s ({args.steps * args.batch / dt:.1f} tok/s, first "
          f"call: kernel build and warm-up included){peak}; "
          f"sample: {out[0, -args.steps:].tolist()}")


if __name__ == "__main__":
    main()
