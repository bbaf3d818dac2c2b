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
3. kernels  holds each hand-written kernel (fused MLP, decode attention,
            flash attention, the ELK-blocked matmul of every projection and
            the LM head) against its plain PyTorch version on the card, at
            the reference's sweep shapes, at the edges of every route of
            the matmul and the MLP, and at the shapes the serving paths
            give it, and times kernel, plain version and a library
            yardstick with CUDA events; every kernel launches each sweep
            case twice and must give equal bits; the timed shapes print the
            route they took (the attention kernels also their splits and
            blocks, decode attention its FMA route beside),
            and the matmul its plan (tiles,
            stages, splits) and its host time a call beside
            ``torch.matmul``'s; the MLP is timed on both routes at the rows
            around its crossover R.  Both attention kernels also over an
            int8 ring (dequantized in the kernel, every route, held to the
            plain versions, which dequantize first), timed at the serving
            shapes beside the bf16 kernel (flash's at both block widths
            and every split count), and ``kv_quant`` (the int8 ring's
            quantization, K's rope folded in) bit for bit against
            ``apply_rope``, ``quantize_kv`` and its scatter.
4. parity   every smoke config (all of ``ARCH_IDS``) in fp32 on the same
            seeded weights, on the CPU
            (plain path) and on the card (kernel path), with resident
            weights (``gspmd``) and streamed ones (``elk_stream``, MoE
            configs with their experts fetched after the router):
            ``ServeEngine``'s lock-step ``generate`` and
            ``ContinuousBatcher.run`` over a mixed trace give equal greedy
            tokens; last logits close.  The qwen3 smoke config also over
            an int8 ring (``kv_dtype`` int8), and through fleets on the
            virtual clock (``serve/fleet.py``): one mixed pod, equal to
            ``run_virtual_trace`` of a direct batcher, and a prefill pod
            and a decode pod with every request migrating (the pods of a
            streamed fleet on one ``LayerStream``): tokens, virtual times,
            summaries and migration events equal on CPU and card, resident
            and streamed.  Then ``[emulator]``: the card's DSMEM rate
            measured by the probe of ``chip/dsmem.py`` beside
            ``h100_sxm()``'s ``link_bw``, and
            ``chip/emulator.check_plan_numerics`` on the card over the
            plans of every matmul op of layer 0 of qwen3-14b's decode graph
            on ``h100_sxm()``.
5. serve    lock-step, resident weights: full-width qwen3-14b (bf16,
            random weights from seed 0), batch 8, prompts of 512 tokens,
            16 greedy steps through ``ServeEngine.generate``.
6. serve-trace  continuous batching, resident weights: the same model and
            weights, 8 slots of 2048, 16 mixed requests (prompts 128-1024,
            16-64 new tokens) through ``ContinuousBatcher.run``.
7. oversub  continuous batching oversubscribed, resident weights: the same
            slots serve 24 requests (the trace of 6, a shared system prompt
            of 512 tokens on about half) with K = 2 (rings parked in host
            memory, LRU swaps) and a prefix store, then at K = 1 with no
            store; equal tokens, at least one swap and one prefix hit, and
            the offload, refill and snapshot copy rates.
7b. int8    5, 6 and 7 again over the int8 ring: the cache's bytes (the
            int8 ring and its scales exactly), the last logits within rel
            0.15 of the bf16 ring's, no ring widened in a decode step (what
            it allocates beyond the step before stays under one layer's
            bf16 ring), the launches by route and by the K/V type the
            attention kernels read; one ``[int8]`` line, and before it the
            lock-step decode step alone (``[int8-step]``: ms a step and the
            device kernels a step, by the profiler).
8. stream-serve  the launcher's default path: the same model and weights,
            cut to STREAM_DEPTH (20) of its 40 layers for the time limit,
            under ``elk_stream``, knobs from ``elk_serve_config`` on
            ``h100_host()``, the layer weights in pinned host memory and
            streamed through the planner's window; lock-step as in 5 and a
            short continuous trace (4 of the requests of 6), with the
            host-to-card copy rate, the copy time of all layers alone and a
            decode step at a window of 1 beside the planner's.
9. models   the paper's Table 2 models, the MoE family and the other dense
            configs at full width, random weights from seed 0 (biases
            drawn nonzero), each freed before the next:
            dit-xl (28 layers, head dim 72), gemma2-27b (46 layers, tied
            head of 256000), gemma-7b (28 layers, 16 heads of 256 with
            G 1, GeGLU 24576, tied head of 256000), llama2-13b (40 layers,
            40/40 heads of 128), opt-30b (48 layers, 56/56 heads of 128,
            qkv biases, a plain relu MLP of 28672 with fc biases),
            qwen1.5-32b (QWEN15_DEPTH of its 64 layers, qkv biases, untied
            head of 152064) and h2o-danube-1.8b (24 layers, 32/8 heads of
            80, window 4096, prompts of 4608 in a ring of 8192) resident,
            lock-step as in 5 (dit-xl: prompts of 256, cache 512); the
            last four also at 2 layers of the same weights, a prefill and
            3 decode steps on the kernels and on the plain path, each
            pass's logits within 3e-2 (relative Frobenius); llama2-70b under
            ``elk_stream`` with the planner's knobs, resident against
            streamed at 8 layers (16 until the dry run came) on the same
            weights (equal tokens);
            llama4-maverick and kimi-k2 resident at 2 layers (a dense layer
            and an MoE layer of 128 / 384 experts), lock-step, and kimi-k2
            (head dim 112) through the 16-request continuous trace of 6.
            One ``[models]`` line a config: depth, parameter bytes, peak
            device memory, prefill ms, decode ms a step, tokens/s; then
            each kernel product of layer 0 and of the first MoE layer, and
            the LM head, held to its plain version on the live weights.
            Then both MoE configs under ``elk_stream`` with the planner's
            knobs: the resident run's weights moved into the layer stream
            (every product on the same route streamed as resident; equal
            greedy tokens, 4 new), each MoE layer's experts fetched after
            its router: one ``[stream-moe]`` line a config with the depth,
            pinned bytes, window and expert buffer, peak device memory,
            prefill and decode ms, and three decode steps' bytes copied
            (window and experts apart, beside the whole layers'), experts
            fetched and GB/s.  A streamed continuous trace of MoE on the
            card is optional and not run (a kimi-k2 chunk of 32 tokens
            touches up to 256 of 384 experts); the parity phase runs the
            MoE smoke configs streamed through the batcher.
10. families  the four remaining families at full width and full depth
            (rwkv6-7b at RWKV_DEPTH of its 32 layers, for the time limit),
            random weights from seed 0, each freed before the next
            (``FAMILY_RUNS``): rwkv6-7b (RWKV6, a recurrent state and no KV
            ring) resident lock-step as in 5, then the first 8 requests of
            6's trace through the continuous batcher, then under
            ``elk_stream`` with the planner's knobs (the resident weights
            moved into the layer stream), 4 new tokens equal to the resident
            run's; hymba-1.5b (attention with window 1024 in a ring of 2048
            and a parallel SSM branch) lock-step, then 6's 16-request trace;
            internvl2-1b (256 stub patch embeddings ahead of the prompts,
            ring 1024, G 7) lock-step, then streamed, 4 tokens equal;
            whisper-tiny (1500 stub frames through the encoder, prompts of
            64, ring 512) lock-step, then under ``elk_stream``, which keeps
            an encoder-decoder model resident as the reference does.  One
            ``[families]`` line a config: depth, parameter bytes, peak
            device memory, prefill ms, decode ms a step, tokens/s, and from
            ``torch.profiler`` a prefill's and a decode step's device time
            split between the port's kernels and PyTorch's own (for rwkv:
            the products against the recurrence, its launches counted).

11. train  outside inference mode, the training side: the three backward
            kernels (``elk_matmul``'s x^T dy and its two-part sum,
            ``fused_mlp_bwd``, ``flash_attention_bwd``) held against their
            plain backward versions over bf16 and fp32 sweeps on every route
            (attention: "wgmma", "mma_sync" and "fma"; causal, window,
            bidirectional, cross with Sq != Sk, G 1-8, D 16-256, S no
            multiple of 64, rings that wrap; the MLP: "fused" and "fma",
            ragged m and ff; the forward's log-sum-exp
            beside it, and the fused pass's h against the forward's bit for
            bit), each case launched twice with equal bits, and timed at
            qwen3-14b's training shapes (4096 tokens; attention also at S
            4096), dit-xl's plain MLP and D 72 attention, kimi-k2's D 112
            attention, D 64's, and gemma-7b's D 256 (B 8 x S 512 and B 1 x
            S 4096), beside the plain versions and a library
            yardstick, the MLP's each launch alone; one fp32 training step (loss
            and every gradient) of every smoke config on the card against
            the CPU; the smoke trainer (the loss falls; a crash and a
            restart from the checkpoint equal the uninterrupted run bit for
            bit; the launcher runs); then qwen3-14b at full width and
            TRAIN_DEPTH (4) of its 40 layers, bf16, B 8 x S 512, remat, 6
            AdamW steps through ``Trainer``: one ``[train]`` line with the
            losses, step ms, tokens/s, peak memory, launches in all and by
            route, and layer 0's and the LM head's gradients against the
            plain versions'; then gemma-7b the same way at GEMMA_TRAIN_DEPTH
            (4) of its 28 layers, GEMMA_TRAIN_STEPS (3) steps (head dim 256
            on the backward's "wgmma" route, GeGLU, the tied head), its
            launches the "train gemma-7b" path.
12. dryrun  the dry run (``launch/dryrun.py``): every (arch, shape) cell of
            ``launch/specs.all_cells`` (15 x 4) counted on the meta device
            on the single-pod mesh, in worker processes (no cell in error;
            exactly the reference's ineligible cells skipped), while four
            cells run on the card at full width at the reference's two
            reduced depths, extrapolated to full depth (``DRYRUN_MEASURED``:
            qwen3-14b decode_32k, streamed over an int8 ring of 32768,
            prefill_32k and train_4k at the batch that fits, hymba-1.5b
            long_500k): one ``[dryrun]`` line each with the counted FLOPs
            and bytes, ``model_flops``, the bound and its term, ms and peak
            bytes at both depths, the full-depth ms, memory and fit, the
            roofline fraction at the measured time and the cuts; it fails
            where a variant runs under its counted bound, where the card's
            argument bytes differ from ``local_bytes``, or where the count's
            product FLOPs differ from what ``model_flops`` explains.

Each serving path runs with the kernels' launch counts set to 0 just
before it and read just after, and fails if a kernel of the path was not
launched as often as its layers, steps and chunks say, or the MLP and the
matmul not through the routes their rows say, or the attention kernels not
over the K/V type the path gives them.  Every phase prints its seconds
(``[time]``).  Phase 3 also holds every
kernel at every shape phases 9 and 10 give it (``MODEL_RUNS`` and
``FAMILY_RUNS``: each config's products, MLPs and attention at its decode,
prefill and chunk rows, head dims 72 and 112, GQA groups of 7, whisper's
bidirectional encoder and cross-attention with Sq != Sk, fp32 products and
odd vocabularies included), each with a timed row, and phase 4 runs the
smoke configs of phases 9 and 10 too.  Then one JSON line
about the kernels, the card's name and power limit, and as the last line
``{"ok": true, "device": {...}}``.

Bounds use datasheet constants of the H100 SXM: 3.35 TB/s of device
memory, 989 TFLOP/s dense bf16 on the tensor cores, 67 TFLOP/s fp32.
``--layers N`` cuts the depth of the lock-step serve phase (never the
width, never the continuous paths).  ``--profile`` adds a ``torch.profiler``
trace of three lock-step decode steps, one prefill and three slot-batched
steps, and of one streamed decode step: the device's busy time and idle
share, the kernels that take the most device time, and for the streamed
step how much of the weight copies' time compute hides; printed and
written to ``build/profile/``; and of three kimi-k2 decode steps and a
prefill, with the expert products' share of the device time, and of one
streamed kimi-k2 decode step, its expert copies apart from the window's
(how long they waited behind window copies).
``--only kernels`` runs the build and the kernel phases, ``--only models``
the build, the parity, the ``[models]`` and the ``[families]`` phases,
``--only train`` the build and the ``[train]`` phase, ``--only dryrun`` the
build and the ``[dryrun]`` phase, ``--only int8step`` the build and
``[int8-step]`` (none prints a result line): the loops for working on one
part.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import dataclasses
import gc
import importlib.metadata
import json
import multiprocessing
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.chip.dsmem import measure_dsmem  # noqa: E402
from repro_torch.chip.emulator import check_plan_numerics  # noqa: E402
from repro_torch.chip.h100 import (XT_RESIDENT, XT_TILES,  # noqa: E402
                                   h100_host, h100_sxm, smem_plan,
                                   xt_schedule, xt_stages)
from repro_torch.chip.simulator import simulate_fleet_traffic  # noqa: E402
from repro_torch.chip.topology import fleet_spec  # noqa: E402
from repro_torch.configs import (ARCH_IDS, get_config,  # noqa: E402
                                 get_smoke_config)
from repro_torch.data.pipeline import DataConfig  # noqa: E402
from repro_torch.core.graph import build_graph  # noqa: E402
from repro_torch.core.partition import (  # noqa: E402
    enumerate_exec_plans, enumerate_preload_plans)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.decode_attention import \
    kernel as decode_kernels  # noqa: E402
from repro_torch.kernels.decode_attention.kernel import (  # noqa: E402
    MMA_HEAD_DIMS as DECODE_MMA_HEAD_DIMS, ROUTES as DECODE_ROUTES,
    decode_attention_kernel)
from repro_torch.kernels.decode_attention.kernel import \
    plan_for as decode_plan_for  # noqa: E402
from repro_torch.kernels.decode_attention.ops import decode_attn  # noqa: E402
from repro_torch.kernels.decode_attention.ref import (  # noqa: E402
    decode_attention_ref, live_mask)
from repro_torch.kernels.elk_matmul.kernel import (  # noqa: E402
    ROUTES as MATMUL_ROUTES, elk_matmul_kernel, plan_for, plan_of,
    xt_capacity)
from repro_torch.kernels.elk_matmul.kernel import \
    route_for as matmul_route_for  # noqa: E402
from repro_torch.kernels.elk_matmul.kernel import \
    layout as matmul_layout  # noqa: E402
from repro_torch.kernels.elk_matmul.kernel import \
    route_of as matmul_route_of  # noqa: E402
from repro_torch.kernels.elk_matmul.ops import matmul  # noqa: E402
from repro_torch.kernels.elk_matmul.ref import (matmul2_ref,  # noqa: E402
                                                matmul_ref)
from repro_torch.kernels.flash_attention import ref as flash_ref  # noqa: E402
from repro_torch.kernels.flash_attention import \
    kernel as flash_kernels  # noqa: E402
from repro_torch.kernels.flash_attention.kernel import (  # noqa: E402
    PADDED_HEAD_DIMS, ROUTES as FLASH_ROUTES, flash_attention_bwd_kernel,
    flash_attention_kernel)
from repro_torch.kernels.flash_attention.kernel import \
    bwd_route_of as flash_bwd_route_of  # noqa: E402
from repro_torch.kernels.flash_attention.kernel import \
    route_for as flash_route_for  # noqa: E402
from repro_torch.kernels.flash_attention.kernel import \
    plan_splits as flash_plan_splits  # noqa: E402
from repro_torch.kernels.flash_attention.kernel import \
    route_of as flash_route_of  # noqa: E402
from repro_torch.kernels.flash_attention.ops import (  # noqa: E402
    flash_attn, flash_attn_pos)
from repro_torch.kernels.fused_mlp import \
    kernel as fused_mlp_kernels  # noqa: E402
from repro_torch.kernels.fused_mlp.kernel import (  # noqa: E402
    ROUTES as MLP_ROUTES, SPLIT_FF_MAX_M, fused_mlp_bwd_kernel,
    fused_mlp_kernel)
from repro_torch.kernels.fused_mlp.kernel import \
    bwd_route_of as mlp_bwd_route_of  # noqa: E402
from repro_torch.kernels.fused_mlp.kernel import \
    route_of as mlp_route_of  # noqa: E402
from repro_torch.kernels.fused_mlp.ops import fused_mlp  # noqa: E402
from repro_torch.kernels.fused_mlp.ref import (  # noqa: E402
    ACTS as MLP_ACTS, act_fn, composed_ref, fused_mlp_bwd_ref)
from repro_torch.kernels.kv_quant.kernel import (  # noqa: E402
    KV_TYPES, kv_quant_kernel, _rope_tables as kv_quant_tables)
from repro_torch.kernels.kv_quant.ref import (  # noqa: E402
    quantize_into_ref, quantize_kv)
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import serve as launcher  # noqa: E402
from repro_torch.launch.specs import SHAPES, all_cells  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import rwkv as rwkv_mod  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.frontends import frontend_embeddings  # noqa: E402
from repro_torch.models.layers import (apply_rope, rms_norm,  # noqa: E402
                                       rope_tables)
from repro_torch.serve import batcher as batcher_mod  # noqa: E402
from repro_torch.serve.batcher import (ContinuousBatcher,  # noqa: E402
                                       _chunk_len, make_trace, summarize)
from repro_torch.serve.engine import (PREFILL_SAT, ServeConfig,  # noqa: E402
                                      ServeEngine, elk_serve_config,
                                      kv_ring_bytes)
from repro_torch.serve.fleet import (FleetPod, FleetRouter,  # noqa: E402
                                     PodCosts, VirtualClock,
                                     run_virtual_trace)
from repro_torch.serve.prefix import (PrefixStore, host_copy,  # noqa: E402
                                      state_bytes)
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig  # noqa: E402
from repro_torch.serve.stream import (LayerStream, _leaves,  # noqa: E402
                                      init_streamed_params, streams)
from repro_torch.train.step import make_loss_fn, value_and_grad  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402
from repro_torch.tree import (tree_items, tree_leaves,  # noqa: E402
                              tree_map, tree_unflatten)

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
# dit-xl in the [models] phase: prompts of 256 latent patches
DIT_PROMPT_LEN, DIT_CACHE = 256, 512

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

# (B, Hq, Hkv, S, D, causal, window): the reference's flash-attention sweep
FLASH_SWEEP = [
    (2, 4, 2, 128, 32, True, 0),       # GQA causal
    (1, 4, 4, 128, 16, True, 48),      # MHA sliding window
    (1, 2, 1, 64, 32, False, 0),       # bidirectional MQA
    (1, 8, 8, 256, 64, True, 0),       # MHA causal, bigger head
]
# the streamed trace: the first requests of the resident one
STREAM_TRACE_N = 4
# the oversubscribed phase: the trace's lengths, a shared system prompt on
# about half of 24 requests, K = 2 over the 8 slots, a prefix store of 8 GiB
# in host memory (24 ring snapshots of 335 MB at full width)
OVERSUB_N, OVERSUB, SYS_PROMPT_LEN = 24, 2.0, 512
PREFIX_STORE_BYTES = 8 << 30
# (M, N, K): the reference's elk_matmul sweep
MATMUL_SWEEP = [(128, 128, 128), (256, 64, 512), (100, 60, 70),
                (33, 129, 257)]
# rows at the edges of the routes of both products (1, a decode step, the
# 16-row tiling, the 64 rows of a wgmma, a chunk); with n and K ragged
# against the tiles and n != K, so that a transposed operand shows
MATMUL_EDGE_M = (1, 8, 16, 17, 63, 64, 65, 256)
MATMUL_EDGE_NK = (200, 328)
MLP_EDGE_M = (1, 8, 16, 17, 63, 64, 65, 256)
# fused_mlp rows timed on both routes to find the crossover R
CROSSOVER_M = (8, 16, 32, 64, 128, 256)
# the [models] phase's lock-step runs at full width: (arch, layers (0: all),
# prompt length, ring).  llama2-70b runs resident against streamed
# (STREAM_STEPS tokens) at STREAM_CHECK_LAYERS (16 until the [dryrun] phase
# came, for the time limit); the MoE models run at
# MOE_DEPTH layers (a dense and an MoE layer), resident against streamed;
# TRACE_ARCH also serves the continuous trace.  (Until the int8 phase came,
# each was then streamed alone at the depth the host holds: 45, 5 and 3
# layers, about 160 s of the time limit.)
STREAM_CHECK_LAYERS, STREAM_STEPS = 8, 4
MOE_DEPTH = 2
# llama2-13b and opt-30b (the paper's Table 2) and qwen1.5-32b resident at
# full width, qwen1.5-32b at QWEN15_DEPTH of its 64 layers: all 64 are 70.4
# GB of bf16 weights, with the ring 81.1 GB of the card's 85.5, which leaves
# no room for a prefill; h2o-danube-1.8b past its window of 4096: prompts of
# DANUBE_PROMPT_LEN positions in a ring of DANUBE_CACHE, so that its prefill
# is windowed and every decode step attends to the last 4096 positions of a
# ring wider than the window
QWEN15_DEPTH = 56
DANUBE_PROMPT_LEN, DANUBE_CACHE = 4608, 8192
MODEL_RUNS = (("dit_xl", 0, DIT_PROMPT_LEN, DIT_CACHE),
              ("gemma2_27b", 0, PROMPT_LEN, CACHE),
              ("gemma_7b", 0, PROMPT_LEN, CACHE),
              ("llama2_13b", 0, PROMPT_LEN, CACHE),
              ("opt_30b", 0, PROMPT_LEN, CACHE),
              ("qwen1_5_32b", QWEN15_DEPTH, PROMPT_LEN, CACHE),
              ("h2o_danube_1_8b", 0, DANUBE_PROMPT_LEN, DANUBE_CACHE),
              ("llama2_70b", STREAM_CHECK_LAYERS, PROMPT_LEN, CACHE),
              ("llama4_maverick_400b_a17b", MOE_DEPTH, PROMPT_LEN, CACHE),
              ("kimi_k2_1t_a32b", MOE_DEPTH, PROMPT_LEN, CACHE))
TRACE_ARCH = "kimi_k2_1t_a32b"
# the configs of MODEL_RUNS also served at PLAIN_LAYERS layers on the
# kernels and on the plain path (``plain_check``): a prefill and PLAIN_STEPS
# decode steps, each pass's bf16 logits within PLAIN_LOGITS_TOL (relative
# Frobenius error) of the plain path's
PLAIN_CHECK_ARCHS = ("llama2_13b", "opt_30b", "qwen1_5_32b",
                     "h2o_danube_1_8b")
PLAIN_LAYERS, PLAIN_STEPS = 2, 3
# init_params draws every bias as zeros; the [models] runs of a config with
# biases fill them with seeded normals x BIAS_SCALE first (``fill_biases``),
# as the CPU parity tests do, so that a bias the kernels misplaced shows
BIAS_SCALE = 0.1
# the [families] phase: the four remaining families at full width and depth,
# (arch, layers (0: all), prompt length, ring) as MODEL_RUNS; whisper's
# prompts of 64 tokens against 1500 frames.  rwkv6-7b, the largest path of
# the run (112.2 s at its 32 layers on an H100 80GB HBM3 at 700 W), runs at
# RWKV_DEPTH layers so that the run stays well inside its time limit: 16
# since the [fleet] phase came (78.2 s of an 850.0 s run), 8 since the four
# configs of PLAIN_CHECK_ARCHS came
WHISPER_PROMPT_LEN, WHISPER_CACHE = 64, 512
RWKV_DEPTH = 8
FAMILY_RUNS = (("rwkv6_7b", RWKV_DEPTH, PROMPT_LEN, CACHE),
               ("hymba_1_5b", 0, PROMPT_LEN, SLOT_CACHE),
               ("internvl2_1b", 0, PROMPT_LEN, CACHE),
               ("whisper_tiny", 0, WHISPER_PROMPT_LEN, WHISPER_CACHE))
# the families that serve requests of phase 6's trace (how many), and those
# streamed against their resident run
FAMILY_TRACE_N = {"rwkv6_7b": 8, "hymba_1_5b": TRACE_N}
FAMILY_STREAMED = ("rwkv6_7b", "internvl2_1b")
RUNS = MODEL_RUNS + FAMILY_RUNS
# the stream phase serves qwen3-14b at STREAM_DEPTH of its 40 layers (since
# the [train] phase came, for the time limit), its tokens held to the
# resident weights cut to the same depth
STREAM_DEPTH = 20
TRACE_ARCHS = (TRACE_ARCH, *FAMILY_TRACE_N)
# the matmul routes that replaced "mma_sync" at some shapes (timed beside it)
NEW_MATMUL_ROUTES = ("wgmma_realign", "splitk_realign", "fma", "fma_splitk")
# products that run in fp32 on a bf16 model (hymba's w_dt and w_bc)
FP32_PRODUCTS = ("ssm dt", "ssm bc")
# the SSM weights ``models/ssm.ssm_branch`` casts to fp32 on every pass
SSM_FP32_CASTS = ("w_dt", "dt_bias", "w_bc", "a_log", "d_skip")


def model_cfg(arch: str, depth: int):
    full = get_config(arch)
    return dataclasses.replace(full, num_layers=depth) if depth else full


def seq_len(cfg, prompt_len: int) -> int:
    """Positions a prefill of ``prompt_len`` tokens fills: a VLM's patches
    go ahead of the prompt."""
    return prompt_len + (cfg.vision_patches
                         if cfg.frontend == "vision_stub" else 0)


def trace_chunks() -> list[tuple[int, int]]:
    """(tokens, start) of the prefill chunks the batcher cuts the
    continuous trace's prompts into: each length once, at its first
    start."""
    out = {}
    for r in make_trace(TRACE_N, vocab_size=2, **TRACE):
        off = 0
        while off < len(r.prompt):
            t = _chunk_len(len(r.prompt) - off, PREFILL_CHUNK)
            out.setdefault(t, off)
            off += t
    return sorted(out.items())


def model_rows(arch: str, prompt_len: int) -> dict:
    """Rows the [models] and [families] phases give ``arch``: its layers
    (a lock-step decode step and prefill, a VLM's patches included; on
    the trace archs also each chunk length of the trace, whose decode
    ticks have SLOTS = BATCH rows), its LM head (a lock-step pass; on the
    trace archs also a chunk's last token) and an enc-dec model's encoder
    (a lock-step prefill's frames)."""
    cfg = get_config(arch)
    layers, head = [BATCH, BATCH * seq_len(cfg, prompt_len)], [BATCH]
    if arch in TRACE_ARCHS:
        layers += [t for t, _ in trace_chunks()]
        head.append(1)
    return {"layer": list(dict.fromkeys(layers)), "head": head,
            "encoder": [BATCH * cfg.encoder_seq] if cfg.encoder_layers
            else []}


def layer_products(cfg) -> list[tuple[str, int, int, int, int, str]]:
    """The products ``layers.linear`` gives elk_matmul in a pass of
    ``cfg``: (name, K, N, row stride of the weight, how many a pass, whose
    rows: "layer" the pass's, "encoder" a prefill's frames, "head" the LM
    head's); an RWKV layer's six d x d products of its time mix and the
    two of its channel mix; a hybrid layer's SSM branch (``FP32_PRODUCTS``
    in fp32); an enc-dec model's cross-attention (q, o at the pass's rows;
    k, v of the frames at prefill) and encoder layers; the LM head last,
    once a pass (tied: the transposed embedding, row stride K)."""
    kinds = tfm.layer_kinds(cfg)
    layers, moe = len(kinds), kinds.count("moe")
    d, hd, ff = cfg.d_model, cfg.resolved_head_dim, cfg.d_ff
    q, kv = cfg.num_heads * hd, cfg.num_kv_heads * hd
    head = [("lm_head", d, cfg.vocab_size,
             d if cfg.tie_embeddings else cfg.vocab_size, 1, "head")]
    if cfg.rwkv:
        return [("r, k, v, g, decay, o", d, d, d, 6 * layers, "layer"),
                ("channel mix in", d, ff, ff, layers, "layer"),
                ("channel mix out", ff, d, d, layers, "layer")] + head
    out = [("q", d, q, q, layers, "layer"),
           ("k, v", d, kv, kv, 2 * layers, "layer"),
           ("o", q, d, d, layers, "layer"),
           ("router", d, cfg.moe_experts, cfg.moe_experts, moe, "layer")]
    if cfg.hybrid_parallel_ssm:
        n2 = 2 * cfg.ssm_state
        out += [("ssm in", d, 2 * d, 2 * d, layers, "layer"),
                ("ssm dt", d, d, d, layers, "layer"),
                ("ssm bc", d, n2, n2, layers, "layer"),
                ("ssm out", d, d, d, layers, "layer")]
    if cfg.encoder_layers:
        enc = cfg.encoder_layers
        out += [("cross q", d, q, q, layers, "layer"),
                ("cross o", q, d, d, layers, "layer"),
                ("cross k, v", d, kv, kv, 2 * layers, "encoder"),
                ("encoder q", d, q, q, enc, "encoder"),
                ("encoder k, v", d, kv, kv, 2 * enc, "encoder"),
                ("encoder o", q, d, d, enc, "encoder")]
    return out + head


def product_dtype(name: str) -> torch.dtype:
    return torch.float32 if name in FP32_PRODUCTS else torch.bfloat16


def mlp_bias(cfg) -> bool:
    """Whether ``cfg``'s MLPs carry fc biases (``b_up``, ``b_down``): a
    plain MLP of a config with ``qkv_bias``, as ``layers.mlp_params`` draws
    them (opt-30b)."""
    return cfg.qkv_bias and not cfg.gated_mlp


def layer_mlps(cfg) -> list[tuple[str, int, int, str]]:
    """(name, hidden width, how many a pass, whose rows) of the MLPs a pass
    of ``cfg`` gives fused_mlp: a dense layer's, an MoE layer's shared
    expert, an encoder layer's (a prefill's frames); none for RWKV, whose
    channel mix is two products."""
    kinds = tfm.layer_kinds(cfg)
    moe, dense = kinds.count("moe"), kinds.count("dense")
    return [("mlp", cfg.d_ff, dense, "layer"),
            ("shared expert", cfg.moe_shared_d_ff,
             moe if cfg.moe_shared_d_ff else 0, "layer"),
            ("encoder mlp", cfg.d_ff, cfg.encoder_layers, "encoder")]


# decode attention's route "mma" over an int8 ring, one instance a head dim
# (T int8_t, eight query rows, DM the head dim)
DECODE_INT8_MMA = tuple(f"decode_attention_kernelIaLi8ELi1ELi{d}EE"
                        for d in DECODE_MMA_HEAD_DIMS)
# the instances the [build] lines list one by one (registers, spills): flash
# attention's "wgmma" instances and its backward's, the fp32 "fma" kernel's
# serving instances (x and y as stored, one part), the realigning producer's
# GemmCfg (its flag B_LDG set), the MLP backward's fused pass and its two
# weight gradients' GemmCfg (A_MNMAJOR and BWD set), the persistent x^T dy
# kernel, and decode attention's int8 "mma" instances
WATCHED_INSTANCES = ("flash_attention_wgmma_kernel",
                     "Lb0ELb0ELb0EEEvNS_4ArgsEii", "Lb0ELb0ELb0ELb0ELb1E",
                     "flash_attention_bwd_dq_kernel",
                     "flash_attention_bwd_dkv_kernel",
                     "fused_mlp_bwd_fused_kernel", "Lb0ELb1ELb1ELb0ELb0E",
                     "gemm_xt_kernel", *DECODE_INT8_MMA)
# of those, the ones a spill fails the run for: the backward's were measured
# much slower when ptxas spilled them (the fused MLP pass at 128 columns 14.7
# against 10.1 ms) and read 0, as the forward's "wgmma" instances do; the
# persistent x^T dy kernel; decode attention's int8 "mma" instances up to
# head dim 128 (at 256 its 64 accumulators of O^T and 32 registers of Q a
# lane, under the 112 registers two blocks an SM leave, spill 288-356
# bytes)
NO_SPILL_INSTANCES = ("flash_attention_wgmma_kernel",
                      "flash_attention_bwd_dq_kernel",
                      "flash_attention_bwd_dkv_kernel",
                      "fused_mlp_bwd_fused_kernel", "Lb0ELb1ELb1ELb0ELb0E",
                      "gemm_xt_kernel",
                      *(key for key in DECODE_INT8_MMA
                        if not key.endswith("Li256EE")))


def ptxas_entries(log: str) -> list[tuple[str, int, int]]:
    """(mangled entry name, registers, spill store bytes) of each kernel in
    ``ptxas -v`` output (its spill line comes before its registers)."""
    out, entry, spill = [], None, 0
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            entry, spill = m.group(1), 0
            continue
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", ln)
        if m and entry:
            out.append((entry, int(m.group(1)), spill))
            entry = None
    return out


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


def host_us(fn, calls: int = 200, repeats: int = 5) -> float:
    """Median host time of one ``fn()`` call in microseconds, over
    ``repeats`` runs of ``calls`` calls queued behind about 30 ms of device
    work: what the host spends to launch, never waiting for the device."""
    fn()
    busy = torch.zeros(8192, 8192, device="cuda", dtype=torch.bfloat16)
    runs = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        for _ in range(20):
            torch.matmul(busy, busy)
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        runs.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return statistics.median(runs)


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


def check_mlp(x, w_up, w_down, kw, act, route=None) -> tuple[float, float]:
    """(max abs error, error over tolerance) of the kernel against
    ``composed_ref`` on these inputs; fails the run beyond tolerance.  The
    product is launched twice and must give the same bits both times."""
    def run():
        if route is None:
            return fused_mlp(x, w_up, w_down, act=act, **kw)
        return fused_mlp_kernel(x, w_up, w_down, kw.get("w_gate"),
                                kw.get("b_up"), kw.get("b_down"), act=act,
                                route=route)

    out = run()
    again = run()
    torch.cuda.synchronize()
    variant = "glu" if "w_gate" in kw else "bias" if kw else "plain"
    taken = route or mlp_route_of(x, w_up, w_down, kw.get("w_gate"))
    where = (f"x{tuple(x.shape)} ff={w_up.shape[1]} {x.dtype} act={act} "
             f"variant={variant} route={taken}")
    if not torch.equal(out, again):
        fail(f"fused_mlp gave other bits the second time: {where}")
    ref = composed_ref(x, w_up, w_down, act=act, **kw)
    if out.shape != ref.shape or out.dtype != ref.dtype:
        fail(f"fused_mlp gave {tuple(out.shape)} {out.dtype}, plain version "
             f"{tuple(ref.shape)} {ref.dtype}")
    if not torch.isfinite(out.to(torch.float32)).all():
        fail(f"fused_mlp output not finite at {where}")
    ref32 = ref.to(torch.float32)
    err = float((out.to(torch.float32) - ref32).abs().max()) if out.numel() else 0.0
    tol = TOL[x.dtype] * (float(ref32.abs().max()) + 1.0 if out.numel() else 1.0)
    if err > tol:
        fail(f"fused_mlp disagrees with composed_ref: {where}: max abs err "
             f"{err:.3e} > tol {tol:.3e}")
    return err, err / tol


def kernels_phase(cfg) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(1234)
    worst, cases = 0.0, 0
    reached = dict.fromkeys(MLP_ROUTES, 0)

    def case(m, d, ff, gated, bias, act, dtype, routes=(None,)):
        nonlocal worst, cases
        x, w_up, w_down, kw = mlp_inputs(gen, (m,), d, ff, gated, bias, dtype)
        for route in routes:
            worst = max(worst, check_mlp(x, w_up, w_down, kw, act, route)[1])
            route = route or mlp_route_of(x, w_up, w_down, kw.get("w_gate"))
            reached[route] += 1
            cases += 1

    for dtype in (torch.float32, torch.bfloat16):
        for sweep_case in SWEEP:
            case(*sweep_case, dtype)
    # bf16 at the rows around each route's edges, d and ff ragged against the
    # tiles (64 of K, 128 of ff, 64-256 of d_out), every variant, on both
    # routes (both take these inputs at any m)
    for m in MLP_EDGE_M:
        for gated, bias, act in (True, False, "silu"), (False, True, "relu"), \
                (False, False, "gelu"):
            case(m, 136, 328, gated, bias, act, torch.bfloat16,
                 ("split_ff", "two_pass"))
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
    if min(reached.values()) < 1:
        fail(f"the fused_mlp sweep did not reach every route: {reached}")
    say(f"[kernels] fused_mlp: {cases} sweep cases inside tolerance, each "
        f"launched twice with equal bits (worst err/tol {worst:.3f}; by "
        f"route {json.dumps(reached)})")

    def serving_row(label, x, w_up, w_down, kw, act, route=None,
                    timed_alone=True):
        """Hold the kernel to its plain version at these inputs (with the
        fc biases ``kw`` carries) and time it; with ``timed_alone`` also
        the plain version and the library yardstick."""
        nonlocal worst, cases
        m, d = x.shape
        ff, dout = w_up.shape[1], w_down.shape[1]
        gated, bias = "w_gate" in kw, "b_up" in kw
        fn = act_fn(act)

        def library():
            if bias:
                h = fn(torch.addmm(kw["b_up"], x, w_up))
                return torch.addmm(kw["b_down"], h, w_down)
            h = torch.matmul(x, w_up)
            h = fn(torch.matmul(x, kw["w_gate"])) * h if gated else fn(h)
            return torch.matmul(h, w_down)

        err, over = check_mlp(x, w_up, w_down, kw, act, route)
        worst = max(worst, over)
        cases += 1
        bound, bound_by = mlp_bound_ms(m, d, ff, dout, gated, bias, x.dtype)
        iters = 5 if m >= 1024 else 20
        row = {
            "shape": label, "m": m, "d": d, "ff": ff, "act": act,
            "gated": gated, "bias": bias, "dtype": "bfloat16",
            "route": route or mlp_route_of(x, w_up, w_down, kw.get("w_gate")),
            "max_abs_err": err,
            "ms": time_ms(lambda: fused_mlp_kernel(
                x, w_up, w_down, kw.get("w_gate"), kw.get("b_up"),
                kw.get("b_down"), act=act, route=route), iters),
            "bound_ms": bound, "bound_by": bound_by}
        if timed_alone:
            row["plain_ms"] = time_ms(lambda: composed_ref(
                x, w_up, w_down, act=act, **kw), 3, warmup=1)
            row["library_ms"] = time_ms(library, iters)
        say(f"[kernels] fused_mlp {label}: " + json.dumps(row))
        return row

    # the shapes the serving paths give it, full width, bf16; and the rows
    # around the crossover R on both routes
    d, ff, dtype = cfg.d_model, cfg.d_ff, torch.bfloat16
    x_all, w_up, w_down, kw = mlp_inputs(gen, (BATCH * PROMPT_LEN,), d, ff,
                                         cfg.gated_mlp, False, dtype)
    shapes, crossover = [], []
    serving = (("decode", BATCH), ("chunk", 32), ("chunk", PREFILL_CHUNK),
               ("prefill", BATCH * PROMPT_LEN))
    for label, m in serving:
        shapes.append(serving_row(f"{label} m={m}", x_all[:m].contiguous(),
                                  w_up, w_down, kw, cfg.mlp_act))
    for m in CROSSOVER_M:
        for route in ("split_ff", "two_pass"):
            crossover.append(serving_row(
                f"crossover m={m}", x_all[:m].contiguous(), w_up, w_down, kw,
                cfg.mlp_act, route, timed_alone=False))
    del x_all, w_up, w_down, kw
    # every MLP the [models] and [families] phases give the kernel, config
    # by config at full width, at the rows of its layers: a dense layer's,
    # an MoE layer's shared expert, an encoder layer's at a prefill's frames;
    # with the fc biases where the config has them (opt-30b); a shape two
    # configs share is held once
    held = set()
    for arch, depth, prompt_len, _ in RUNS:
        mcfg = model_cfg(arch, depth)
        d, bias = mcfg.d_model, mlp_bias(mcfg)
        for name, mff, count, where in layer_mlps(mcfg):
            key = (d, mff, mcfg.gated_mlp, mcfg.mlp_act, bias)
            rows = [m for m in model_rows(arch, prompt_len)[where]
                    if count and (m, key) not in held]
            if not rows:
                continue
            x_all, w_up, w_down, kw = mlp_inputs(
                gen, (max(rows),), d, mff, mcfg.gated_mlp, bias, dtype)
            for m in rows:
                held.add((m, key))
                shapes.append(serving_row(
                    f"{mcfg.name} {name} {d}/{mff}{' bias' if bias else ''} "
                    f"m={m}", x_all[:m].contiguous(), w_up, w_down, kw,
                    mcfg.mlp_act))
            del x_all, w_up, w_down, kw
    decode = shapes[0]
    return {
        "name": "fused_mlp", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_mlp.cu",
        "replaces": "src/repro/kernels/fused_mlp/kernel.py:38",
        "launches": 0,
        # the scalar keys are the decode shape's (most launches on the
        # path); "shapes" holds the others, "crossover" both routes at the
        # rows around R
        "max_abs_err": decode["max_abs_err"], "ms": decode["ms"],
        "plain_ms": decode["plain_ms"], "bound_ms": decode["bound_ms"],
        "bound_by": decode["bound_by"], "library_ms": decode["library_ms"],
        "kernel_ms": decode["ms"], "split_ff_max_m": SPLIT_FF_MAX_M,
        "cases": cases, "max_err_over_tol": worst, "sweep_routes": reached,
        "shapes": shapes, "crossover": crossover,
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


def int8_ring(k, v) -> tuple:
    """(int8 K, int8 V, (k_scale, v_scale)): the ring ``k``, ``v``
    quantized as the model quantizes its rows (``quantize_kv``); a slot
    never written, tagged the sentinel, keeps its values, masked anyway."""
    (kq, ks), (vq, vs) = quantize_kv(k), quantize_kv(v)
    return kq, vq, (ks, vs)


def stages_ms(fn, depths=(2, 4)) -> dict:
    """``time_ms`` of a decode attention call with route "mma" held to a
    ring of each of ``depths`` stages, whatever ``tiling`` plans; each
    depth's output equal to the planned one's bit for bit (the two warp
    groups take the same tiles at any even depth: the same sums in the
    same order)."""
    planned = decode_kernels.tiling
    want = fn()
    out = {}
    try:
        for st in depths:
            decode_kernels.tiling = lambda g, d, elem, route="fma", st=st: (
                (64, st) if route == "mma" else planned(g, d, elem, route))
            if not torch.equal(fn(), want):
                fail(f"decode attention on a ring of {st} stages gave other "
                     "bits")
            out[st] = time_ms(fn, 50)
    finally:
        decode_kernels.tiling = planned
    return out


def check_attn(q, k, v, slot_pos, q_pos, window=0, dead_rows=(),
               route=None, splits=None, kv_scales=None) -> tuple[float, float]:
    """(max abs error, error over tolerance) of the kernel against
    ``decode_attention_ref`` on these inputs (an int8 ring with its
    ``kv_scales``); fails the run beyond tolerance, if a row with no live
    slot is not exactly zero, or if a second launch gives other bits."""
    def run():
        return decode_attention_kernel(q, k, v, slot_pos, q_pos, window=window,
                                       route=route, splits=splits,
                                       kv_scales=kv_scales)
    out, again = run(), run()
    torch.cuda.synchronize()
    ref = decode_attention_ref(q, k, v, slot_pos, q_pos, window=window,
                               kv_scales=kv_scales)
    where = (f"q{tuple(q.shape)} cache{tuple(k.shape)} {q.dtype}/{k.dtype} "
             f"slot_pos{tuple(slot_pos.shape)} window={window} route={route} "
             f"splits={splits}")
    if not torch.equal(out, again):
        fail(f"decode_attention gave other bits on a second launch at "
             f"{where}")
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


def kv_bytes_per_element(k, d: int) -> float:
    """Bytes an attention kernel reads for one element of the ring: its
    own, and over an int8 ring a share of the slot's bf16 scale."""
    return k.element_size() + (2 / d if k.dtype == torch.int8 else 0)


def products_peak(q, k) -> float:
    """The peak rate of the attention products: of the ring's type, or over
    an int8 ring (dequantized to bf16 in the kernel) of the query's."""
    return PEAK_FLOPS[q.dtype if k.dtype == torch.int8 else k.dtype]


def attn_bound_ms(q, k, slot_pos, q_pos, window) -> tuple[float, float, str]:
    """(bound over the live slots, bound over the whole ring, by what).
    Bytes: q read and the output written once, K and V of the slots this
    data attends to (an int8 ring's with their scales), the tags;
    operations: two products over those slots.  The kernel reads the whole
    ring; the first bound is what the function needs, the second what
    reading every slot costs at the memory rate."""
    b, hq, d = q.shape
    hkv, c = k.shape[1], k.shape[2]
    live = int(live_mask(slot_pos, q_pos, b, window).sum())    # row-slots
    size = kv_bytes_per_element(k, d)
    fixed = 2 * q.numel() * q.element_size() + slot_pos.numel() * 4
    t_live = (fixed + 2 * live * hkv * d * size) / HBM_BYTES_PER_S
    t_ring = (fixed + 2 * k.numel() * size) / HBM_BYTES_PER_S
    t_ops = 4 * live * hq * d / products_peak(q, k)
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
        # 1, 5, 8, 16 and 20 (more than one block's rows), C not a multiple
        # of the tile, a ring of more tiles than the kernel lists (it then
        # reads each split's own range of tiles); the cluster of 8 splits
        # (one row), splits whose share of the live tiles is empty (an early
        # position in a long ring), and one block a row (64 x 8 rows fill
        # the card without a split)
        for b, hq, hkv, c, d, pos, win in (
                (2, 32, 8, 300, 80, 250, 0), (2, 16, 16, 130, 256, 200, 0),
                (1, 16, 1, 100, 256, 60, 0), (2, 40, 8, 1000, 128, 999, 0),
                (1, 40, 2, 77, 128, 40, 0), (1, 4, 1, 66000, 16, 70000, 0),
                (1, 8, 1, 2048, 64, 40, 0), (1, 5, 1, 2048, 128, 3000, 100),
                (3, 24, 3, 517, 256, 400, 0), (1, 8, 8, 1000, 64, 1000, 33),
                (64, 40, 8, 300, 128, 299, 0),
                # dit-xl's D 72 at G 1 and kimi-k2's D 112 at G 8
                (2, 16, 16, 300, 72, 250, 0), (1, 16, 16, 517, 72, 900, 64),
                (2, 64, 8, 1000, 112, 999, 0), (1, 64, 8, 130, 112, 700, 48),
                (1, 16, 2, 2048, 112, 40, 0),
                # D 128 at gemma2-27b's G 2 and llama2-70b's G 8
                (2, 32, 16, 1000, 128, 999, 0), (1, 64, 8, 517, 128, 900, 64),
                # D 64 at internvl2-1b's G 7 (a dead column of the mma
                # route), hymba-1.5b's G 5 with its window of 1024 in a ring
                # of 2048 (wrapped and not), whisper-tiny's G 1
                (2, 14, 2, 1024, 64, 780, 0), (3, 14, 2, 517, 64, 900, 0),
                (2, 25, 5, 2048, 64, 3000, 1024),
                (1, 25, 5, 2048, 64, 1500, 1024),
                (2, 6, 6, 512, 64, 72, 0)):
            q, k, v = attn_inputs(gen, b, hq, hkv, c, d, dtype)
            case(q, k, v, ring_tags(c, pos), pos - 1, win)
            if dtype == torch.bfloat16 and c < 60000:
                # the other route, and the split forced off and to 8
                case(q, k, v, ring_tags(c, pos), pos - 1, win, route="fma")
                for splits in (1, 8):
                    case(q, k, v, ring_tags(c, pos), pos - 1, win,
                         splits=splits)
    # bf16 per-row positions with a dead row on route "fma" too, and on
    # route "mma" at D 72 (G 1) and D 112 (G 8)
    qp = torch.tensor([5, 130, 350, 0], dtype=torch.int32, device="cuda")
    tags = torch.stack([ring_tags(200, int(p) + 1) for p in qp.tolist()])
    tags[3] = SENTINEL
    q, k, v = attn_inputs(gen, 4, 10, 2, 200, 32, torch.bfloat16)
    case(q, k, v, tags, qp, 48, dead_rows=(3,), route="fma")
    for hq, hkv, d in ((4, 4, 72), (16, 2, 112)):
        q, k, v = attn_inputs(gen, 4, hq, hkv, 200, d, torch.bfloat16)
        for win in (0, 48):
            case(q, k, v, tags, qp, win, dead_rows=(3,))
            for splits in (1, 8):
                case(q, k, v, tags, qp, win, dead_rows=(3,), splits=splits)
    # fp32 query against a bf16 cache (fp32 weights, default bf16 KV)
    q, k, v = attn_inputs(gen, 2, 8, 2, 128, 32, torch.float32)
    case(q, k.to(torch.bfloat16), v.to(torch.bfloat16), ring_tags(128, 90),
         89)
    say(f"[kernels] decode_attention: {cases} sweep cases inside tolerance "
        f"(worst err/tol and its err: {json.dumps(worst)})")

    # the int8 ring, dequantized in the kernel: route "mma" (a bf16 query)
    # and "fma" (forced, and an fp32 query, the fp32 parity's), head dims
    # 64, 72 (the lanes copy its rows: TMA cannot stride 72 bytes), 112,
    # 128 and 256 at groups of 1, 5, 7 and 8, windows, split as planned,
    # unsplit and over a cluster of 8; per-row positions with a dead row
    bf16_cases, worst_bf16 = cases, dict(worst)
    worst = {"float32": (0.0, 0.0), "bfloat16": (0.0, 0.0)}
    cases = 0
    for b, hq, hkv, c, d, pos, win in (
            (2, 8, 8, 300, 64, 250, 0), (2, 25, 5, 2048, 64, 3000, 1024),
            (2, 14, 2, 1024, 64, 780, 0), (2, 16, 16, 300, 72, 250, 0),
            (1, 16, 16, 517, 72, 900, 64), (2, 64, 8, 1000, 112, 999, 0),
            (1, 35, 5, 130, 112, 700, 48), (2, 40, 8, 1000, 128, 999, 0),
            (1, 56, 8, 517, 128, 900, 64), (3, 24, 3, 517, 256, 400, 0),
            (1, 40, 5, 2048, 256, 1500, 100)):
        q, k, v = attn_inputs(gen, b, hq, hkv, c, d, torch.bfloat16)
        kq, vq, sc = int8_ring(k, v)
        tags = ring_tags(c, pos)
        for route in (None, "fma"):
            for splits in (None, 1, 8):
                case(q, kq, vq, tags, pos - 1, win, route=route,
                     splits=splits, kv_scales=sc)
        case(q.float(), kq, vq, tags, pos - 1, win, kv_scales=sc)
    qp = torch.tensor([5, 130, 350, 0], dtype=torch.int32, device="cuda")
    tags = torch.stack([ring_tags(200, int(p) + 1) for p in qp.tolist()])
    tags[3] = SENTINEL
    for hq, hkv, d in ((40, 8, 128), (16, 16, 72)):
        q, k, v = attn_inputs(gen, 4, hq, hkv, 200, d, torch.bfloat16)
        kq, vq, sc = int8_ring(k, v)
        for win in (0, 48):
            for route in (None, "fma"):
                case(q, kq, vq, tags, qp, win, dead_rows=(3,), route=route,
                     kv_scales=sc)
            case(q.float(), kq, vq, tags, qp, win, dead_rows=(3,),
                 kv_scales=sc)
    worst_int8, int8_cases = worst, cases
    say(f"[kernels] decode_attention int8 ring: {int8_cases} sweep cases "
        f"inside tolerance (worst err/tol and its err: "
        f"{json.dumps(worst_int8)})")
    cases, worst = bf16_cases, worst_bf16

    # the two shapes the serving paths give it, full width, bf16, and the
    # continuous shape at a group of 8; each also on route "fma"; then every
    # shape the [models] and [families] phases give it, config by config at
    # full width, with its window: a mid-run lock-step step, and on the
    # trace archs the continuous one
    hkv, d = cfg.num_kv_heads, cfg.resolved_head_dim
    dtype = torch.bfloat16
    shapes = []
    slot_pos_now = [p + 20 for p in TRACE["prompt_lens"] * 2]
    serving = [
        ("lock-step", BATCH, CACHE, cfg.num_heads, hkv, d,
         PROMPT_LEN + STEPS // 2, 0),
        ("continuous", SLOTS, SLOT_CACHE, cfg.num_heads, hkv, d, None, 0),
        ("continuous G=8", SLOTS, SLOT_CACHE, 8 * hkv, hkv, d, None, 0)]
    for arch, depth, prompt_len, ring in RUNS:
        mcfg = model_cfg(arch, depth)
        if mcfg.rwkv:
            continue
        heads = (mcfg.num_heads, mcfg.num_kv_heads, mcfg.resolved_head_dim)
        win = tfm.attn_spec(mcfg).sliding_window
        tag = (f"D={heads[2]} G={heads[0] // heads[1]}"
               + (f" window={win}" if win else ""))
        serving.append((f"{mcfg.name} lock-step {tag}", BATCH, ring, *heads,
                        seq_len(mcfg, prompt_len) + STEPS // 2, win))
        if arch in TRACE_ARCHS:
            serving.append((f"{mcfg.name} continuous {tag}", SLOTS,
                            SLOT_CACHE, *heads, None, win))
    for label, b, c, hq, hkv, d, lock_pos, win in serving:
        q, k, v = attn_inputs(gen, b, hq, hkv, c, d, dtype)
        if lock_pos is not None:
            tags, qp = ring_tags(c, lock_pos + 1), lock_pos
        else:
            qp = torch.tensor(slot_pos_now, dtype=torch.int32, device="cuda")
            tags = torch.stack([ring_tags(c, p + 1) for p in slot_pos_now])
        err = case(q, k, v, tags, qp, win)
        case(q, k, v, tags, qp, win, route="fma")
        mask = live_mask(tags, qp, b, win)[:, None, None, :]   # (B,1,1,C)
        q4 = q[:, :, None, :]

        def library():
            return torch.nn.functional.scaled_dot_product_attention(
                q4, k, v, attn_mask=mask, enable_gqa=True)

        bound, ring_bound, bound_by = attn_bound_ms(q, k, tags, qp, win)
        plan = decode_plan_for(q, k)
        shapes.append({
            "shape": label, "b": b, "hq": hq, "hkv": hkv, "c": c, "d": d,
            "window": win, "dtype": "bfloat16", "route": plan["route"],
            "splits": plan["splits"],
            "blocks": plan["blocks"], "bk": plan["bk"],
            "stages": plan["stages"],
            "live_slots": int(live_mask(tags, qp, b, win).sum()),
            "max_abs_err": err,
            "ms": time_ms(lambda: decode_attn(q, k, v, tags, qp, window=win),
                          50),
            "fma_ms": time_ms(lambda: decode_attention_kernel(
                q, k, v, tags, qp, window=win, route="fma"), 50),
            "plain_ms": time_ms(lambda: decode_attention_ref(
                q, k, v, tags, qp, window=win), 5, warmup=1),
            "bound_ms": bound, "bound_by": bound_by,
            "ring_bound_ms": ring_bound,
            "library_ms": time_ms(library, 50),
        })
        say(f"[kernels] decode_attention {label}: " + json.dumps(shapes[-1]))

    # the int8 ring at the serving shapes, beside the bf16 kernel at the
    # same shape: lock-step B 8, C 1024 at position 520; continuous 8 x
    # 2048; and the reference's decode_32k shape (B 8, Hkv 8, D 128, C
    # 32768, every slot live), for which its launch/specs.py picks int8
    int8_shapes = []
    hq, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    for label, b, c, lock_pos in (
            ("lock-step", BATCH, CACHE, PROMPT_LEN + STEPS // 2),
            ("continuous", SLOTS, SLOT_CACHE, None),
            ("long ring C=32768", BATCH, 32768, 32768)):
        q, k, v = attn_inputs(gen, b, hq, hkv, c, d, dtype)
        kq, vq, sc = int8_ring(k, v)
        if lock_pos is not None:
            tags, qp = ring_tags(c, lock_pos + 1), lock_pos
        else:
            qp = torch.tensor(slot_pos_now, dtype=torch.int32, device="cuda")
            tags = torch.stack([ring_tags(c, p + 1) for p in slot_pos_now])
        err, _ = check_attn(q, kq, vq, tags, qp, kv_scales=sc)
        bound, ring_bound, bound_by = attn_bound_ms(q, kq, tags, qp, 0)
        bf16_bound = attn_bound_ms(q, k, tags, qp, 0)[0]
        plan = decode_plan_for(q, kq)
        int8_shapes.append({
            "shape": f"int8 {label}", "b": b, "hq": hq, "hkv": hkv, "c": c,
            "d": d, "kv": "int8", "route": plan["route"],
            "splits": plan["splits"], "stages": plan["stages"],
            "live_slots": int(live_mask(tags, qp, b, 0).sum()),
            "max_abs_err": err,
            "ms": time_ms(lambda: decode_attn(q, kq, vq, tags, qp,
                                              kv_scales=sc), 50),
            # the same call on rings of two and four stages, the plan's
            # among them
            "stages_ms": stages_ms(lambda: decode_attn(
                q, kq, vq, tags, qp, kv_scales=sc)),
            # the kernel at each split count, the planned one among them
            "splits_ms": {sp: time_ms(lambda: decode_attention_kernel(
                q, kq, vq, tags, qp, kv_scales=sc, splits=sp), 50)
                for sp in (1, 2, 4, 8)},
            "bf16_ms": time_ms(lambda: decode_attn(q, k, v, tags, qp), 50),
            "fma_ms": time_ms(lambda: decode_attention_kernel(
                q, kq, vq, tags, qp, route="fma", kv_scales=sc), 20),
            "plain_ms": time_ms(lambda: decode_attention_ref(
                q, kq, vq, tags, qp, kv_scales=sc), 3, warmup=1),
            "bound_ms": bound, "bound_by": bound_by,
            "ring_bound_ms": ring_bound, "bf16_bound_ms": bf16_bound,
            # no one PyTorch call attends over an int8 ring
            "library_ms": None,
        })
        say(f"[kernels] decode_attention {int8_shapes[-1]['shape']}: "
            + json.dumps(int8_shapes[-1]))
        del q, k, v, kq, vq, sc
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
        "int8_cases": int8_cases, "int8_worst_by_dtype": worst_int8,
        "int8_shapes": int8_shapes,
    }


def check_flash(q, k, v, q_pos=None, k_pos=None, *, causal=True, window=0,
                dead=None, route=None, splits=None,
                kv_scales=None) -> tuple[float, float]:
    """(max abs error, error over tolerance) of the kernel against
    ``mha_ref`` (no positions) or ``mha_pos_ref`` on these inputs (an int8
    ring with its ``kv_scales``), on the route and splits the wrapper plans
    unless given; fails the run beyond tolerance, if a query marked in
    ``dead`` (B, Sq) is not exactly zero in every head, or if a second
    launch gives other bits."""
    def run():
        return flash_attention_kernel(q, k, v, q_pos, k_pos, causal=causal,
                                      window=window, route=route,
                                      splits=splits, kv_scales=kv_scales)
    out, again = run(), run()
    torch.cuda.synchronize()
    if q_pos is None:
        ref = flash_ref.mha_ref(q, k, v, causal=causal, window=window)
    else:
        ref = flash_ref.mha_pos_ref(q, k, v, q_pos, k_pos, causal=causal,
                                    window=window, kv_scales=kv_scales)
    where = (f"q{tuple(q.shape)} strides {q.stride()} k{tuple(k.shape)} "
             f"{q.dtype}/{k.dtype} causal={causal} window={window} "
             f"positions={'no' if q_pos is None else tuple(k_pos.shape)} "
             f"route={route or flash_route_of(q, k)} splits={splits}")
    if out.shape != ref.shape or out.dtype != ref.dtype:
        fail(f"flash_attention gave {tuple(out.shape)} {out.dtype}, plain "
             f"version {tuple(ref.shape)} {ref.dtype} at {where}")
    if not torch.equal(out, again):
        fail(f"flash_attention gave other bits on a second launch at {where}")
    if not torch.isfinite(out.to(torch.float32)).all():
        fail(f"flash_attention output not finite at {where}")
    if dead is not None and out.transpose(1, 2)[dead].any():
        fail(f"flash_attention: a query with no live key is not zero at "
             f"{where}")
    ref32 = ref.to(torch.float32)
    err = float((out.to(torch.float32) - ref32).abs().max())
    tol = ATTN_TOL[q.dtype] * float(ref32.abs().max())
    if err > tol:
        fail(f"flash_attention disagrees with the plain version at {where}: "
             f"max abs err {err:.3e} > tol {tol:.3e}")
    return err, err / tol if tol else 0.0


def flash_bound_ms(q, k, q_pos, k_pos, causal, window
                   ) -> tuple[float, str]:
    """Least time for the function on these inputs: q read and the output
    written once, K and V of the keys some query attends to (an int8
    ring's with their scales), the positions; the two products over the
    (query, key) pairs the mask lets through."""
    b, hq, sq, d = q.shape
    hkv = k.shape[1]
    ok = flash_ref.live_mask(q_pos, k_pos, causal=causal, window=window)
    keys = int(ok.any(dim=1).sum())              # (row, key) pairs read
    pairs = int(ok.sum())
    size = kv_bytes_per_element(k, d)
    t_bytes = (2 * q.numel() * q.element_size() + 2 * keys * hkv * d * size
               + (q_pos.numel() + k_pos.numel()) * 4) / HBM_BYTES_PER_S
    t_ops = 4 * pairs * hq * d / products_peak(q, k)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def flash_phase(cfg, chunk: int) -> dict:
    """The flash-attention sweep against ``mha_ref`` / ``mha_pos_ref`` and
    the serving shapes timed: lock-step prefill, and against a ring of 2048
    the chunks the batcher cuts: ``chunk`` tokens (the streamed path's, cut
    from the planner's budget) and a tail of half that, and 256 (the
    resident path's)."""
    gen = torch.Generator(device="cuda").manual_seed(2468)
    worst = {"float32": (0.0, 0.0), "bfloat16": (0.0, 0.0)}
    cases = 0

    def normal(*shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda",
                           dtype=torch.float32).to(dtype)

    def qkv(b, hq, hkv, sq, sk, d, dtype, kv_dtype=None):
        kv_dtype = kv_dtype or dtype
        return (normal(b, hq, sq, d, dtype=dtype),
                normal(b, hkv, sk, d, dtype=kv_dtype),
                normal(b, hkv, sk, d, dtype=kv_dtype))

    def case(q, *args, **kw):
        nonlocal cases
        err, over = check_flash(q, *args, **kw)
        key = str(q.dtype).split(".")[1]
        worst[key] = max(worst[key], (over, err))
        cases += 1
        return err

    def chunk_positions(b, t, c, starts):
        """(q_pos (B, T), ring tags (B, C)) of chunks of ``t`` tokens at
        ``starts``, their own tokens already tagged in the ring."""
        q_pos = torch.stack([torch.arange(p, p + t, device="cuda")
                             for p in starts]).to(torch.int32)
        tags = torch.stack([ring_tags(c, p + t) for p in starts])
        return q_pos, tags

    for dtype in (torch.float32, torch.bfloat16):
        # the reference's sweep and its model-attention shape
        for b, hq, hkv, s, d, causal, win in FLASH_SWEEP + [
                (1, 4, 2, 64, 32, True, 0)]:
            case(*qkv(b, hq, hkv, s, s, d, dtype), causal=causal, window=win)
        # ragged S; groups of 1, 5 and 8; head dims 16-256; a window
        # shorter than a tile
        for b, hq, hkv, s, d, causal, win in (
                (1, 4, 2, 100, 64, True, 0), (2, 4, 2, 257, 64, False, 0),
                (1, 4, 4, 130, 128, True, 0), (1, 5, 1, 150, 64, True, 0),
                (1, 8, 1, 257, 128, True, 0), (2, 2, 1, 150, 256, True, 0),
                (1, 4, 2, 90, 80, True, 0), (1, 2, 2, 70, 16, True, 0),
                (1, 4, 2, 200, 64, True, 20)):
            case(*qkv(b, hq, hkv, s, s, d, dtype), causal=causal, window=win)
        # per-row positions against a ring of 256: row 0 part-filled, row 1
        # wrapped, row 2 evicted (every tag the sentinel: zeros)
        t, c = 40, 256
        q_pos, tags = chunk_positions(3, t, c, (100, 600, 0))
        tags[2] = SENTINEL
        dead = torch.zeros((3, t), dtype=torch.bool, device="cuda")
        dead[2] = True
        for win in (0, 64):
            case(*qkv(3, 8, 2, t, c, 64, dtype), q_pos, tags, window=win,
                 dead=dead)
        # every row masked
        q, k, v = qkv(2, 4, 2, t, c, 64, dtype)
        case(q, k, v, q_pos[:2].contiguous(),
             torch.full((2, c), SENTINEL, dtype=torch.int32, device="cuda"),
             dead=torch.ones((2, t), dtype=torch.bool, device="cuda"))
        # one position row for every batch row; a ring of more tiles than
        # the kernel lists (it then reads every tile)
        q_pos1, tags1 = chunk_positions(1, 24, 70000, (69000,))
        case(*qkv(2, 4, 1, 24, 70000, 16, dtype), q_pos1, tags1)
        q_pos1, tags1 = chunk_positions(1, 20, 70000, (69000,))
        case(*qkv(1, 10, 2, 20, 70000, 128, dtype), q_pos1, tags1)
        # bidirectional with Sq != Sk and no positions (a cross-attention):
        # whisper-tiny's decode step (Sq 1: a block's single live row) and a
        # prefill's prompt against its 1500 frames (23 x 64 + 28), ragged
        # Sq and Sk, GQA, head dims of every route
        for b, hq, hkv, sq, sk, d in ((2, 6, 6, 1, 1500, 64),
                                      (2, 6, 6, 64, 1500, 64),
                                      (1, 4, 2, 37, 300, 128),
                                      (2, 4, 4, 5, 130, 72),
                                      (1, 8, 1, 1, 77, 112),
                                      (1, 14, 2, 70, 30, 64)):
            case(*qkv(b, hq, hkv, sq, sk, d, dtype), causal=False)
        # internvl2-1b's G 7, causal and bidirectional
        for causal in (True, False):
            case(*qkv(1, 14, 2, 300, 300, 64, dtype), causal=causal)
    # route "wgmma" (bf16, head dims 64, 128, 256): groups of 1, 2, 5 and 8;
    # chunks of 1-256 tokens against a ring of 512 (part-filled, wrapped,
    # windowed), with the KV loop split as planned, not split, and split
    # over a cluster of 8 (a chunk early in the ring leaves most splits with
    # no live key); prefills with ragged S, windows, bidirectional, batch 2;
    # q read through the strides of a (B, S, Hq, D) projection
    bf16 = torch.bfloat16
    for hq, hkv, d in ((4, 4, 64), (10, 2, 128), (16, 2, 256), (40, 8, 128),
                       (8, 4, 128), (16, 2, 128), (14, 2, 64)):
        for t, start, win in ((1, 300, 0), (16, 0, 0), (37, 100, 0),
                              (64, 480, 64), (256, 200, 0)):
            q_pos, tags = chunk_positions(1, t, 512, (start,))
            q, k, v = qkv(1, hq, hkv, t, 512, d, bf16)
            for splits in (None, 1, 8):
                case(q, k, v, q_pos, tags, window=win, splits=splits)
        for b, s_len, causal, win in ((2, 333, True, 0), (1, 200, True, 50),
                                      (1, 130, False, 0), (2, 97, True, 0)):
            q, k, v = qkv(b, hq, hkv, s_len, s_len, d, bf16)
            for splits in (None, 1, 3):
                case(q, k, v, causal=causal, window=win, splits=splits)
        q_strided = normal(2, 150, hq, d, dtype=bf16).transpose(1, 2)
        k, v = qkv(2, hq, hkv, 150, 150, d, bf16)[1:]
        case(q_strided, k, v)
        q_pos, tags = chunk_positions(2, 150, 512, (40, 400))
        k, v = qkv(2, hq, hkv, 150, 512, d, bf16)[1:]
        case(q_strided, k, v, q_pos, tags, splits=4)
        # a cross-attention: Sq 1 and 64 against 1500 keys, split as planned,
        # not split and over a cluster of 8
        for sq in (1, 64):
            q, k, v = qkv(2, hq, hkv, sq, 1500, d, bf16)
            for splits in (None, 1, 8):
                case(q, k, v, causal=False, splits=splits)
    # dit-xl's D 72 (G 1) and kimi-k2's D 112 (G 8), and 80 and 96: route
    # "wgmma" in the layout of 128, split as planned, unsplit and over a
    # cluster of 8; "mma_sync" forced; the planned route:
    # prefills with ragged S, a window, bidirectional; chunks against a ring
    # of 512 (part-filled, wrapped, windowed, a dead row); q through the
    # strides of a (B, S, Hq, D) projection
    wg_pad = [dict(route="wgmma", splits=sp) for sp in (None, 1, 8)] + [
        dict(route="mma_sync"), {}]
    for hq, hkv, d in ((16, 16, 72), (64, 8, 112), (8, 2, 80), (10, 2, 96)):
        for b, s_len, causal, win in ((2, 257, True, 0), (1, 200, True, 50),
                                      (1, 130, False, 0)):
            q, k, v = qkv(b, hq, hkv, s_len, s_len, d, bf16)
            for kw in wg_pad:
                case(q, k, v, causal=causal, window=win, **kw)
        for t, start, win in ((1, 300, 0), (37, 100, 0), (64, 480, 64),
                              (256, 200, 0)):
            q_pos, tags = chunk_positions(1, t, 512, (start,))
            q, k, v = qkv(1, hq, hkv, t, 512, d, bf16)
            for kw in wg_pad:
                case(q, k, v, q_pos, tags, window=win, **kw)
        q_pos, tags = chunk_positions(3, 40, 512, (100, 600, 0))
        tags[2] = SENTINEL
        dead = torch.zeros((3, 40), dtype=torch.bool, device="cuda")
        dead[2] = True
        q, k, v = qkv(3, hq, hkv, 40, 512, d, bf16)
        for kw in wg_pad:
            case(q, k, v, q_pos, tags, dead=dead, **kw)
        q_strided = normal(2, 150, hq, d, dtype=bf16).transpose(1, 2)
        k, v = qkv(2, hq, hkv, 150, 150, d, bf16)[1:]
        for kw in wg_pad:
            case(q_strided, k, v, **kw)
    # fp32 query against a bf16 ring (fp32 weights, default bf16 KV)
    q_pos, tags = chunk_positions(2, 33, 128, (10, 200))
    case(*qkv(2, 8, 2, 33, 128, 32, torch.float32, torch.bfloat16), q_pos,
         tags)
    say(f"[kernels] flash_attention: {cases} sweep cases inside tolerance "
        f"(worst err/tol and its err: {json.dumps(worst)})")

    # the int8 ring, dequantized in the kernel: chunks of 4-256 tokens at
    # ring offsets 0, 700 and 1900 of a ring of 2048 on every route
    # ("wgmma" at D 64, 80, 96, 112, 128, 256, split as planned, unsplit
    # and over 8, and at 80-112 also "mma_sync" forced; "mma_sync" at 72,
    # where an int8 row is no stride TMA takes; "fma" with an fp32 query),
    # windows; three rows, one of them evicted
    bf16_cases, worst_bf16 = cases, dict(worst)
    worst = {"float32": (0.0, 0.0), "bfloat16": (0.0, 0.0)}
    cases = 0
    for hq, hkv, d in ((40, 8, 128), (14, 2, 64), (32, 16, 256), (16, 16, 72),
                       (64, 8, 112), (8, 2, 80), (10, 2, 96)):
        for t, start, win in ((4, 0, 0), (32, 700, 0), (32, 1900, 0),
                              (256, 700, 0), (100, 1900, 300),
                              (256, 0, 1024)):
            q_pos, tags = chunk_positions(1, t, SLOT_CACHE, (start,))
            q, k, v = qkv(1, hq, hkv, t, SLOT_CACHE, d, bf16)
            kq, vq, sc = int8_ring(k, v)
            wg = flash_route_for(bf16, torch.int8, d, hq // hkv) == "wgmma"
            for kw in ([dict(splits=sp) for sp in (None, 1, 8)]
                       + ([dict(route="mma_sync")] if d in PADDED_HEAD_DIMS
                          else [])
                       if wg else [{}]):
                case(q, kq, vq, q_pos, tags, window=win, kv_scales=sc, **kw)
            case(q.float(), kq, vq, q_pos, tags, window=win, kv_scales=sc)
        q_pos, tags = chunk_positions(3, 40, 512, (100, 600, 0))
        tags[2] = SENTINEL
        dead = torch.zeros((3, 40), dtype=torch.bool, device="cuda")
        dead[2] = True
        q, k, v = qkv(3, hq, hkv, 40, 512, d, bf16)
        kq, vq, sc = int8_ring(k, v)
        case(q, kq, vq, q_pos, tags, dead=dead, kv_scales=sc)
        case(q.float(), kq, vq, q_pos, tags, dead=dead, kv_scales=sc)
    # route "wgmma" where the scales cannot all come by bulk copies: a
    # wrapped ring of 1000 slots (its last tile's scales by the producer's
    # lanes), of 1001 (every tile's: rows not on 16 bytes) and scales one
    # element into a buffer (not on 16 bytes)
    for c, offset in ((1000, 0), (1001, 0), (1024, 1)):
        for hq, hkv, d in ((40, 8, 128), (14, 2, 64), (32, 16, 256)):
            q_pos, tags = chunk_positions(1, 32, c, (c + 100,))
            q, k, v = qkv(1, hq, hkv, 32, c, d, bf16)
            kq, vq, sc = int8_ring(k, v)
            if offset:
                sc = tuple(torch.cat([x.new_zeros(offset), x.flatten()])
                           [offset:].view(x.shape) for x in sc)
            for splits in (None, 1):
                case(q, kq, vq, q_pos, tags, kv_scales=sc, splits=splits)
    worst_int8, int8_cases = worst, cases
    say(f"[kernels] flash_attention int8 ring: {int8_cases} sweep cases "
        f"inside tolerance (worst err/tol and its err: "
        f"{json.dumps(worst_int8)})")
    cases, worst = bf16_cases, worst_bf16

    # the shapes the serving paths give it, full width, bf16; then every
    # shape the [models] and [families] phases give it, config by config at
    # full width with its mask: the lock-step prefill (an enc-dec model's
    # encoder and its cross-attention at a prefill and a decode step too),
    # and on the trace archs each chunk length of the trace
    heads = (cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim)
    dtype = torch.bfloat16
    sdpa = torch.nn.functional.scaled_dot_product_attention
    shapes = []
    # (label, B, Sq, Sk, chunk start (None: no positions), heads, causal,
    # window)
    serving = [("lock-step prefill", BATCH, PROMPT_LEN, PROMPT_LEN, None,
                heads, True, 0)]
    for t, starts in ((chunk, (0, 700, 1900)), (chunk // 2, (1900,)),
                      (PREFILL_CHUNK, (0, 700, 1900))):
        for start in starts:
            serving.append((f"chunk T={t} at {start}", 1, t, SLOT_CACHE,
                            start, heads, True, 0))
    for arch, depth, prompt_len, _ in RUNS:
        mcfg = model_cfg(arch, depth)
        if mcfg.rwkv:
            continue
        mheads = (mcfg.num_heads, mcfg.num_kv_heads, mcfg.resolved_head_dim)
        win = tfm.attn_spec(mcfg).sliding_window
        tag = (f"D={mheads[2]} G={mheads[0] // mheads[1]}"
               + (f" window={win}" if win else ""))
        seq = seq_len(mcfg, prompt_len)
        serving.append((f"{mcfg.name} prefill {tag}", BATCH, seq, seq, None,
                        mheads, True, win))
        if mcfg.encoder_layers:
            e = mcfg.encoder_seq
            serving += [
                (f"{mcfg.name} encoder {tag}", BATCH, e, e, None, mheads,
                 False, 0),
                (f"{mcfg.name} cross-attention prefill {tag}", BATCH, seq, e,
                 None, mheads, False, 0),
                (f"{mcfg.name} cross-attention decode {tag}", BATCH, 1, e,
                 None, mheads, False, 0)]
        if arch in TRACE_ARCHS:
            serving += [(f"{mcfg.name} chunk T={t} at {start} {tag}", 1, t,
                         SLOT_CACHE, start, mheads, True, win)
                        for t, start in trace_chunks()]
    for label, b, t, c, start, (hq, hkv, d), causal, win in serving:
        q, k, v = qkv(b, hq, hkv, t, c, d, dtype)
        if start is None:
            q_pos = torch.arange(t, dtype=torch.int32, device="cuda")
            k_pos = torch.arange(c, dtype=torch.int32, device="cuda")
            q_pos = q_pos[None].expand(b, t).contiguous()
            k_pos = k_pos[None].expand(b, c).contiguous()
            err = case(q, k, v, causal=causal, window=win)

            def kernel():
                return flash_attn(q, k, v, causal=causal, window=win)

            def plain():
                return flash_ref.mha_ref(q, k, v, causal=causal, window=win)
        else:
            q_pos, k_pos = chunk_positions(b, t, c, (start,))
            err = case(q, k, v, q_pos, k_pos, causal=causal, window=win)

            def kernel():
                return flash_attn_pos(q, k, v, q_pos, k_pos, causal=causal,
                                      window=win)

            def plain():
                return flash_ref.mha_pos_ref(q, k, v, q_pos, k_pos,
                                             causal=causal, window=win)
        if start is None and not win:
            def library():
                return sdpa(q, k, v, is_causal=causal, enable_gqa=True)
        else:
            mask = flash_ref.live_mask(q_pos, k_pos, causal=causal,
                                       window=win)[:, None]   # (B,1,T,C)

            def library():
                return sdpa(q, k, v, attn_mask=mask, enable_gqa=True)
        bound, bound_by = flash_bound_ms(q, k, q_pos, k_pos, causal, win)
        route = flash_route_of(q, k)
        if route == "wgmma":
            row_tiles, splits = flash_plan_splits(b, hkv, t, c, hq // hkv)
            blocks = b * hkv * row_tiles * splits
        else:   # a block for 64 queries (kMmaBQ) of a head, the ring unsplit
            splits, blocks = 1, b * hq * -(-t // 64)
        padded = d in PADDED_HEAD_DIMS
        if padded:
            # the head dims "wgmma" lays out as 128: both kernels alone,
            # "mma_sync" the one these shapes ran on before
            pos = {} if start is None else dict(q_pos=q_pos, k_pos=k_pos)
            alt = {"wgmma_ms": time_ms(lambda: flash_attention_kernel(
                q, k, v, causal=causal, window=win, route="wgmma", **pos),
                20)}
            alt["mma_sync_ms"] = time_ms(
                lambda: flash_attention_kernel(q, k, v, causal=causal,
                                               window=win, route="mma_sync",
                                               **pos), 20)
        shapes.append({
            "shape": label, "b": b, "hq": hq, "hkv": hkv, "sq": t, "sk": c,
            "d": d, "causal": causal, "window": win, "dtype": "bfloat16",
            "max_abs_err": err,
            "route": route, "splits": splits, "blocks": blocks,
            "ms": time_ms(kernel, 20),
            "plain_ms": time_ms(plain, 3, warmup=1),
            "bound_ms": bound, "bound_by": bound_by,
            "library_ms": time_ms(library, 20),
            **(alt if padded else {}),
        })
        say(f"[kernels] flash_attention {label}: " + json.dumps(shapes[-1]))

    # the int8 ring at the chunk shapes of the serving path, beside the
    # bf16 kernel at the same shape; and kimi-k2's chunk of 256 (D 112, G 8)
    int8_shapes = []
    kimi = get_config("kimi_k2_1t_a32b")
    for (hq, hkv, d), t, start in (
            (heads, 32, 700), (heads, 32, 1900), (heads, PREFILL_CHUNK, 700),
            ((kimi.num_heads, kimi.num_kv_heads, kimi.resolved_head_dim),
             PREFILL_CHUNK, 700)):
        q, k, v = qkv(1, hq, hkv, t, SLOT_CACHE, d, dtype)
        kq, vq, sc = int8_ring(k, v)
        q_pos, k_pos = chunk_positions(1, t, SLOT_CACHE, (start,))
        err, _ = check_flash(q, kq, vq, q_pos, k_pos, kv_scales=sc)
        bound, bound_by = flash_bound_ms(q, kq, q_pos, k_pos, True, 0)
        row_tiles, splits = flash_plan_splits(1, hkv, t, SLOT_CACHE, hq // hkv)
        int8_shapes.append({
            "shape": f"int8 chunk T={t} at {start} D={d}", "b": 1, "hq": hq,
            "hkv": hkv, "sq": t, "sk": SLOT_CACHE, "d": d, "kv": "int8",
            "route": flash_route_of(q, kq), "splits": splits,
            "max_abs_err": err,
            "ms": time_ms(lambda: flash_attn_pos(q, kq, vq, q_pos, k_pos,
                                                 kv_scales=sc), 20),
            "bf16_ms": time_ms(lambda: flash_attn_pos(q, k, v, q_pos, k_pos),
                               20),
            "plain_ms": time_ms(lambda: flash_ref.mha_pos_ref(
                q, kq, vq, q_pos, k_pos, kv_scales=sc), 3, warmup=1),
            "bound_ms": bound, "bound_by": bound_by,
            "bf16_bound_ms": flash_bound_ms(q, k, q_pos, k_pos, True, 0)[0],
            # no one PyTorch call attends over an int8 ring
            "library_ms": None,
            # every split count, the plan's apart
            "other_designs_ms": {
                f"splits {n}": time_ms(
                    lambda: flash_attention_kernel(
                        q, kq, vq, q_pos, k_pos, kv_scales=sc, splits=n), 20)
                for n in (1, 2, 4, 8) if n != splits},
            **({"mma_sync_ms": time_ms(lambda: flash_attention_kernel(
                q, kq, vq, q_pos, k_pos, kv_scales=sc, route="mma_sync"), 20)}
               if d in PADDED_HEAD_DIMS else {}),
        })
        say(f"[kernels] flash_attention {int8_shapes[-1]['shape']}: "
            + json.dumps(int8_shapes[-1]))
    # what encoding the tensor maps of K and V costs on the host: one
    # prefill-shaped call with the same k and v every time (maps from the
    # cache) against calls whose k and v start somewhere new each time (16
    # bytes further into one buffer: two maps encoded a call)
    b, t = 1, PROMPT_LEN
    hq, hkv, d = heads
    q, k, v = qkv(b, hq, hkv, t, t, d, dtype)
    n = k.numel()
    kv_pool = normal(2, n + 8 * 5000, dtype=dtype)
    views = iter(range(10 ** 9))

    def fresh():
        i = next(views) % 5000
        return flash_attn(q, kv_pool[0, 8 * i:8 * i + n].view(k.shape),
                          kv_pool[1, 8 * i:8 * i + n].view(k.shape))

    cached_us = host_us(lambda: flash_attn(q, k, v))
    fresh_us = host_us(fresh, calls=800)
    map_encode = {"cached_call_us": cached_us, "fresh_kv_call_us": fresh_us,
                  "us_per_map": (fresh_us - cached_us) / 2}
    say(f"[kernels] flash_attention host time a call, B 1, S {t}: "
        + json.dumps(map_encode))
    main = shapes[0]
    return {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:32",
        "launches": 0,
        # the scalar keys are the lock-step prefill's shape; "shapes" holds
        # the chunk shapes too
        "max_abs_err": main["max_abs_err"], "ms": main["ms"],
        "kernel_ms": main["ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": main["library_ms"],
        "cases": cases, "max_err_over_tol": max(w for w, _ in worst.values()),
        "worst_by_dtype": worst, "shapes": shapes, "host_map_encode": map_encode,
        "int8_cases": int8_cases, "int8_worst_by_dtype": worst_int8,
        "int8_shapes": int8_shapes,
    }


def kv_quant_phase(cfg) -> dict:
    """The int8 ring's quantization kernel held bit for bit to its plain
    version (``quantize_into_ref``: K's rope by ``apply_rope`` where the
    tables are given, then ``quantize_kv`` and the scatter): the serving
    shapes with the tables the serving paths pass ((1, D/2) at the lock-step
    decode step's one position, (B, 1, D/2) at a slot step, (1, T, D/2) at
    chunks of 32 and 256); head dims 64, 72, 80, 112, 128 and 256 in fp32
    and bf16 at each of those three table shapes, and without a rope at 64,
    72, 112 and 256; V through the strides of a (B, T, Hkv, D) projection;
    rows whose elements fall on .5 exactly (position 0: the rope leaves
    them as they are) and all-zero rows; each case launched twice for equal
    bits.  The serving shapes timed with the rope (the serving paths' one
    launch), without it, and as the chain the serving paths ran before the
    rope was folded in (``apply_rope``'s launches, then the kernel); and
    the host time of a call with and without the tables, and of the
    tables' checks alone (``_rope_tables``)."""
    gen = torch.Generator(device="cuda").manual_seed(1357)
    hkv, d = cfg.num_kv_heads, cfg.resolved_head_dim

    def rings(b, h, c, dd):
        return ([torch.zeros(b, h, c, dd, dtype=torch.int8, device="cuda")
                 for _ in range(2)]
                + [torch.zeros(b, h, c, 1, dtype=torch.bfloat16,
                               device="cuda") for _ in range(2)])

    def new_rows(b, h, t, dd, dtype, strided):
        k = torch.randn(b, h, t, dd, generator=gen, device="cuda") * 3
        v = torch.randn(b, t, h, dd, generator=gen, device="cuda")
        v = v.transpose(1, 2) if strided else v.transpose(1, 2).contiguous()
        k[0, 0, 0] = 0.0                                  # an all-zero row
        ties = torch.tensor([0.5, 1.5, 2.5, -0.5, -2.5, 126.5, -127.0, 3.5],
                            device="cuda")                # ties at .5
        k[-1, -1, -1, :8] = ties
        if h > 1:
            k[0, 1, 0, :8] = ties
        return k.to(dtype), v.to(dtype)

    def positions(b, t, c, at):
        if at is not None and t == 1:
            return at                     # one position for every row
        base = torch.randint(0, 4 * c, (b, 1), generator=gen, device="cuda")
        if at is not None:
            base = torch.full((b, 1), at, device="cuda")
        return (base + torch.arange(t, device="cuda")).to(torch.int32)

    def tables(pos, dd):
        """The rope tables the serving paths build for these positions."""
        if isinstance(pos, int):
            pos = torch.full((1,), pos, dtype=torch.int32, device="cuda")
        return rope_tables(pos, dd, cfg.rope_theta)

    cases = 0
    serving = (("lock-step decode", BATCH, 1, CACHE, PROMPT_LEN + STEPS // 2),
               ("continuous decode", SLOTS, 1, SLOT_CACHE, None),
               ("chunk T=32", 1, 32, SLOT_CACHE, 700),
               (f"chunk T={PREFILL_CHUNK}", 1, PREFILL_CHUNK, SLOT_CACHE,
                700))
    # (label, B, T, C, position (None: random rows), Hkv, D, type, V
    # strided, rope)
    sweep = [(label, b, t, c, at, hkv, d, torch.bfloat16, True, True)
             for label, b, t, c, at in serving]
    sweep += [(f"D={dd} {str(dt).split('.')[1]} rope {shape}", b, t, c, at,
               h, dd, dt, True, True)
              for dd in (64, 72, 80, 112, 128, 256)
              for dt in (torch.float32, torch.bfloat16)
              for shape, b, t, c, at, h in (("(1, D/2)", 3, 1, 77, 0, 5),
                                            ("(B, 1, D/2)", 4, 1, 300, None,
                                             2),
                                            ("(1, T, D/2)", 1, 37, 300, 0,
                                             3))]
    sweep += [(f"D={dd} {str(dt).split('.')[1]}", b, t, c, at, h, dd, dt,
               strided, False)
              for dd in (64, 72, 112, 256) for dt in (torch.float32,
                                                      torch.bfloat16)
              for b, t, c, at, h, strided in ((3, 1, 77, 100, 5, False),
                                              (2, 5, 300, None, 2, True))]
    shapes = []
    for label, b, t, c, at, h, dd, dtype, strided, rope in sweep:
        k_new, v_new = new_rows(b, h, t, dd, dtype, strided)
        pos = positions(b, t, c, at)
        sc = tables(pos, dd) if rope else (None, None)
        got, again, want = rings(b, h, c, dd), rings(b, h, c, dd), \
            rings(b, h, c, dd)
        kv_quant_kernel(k_new, v_new, *got, pos, *sc)
        kv_quant_kernel(k_new, v_new, *again, pos, *sc)
        torch.cuda.synchronize()
        quantize_into_ref(k_new, v_new, *want, pos, *sc)
        for name, a, b2, w in zip(("k", "v", "k_scale", "v_scale"), got,
                                  again, want):
            if not torch.equal(a, b2):
                fail(f"kv_quant gave other bits on a second launch: {label} "
                     f"{name}")
            if not torch.equal(a, w):
                fail(f"kv_quant differs from apply_rope, quantize_kv and "
                     f"its scatter at {label} (B {b}, Hkv {h}, T {t}, C {c}, "
                     f"D {dd}, {dtype}, rope {rope}): {name}, "
                     f"{int((a.float() != w.float()).sum())} elements")
        cases += 1
        if (label, b, t, c, at) not in serving:
            continue
        elems = 2 * b * h * t * dd
        nbytes = (elems * k_new.element_size() + elems + 2 * b * h * t * 2
                  + 2 * sc[0].numel() * sc[0].element_size())
        shapes.append({
            "shape": label, "b": b, "hkv": h, "t": t, "c": c, "d": dd,
            "src": "bfloat16", "rope": list(sc[0].shape), "max_abs_err": 0.0,
            "ms": time_ms(lambda: kv_quant_kernel(k_new, v_new, *got, pos,
                                                  *sc), 100),
            "no_rope_ms": time_ms(lambda: kv_quant_kernel(
                k_new, v_new, *got, pos), 100),
            "rope_then_kernel_ms": time_ms(lambda: kv_quant_kernel(
                apply_rope(k_new, *sc), v_new, *got, pos), 100),
            # the host's share of a call: the wrapper with the tables, without
            # them, and the tables' checks alone
            "host_us": host_us(lambda: kv_quant_kernel(k_new, v_new, *got,
                                                       pos, *sc)),
            "no_rope_host_us": host_us(lambda: kv_quant_kernel(
                k_new, v_new, *got, pos)),
            "rope_checks_host_us": host_us(lambda: kv_quant_tables(
                *sc, b, t, dd, k_new.device)),
            "plain_ms": time_ms(lambda: quantize_into_ref(
                k_new, v_new, *want, pos, *sc), 20),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            # no one PyTorch call ropes, quantizes and scatters
            "library_ms": None,
        })
        say(f"[kernels] kv_quant {label}: " + json.dumps(shapes[-1]))
    say(f"[kernels] kv_quant: {cases} cases equal to the plain version bit "
        f"for bit, twice each")
    main = shapes[1]
    return {
        "name": "kv_quant", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/kv_quant.cu",
        # no TPU kernel: the reference quantizes in jnp (_quantize_kv and
        # its scatter), which plain PyTorch runs as about ten launches
        "replaces": "src/repro/models/transformer.py:233",
        "launches": 0, "max_abs_err": 0.0, "ms": main["ms"],
        "kernel_ms": main["ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": "bytes",
        "library_ms": None, "cases": cases, "shapes": shapes,
    }


def check_matmul(x, y, **blocks) -> tuple[float, float]:
    """(max abs error, largest error over its limit) of the kernel against
    ``matmul_ref`` on these inputs; fails the run beyond the limit.  The
    product is launched twice and must give the same bits both times.

    Both sides take the same inputs and sum their products in fp32 (the
    products of two bf16 values are exact), in other orders.  Each sum is
    within K ulp-sized steps of the exact one, so per output the two differ
    by at most ``2 K 2**-23 (|x| @ |y|)`` (an ulp, not half of one, for
    the tensor cores' adder); in bf16 the output is rounded once on each
    side, which adds at most one bf16 unit, ``2**-7 |ref|``.  The limit is
    that sum, and never more than the reference's kernel-test bound
    ``TOL * (max|ref| + 1)``."""
    out = matmul(x, y, **blocks)
    again = matmul(x, y, **blocks)
    torch.cuda.synchronize()
    route = "mma_sync" if blocks else matmul_route_of(x, y)
    where = (f"x{tuple(x.shape)} stride {x.stride()} y{tuple(y.shape)} "
             f"stride {y.stride()} {x.dtype} blocks {blocks or 'planned'} "
             f"route {route}")
    if not torch.equal(out, again):
        fail(f"elk_matmul gave other bits the second time at {where}")
    ref = matmul_ref(x, y)
    if out.shape != ref.shape or out.dtype != ref.dtype:
        fail(f"elk_matmul gave {tuple(out.shape)} {out.dtype}, plain version "
             f"{tuple(ref.shape)} {ref.dtype} at {where}")
    if not torch.isfinite(out.to(torch.float32)).all():
        fail(f"elk_matmul output not finite at {where}")
    ref32 = ref.to(torch.float32)
    diff = (out.to(torch.float32) - ref32).abs()
    k = x.shape[1]
    limit = 2 * k * 2.0 ** -23 * torch.matmul(x.to(torch.float32).abs(),
                                              y.to(torch.float32).abs())
    if x.dtype == torch.bfloat16:
        limit += 2.0 ** -7 * ref32.abs()
    cap = TOL[x.dtype] * (float(ref32.abs().max()) + 1.0)
    limit = limit.clamp(max=cap)
    over = float((diff / limit.clamp(min=1e-30)).max())
    err = float(diff.max())
    if over > 1.0:
        fail(f"elk_matmul disagrees with matmul_ref at {where}: max abs err "
             f"{err:.3e}, {over:.3f} x its limit")
    return err, over


def matmul_bound_ms(m, n, k, dtype) -> tuple[float, str]:
    """Least time for the product: x and y read once, the output written
    once, at the memory rate; its 2 m n k operations at the peak rate."""
    size = torch.empty((), dtype=dtype).element_size()
    t_bytes = (m * k + k * n + m * n) * size / HBM_BYTES_PER_S
    t_ops = 2 * m * n * k / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def elk_matmul_phase(cfg) -> dict:
    """The reference's matmul sweep against ``matmul_ref``, at the
    reference test's blocks (64, the mma_sync kernel) and on the planned
    route, with a transposed ``y`` and a strided ``x``; the rows at the
    edges of every route with n and K ragged, both layouts of ``y``, a
    strided ``x`` TMA takes and one it does not; then the products
    ``layers.linear`` gives the kernel on the serving paths, full width,
    bf16, timed: q/o, k/v at 8, 32, 256 and 4096 rows, the LM head at 8 and
    32; and every product of the [models] phase (``MODEL_RUNS``)."""
    gen = torch.Generator(device="cuda").manual_seed(1357)

    def normal(*shape, dtype, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda",
                            dtype=torch.float32) * scale).to(dtype)

    worst = {"float32": (0.0, 0.0), "bfloat16": (0.0, 0.0)}
    reached = dict.fromkeys(MATMUL_ROUTES, 0)
    cases = 0

    def case(x, y, **blocks):
        nonlocal cases
        err, over = check_matmul(x, y, **blocks)
        key = str(x.dtype).split(".")[1]
        worst[key] = max(worst[key], (over, err))
        reached["mma_sync" if blocks else matmul_route_of(x, y)] += 1
        cases += 1
        return err

    for dtype in (torch.float32, torch.bfloat16):
        for m, n, k in MATMUL_SWEEP:
            x, y = normal(m, k, dtype=dtype), normal(k, n, dtype=dtype)
            case(x, y, bm=64, bn=64, bk=64)
            case(x, y)
            # y as the transpose of an (n, k) tensor (a tied embedding)
            case(x, y.t().contiguous().t(), bm=64, bn=64, bk=64)
            case(x, y.t().contiguous().t())
        # x with a row stride (the last token of a prefill), rows 8-aligned
        # and not
        for k in (64, 70):
            xs = normal(3, 5, k, dtype=dtype)[:, -1, :]
            case(xs, normal(k, 100, dtype=dtype))
            case(xs, normal(100, k, dtype=dtype).t())
    # bf16 at the edges of the routes: splitk below 64 rows, wgmma from 64;
    # n and K ragged against every tile and n != K; both layouts of y; x
    # strided with a stride TMA takes (3 K) and one it does not (a base 2
    # bytes off 16)
    n, k = MATMUL_EDGE_NK
    for m in MATMUL_EDGE_M:
        x = normal(m, k, dtype=torch.bfloat16)
        y = normal(k, n, dtype=torch.bfloat16)
        case(x, y)
        case(x, y.t().contiguous().t())
        case(normal(m, 3, k, dtype=torch.bfloat16)[:, 1, :], y)
        case(normal(m, k + 1, dtype=torch.bfloat16)[:, 1:], y)
    # 128-row tiles 128 and 256 wide, n ragged against them, an even and an
    # odd number of row tiles
    for m in (1024, 1152):
        for wide in (11 * n, 22 * n):
            case(normal(m, k, dtype=torch.bfloat16),
                 normal(k, wide, dtype=torch.bfloat16))
    # a product 8 wide (dit-xl's LM head, vocab 8: a tile of 64 or more
    # columns over 8) at the rows of a decode step, of the routes' edges and
    # of a prefill, on the planned route and on mma_sync
    for m in (1, 8, 63, 64, 4096):
        x = normal(m, 1152, dtype=torch.bfloat16)
        y = normal(1152, 8, dtype=torch.bfloat16)
        case(x, y)
        case(x, y, bm=64, bn=64, bk=64)
    # odd N, the odd vocabularies' case: an output row stride of 1001 (the
    # single-element stores), y untied (row stride 1001: no TMA, mma_sync)
    # and tied (TMA with an N tail); in fp32 (FMA) N 32 and 1001 as hymba's
    # w_bc and a vocabulary give it
    for m in (1, 8, 17, 64, 65, 300):
        for dtype in (torch.float32, torch.bfloat16):
            x = normal(m, 136, dtype=dtype)
            y = normal(136, 1001, dtype=dtype)
            case(x, y)
            case(x, y.t().contiguous().t())
        case(normal(m, 200, dtype=torch.float32),
             normal(200, 32, dtype=torch.float32))
    # the realigning producer ("_realign" routes): y's rows 1001 and 32001
    # elements apart (hymba's untied head), a base 2 bytes off 16 (a
    # contiguous view, and column views of a wider weight on an odd stride
    # and on one TMA would take), the head also on the mma_sync kernel
    bf16 = torch.bfloat16
    odd_ys = (normal(200, 1001, dtype=bf16), normal(200, 32001, dtype=bf16),
              normal(200 * 1000 + 1, dtype=bf16)[1:].view(200, 1000),
              normal(200, 1025, dtype=bf16)[:, 1:],
              normal(200, 1032, dtype=bf16)[:, 1:1001])
    for m in (1, 8, 17, 64, 65, 300):
        x = normal(m, 200, dtype=bf16)
        for y in odd_ys:
            case(x, y)
        case(x, odd_ys[1], bm=64, bn=64, bk=64)
    # fp32 ("fma", "fma_splitk"): hymba's w_bc (N 32) and w_dt (N 1600),
    # K 1600, at the rows of a decode step, the tiles' edges and a prefill
    for m in (1, 8, 17, 64, 65, 4096):
        x = normal(m, 1600, dtype=torch.float32)
        for n in (32, 1600):
            case(x, normal(1600, n, dtype=torch.float32, scale=1600 ** -0.5))
    # x read transposed, route "wgmma_xt" (a weight gradient's x^T dy; the
    # [train] phase sweeps it in full): a split short wave, a tile split
    # over five blocks
    for tok, width, n in ((1000, 2176, 1024), (513, 64, 136)):
        case(normal(tok, width, dtype=bf16).t(), normal(tok, n, dtype=bf16))
    if min(reached.values()) < 1:
        fail(f"the elk_matmul sweep did not reach every route: {reached}")
    say(f"[kernels] elk_matmul: {cases} sweep cases inside their limits, each "
        f"launched twice with equal bits (by route {json.dumps(reached)}; "
        f"worst err/limit and its err: {json.dumps(worst)})")

    dtype = torch.bfloat16
    shapes = []

    def product_row(label, x, w):
        """Hold ``x @ w`` to its plain version and time it beside the plain
        version and the library call."""
        err = case(x, w)
        m, n, k, lda, ldy, _ = matmul_layout(x, w)
        plan = plan_of(x, w)
        bound, bound_by = matmul_bound_ms(m, n, k, x.dtype)
        iters = 5 if m * n > 2 ** 24 else 20
        old = {}
        if plan.route in NEW_MATMUL_ROUTES:
            # the mma_sync kernel these shapes ran on before, on its plan
            o = plan_for(m, n, k, x.dtype, mma_sync=True)
            old = {"old_route": "mma_sync",
                   "old_tiles": [o.bm, o.bn, o.bk],
                   "old_route_ms": time_ms(lambda: matmul(
                       x, w, bm=o.bm, bn=o.bn, bk=o.bk), iters)}
        shapes.append({
            "shape": label, "m": m, "n": n, "k": k,
            "dtype": str(x.dtype).split(".")[1],
            "route": plan.route, "tiles": [plan.bm, plan.bn, plan.bk],
            "stages": plan.stages, "splits": plan.splits,
            "blocks": plan.blocks, "smem_bytes": plan.smem_bytes,
            "max_abs_err": err,
            "ms": time_ms(lambda: matmul(x, w), iters),
            "plain_ms": time_ms(lambda: matmul_ref(x, w), 3, warmup=1),
            "bound_ms": bound, "bound_by": bound_by,
            "library_ms": time_ms(lambda: torch.matmul(x, w), iters),
            **old,
        })
        say(f"[kernels] elk_matmul {label}: " + json.dumps(shapes[-1]))

    d = cfg.d_model
    products = {"q, o": cfg.num_heads * cfg.resolved_head_dim,
                "k, v": cfg.num_kv_heads * cfg.resolved_head_dim,
                "lm_head": cfg.vocab_size}
    weights = {name: normal(d, n, dtype=dtype, scale=d ** -0.5)
               for name, n in products.items()}
    x_all = normal(BATCH * PROMPT_LEN, d, dtype=dtype)
    for m in (BATCH, 32, PREFILL_CHUNK, BATCH * PROMPT_LEN):
        for name, w in weights.items():
            if name != "lm_head" or m <= 32:
                product_row(f"{name} m={m}", x_all[:m], w)
    # host cost of a call at the decode step's q/o product (161 calls a
    # step): checks, plan lookup, allocation and the ctypes launch, against
    # torch.matmul's
    x, w = x_all[:BATCH], weights["q, o"]
    host = {"elk_matmul": host_us(lambda: matmul(x, w)),
            "torch.matmul": host_us(lambda: torch.matmul(x, w))}
    say(f"[kernels] elk_matmul host us a call, q, o m={BATCH}: "
        + json.dumps(host))
    del weights, x_all, x, w
    # every product the [models] and [families] phases give the kernel,
    # config by config at full width: each layer product at the rows of its
    # layers (an encoder's at a prefill's frames; hymba's w_dt and w_bc in
    # fp32), the LM head (tied: the transposed embedding) at the rows of its
    # head; a shape two products or two configs share is held once
    held = set()
    for arch, depth, prompt_len, _ in RUNS:
        mcfg = model_cfg(arch, depth)
        rows_of = model_rows(arch, prompt_len)
        by_shape = {}
        for name, k, n, ldy, count, where in layer_products(mcfg):
            if count:
                key = (k, n, ldy != n, where, product_dtype(name))
                by_shape.setdefault(key, []).append(name)
        for (k, n, tied, where, pdtype), names in by_shape.items():
            rows = [m for m in rows_of[where]
                    if (m, k, n, tied, pdtype) not in held]
            if not rows:
                continue
            w = (normal(n, k, dtype=pdtype, scale=k ** -0.5).t() if tied
                 else normal(k, n, dtype=pdtype, scale=k ** -0.5))
            x_all = normal(max(rows), k, dtype=pdtype)
            for m in rows:
                held.add((m, k, n, tied, pdtype))
                product_row(f"{mcfg.name} {', '.join(names)}"
                            f"{' (tied)' if tied else ''}"
                            f"{' fp32' if pdtype == torch.float32 else ''}"
                            f" m={m}", x_all[:m], w)
            del w, x_all
    main = shapes[0]                   # q, o at a decode step
    return {
        "name": "elk_matmul", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/elk_matmul.cu",
        "replaces": "src/repro/kernels/elk_matmul/kernel.py:31",
        "launches": 0,
        # the scalar keys are the decode step's q/o product (the most
        # launches on the paths); "shapes" holds the others
        "max_abs_err": main["max_abs_err"], "ms": main["ms"],
        "kernel_ms": main["ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": main["library_ms"],
        "cases": cases, "max_err_over_tol": max(w for w, _ in worst.values()),
        "worst_by_dtype": worst, "sweep_routes": reached, "shapes": shapes,
        "host_us_per_call": host,
    }


# ---------------------------------------------------------------------------
# phase 4: CPU (plain path) against the card (kernel path)
# ---------------------------------------------------------------------------

def parity_phase() -> None:
    """For each smoke config in fp32 (every id of ``ARCH_IDS``), on the
    same seeded weights: the CPU (plain path) against the card (kernel
    path), with resident weights (``gspmd``) and streamed ones
    (``elk_stream``, a window of 2 of the 2 layers; an MoE layer's experts
    fetched after its router; an enc-dec model resident under both, as the
    reference keeps it)."""
    for arch in ARCH_IDS:
        parity_config(dataclasses.replace(
            get_smoke_config(arch), dtype="float32", param_dtype="float32"))
    # the int8 ring: quantized on the card by kv_quant, read by the fma
    # routes of both attention kernels, which round each dequantized
    # element to bf16 as the CPU's plain path does
    parity_config(dataclasses.replace(
        get_smoke_config("qwen3_14b"), dtype="float32",
        param_dtype="float32"), kv_dtype="int8")
    parity_fleets()
    # ties go to the first index on the card as on the CPU
    rows = torch.zeros(3, 300)
    rows[0, [7, 200]] = 3.0
    rows[2, [150, 151]] = 2.0
    if torch.argmax(rows.cuda(), dim=-1).tolist() != [7, 0, 150]:
        fail("torch.argmax on the card does not pick the first maximum")


def parity_config(cfg, kv_dtype: str = "float32") -> None:
    params = tfm.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    modes = ("gspmd", "elk_stream")
    scfg = ServeConfig(batch=2, cache_capacity=32, kv_dtype=kv_dtype,
                       prefetch_depth=2)
    kv = "int8" if kv_dtype == "int8" else "bfloat16"
    name = cfg.name + (" int8 KV" if kv == "int8" else "")
    engines = {(dev, mode): ServeEngine(
        cfg, params, dataclasses.replace(scfg, mode=mode), device=dev)
        for dev in ("cpu", "cuda") for mode in modes}
    prompts = torch.randint(0, cfg.vocab_size, (2, 12),
                            generator=torch.Generator().manual_seed(1))
    fe = frontend_embeddings(cfg, 2, device="cpu")   # what generate draws
    before = read_launches()
    toks = {key: eng.generate(prompts, steps=8).cpu()
            for key, eng in engines.items()}
    launched = {k: n - before[k] for k, n in read_launches().items()}
    want = lockstep_expected(cfg, 2, 12, 8, kv)
    want = {k: len(modes) * n for k, n in want.items() if k != "routes"}
    if launched != want:
        fail(f"{name}: the card's engines launched the kernels "
             f"{launched} times, their passes say {want}")
    ref = toks["cpu", "gspmd"]
    for key, got in toks.items():
        if not torch.equal(ref, got):
            fail(f"{name}: greedy tokens differ between the CPU (gspmd) "
                 f"and {key}:\n{ref}\n{got}")
    # last-step logits, all fed the CPU run's tokens
    last = {}
    for key, eng in engines.items():
        logits, cache = eng.prefill(prompts, **fe)
        for step in range(7):
            logits, cache = eng.decode(ref[:, 12 + step], cache)
        last[key] = logits.to(torch.float32).cpu()
    base = last["cpu", "gspmd"]
    err = max(float((base - got).abs().max()) for got in last.values())
    tol = 2e-4 * (float(base.abs().max()) + 1.0)
    if err > tol:
        fail(f"{name}: last-step logits differ: {err:.3e} > {tol:.3e}")
    if not torch.equal(last["cuda", "gspmd"], last["cuda", "elk_stream"]):
        fail(f"{name}: on the card elk_stream and gspmd logits are not "
             "identical")
    say(f"[parity] smoke {name} fp32: tokens equal on CPU and card, "
        f"{' and '.join(modes)}, last-step logits max abs diff {err:.3e} "
        f"(tol {tol:.3e}); on the card elk_stream equals gspmd bit for bit"
        + ("" if engines["cuda", "elk_stream"].streamed else
           " (an enc-dec model: resident under elk_stream)"))
    if cfg.encoder_layers:      # no slot path, as in the reference
        return

    # continuous batching: the same trace through every engine's batcher
    # (chunks of 8 into rings of 32; MoE dropless on the slot path); the
    # card launches the kernels a pass of the config runs (an RWKV config
    # no attention and no MLP), the CPU none
    used = {k for k, n in passes_expected(
        cfg, [("chunk", 8, 1), ("decode", 2, 2)], kv).items()
        if k != "routes" and n}
    done = {}
    for (dev, mode), eng in engines.items():
        eng.scfg.prefill_chunk = 8
        before = read_launches()
        comps = ContinuousBatcher(eng).run(make_trace(
            6, vocab_size=cfg.vocab_size))
        done[dev, mode] = {c.rid: c.tokens for c in comps}
        launched = {k: n - before[k] for k, n in read_launches().items()}
        if {k for k, n in launched.items() if n} != (
                used if dev == "cuda" else set()):
            fail(f"{name}: the {dev} {mode} batcher launched the kernels "
                 f"{launched} times")
    ref = done["cpu", "gspmd"]
    for key, got in done.items():
        if sorted(got) != list(range(6)) or any(
                not np.array_equal(ref[r], got[r]) for r in ref):
            fail(f"{name}: continuous-batching tokens differ between the "
                 f"CPU (gspmd) and {key}:\n{ref}\n{got}")
    say(f"[parity] smoke {name} fp32: ContinuousBatcher tokens equal on "
        f"CPU and card, {' and '.join(modes)}, for 6 mixed requests")


# the virtual prices of a tick in the parity phase's fleets (the reference
# tests' COSTS)
PARITY_FLEET_COSTS = PodCosts(decode_step_s=1e-3, tick_overhead_s=5e-4)


def fleet_outcome(completions, summary: dict, router=None) -> dict:
    """What a fleet run must reproduce: each request's tokens, virtual
    first-token and finish times and place in the finish order, the
    summary's ``summarize`` keys, and the router's migrations."""
    out = {"completions": [(c.rid, c.tokens.tolist(), c.first_token_s,
                            c.finish_s, c.finish_order) for c in completions],
           "summary": {k: summary[k] for k in summarize(completions, 1.0)}}
    if router is not None:
        out.update(migration_events=list(router.migration_events),
                   planned_migration_s=router.planned_migration_s,
                   routed=list(router.routed), shed=len(router.shed))
    return out


def parity_fleets() -> None:
    """The qwen3 smoke config in fp32 on seeded weights, on the CPU and on
    the card, resident and streamed (the pods of a streamed fleet share one
    ``LayerStream``), through (a) a fleet of one mixed pod, which must equal
    ``run_virtual_trace`` of a direct batcher, and (b) a prefill pod (chunk
    ``PREFILL_SAT`` clamped to the ring) and a decode pod (chunk 16) priced
    by ``fleet_spec(h100_host(), 2)``, every request migrating.  Tokens,
    virtual times, summaries and migration events must be equal on all
    four; the card launches the kernels of the passes, the CPU none."""
    cfg = dataclasses.replace(get_smoke_config("qwen3_14b"), dtype="float32",
                              param_dtype="float32")
    params = tfm.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    scfg = ServeConfig(batch=2, cache_capacity=32, kv_dtype="float32",
                       prefetch_depth=2, prefill_chunk=8)
    trace = make_trace(6, vocab_size=cfg.vocab_size, arrival_spacing_s=1e-3)
    used = {k for k, n in passes_expected(
        cfg, [("chunk", 8, 1), ("decode", 2, 2)]).items()
        if k != "routes" and n}
    results = {}
    for dev in ("cpu", "cuda"):
        for mode in ("gspmd", "elk_stream"):
            base = ServeEngine(cfg, params, dataclasses.replace(
                scfg, mode=mode), device=dev)

            def engine(chunk: int) -> ServeEngine:
                return ServeEngine(cfg, base.params, dataclasses.replace(
                    base.scfg, prefill_chunk=chunk), device=dev)

            fleets = {
                "one mixed pod": ([FleetPod(engine(8), "mixed",
                                            costs=PARITY_FLEET_COSTS)], None),
                "disaggregated": ([
                    FleetPod(engine(min(PREFILL_SAT, 32)), "prefill",
                             costs=PARITY_FLEET_COSTS),
                    FleetPod(engine(16), "decode",
                             costs=PARITY_FLEET_COSTS)],
                    fleet_spec(h100_host(), 2))}
            runs = {}
            for label, (pods, fl) in fleets.items():
                before = read_launches()
                fr = FleetRouter(pods, fleet=fl)
                fr.run(trace)
                launched = {k for k, n in read_launches().items()
                            if n - before[k]}
                if launched != (used if dev == "cuda" else set()):
                    fail(f"parity fleet {label} on {dev} {mode} launched "
                         f"{sorted(launched)}, its passes run {sorted(used)}")
                if len(fr.completed) != len(trace):
                    fail(f"parity fleet {label}: {len(fr.completed)} of "
                         f"{len(trace)} requests completed")
                runs[label] = fleet_outcome(fr.completed, fr.summary(), fr)
            if runs["disaggregated"]["summary"]["requests"] != len(trace) or \
                    len(runs["disaggregated"]["migration_events"]) != \
                    len(trace):
                fail(f"parity fleet on {dev} {mode}: not every request "
                     "migrated")
            vc = VirtualClock()
            comps = run_virtual_trace(ContinuousBatcher(engine(8), vc),
                                      trace, PARITY_FLEET_COSTS)
            direct = fleet_outcome(comps, summarize(comps, vc.t))
            one = {k: runs["one mixed pod"][k] for k in direct}
            if one != direct:
                fail(f"parity fleet of one mixed pod on {dev} {mode} differs "
                     f"from run_virtual_trace:\n{one}\n{direct}")
            results[dev, mode] = runs
    ref = results["cpu", "gspmd"]
    for key, runs in results.items():
        for label, got in runs.items():
            if got != ref[label]:
                fail(f"parity fleet {label}: {key} differs from the CPU's "
                     f"gspmd run:\n{got}\n{ref[label]}")
    dis = ref["disaggregated"]
    say(f"[parity] smoke {cfg.name} fp32 fleets: one mixed pod equal to "
        "run_virtual_trace, and a prefill + decode fleet (6 migrations of "
        f"{dis['migration_events'][0][0]} bytes, planned "
        f"{dis['planned_migration_s']:.6f} s): tokens, virtual times, "
        "summaries and migration events equal on CPU and card, gspmd and "
        "elk_stream (the pods on one LayerStream)")


# ---------------------------------------------------------------------------
# phase 5: full-width serving
# ---------------------------------------------------------------------------

class _XtCount:
    """The launches of ``elk_matmul`` that read x transposed (the x^T dy
    of a weight gradient), counted as a kernel of their own."""

    @property
    def launches(self) -> int:
        return elk_matmul_kernel.by_operand["x_trans"]

    @launches.setter
    def launches(self, n: int) -> None:
        elk_matmul_kernel.by_operand["x_trans"] = n


# the kernels of the serving paths, whose rows the kernel phases make
COUNTERS = {"fused_mlp": fused_mlp_kernel,
            "decode_attention": decode_attention_kernel,
            "flash_attention": flash_attention_kernel,
            "elk_matmul": elk_matmul_kernel,
            "kv_quant": kv_quant_kernel}
SERVING_KERNELS = tuple(COUNTERS)
# the training side's: the backward kernels, and the products of elk_matmul
# that read x transposed (x^T dy, counted in elk_matmul's launches too)
TRAIN_COUNTERS = {"fused_mlp_bwd": fused_mlp_bwd_kernel,
                  "flash_attention_bwd": flash_attention_bwd_kernel,
                  "elk_matmul_xt": _XtCount()}


def zero_launches() -> None:
    for counter in (*COUNTERS.values(), *TRAIN_COUNTERS.values()):
        counter.launches = 0
        for by in ("by_route", "by_kv", "by_operand"):
            if hasattr(counter, by):
                setattr(counter, by, dict.fromkeys(getattr(counter, by), 0))


def _counters(train: bool) -> dict:
    return {**COUNTERS, **TRAIN_COUNTERS} if train else COUNTERS


def read_launches(train: bool = False) -> dict:
    """Launches of the serving kernels, and with ``train`` of the training
    side's too."""
    return {name: counter.launches
            for name, counter in _counters(train).items()}


def read_routes(train: bool = False) -> dict:
    """Launches by route of every kernel that has routes, and the attention
    kernels' by the type of the K/V they read ("<name> kv")."""
    out = {}
    for name, counter in _counters(train).items():
        if hasattr(counter, "by_route"):
            out[name] = dict(counter.by_route)
        if hasattr(counter, "by_kv"):
            out[f"{name} kv"] = dict(counter.by_kv)
    return out


def record_launches(rows: list[dict], path: str, counts: dict,
                    expected: dict, routes: dict) -> None:
    """Add one path's launch counts to the kernels' rows; fail if a kernel
    was not launched as often as the path's layers, steps and chunks say,
    or not through the routes their rows say (``expected["routes"]``).  A
    kernel the path does not run (an RWKV model's attention and MLP) must
    launch 0 times and is not counted among the path's kernels."""
    for row in rows:
        n = counts[row["name"]]
        if n != expected[row["name"]]:
            fail(f"{row['name']} launched {n} times on the {path} path, "
                 f"expected {expected[row['name']]}")
        if not n:
            continue
        row.setdefault("launches_by_path", {})[path] = n
        row["launches"] += n
        for key, field in ((row["name"], "launches_by_route"),
                           (f"{row['name']} kv", "launches_by_kv")):
            if key not in routes:
                continue
            got = {r: c for r, c in routes[key].items() if c}
            want = {r: c for r, c in expected["routes"][key].items() if c}
            row.setdefault(field, {})[path] = got
            if got != want:
                fail(f"{row['name']} went through {got} ({field}) on the "
                     f"{path} path, expected {want}")


def chunk_lengths(trace, budget: int) -> list[int]:
    """The prefill chunks the batcher cuts the trace's prompts into."""
    out = []
    for r in trace:
        off = 0
        while off < len(r.prompt):
            out.append(_chunk_len(len(r.prompt) - off, budget))
            off += out[-1]
    return out


def passes_expected(cfg, passes: list[tuple[str, int, int]],
                    kv: str = "bfloat16") -> dict:
    """Launches, in all and by route, of bf16 passes of ``cfg`` at full
    width over a ring of type ``kv``, each (a prefill "flash", a chunk of a
    prompt "chunk" or a decode step "decode", rows of the layers, rows of
    the LM head).  Every attention layer launches its attention kernel, the
    four projections and its MLP; an MoE layer the router (a product) and
    its shared expert's MLP in place of the MLP; a hybrid layer the four
    products of its SSM branch (two in fp32); an RWKV layer its eight
    products and no attention and no MLP; an enc-dec model's decoder layer
    a cross-attention (flash attention at every pass, Sq the pass's tokens,
    and its q, o products) and, at a flash pass (a prefill, whose head rows
    are its batch), its cross k, v products and the encoder's layers over
    the batch's frames; the head one product a pass.  By route: the MLP on
    "two_pass" above SPLIT_FF_MAX_M rows and "split_ff" at or below; each
    product on the route of its plan (``elk_matmul.kernel.route_for``: TMA
    takes it when it is bf16 and its row strides are whole 16 bytes, the
    "_realign" routes an untied head whose rows are not, "fma" /
    "fma_splitk" the fp32 ones); flash attention on the route of
    ``flash_attention.kernel.route_for`` for the K/V it reads (a chunk over
    an int8 ring at D 72 on "mma_sync"); decode attention on "mma".  By the
    type of K/V the attention kernels read:
    the ring's at a decode step and a chunk, the activations' (bf16) at a
    prefill, in cross-attention and in the encoder.  ``kv_quant`` once a
    layer at a decode step and a chunk over an int8 ring."""
    layers = 0 if cfg.rwkv else cfg.num_layers
    enc, cross = cfg.encoder_layers, cfg.num_layers if cfg.encoder_layers else 0
    d, g = cfg.resolved_head_dim, cfg.num_heads // cfg.num_kv_heads
    kv_dtype = torch.int8 if kv == "int8" else torch.bfloat16
    mlp = dict.fromkeys(MLP_ROUTES, 0)
    mm = dict.fromkeys(MATMUL_ROUTES, 0)
    attn = {"flash_attention": dict.fromkeys(FLASH_ROUTES, 0),
            "decode_attention": dict.fromkeys(DECODE_ROUTES, 0)}
    kv_of = {"flash_attention kv": dict.fromkeys(KV_TYPES, 0),
             "decode_attention kv": dict.fromkeys(KV_TYPES, 0)}
    quant = 0

    def route(m, k, n, ldy, dtype):
        # a tied head is the transposed embedding: its rows are K long
        return matmul_route_for(m, n, k, dtype, k, ldy, int(ldy != n))

    for kind, rows, head_rows in passes:
        flash = kind != "decode"
        prefill = kind == "flash"
        # a chunk reads the ring's type, the rest bf16 K/V (cross-attention,
        # the encoder, a prefill's own)
        bf16_route = flash_route_for(torch.bfloat16, torch.bfloat16, d, g)
        attn["flash_attention"][bf16_route] += cross + (
            enc if prefill else 0)
        if flash:
            attn["flash_attention"][flash_route_for(
                torch.bfloat16, torch.bfloat16 if prefill else kv_dtype,
                d, g)] += layers
        kv_of["flash_attention kv"]["bfloat16"] += cross + (
            enc if prefill else 0)
        if prefill:
            kv_of["flash_attention kv"]["bfloat16"] += layers
        elif flash:
            kv_of["flash_attention kv"][kv] += layers
        else:
            attn["decode_attention"]["mma"] += layers
            kv_of["decode_attention kv"][kv] += layers
        if kv == "int8" and not prefill:
            quant += layers
        m_of = {"layer": rows, "head": head_rows,
                "encoder": head_rows * cfg.encoder_seq if prefill else 0}
        for _, _, count, where in layer_mlps(cfg):
            if count and m_of[where]:
                mlp["two_pass" if m_of[where] > SPLIT_FF_MAX_M
                    else "split_ff"] += count
        for name, k, n, ldy, count, where in layer_products(cfg):
            if count and m_of[where]:
                mm[route(m_of[where], k, n, ldy, product_dtype(name))] += count
    routes = {"fused_mlp": mlp, "elk_matmul": mm, **attn}
    return {**{name: sum(by.values()) for name, by in routes.items()},
            "kv_quant": quant, "routes": {**routes, **kv_of}}


def trace_expected(cfg, decode_ticks: int, chunks: list[int],
                   kv: str = "bfloat16") -> dict:
    """Launches of a continuous trace over a ring of type ``kv``: every
    decode tick a pass of SLOTS rows; every chunk a pass of its tokens
    (decode attention for a chunk of one token, flash attention for a
    longer one) whose head has one row."""
    return passes_expected(cfg, [("decode", SLOTS, SLOTS)] * decode_ticks + [
        ("decode" if t == 1 else "chunk", t, 1) for t in chunks], kv)


def draw_params(cfg) -> dict:
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    params = tfm.init_params(torch.Generator(device=dev).manual_seed(0), cfg, dev)
    torch.cuda.synchronize()
    say(f"[serve] {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, bf16; weights drawn on the "
        f"card in {time.perf_counter() - t0:.1f}s")
    return params


def lockstep_expected(cfg, batch: int = BATCH, prompt_len: int = PROMPT_LEN,
                      steps: int = STEPS, kv: str = "bfloat16") -> dict:
    """Launches of one ``generate`` of ``steps`` tokens: one prefill of
    batch x (prompt_len + a VLM's patches) rows (flash attention) and
    steps - 1 decode steps of batch rows (decode attention); the head has
    batch rows every pass."""
    return passes_expected(cfg, [
        ("flash", batch * seq_len(cfg, prompt_len), batch)] + [
        ("decode", batch, batch)] * (steps - 1), kv)


def lockstep_run(cfg, eng: ServeEngine, kernel_rows: list[dict], path: str,
                 prompt_len: int, steps: int, warm_steps: int,
                 kv: str = "bfloat16") -> dict:
    """``generate`` of ``steps`` tokens for BATCH prompts of ``prompt_len``
    (seed 1) with the kernels' counts at 0 before and read after, recorded
    as ``path``; tokens inside the vocabulary, prompts kept.  Then a
    prefill (timed, on the cache it filled; a cache with a recurrent state
    is then filled afresh, the timed pass having advanced it) and
    ``steps - 1`` decode steps (timed together), their tokens equal to
    generate's, their logits finite, the cache updated in place.  The
    prefills get the stub frontend embeddings ``generate`` draws."""
    dev = torch.device("cuda")
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, prompt_len),
                            device=dev,
                            generator=torch.Generator(device=dev).manual_seed(1))
    fe = frontend_embeddings(cfg, BATCH, device=dev)
    eng.generate(prompts, steps=warm_steps)          # warm-up
    torch.cuda.synchronize()
    zero_launches()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = eng.generate(prompts, steps=steps)
    end.record()
    torch.cuda.synchronize()
    gen_ms = start.elapsed_time(end)
    counts, routes = read_launches(), read_routes()
    record_launches(kernel_rows, path, counts,
                    lockstep_expected(cfg, BATCH, prompt_len, steps, kv),
                    routes)
    if tuple(out.shape) != (BATCH, prompt_len + steps) or not torch.equal(
            out[:, :prompt_len], prompts):
        fail(f"{path}: generate gave shape {tuple(out.shape)} or lost the "
             "prompts")
    if int(out.min()) < 0 or int(out.max()) >= cfg.vocab_size:
        fail(f"{path}: a generated token lies outside the vocabulary")

    logits, cache = eng.prefill(prompts, **fe)
    prefill_ms = time_ms(lambda: eng.prefill(prompts, cache, **fe), 1,
                         warmup=0)
    if "rwkv_state" in cache or "ssm_state" in cache:
        logits, cache = eng.prefill(prompts, **fe)
    if not torch.isfinite(logits).all():
        fail(f"{path}: prefill logits not finite")
    tok = torch.argmax(logits[:, -1, :], dim=-1)
    if not torch.equal(tok, out[:, prompt_len]):
        fail(f"{path}: prefill's greedy token differs from generate's")
    ptrs = {k: t.data_ptr() for k, t in cache.items()
            if isinstance(t, torch.Tensor)}
    start.record()
    for step in range(steps - 1):
        logits, cache = eng.decode(tok, cache)
        tok = torch.argmax(logits[:, -1, :], dim=-1)
        if not torch.equal(tok, out[:, prompt_len + 1 + step]):
            fail(f"{path}: decode step {step} differs from generate's token")
    end.record()
    torch.cuda.synchronize()
    if not torch.isfinite(logits).all():
        fail(f"{path}: decode logits not finite")
    if ptrs != {k: cache[k].data_ptr() for k in ptrs} or \
            cache["pos"] != seq_len(cfg, prompt_len) + steps - 1:
        fail(f"{path}: the cache was not updated in place")
    return {"out": out, "prompts": prompts, "cache": cache,
            "generate_ms": gen_ms,
            "tokens_per_s": BATCH * steps / (gen_ms * 1e-3),
            "prefill_ms": prefill_ms,
            "decode_ms_per_token": start.elapsed_time(end) / (steps - 1),
            "launches": counts, "launches_by_route": routes}


def resident_tokens(cfg, params: dict) -> torch.Tensor:
    """``generate`` of STEPS tokens for the lock-step prompts (seed 1) on
    the resident weights cut to ``cfg``'s depth: what the streamed run of
    the same weights must give."""
    dev = torch.device("cuda")
    eng = ServeEngine(cfg, {**params,
                            "layers": params["layers"][:cfg.num_layers]},
                      ServeConfig(batch=BATCH, cache_capacity=CACHE))
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT_LEN),
                            device=dev,
                            generator=torch.Generator(device=dev).manual_seed(1))
    return eng.generate(prompts, steps=STEPS)


def serve_phase(cfg, params: dict, kernel_rows: list[dict],
                profile: bool) -> torch.Tensor:
    torch.cuda.reset_peak_memory_stats()
    eng = ServeEngine(cfg, params, ServeConfig(batch=BATCH, cache_capacity=CACHE))
    run = lockstep_run(cfg, eng, kernel_rows, "lock-step", PROMPT_LEN, STEPS,
                       warm_steps=2)
    prompts, out = run["prompts"], run["out"]

    # layer 0's MLP on the live weights and a live activation
    p0 = params["layers"][0]
    h = rms_norm(params["embed"][prompts], p0["ln2"], cfg.norm_eps)
    _, over = check_mlp(h, p0["mlp"]["w_up"], p0["mlp"]["w_down"],
                        {"w_gate": p0["mlp"]["w_gate"]}, cfg.mlp_act)
    say(f"[serve] layer 0 MLP on live weights: err/tol {over:.3f}")
    say("[serve] " + json.dumps({
        "model": cfg.name, "layers": cfg.num_layers, "batch": BATCH,
        "prompt_len": PROMPT_LEN, "steps": STEPS, "cache": CACHE,
        "prefill_ms": run["prefill_ms"],
        "decode_ms_per_token": run["decode_ms_per_token"],
        "generate_ms": run["generate_ms"],
        "tokens_per_s": run["tokens_per_s"],
        "decode_tokens_per_s": BATCH / (run["decode_ms_per_token"] * 1e-3),
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        "launches": run["launches"],
        "launches_by_route": run["launches_by_route"],
        "sample": out[0, PROMPT_LEN:].tolist()}))
    if profile:
        profile_phase(eng, prompts, {"prefill": run["prefill_ms"],
                                     "decode": run["decode_ms_per_token"]})
    return out


# ---------------------------------------------------------------------------
# phase 6: continuous batching at full width
# ---------------------------------------------------------------------------

def check_completions(trace, comps, vocab: int) -> None:
    """Every request completed, with its prompt kept and as many tokens as
    it asked for, all inside the vocabulary."""
    if sorted(c.rid for c in comps) != sorted(r.rid for r in trace):
        fail(f"{len(comps)} of {len(trace)} requests completed")
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


def trace_phase(cfg, params: dict, kernel_rows: list[dict], profile: bool,
                path: str = "continuous", tag: str = "[serve-trace]",
                requests: int = TRACE_N, kv_dtype: str = "bfloat16") -> dict:
    """The first ``requests`` of the TRACE_N-request trace through
    ``ContinuousBatcher.run`` (SLOTS slots of SLOT_CACHE, chunks of
    PREFILL_CHUNK, a ring of ``kv_dtype``), resident weights, its launches
    recorded as ``path``; then, where the cache has a ring, layer 0's
    attention on the rings the requests left behind.  Returns the line's
    statistics."""
    torch.cuda.reset_peak_memory_stats()
    scfg = ServeConfig(batch=SLOTS, cache_capacity=SLOT_CACHE,
                       prefill_chunk=PREFILL_CHUNK, kv_dtype=kv_dtype)
    eng = ServeEngine(cfg, params, scfg)
    vocab = cfg.vocab_size
    ContinuousBatcher(eng).run(make_trace(        # warm-up
        4, vocab_size=vocab, prompt_lens=(16, 48), max_new=(2, 5), seed=1))
    torch.cuda.synchronize()
    cache = eng.slot_cache
    ptrs = {k: t.data_ptr() for k, t in cache.items()}

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
        if "slot_pos" in cache:
            last_tags[slot] = (cache["slot_pos"][slot].clone(),
                               int(cache["pos"][slot]))
        return evict(slot, **kw)

    eng.step, eng.evict_slot = timed_step, kept_evict
    trace = make_trace(TRACE_N, vocab_size=vocab, **TRACE)[:requests]
    bat = ContinuousBatcher(eng)
    zero_launches()
    t0 = time.perf_counter()
    comps = bat.run(trace)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, routes = read_launches(), read_routes()
    del eng.step, eng.evict_slot    # the class's methods again, no cycle
    chunks = chunk_lengths(trace, bat.chunk_budget)
    layers = cfg.num_layers
    record_launches(kernel_rows, path, counts,
                    trace_expected(cfg, bat.decode_ticks, chunks,
                                   "int8" if kv_dtype == "int8"
                                   else "bfloat16"), routes)
    check_completions(trace, comps, vocab)
    if eng.slot_cache is not cache or ptrs != {
            k: cache[k].data_ptr() for k in ptrs}:
        fail("the slot cache was not updated in place")

    # layer 0's attention on the rings the requests left behind
    if "k" in cache:
        unused = (torch.full((SLOT_CACHE,), SENTINEL, dtype=torch.int32,
                             device="cuda"), 0)     # a slot no request took
        kept = [last_tags.get(s, unused) for s in range(SLOTS)]
        tags = torch.stack([t for t, _ in kept])
        q_pos = torch.tensor([p - 1 for _, p in kept], dtype=torch.int32,
                             device="cuda")
        q = torch.randn(
            (SLOTS, cfg.num_heads, cfg.resolved_head_dim),
            generator=torch.Generator(device="cuda").manual_seed(5),
            device="cuda").to(torch.bfloat16)
        scales = ((cache["k_scale"][0], cache["v_scale"][0])
                  if "k_scale" in cache else None)
        err, over = check_attn(q, cache["k"][0], cache["v"][0], tags, q_pos,
                               tfm.attn_spec(cfg).sliding_window,
                               dead_rows=[s for s in range(SLOTS)
                                          if s not in last_tags],
                               kv_scales=scales)
        say(f"{tag} layer 0 attention on the rings of {len(last_tags)} "
            f"slots: err {err:.3e}, err/tol {over:.3f}")

    step_ms = [a.elapsed_time(b) for a, b in events]
    stats = summarize(comps, wall)
    stats.update({
        "model": cfg.name, "layers": layers, "slots": SLOTS,
        "cache": SLOT_CACHE, "prefill_chunk": PREFILL_CHUNK,
        "prompt_tokens": sum(len(r.prompt) for r in trace),
        "ticks": bat.ticks, "decode_ticks": bat.decode_ticks,
        "prefill_chunks": len(chunks),
        "decode_ms_per_tick": sum(step_ms) / len(step_ms),
        "decode_ms_per_tick_min": min(step_ms),
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        "launches": counts, "launches_by_route": routes,
        "finish_order": [c.rid for c in comps]})
    say(f"{tag} " + json.dumps(stats))
    if profile:
        profile_steps(eng, last_tags)
    return stats


# ---------------------------------------------------------------------------
# phase 7: oversubscribed continuous batching, KV offload and prefix reuse
# ---------------------------------------------------------------------------

def copy_gbps(eng: ServeEngine, slot: int, state: dict) -> dict:
    """One slot's state moved alone, best of 3: card to host
    (``offload_slot``), host to card (``refill_slot``), and a prefix
    snapshot of a request cache (``host_copy``)."""
    def best(fn):
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return min(times)

    nbytes = eng.slot_state_bytes()
    eng.refill_slot(slot, state)
    offload_s = best(lambda: eng.offload_slot(slot))
    refill_s = best(lambda: eng.refill_slot(slot, state))
    rc = eng.new_request_cache()
    snapshot_s = best(lambda: host_copy(rc))
    eng.evict_slot(slot, keep=False)
    return {"slot_state_bytes": nbytes,
            "offload_ms": offload_s * 1e3,
            "offload_GBps": nbytes / offload_s / 1e9,
            "refill_ms": refill_s * 1e3,
            "refill_GBps": nbytes / refill_s / 1e9,
            "snapshot_ms": snapshot_s * 1e3,
            "snapshot_GBps": nbytes / snapshot_s / 1e9}


def oversub_phase(cfg, params: dict, kernel_rows: list[dict],
                  kv_dtype: str = "bfloat16", tag: str = "[oversub]",
                  path: str = "oversub continuous") -> dict:
    """The resident model and weights of the continuous phase, 8 slots of
    2048 (a ring of ``kv_dtype``), serving 24 requests of which about half
    share a system prompt of 512 tokens: first oversubscribed (K = 2:
    prefill ahead, parked rings in host memory, LRU swaps) with a prefix
    store of PREFIX_STORE_BYTES, then at K = 1 with no store.  Every
    request must get the same tokens both times; the first run must have
    swapped at least once and hit the store at least once.  Returns the
    oversubscribed run's statistics and the copy rates."""
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    scfg = ServeConfig(batch=SLOTS, cache_capacity=SLOT_CACHE,
                       prefill_chunk=PREFILL_CHUNK, kv_dtype=kv_dtype)
    kv = "int8" if kv_dtype == "int8" else "bfloat16"
    eng = ServeEngine(cfg, params, scfg)
    vocab = cfg.vocab_size
    trace = make_trace(OVERSUB_N, vocab_size=vocab, **TRACE,
                       sys_prompt_len=SYS_PROMPT_LEN, sys_prompt_frac=0.5)
    chunks, swaps = [], []
    prefill_chunk, offload = eng.prefill_chunk, eng.offload_slot

    def counted_chunk(cache, tokens):
        chunks.append(tokens.shape[1])
        return prefill_chunk(cache, tokens)

    def counted_offload(slot):
        swaps.append(slot)
        return offload(slot)

    eng.prefill_chunk, eng.offload_slot = counted_chunk, counted_offload
    runs = {}
    for label, kw in (("oversub", dict(oversub=OVERSUB, prefix_store=
                                       PrefixStore(PREFIX_STORE_BYTES))),
                      ("capped", dict())):
        chunks.clear()
        swaps.clear()
        bat = ContinuousBatcher(eng, **kw)
        zero_launches()
        t0 = time.perf_counter()
        comps = bat.run(trace)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts, routes = read_launches(), read_routes()
        want = trace_expected(cfg, bat.decode_ticks, chunks, kv)
        if label == "oversub":
            record_launches(kernel_rows, path, counts, want, routes)
        elif {**counts, "routes": routes} != want:
            fail(f"the K = 1 run launched {counts}, by route {routes}")
        check_completions(trace, comps, vocab)
        stats = summarize(comps, wall)
        kinds = [k for k, _ in bat.spill_events]
        stats.update({
            "oversub": bat.oversub, "virtual_slots": bat.virtual_slots,
            "ticks": bat.ticks, "decode_ticks": bat.decode_ticks,
            "prefill_chunks": len(chunks),
            "prefill_tokens": sum(chunks),
            "spill_events": len(bat.spill_events),
            "spills": kinds.count("spill"), "refills": kinds.count("refill"),
            "swaps": len(swaps),
            "bytes_moved": sum(nb for _, nb in bat.spill_events),
            "planned_spill_s": bat.planned_spill_s,
            "launches": counts, "launches_by_route": routes,
        "finish_order": [c.rid for c in comps]})
        if bat.prefix is not None:
            stats.update({
                "prefix_hits": bat.prefix_hits,
                "prefix_tokens_saved": bat.prefix_tokens_saved,
                "prefix_store_bytes": bat.prefix.bytes,
                "prefix_store_budget": bat.prefix.capacity_bytes,
                "prefix_snapshots_stored": len(bat.prefix)})
        runs[label] = ({c.rid: c.tokens for c in comps}, stats, bat)
        say(f"{tag} {label}: " + json.dumps(stats))
    del eng.prefill_chunk, eng.offload_slot  # the class's methods again
    got, stats, bat = runs["oversub"]
    want = runs["capped"][0]
    for rid, toks in want.items():
        if not np.array_equal(got[rid], toks):
            fail(f"request {rid}: oversubscribed tokens differ from the K = 1 "
                 f"run's:\n{got[rid]}\n{toks}")
    if stats["swaps"] < 1 or stats["prefix_hits"] < 1:
        fail(f"the oversubscribed run swapped {stats['swaps']} times and hit "
             f"the prefix store {stats['prefix_hits']} times")
    state = eng.offload_slot(0)
    rates = copy_gbps(eng, 0, state)
    say(f"{tag} " + json.dumps({
        "model": cfg.name, "layers": cfg.num_layers, "slots": SLOTS,
        "cache": SLOT_CACHE, "prefill_chunk": PREFILL_CHUNK,
        "kv_dtype": kv_dtype,
        "requests": OVERSUB_N, "sys_prompt_len": SYS_PROMPT_LEN,
        "tokens_equal_to_capped": True, **rates,
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}))
    del runs, bat, state
    return {**stats, **rates}


# ---------------------------------------------------------------------------
# phase 7b: the int8 KV cache at full width
# ---------------------------------------------------------------------------

def last_logits(eng: ServeEngine, prompts, tokens, steps: int) -> torch.Tensor:
    """The last of ``steps - 1`` decode steps' logits after a prefill of
    ``prompts``, the steps fed ``tokens`` (B, steps) in turn (fp32)."""
    logits, cache = eng.prefill(prompts)
    for step in range(steps - 1):
        logits, cache = eng.decode(tokens[:, step], cache)
    return logits.float()


def int8_step(cfg, eng: ServeEngine, groups: int = 5, steps: int = 16
              ) -> dict:
    """The lock-step decode step over the int8 ring (``eng`` a resident
    engine with ``kv_dtype`` int8, B 8, a ring of 1024): after a prefill of
    BATCH prompts of PROMPT_LEN (seed 1) and two warm-up steps, ``groups``
    runs of ``steps`` decode steps, each timed by CUDA events (greedy tokens
    fed back; the path is host-bound, so its ms a step is the median of the
    runs'), then one step under ``device_split``: the device kernels a step
    launches, the port's counted apart from PyTorch's."""
    dev = torch.device("cuda")
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT_LEN),
                            device=dev,
                            generator=torch.Generator(device=dev).manual_seed(1))
    logits, cache = eng.prefill(prompts)
    tok = torch.argmax(logits[:, -1, :], dim=-1)
    for _ in range(2):
        logits, cache = eng.decode(tok, cache)
        tok = torch.argmax(logits[:, -1, :], dim=-1)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    zero_launches()
    runs = []
    for _ in range(groups):
        start.record()
        for _ in range(steps):
            logits, cache = eng.decode(tok, cache)
            tok = torch.argmax(logits[:, -1, :], dim=-1)
        end.record()
        torch.cuda.synchronize()
        runs.append(start.elapsed_time(end) / steps)
    if not torch.isfinite(logits).all():
        fail("int8 lock-step decode: logits not finite")
    counted = read_launches()
    split = device_split(lambda: eng.decode(tok, cache))
    return {"model": cfg.name, "layers": cfg.num_layers, "batch": BATCH,
            "cache": CACHE, "prompt_len": PROMPT_LEN, "steps": groups * steps,
            "ms_per_step": statistics.median(runs), "ms_per_step_runs": runs,
            "launches_per_step": {k: n / (groups * steps)
                                  for k, n in counted.items()},
            "device_kernels_per_step": split["port_kernels"]
            + split["other_kernels"], **split}


def int8_phase(cfg, params: dict, kernel_rows: list[dict]) -> None:
    """Full-width qwen3-14b, resident, bf16 activations, the int8 ring
    (``ServeConfig(kv_dtype="int8")``): the lock-step run of [serve] (B 8,
    prompts of 512, 16 steps, a ring of 1024), the 16-request continuous
    trace on 8 slots of 2048 and the oversubscribed K = 2 trace of
    [oversub], their launches recorded by route and by the K/V type the
    attention kernels read.  Fails unless every request completes with its
    tokens, the lock-step last logits lie within the reference's own bound
    of the bf16 ring's (rel < 0.15, ``test_int8_kv_cache_close_to_bf16``),
    the cache holds exactly the int8 ring and its scales, and a decode step
    allocates less than one layer's bf16 ring beyond what the step before
    held (nothing widens the ring)."""
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    eng = ServeEngine(cfg, params, ServeConfig(
        batch=BATCH, cache_capacity=CACHE, kv_dtype="int8"))
    run = lockstep_run(cfg, eng, kernel_rows, "int8 lock-step", PROMPT_LEN,
                       STEPS, warm_steps=2, kv="int8")
    peak = torch.cuda.max_memory_allocated()
    cache = run["cache"]
    hkv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    slots = cfg.num_layers * BATCH * hkv * CACHE
    want_bytes = 2 * slots * hd + 2 * slots * 2    # int8 K, V; bf16 scales
    bf16_bytes = 2 * slots * hd * 2
    got_bytes = sum(t.numel() * t.element_size() for key, t in cache.items()
                    if key in ("k", "v", "k_scale", "v_scale"))
    if (got_bytes != want_bytes or cache["k"].dtype != torch.int8
            or cache["k_scale"].dtype != torch.bfloat16):
        fail(f"the int8 cache holds {got_bytes} bytes "
             f"({cache['k'].dtype}, {cache['k_scale'].dtype}), the int8 "
             f"ring and its scales are {want_bytes}")

    # nothing widens the ring: one more decode step, its allocation beyond
    # what the step before held
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    logits, cache = eng.decode(run["out"][:, -1], cache)
    torch.cuda.synchronize()
    step_extra = torch.cuda.max_memory_allocated() - base
    layer_ring = 2 * BATCH * hkv * CACHE * hd * 2   # one layer's bf16 K, V
    if not torch.isfinite(logits).all() or step_extra >= layer_ring:
        fail(f"an int8 decode step allocated {step_extra} bytes beyond the "
             f"step before (one layer's bf16 ring: {layer_ring})")

    # the bf16 ring's last logits on the same tokens
    bf = ServeEngine(cfg, params, ServeConfig(batch=BATCH,
                                              cache_capacity=CACHE))
    fed = run["out"][:, PROMPT_LEN:]
    a = last_logits(bf, run["prompts"], fed, STEPS)
    b = last_logits(eng, run["prompts"], fed, STEPS)
    rel = float((a - b).abs().max()) / float(a.abs().max())
    if not rel < 0.15:
        fail(f"int8 KV cache too lossy against bf16: rel {rel:.4f}")
    del bf, a, b, logits, cache, eng
    lock = {k: run[k] for k in ("prefill_ms", "decode_ms_per_token",
                                "generate_ms", "tokens_per_s")}
    lock["decode_tokens_per_s"] = BATCH / (run["decode_ms_per_token"] * 1e-3)
    del run
    eng = ServeEngine(cfg, params, ServeConfig(
        batch=BATCH, cache_capacity=CACHE, kv_dtype="int8"))
    say("[int8-step] " + json.dumps(int8_step(cfg, eng)))
    del eng

    trace = trace_phase(cfg, params, kernel_rows, False,
                        path="int8 continuous", tag="[int8-trace]",
                        kv_dtype="int8")
    over = oversub_phase(cfg, params, kernel_rows, kv_dtype="int8",
                         tag="[int8-oversub]",
                         path="int8 oversub continuous")
    say("[int8] " + json.dumps({
        "model": cfg.name, "layers": cfg.num_layers, "kv_dtype": "int8",
        "lock_step": lock, "cache_bytes": got_bytes,
        "bf16_cache_bytes": bf16_bytes,
        "cache_over_bf16": got_bytes / bf16_bytes,
        "max_memory_allocated_bytes": peak,
        "decode_step_extra_bytes": step_extra,
        "layer_bf16_ring_bytes": layer_ring,
        "last_logits_rel_to_bf16": rel,
        "continuous": {k: trace[k] for k in (
            "gen_tok_s", "decode_tok_s", "decode_ms_per_tick",
            "p50_latency_s", "p99_latency_s", "max_memory_allocated_bytes")
            if k in trace},
        "oversub": {k: over[k] for k in (
            "gen_tok_s", "spill_events", "swaps", "bytes_moved",
            "slot_state_bytes", "offload_GBps", "refill_GBps",
            "snapshot_GBps", "prefix_hits") if k in over},
        "spill_GB": over["bytes_moved"] / 1e9}))
    say(f"[int8] phase took {time.perf_counter() - t0:.1f}s")


# ---------------------------------------------------------------------------
# phase 7c: the fleet router at full width
# ---------------------------------------------------------------------------

def fleet_expected(cfg, router, trace, kv: str = "bfloat16") -> dict:
    """Launches of a fleet's run: every pod's decode ticks (passes of SLOTS
    rows) and the chunks of the prompts it prefilled: a mixed pod those of
    the requests it completed, a prefill pod (the fleet's one pod that is
    not a decode pod) those of every completed request, a decode pod
    none."""
    roles = [p.role for p in router.pods]
    if "prefill" in roles and sum(r != "decode" for r in roles) > 1:
        fail(f"fleet_expected counts a prefill pod alone beside decode "
             f"pods, not {roles}")
    by_rid = {r.rid: r for r in trace}
    passes = []
    for p in router.pods:
        done = {"mixed": p.batcher.completed, "prefill": router.completed,
                "decode": []}[p.role]
        chunks = chunk_lengths([by_rid[c.rid] for c in done],
                               p.batcher.chunk_budget)
        passes += [("decode", SLOTS, SLOTS)] * p.batcher.decode_ticks + [
            ("decode" if t == 1 else "chunk", t, 1) for t in chunks]
    return passes_expected(cfg, passes, kv)


def timed_calls(fn, seconds: list):
    """``fn``, with the seconds of each call (the card synchronised before
    and after) appended to ``seconds``."""
    def call(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        return out
    return call


def served(router: FleetRouter, trace) -> FleetRouter:
    router.run(trace)
    return router


def fleet_run(cfg, serve, trace, kernel_rows: list[dict], path: str) -> tuple:
    """``serve()`` (a fleet's run over ``trace``, returning its router) with
    the kernels' counts at 0 before and read after, recorded as ``path``;
    every request that was not shed completes with its tokens.  Returns
    the router and the run's line."""
    gc.collect()
    zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fr = serve()
    torch.cuda.synchronize()
    real = time.perf_counter() - t0
    counts, routes = read_launches(), read_routes()
    record_launches(kernel_rows, path, counts,
                    fleet_expected(cfg, fr, trace), routes)
    shed = {r.rid for r in fr.shed}
    check_completions([r for r in trace if r.rid not in shed], fr.completed,
                      cfg.vocab_size)
    s = fr.summary()
    line = {k: s[k] for k in ("pods", "roles", "routed", "migrations",
                              "planned_migration_s", "shed", "requests",
                              "wall_s", "p50_ttft_s", "p99_ttft_s",
                              "gen_tok_s")}
    line.update(virtual_planned_migration_s=fr.planned_migration_s,
                migrated_bytes=sum(nb for nb, *_ in fr.migration_events),
                max_ttft_s=max(c.ttft_s for c in fr.completed),
                ticks=[p.batcher.ticks for p in fr.pods],
                decode_ticks=[p.batcher.decode_ticks for p in fr.pods],
                real_s=real, launches=counts)
    return fr, line


def direct_run(cfg, eng: ServeEngine, trace, costs: PodCosts) -> tuple:
    """A direct batcher on ``eng`` over ``trace`` on a virtual clock
    (``run_virtual_trace``), its launches checked (not recorded)."""
    gc.collect()
    vc = VirtualClock()
    bat = ContinuousBatcher(eng, vc)
    zero_launches()
    comps = run_virtual_trace(bat, trace, costs)
    torch.cuda.synchronize()
    want = trace_expected(cfg, bat.decode_ticks,
                          chunk_lengths(trace, bat.chunk_budget))
    if {**read_launches(), "routes": read_routes()} != want:
        fail(f"the direct batcher launched {read_launches()}, by route "
             f"{read_routes()}; its passes say {want}")
    check_completions(trace, comps, cfg.vocab_size)
    return comps, summarize(comps, vc.t)


def fleet_phase(cfg, params: dict, kernel_rows: list[dict]) -> dict:
    """Full-width qwen3-14b, resident bf16 weights shared by every pod, 8
    slots of 2048 a pod, the 16-request trace of the continuous phase on
    the fleet's virtual clock, each pod priced by
    ``PodCosts.from_serve_config`` of the launcher's ``ServeConfig``
    (``--mode gspmd --batch 8 --cache 2048 --prefill-chunk 256``): (a) one
    mixed pod, equal to ``run_virtual_trace`` of a direct batcher (tokens,
    virtual first-token and finish times, finish order, ``summarize``);
    (b) a prefill pod (chunk 128, ``PREFILL_SAT``) and a decode pod (chunk
    16) priced by ``fleet_spec(h100_host(), 2)``: all 16 requests migrate,
    as host copies of their request caches, each migration the request
    cache's bytes; the tokens those of a direct batcher at chunk 128;
    ``planned_migration_s`` > 0; ``simulate_fleet_traffic`` prices each
    migration alone as the plan does, and on the router's events adds the
    fleet link's queue (its ratio to the plan is printed: the plan prices
    each migration alone); the real handoff and refill copies timed; (c) the
    launcher's ``_run_fleet`` with ``--fleet 2`` (mixed), then with
    ``--ttft-slo-ms`` half of (a)'s virtual p99 TTFT, which must shed and
    keep every admitted TTFT under the target.  Each fleet's launches are
    recorded as a path of its own.  One ``[fleet]`` line."""
    t_phase = time.perf_counter()
    vocab = cfg.vocab_size
    trace = make_trace(TRACE_N, vocab_size=vocab, **TRACE)
    argv = ["--arch", "qwen3-14b", "--mode", "gspmd", "--batch", str(SLOTS),
            "--cache", str(SLOT_CACHE), "--prefill-chunk",
            str(PREFILL_CHUNK), "--trace", str(TRACE_N), "--fleet", "2"]
    args = launcher.parse_args(argv)
    scfg = launcher.serve_config(cfg, args)
    costs = PodCosts.from_serve_config(scfg)
    base = ServeEngine(cfg, params, scfg)

    def engine(chunk: int) -> ServeEngine:
        # every pod on the same weight tensors
        return ServeEngine(cfg, base.params,
                           dataclasses.replace(scfg, prefill_chunk=chunk))

    ContinuousBatcher(engine(scfg.prefill_chunk)).run(make_trace(  # warm-up
        2, vocab_size=vocab, prompt_lens=(16, 48), max_new=(2, 5), seed=1))
    out = {"model": cfg.name, "layers": cfg.num_layers, "slots": SLOTS,
           "cache": SLOT_CACHE, "requests": TRACE_N,
           "costs": dataclasses.asdict(costs)}

    # (a) one mixed pod against the direct batcher
    fr, line = fleet_run(cfg, lambda: served(FleetRouter([FleetPod(
        engine(scfg.prefill_chunk), "mixed", costs=costs)]), trace), trace,
        kernel_rows, "fleet one mixed pod")
    comps, direct = direct_run(cfg, engine(scfg.prefill_chunk), trace, costs)
    if fleet_outcome(fr.completed, fr.summary()) != \
            fleet_outcome(comps, direct):
        fail("the fleet of one mixed pod differs from run_virtual_trace of "
             "a direct batcher")
    out["one_mixed_pod"] = {**line, "equal_to_run_virtual_trace": True}
    p99_a = line["p99_ttft_s"]
    del fr, comps

    # (b) prefill pod + decode pod, priced migrations, real copies timed
    fl = fleet_spec(h100_host(), 2)
    pf, dec = engine(min(PREFILL_SAT, SLOT_CACHE)), engine(min(16, SLOT_CACHE))
    handoff_s, refill_s = [], []
    dec.refill_slot = timed_calls(dec.refill_slot, refill_s)
    batcher_mod.host_copy = timed_calls(host_copy, handoff_s)
    try:
        fr, line = fleet_run(cfg, lambda: served(FleetRouter(
            [FleetPod(pf, "prefill", costs=costs),
             FleetPod(dec, "decode", costs=costs)], fleet=fl), trace),
            trace, kernel_rows, "fleet disaggregated")
    finally:
        batcher_mod.host_copy = host_copy
        del dec.refill_slot             # the class's method again
    nbytes = state_bytes(pf.new_request_cache())
    if fr.migrations != TRACE_N or len(fr.migration_events) != TRACE_N:
        fail(f"{fr.migrations} of {TRACE_N} requests migrated")
    if {nb for nb, *_ in fr.migration_events} != {nbytes} or nbytes != \
            kv_ring_bytes(cfg, SLOT_CACHE) or nbytes != dec.slot_state_bytes():
        fail(f"a migration moved {set(nb for nb, *_ in fr.migration_events)} "
             f"bytes; the request cache holds {nbytes}")
    if len(handoff_s) != TRACE_N or len(refill_s) != TRACE_N:
        fail(f"{len(handoff_s)} handoff copies and {len(refill_s)} refills "
             f"for {TRACE_N} migrations")
    # the fleet simulator on the same events, and on the same migrations
    # each alone on the fleet link: alone, its legs must price each one as
    # the plan does; together it adds only the link's queue, which the
    # router's per-migration plan leaves out (reported, not a failure)
    events = fr.migration_events
    res = simulate_fleet_traffic(fl, events)
    sim = sum(f - at for f, (_, at, _, _) in zip(res.finish, events))
    gap = 2 * max(fl.migration_time(nb, a, b) for nb, _, a, b in events)
    alone = simulate_fleet_traffic(fl, [(nb, i * gap, a, b) for i, (
        nb, _, a, b) in enumerate(events)])
    alone_s = sum(f - i * gap for i, f in enumerate(alone.finish))
    planned = fr.planned_migration_s
    if not (planned > 0 and abs(alone_s - planned) <= 1e-9 * planned
            and sim >= planned * (1 - 1e-12)):
        fail(f"planned migration {planned} s; the fleet simulator {sim} s "
             f"on the router's events, {alone_s} s on them one at a time")
    ratio = sim / planned
    got = {c.rid: c.tokens for c in fr.completed}
    comps, _ = direct_run(cfg, engine(min(PREFILL_SAT, SLOT_CACHE)), trace,
                          costs)
    for c in comps:
        if not np.array_equal(got[c.rid], c.tokens):
            fail(f"request {c.rid}: migrated tokens differ from a direct "
                 f"batcher's at chunk 128:\n{got[c.rid]}\n{c.tokens}")
    out["disaggregated"] = {
        **line, "tokens_equal_to_direct_chunk_128": True,
        "migration_bytes": nbytes, "sim_migration_s": sim,
        "sim_over_plan": ratio, "sim_within_2x_of_plan": ratio <= 2.0,
        "sim_alone_migration_s": alone_s,
        "fleet_link_busy_s": res.busy["fleet"],
        "last_migration_lands_s": max(res.finish),
        "handoff_GBps": nbytes * TRACE_N / sum(handoff_s) / 1e9,
        "handoff_ms": [t * 1e3 for t in (min(handoff_s), max(handoff_s))],
        "refill_GBps": nbytes * TRACE_N / sum(refill_s) / 1e9,
        "refill_ms": [t * 1e3 for t in (min(refill_s), max(refill_s))]}
    del fr, comps, pf, dec, got

    # (c) the launcher's _run_fleet: two mixed pods, then shedding
    slo_ms = p99_a * 1e3 / 2
    for label, extra in (("launcher_mixed", []),
                         ("launcher_shed", ["--ttft-slo-ms", repr(slo_ms)])):
        a = launcher.parse_args(argv + extra)
        keep, summary = [], {}

        def serve(a=a, keep=keep, summary=summary):
            summary.update(launcher._run_fleet(base, a, vocab, trace=trace,
                                               keep=keep))
            return keep[0]

        fr, line = fleet_run(cfg, serve, trace, kernel_rows,
                             "fleet " + label.replace("_", " "))
        if summary != fr.summary() | {"disagg": False,
                                      "ttft_slo_ms": a.ttft_slo_ms}:
            fail(f"_run_fleet's summary {summary} is not its router's")
        out[label] = {**line, "ttft_slo_ms": a.ttft_slo_ms}
        if extra and not (len(fr.shed) >= 1 and line["max_ttft_s"]
                          <= slo_ms * 1e-3 + 1e-9):
            fail(f"at a TTFT target of {slo_ms} ms the launcher's fleet shed "
                 f"{len(fr.shed)} requests and admitted one of "
                 f"{line['max_ttft_s']} s")
        del fr
    out["phase_s"] = time.perf_counter() - t_phase
    say("[fleet] " + json.dumps(out))
    return out


def emulator_phase() -> None:
    """The card's DSMEM rate measured again (``chip/dsmem.py``) and printed
    beside ``h100_sxm()``'s ``link_bw``, which holds the rate a probe
    measured before; then ``check_plan_numerics`` on the card over every
    matmul op of layer 0 of qwen3-14b's decode graph (B 8, a ring of
    CACHE) on ``h100_sxm()``: up to 4 exec plans an op, each with its first
    and last preload plan."""
    chip = h100_sxm()
    rate = measure_dsmem()
    say("[emulator] DSMEM " + json.dumps({
        **rate, "h100_sxm_link_bw": chip.link_bw,
        "measured_over_link_bw": rate["bytes_per_s_per_sm"] / chip.link_bw}))
    g = build_graph(get_config("qwen3_14b"), batch=BATCH, seq=CACHE,
                    phase="decode")
    worst, by_op = 0.0, {}
    for op in g.ops:
        if op.kind != "matmul" or not op.name.startswith("l0."):
            continue
        eps = enumerate_exec_plans(op, chip)
        if not eps:
            fail(f"[emulator] no exec plan of {op.name} on h100_sxm")
        by_op[op.name] = 0
        for ep in eps[:4]:
            pps = enumerate_preload_plans(op, ep, chip)
            for pp in (pps[0], pps[-1]):
                worst = max(worst, check_plan_numerics(ep, pp))
                by_op[op.name] += 1
    say(f"[emulator] {sum(by_op.values())} plans of the {len(by_op)} matmul "
        f"ops of layer 0 on h100_sxm inside the bound max|got-ref| <= 2e-2 "
        f"(max|ref| + 1) on the card: worst err {worst:.3e}; plans by op "
        f"{json.dumps(by_op)}")


# ---------------------------------------------------------------------------
# phase 8: the launcher's default path, weights streamed from the host
# ---------------------------------------------------------------------------

def copy_rates(ls) -> dict:
    """The host-to-card copies of the layer stream alone, on its copy
    stream with no compute: the largest layer record (best of 3), then
    every layer's record once through the window."""
    stream = ls.copy_stream
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    big = max(range(ls.n), key=lambda li: ls.host[li].numel())
    torch.cuda.synchronize()
    one = []
    for _ in range(3):
        with torch.cuda.stream(stream):
            ev[0].record(stream)
            ls.buffers[0].copy_(ls.host[big], non_blocking=True)
            ev[1].record(stream)
        torch.cuda.synchronize()
        one.append(ev[0].elapsed_time(ev[1]))
    with torch.cuda.stream(stream):
        ev[0].record(stream)
        for li in range(ls.n):
            src = ls.host[li]
            ls.buffers[li % ls.depth][:src.numel()].copy_(src,
                                                          non_blocking=True)
        ev[1].record(stream)
    torch.cuda.synchronize()
    best = min(one)
    return {"layer_bytes": ls.layer_bytes, "layer_copy_ms": best,
            "host_to_device_GBps": ls.layer_bytes / (best * 1e-3) / 1e9,
            "all_layers_copy_ms": ev[0].elapsed_time(ev[1])}


def stream_phase(cfg, kernel_rows: list[dict], resident_out,
                 profile: bool) -> None:
    """Full-width qwen3-14b under ``elk_stream`` with the planner's knobs,
    as the launcher serves it: the weights are drawn from the serve phase's
    seed one layer at a time, each moved to pinned host memory before the
    next is drawn (the card never holds the decoder, start-up included),
    then lock-step serving as in the serve phase and a short continuous
    trace.  ``resident_out`` is the serve phase's ``generate`` on the same
    weights and prompts (None when its depth was cut): the streamed run
    must give the same tokens."""
    t0 = time.perf_counter()
    lock_scfg = elk_serve_config(cfg, batch=BATCH, cache_capacity=CACHE,
                                 pod=h100_host())
    slot_scfg = elk_serve_config(cfg, batch=SLOTS, cache_capacity=SLOT_CACHE,
                                 pod=h100_host())
    say(f"[stream] ELK scheduler (h100_host): lock-step prefetch_depth="
        f"{lock_scfg.prefetch_depth} prefill_chunk={lock_scfg.prefill_chunk}"
        f"; continuous prefetch_depth={slot_scfg.prefetch_depth} "
        f"prefill_chunk={slot_scfg.prefill_chunk}; planned in "
        f"{time.perf_counter() - t0:.1f}s")
    dev = torch.device("cuda")
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    if base > 2 ** 30:
        fail(f"{base} bytes still allocated on the card before the stream "
             "phase: the resident phases' weights are held")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    depth = max(lock_scfg.prefetch_depth, slot_scfg.prefetch_depth)
    eng = ServeEngine(cfg, init_streamed_params(
        torch.Generator(device=dev).manual_seed(0), cfg, dev, depth),
        dataclasses.replace(lock_scfg, prefetch_depth=depth))
    eng.scfg.prefetch_depth = lock_scfg.prefetch_depth
    ls = eng.params["layers"]
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - base
    startup_peak = torch.cuda.max_memory_allocated() - base
    outside = sum(t.numel() * t.element_size()
                  for k, t in eng.params.items() if k != "layers")
    window = ls.depth * ls.layer_bytes
    if held > outside + window + 2 ** 30:
        fail(f"{held} bytes allocated on the card after the layers went to "
             f"the host (weights outside the layers {outside}, window "
             f"{window})")
    if startup_peak > outside + window + 2 * ls.layer_bytes + 2 ** 30:
        fail(f"drawing the streamed weights took {startup_peak} bytes of the "
             f"card (outside the layers {outside}, window {window}, a layer "
             f"{ls.layer_bytes}): more than a layer of the decoder was held")
    say(f"[stream] {ls.n} layers of {ls.layer_bytes} bytes drawn one at a "
        f"time into pinned host memory in {time.perf_counter() - t0:.1f}s; "
        f"window of {ls.depth} layer buffers on the card; {held} bytes "
        f"allocated, start-up peak {startup_peak}")

    torch.cuda.reset_peak_memory_stats()
    copies0 = ls.copies
    run = lockstep_run(cfg, eng, kernel_rows, "stream lock-step", PROMPT_LEN,
                       STEPS, warm_steps=2)
    # every pass streams every layer: the warm-up, generate, two prefills
    # and the decode steps
    passes = 2 + STEPS + 2 + (STEPS - 1)
    if ls.copies - copies0 != cfg.num_layers * passes:
        fail(f"{ls.copies - copies0} layer copies in {passes} streamed passes "
             f"of {cfg.num_layers} layers")
    out = run["out"]
    if resident_out is not None and not torch.equal(out, resident_out):
        fail("streamed and resident weights gave different tokens")
    peak = torch.cuda.max_memory_allocated()

    # decode steps at a window of 1 beside the planner's
    cache, tok = run["cache"], out[:, -1]
    eng.scfg.prefetch_depth = 1
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(4):
        logits, cache = eng.decode(tok, cache)
    end.record()
    torch.cuda.synchronize()
    eng.scfg.prefetch_depth = lock_scfg.prefetch_depth
    if not torch.isfinite(logits).all():
        fail("streamed decode logits at a window of 1 not finite")
    rates = copy_rates(ls)
    say("[stream] " + json.dumps({
        "model": cfg.name, "layers": cfg.num_layers, "batch": BATCH,
        "prompt_len": PROMPT_LEN, "steps": STEPS, "cache": CACHE,
        "prefetch_depth": lock_scfg.prefetch_depth,
        "prefill_chunk": lock_scfg.prefill_chunk,
        "prefill_ms": run["prefill_ms"],
        "decode_ms_per_token": run["decode_ms_per_token"],
        "decode_ms_per_token_p1": start.elapsed_time(end) / 4,
        "generate_ms": run["generate_ms"],
        "tokens_per_s": run["tokens_per_s"],
        "max_memory_allocated_bytes": peak,
        "startup_peak_bytes": startup_peak, **rates,
        "equal_to_resident": resident_out is not None,
        "launches": run["launches"],
        "launches_by_route": run["launches_by_route"],
        "sample": out[0, PROMPT_LEN:].tolist()}))
    if profile:
        profile_stream_step(eng, run["prompts"])
    del cache, logits, run

    # a short continuous trace through the same host weights
    torch.cuda.reset_peak_memory_stats()
    seng = ServeEngine(cfg, dict(eng.params), slot_scfg)
    vocab = cfg.vocab_size
    ContinuousBatcher(seng).run(make_trace(        # warm-up
        2, vocab_size=vocab, prompt_lens=(16, 48), max_new=(2, 3), seed=1))
    trace = make_trace(STREAM_TRACE_N, vocab_size=vocab, **TRACE)
    bat = ContinuousBatcher(seng)
    zero_launches()
    t0 = time.perf_counter()
    comps = bat.run(trace)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, routes = read_launches(), read_routes()
    chunks = chunk_lengths(trace, bat.chunk_budget)
    record_launches(kernel_rows, "stream continuous", counts,
                    trace_expected(cfg, bat.decode_ticks, chunks),
                    routes)
    check_completions(trace, comps, vocab)
    stats = summarize(comps, wall)
    stats.update({
        "model": cfg.name, "layers": cfg.num_layers, "slots": SLOTS,
        "cache": SLOT_CACHE, "prefetch_depth": slot_scfg.prefetch_depth,
        "prefill_chunk": slot_scfg.prefill_chunk,
        "chunk_budget": bat.chunk_budget, "ticks": bat.ticks,
        "decode_ticks": bat.decode_ticks, "prefill_chunks": len(chunks),
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        "launches": counts, "launches_by_route": routes,
        "finish_order": [c.rid for c in comps]})
    say("[stream-trace] " + json.dumps(stats))


# ---------------------------------------------------------------------------
# phase 9: the paper's Table 2 models and the MoE family
# ---------------------------------------------------------------------------

def tree_bytes(tree) -> int:
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    return tree.host_bytes                    # a LayerStream's host copy


def free_card(what: str) -> None:
    """Everything of the configs before is freed: fail if more than 1 GiB
    is still allocated on the card."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    if held > 2 ** 30:
        fail(f"{held} bytes still allocated on the card before {what}")
    torch.cuda.reset_peak_memory_stats()


def host_memory() -> dict:
    """The host's memory as /proc/meminfo gives it, and the cgroup's limit
    and use where one is set; ``usable_bytes`` is the least of what they
    leave.  Read it before the process takes host memory: on the card's
    machine MemAvailable does not rise again when the process frees memory,
    though the memory is there to take again (PERF.md)."""
    info = {}
    with open("/proc/meminfo") as f:
        for line in f:
            key, val = line.split(":", 1)
            if key in ("MemTotal", "MemAvailable"):
                info[key] = int(val.split()[0]) * 1024
    usable = info["MemAvailable"]
    cgroup = Path("/sys/fs/cgroup")
    try:
        limit = (cgroup / "memory.max").read_text().strip()
        used = int((cgroup / "memory.current").read_text())
    except (OSError, ValueError):
        limit = "max"
    if limit != "max":
        info["cgroup_limit"], info["cgroup_used"] = int(limit), used
        usable = min(usable, int(limit) - used)
    info["usable_bytes"] = usable
    return info


def model_line(cfg, full_layers: int, param_bytes: int, run: dict,
               **extra) -> None:
    say("[models] " + json.dumps({
        "model": cfg.name, "depth": f"{cfg.num_layers} of {full_layers}",
        "param_bytes": param_bytes,
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        **{k: v for k, v in run.items()
           if k not in ("out", "prompts", "cache")},
        **extra, "sample": run["out"][0, -8:].tolist()}))


def fill_biases(params: dict, seed: int = 2) -> list[str]:
    """Fill every bias of ``params``' layers (the leaves named ``b_*``: the
    q, k, v biases and the fc biases) in place with normals x BIAS_SCALE,
    drawn from ``seed`` on their device.  Returns the names filled."""
    gen = torch.Generator(device=params["embed"].device).manual_seed(seed)
    names = set()
    for path, t in tree_items(params["layers"]):
        name = path.rsplit("/", 1)[-1]
        if name.startswith("b_"):
            t.copy_(torch.randn(t.shape, generator=gen, device=t.device,
                                dtype=torch.float32).mul_(BIAS_SCALE))
            names.add(name)
    return sorted(names)


def resident_model(arch: str, depth: int, prompt_len: int, cache: int,
                   kernel_rows: list[dict]):
    """Draw ``arch`` at full width (``depth`` layers, 0 = all) on the card
    from seed 0 (its biases nonzero: ``fill_biases``) and serve it
    lock-step, resident: BATCH x ``prompt_len``, STEPS steps.  Returns
    (cfg, params, engine, the run)."""
    full = get_config(arch)
    cfg = dataclasses.replace(full, num_layers=depth) if depth else full
    free_card(cfg.name)
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    params = tfm.init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                             dev)
    biases = fill_biases(params)
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    eng = ServeEngine(cfg, params, ServeConfig(batch=BATCH,
                                               cache_capacity=cache))
    run = lockstep_run(cfg, eng, kernel_rows, f"{cfg.name} lock-step",
                       prompt_len, STEPS, warm_steps=2)
    model_line(cfg, full.num_layers, tree_bytes(params), run,
               batch=BATCH, prompt_len=prompt_len, cache=cache, steps=STEPS,
               layer_kinds=sorted(set(tfm.layer_kinds(cfg))),
               drawn_in_s=draw_s, mode="gspmd", biases=biases,
               window=tfm.attn_spec(cfg).sliding_window)
    live_checks(cfg, params, run["prompts"])
    return cfg, params, eng, run


def rel_frobenius(got: torch.Tensor, ref: torch.Tensor) -> float:
    """||got - ref|| / ||ref|| over every element, in fp32."""
    ref32 = ref.float()
    return float((got.float() - ref32).norm() / ref32.norm().clamp(min=1e-30))


def plain_check(cfg, params: dict, prompts: torch.Tensor, ring: int) -> dict:
    """The first PLAIN_LAYERS layers of the live weights at full width, as a
    model of their own: a prefill of ``prompts`` and PLAIN_STEPS greedy
    decode steps on the kernels, then the same passes under
    ``_plain_dispatch()`` fed the kernels' tokens.  Each pass's bf16 logits
    must lie within PLAIN_LOGITS_TOL (relative Frobenius error) of the
    plain path's; the kernel passes must launch what ``passes_expected``
    says, the plain ones nothing.  Returns the errors by pass."""
    cut = dataclasses.replace(cfg, num_layers=PLAIN_LAYERS)
    eng = ServeEngine(cut, {**params, "layers": params["layers"][
        :PLAIN_LAYERS]}, ServeConfig(batch=BATCH, cache_capacity=ring))
    rows = BATCH * seq_len(cut, prompts.shape[1])
    want = passes_expected(cut, [("flash", rows, BATCH)]
                           + [("decode", BATCH, BATCH)] * PLAIN_STEPS)

    def passes(tokens: list) -> list[torch.Tensor]:
        logits, cache = eng.prefill(prompts)
        out = [logits]
        for step in range(PLAIN_STEPS):
            if len(tokens) == step:     # the kernel run picks the tokens
                tokens.append(torch.argmax(logits[:, -1, :], dim=-1))
            logits, cache = eng.decode(tokens[step], cache)
            out.append(logits)
        torch.cuda.synchronize()
        return out

    tokens: list = []
    zero_launches()
    kernel = passes(tokens)
    if {**read_launches(), "routes": read_routes()} != want:
        fail(f"{cfg.name} at {PLAIN_LAYERS} layers launched "
             f"{read_launches()}, by route {read_routes()}, on the kernel "
             f"path; its passes say {want}")
    zero_launches()
    with _plain_dispatch():
        plain = passes(tokens)
    if any(read_launches().values()):
        fail(f"{cfg.name}: the plain path launched {read_launches()}")
    errs = {}
    for i, (k, p) in enumerate(zip(kernel, plain)):
        if not torch.isfinite(k).all():
            fail(f"{cfg.name} at {PLAIN_LAYERS} layers: pass {i} logits not "
                 "finite on the kernels")
        errs["prefill" if i == 0 else f"decode {i}"] = rel_frobenius(k, p)
    worst = max(errs.values())
    say(f"[models] {cfg.name} at {PLAIN_LAYERS} of {cfg.num_layers} layers, "
        f"full width: kernels against the plain path (decode attention "
        f"included), a prefill of {tuple(prompts.shape)} and {PLAIN_STEPS} "
        f"decode steps: worst relative Frobenius error of the bf16 logits "
        f"{worst:.3e} (limit {PLAIN_LOGITS_TOL}); by pass {json.dumps(errs)}")
    if worst > PLAIN_LOGITS_TOL:
        fail(f"{cfg.name} at {PLAIN_LAYERS} layers: the kernels' logits lie "
             f"{worst:.3e} from the plain path's, past {PLAIN_LOGITS_TOL}")
    return errs


def live_checks(cfg, params: dict, prompts: torch.Tensor) -> None:
    """Each kernel product of layer 0 and of the first MoE layer, and the LM
    head, on the live weights, held to its plain version at the prefill's
    rows: the embedded prompts after the layer's norms (the o projection
    takes their first Hq x D columns, repeated where Hq x D exceeds d_model),
    the head the last tokens after the final norm."""
    x = params["embed"][prompts]                        # (B, S, d)
    kinds = tfm.layer_kinds(cfg)
    checked = sorted({0, kinds.index("moe") if "moe" in kinds else 0})
    worst = 0.0
    for i in checked:
        p = params["layers"][i]
        h = rms_norm(x, p["ln1"], cfg.norm_eps).reshape(-1, cfg.d_model)
        a = p["attn"]
        for w in (a["w_q"], a["w_k"], a["w_v"]):
            worst = max(worst, check_matmul(h, w)[1])
        n_o = a["w_o"].shape[0]         # Hq x D, past d_model at gemma-7b
        worst = max(worst, check_matmul(h.repeat(
            1, -(-n_o // h.shape[1]))[:, :n_o].contiguous(), a["w_o"])[1])
        h = rms_norm(x, p["ln2"], cfg.norm_eps).reshape(-1, cfg.d_model)
        if "moe" in p:
            worst = max(worst, check_matmul(h, p["moe"]["router"])[1])
        for mp in (p.get("mlp"), p.get("shared_mlp")):
            if mp is not None:
                kw = {k: mp[k] for k in ("w_gate", "b_up", "b_down")
                      if k in mp}
                worst = max(worst, check_mlp(h, mp["w_up"], mp["w_down"], kw,
                                             cfg.mlp_act)[1])
    h = rms_norm(x[:, -1], params["final_norm"], cfg.norm_eps)
    head = (params["embed"].t() if cfg.tie_embeddings
            else params["lm_head"])
    worst = max(worst, check_matmul(h, head)[1])
    say(f"[models] {cfg.name}: the kernels on the live weights of layers "
        f"{checked} and the LM head inside their limits (worst err/limit "
        f"{worst:.3f})")


def llama2_70b_phase() -> None:
    """llama2-70b under ``elk_stream`` with the planner's knobs on
    ``h100_host()``, full width: resident against streamed at
    STREAM_CHECK_LAYERS layers on the same weights (equal greedy tokens,
    the launches of their passes), and the kernels on its live weights."""
    full = get_config("llama2_70b")
    dev = torch.device("cuda")
    say(f"[models] host memory now: {json.dumps(host_memory())}")

    # resident and streamed at a depth both hold, on the same weights
    cfg = dataclasses.replace(full, num_layers=STREAM_CHECK_LAYERS)
    free_card("the llama2-70b check")
    params = tfm.init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                             dev)
    res = ServeEngine(cfg, params, ServeConfig(batch=BATCH,
                                               cache_capacity=CACHE))
    scfg = elk_serve_config(cfg, batch=BATCH, cache_capacity=CACHE,
                            pod=h100_host())
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT_LEN),
                            device=dev,
                            generator=torch.Generator(device=dev).manual_seed(1))
    want = lockstep_expected(cfg, BATCH, PROMPT_LEN, STREAM_STEPS)
    outs = {}
    for mode in ("gspmd", "elk_stream"):
        eng = res if mode == "gspmd" else ServeEngine(cfg, params, scfg)
        eng.generate(prompts, steps=1)
        zero_launches()
        outs[mode] = eng.generate(prompts, steps=STREAM_STEPS)
        torch.cuda.synchronize()
        if {**read_launches(), "routes": read_routes()} != want:
            fail(f"llama2-70b {mode} at {STREAM_CHECK_LAYERS} layers launched "
                 f"{read_launches()}, by route {read_routes()}")
    if not torch.equal(outs["gspmd"], outs["elk_stream"]):
        fail(f"llama2-70b at {STREAM_CHECK_LAYERS} layers: streamed and "
             f"resident weights gave different tokens:\n{outs}")
    say(f"[models] llama2-70b at {STREAM_CHECK_LAYERS} layers, full width: "
        f"resident and streamed (prefetch_depth {scfg.prefetch_depth}) "
        f"tokens equal, {outs['gspmd'][0, PROMPT_LEN:].tolist()}")
    live_checks(cfg, params, prompts)
    del res, eng, params, outs


def same_routes(cfg, layers: list, ls) -> int:
    """Every product and MLP of ``layers`` (resident) takes the route on the
    stream's buffer views that it takes on the resident tensors, at a
    decode step's and a prefill's rows, and every weight of the views lies
    on 256 bytes; fails otherwise.  Returns the checks made."""
    checks = 0
    for li, layer in enumerate(layers):
        ls.issue(li, 0)
        view = ls.acquire(li, 0)
        ls.release(0)
        torch.cuda.synchronize()
        pairs = [(k, layer["attn"][k], view["attn"][k])
                 for k in ("w_q", "w_k", "w_v", "w_o")]
        if "moe" in layer:
            pairs.append(("router", layer["moe"]["router"],
                          view["moe"]["router"]))
        mlps = [(key, layer[key], view[key]) for key in ("mlp", "shared_mlp")
                if key in layer]
        for rows in (BATCH, BATCH * PROMPT_LEN):
            for name, a, b in pairs:
                x = torch.empty((rows, a.shape[0]), dtype=torch.bfloat16,
                                device="cuda")
                checks += 1
                if matmul_route_of(x, a) != matmul_route_of(x, b):
                    fail(f"{cfg.name} layer {li} {name}: route "
                         f"{matmul_route_of(x, b)} streamed, "
                         f"{matmul_route_of(x, a)} resident")
            x = torch.empty((rows, cfg.d_model), dtype=torch.bfloat16,
                            device="cuda")
            for name, a, b in mlps:
                checks += 1
                got, want = (mlp_route_of(x, w["w_up"], w["w_down"],
                                          w.get("w_gate")) for w in (b, a))
                if got != want:
                    fail(f"{cfg.name} layer {li} {name}: route {got} "
                         f"streamed, {want} resident")
        for path, t in _leaves(view):
            if isinstance(t, torch.Tensor) and t.data_ptr() % 256:
                fail(f"{cfg.name} layer {li} {path} lies off 256 bytes")
    return checks


def moe_stream_phase(arch: str, cfg, params: dict, run: dict,
                     kernel_rows: list[dict], profile: bool) -> None:
    """An MoE config under ``elk_stream`` with the planner's knobs on
    ``h100_host()``, full width, at MOE_DEPTH layers.  The resident run's
    weights (``params``) move into a layer stream, their device copy
    freed: every product takes the same route on the stream's views, and
    the streamed engine (its expert buffer sized once the resident layers
    are gone) gives the resident run's greedy tokens.  Then lock-step on
    it, and three decode steps one by one: the ``[stream-moe]`` line with
    the bytes each copied, window and experts apart, beside what
    whole-layer copies would have moved; then three at a window of 2 (the
    stream holds two buffers for them), where the experts' copies queue
    behind the next layer's window copy."""
    dev = torch.device("cuda")
    full = get_config(arch)
    depth = cfg.num_layers
    scfg = elk_serve_config(cfg, batch=BATCH, cache_capacity=CACHE,
                            pod=h100_host())
    layers = params.pop("layers")
    ls = LayerStream(layers, dev, depth=max(scfg.prefetch_depth, 2))
    checks = same_routes(cfg, layers, ls)
    del layers
    gc.collect()
    torch.cuda.empty_cache()
    eng = ServeEngine(cfg, {**params, "layers": ls}, scfg)   # sizes experts
    if any(t.data_ptr() % 256 for w in ls._expert_views for t in w.values()):
        fail(f"{cfg.name}: an expert slot lies off 256 bytes")
    zero_launches()
    out = eng.generate(run["prompts"], steps=STREAM_STEPS)
    torch.cuda.synchronize()
    if {**read_launches(), "routes": read_routes()} != lockstep_expected(
            cfg, BATCH, PROMPT_LEN, STREAM_STEPS):
        fail(f"{cfg.name} streamed at {cfg.num_layers} layers launched "
             f"{read_launches()}, by route {read_routes()}")
    if not torch.equal(out, run["out"][:, :PROMPT_LEN + STREAM_STEPS]):
        fail(f"{cfg.name} at {cfg.num_layers} layers: streamed and resident "
             f"weights gave different tokens:\n{out}\n{run['out']}")
    say(f"[models] {cfg.name} at {cfg.num_layers} layers, full width: "
        f"{checks} products and MLPs on the same route streamed as resident; "
        f"resident and streamed (prefetch_depth {scfg.prefetch_depth}, an "
        f"expert buffer of {ls.expert_slots} experts) tokens equal, "
        f"{out[0, PROMPT_LEN:].tolist()}")
    del out
    copies0 = ls.copies
    run = lockstep_run(cfg, eng, kernel_rows, f"{cfg.name} stream lock-step",
                       PROMPT_LEN, STREAM_STEPS, warm_steps=1)
    passes = 1 + STREAM_STEPS + 2 + (STREAM_STEPS - 1)
    if ls.copies - copies0 != depth * passes:
        fail(f"{ls.copies - copies0} layer copies in {passes} streamed passes "
             f"of {depth} layers")
    # three decode steps at the planner's window, three at a window of 2
    cache, tok = run["cache"], run["out"][:, -1]
    steps, planned = {}, scfg.prefetch_depth    # (eng.scfg is scfg)
    for window in dict.fromkeys((planned, 2)):
        eng.scfg.prefetch_depth = window
        steps[window] = []
        for _ in range(3):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            logits, cache = eng.decode(tok, cache)
            ev[1].record()
            torch.cuda.synchronize()
            tok = torch.argmax(logits[:, -1, :], dim=-1)
            steps[window].append((ev[0].elapsed_time(ev[1]), dict(ls.bytes)))
        if not torch.isfinite(logits).all():
            fail(f"{cfg.name}: streamed decode logits at a window of {window} "
                 "not finite")
    eng.scfg.prefetch_depth = planned
    say("[stream-moe] " + json.dumps({
        "model": cfg.name, "depth": f"{depth} of {full.num_layers}",
        "layer_kinds": tfm.layer_kinds(cfg), "batch": BATCH,
        "prompt_len": PROMPT_LEN, "cache": CACHE, "steps": STREAM_STEPS,
        "pinned_host_bytes": ls.host_bytes, "prefetch_depth": planned,
        "prefill_chunk": scfg.prefill_chunk, "window_buffers": ls.depth,
        "window_bytes": ls.depth * ls.layer_bytes,
        "expert_slots": ls.expert_slots,
        "expert_buffer_bytes": ls.expert_slots * ls.expert_bytes,
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        "prefill_ms": run["prefill_ms"],
        "decode_ms_per_token": run["decode_ms_per_token"],
        "tokens_per_s": run["tokens_per_s"],
        "decode_step_ms": [ms for ms, _ in steps[planned]],
        "window_bytes_per_step": [b["window"] for _, b in steps[planned]],
        "expert_bytes_per_step": [b["experts"] for _, b in steps[planned]],
        "experts_per_step": [b["experts"] // ls.expert_bytes
                             for _, b in steps[planned]],
        "whole_layer_bytes_per_step": ls.host_bytes,
        "copied_GBps": [sum(b.values()) / (ms * 1e-3) / 1e9
                        for ms, b in steps[planned]],
        "decode_step_ms_p2": [ms for ms, _ in steps[2]],
        **copy_rates(ls), "launches": run["launches"],
        "launches_by_route": run["launches_by_route"],
        "sample": run["out"][0, PROMPT_LEN:].tolist()}))
    if profile and arch == TRACE_ARCH:
        for window in steps:
            eng.scfg.prefetch_depth = window
            profile_stream_step(eng, run["prompts"],
                                label=f"stream-moe decode p{window}")
        eng.scfg.prefetch_depth = planned
    del eng, ls, run, cache, logits
    params.clear()


def models_phase(kernel_rows: list[dict], profile: bool) -> None:
    """The configs of ``MODEL_RUNS`` at full width, one after another,
    each freed before the next: dit-xl, gemma2-27b, gemma-7b, llama2-13b,
    opt-30b and h2o-danube-1.8b resident at full depth and qwen1.5-32b at
    QWEN15_DEPTH, the configs of PLAIN_CHECK_ARCHS then at PLAIN_LAYERS
    against the plain path (``plain_check``); llama2-70b resident against
    streamed, llama4-maverick and kimi-k2 resident at MOE_DEPTH layers (a
    dense and an MoE layer), kimi-k2 also through the continuous batcher,
    then both streamed (``moe_stream_phase``)."""
    t_phase = time.perf_counter()
    for arch, depth, prompt_len, ring in MODEL_RUNS:
        t_check = time.perf_counter()
        if arch == "llama2_70b":
            llama2_70b_phase()
            say(f"[models] llama2-70b check at {STREAM_CHECK_LAYERS} layers "
                f"took {time.perf_counter() - t_check:.1f}s")
            continue
        cfg, params, eng, run = resident_model(arch, depth, prompt_len, ring,
                                               kernel_rows)
        say(f"[models] {cfg.name} resident took "
            f"{time.perf_counter() - t_check:.1f}s")
        if arch == TRACE_ARCH and profile:
            profile_moe(eng, run)
        del eng
        if arch in PLAIN_CHECK_ARCHS:
            t_check = time.perf_counter()
            del run["cache"]                    # the full depth's ring
            plain_check(cfg, params, run["prompts"], ring)
            say(f"[models] {cfg.name} plain-path check took "
                f"{time.perf_counter() - t_check:.1f}s")
        if arch == TRACE_ARCH:
            trace_phase(cfg, params, kernel_rows, False,
                        path=f"{cfg.name} continuous", tag="[models-trace]")
        if "moe" in tfm.layer_kinds(cfg):
            moe_stream_phase(arch, cfg, params, run, kernel_rows, profile)
        del params, run
    free_card("the end of the models phase")
    say(f"[models] phase took {time.perf_counter() - t_phase:.1f}s")


# ---------------------------------------------------------------------------
# phase 10: the four remaining families at full width (rwkv6-7b at
# RWKV_DEPTH layers, the others at full depth)
# ---------------------------------------------------------------------------

# the port's kernels by name: each lies in an anonymous namespace at the top
# of its CUDA source (``hg::`` for the mainloop of ``hopper_gemm.cuh``)
PORT_KERNEL = re.compile(r"(void )?(hg::)?\(anonymous namespace\)::"
                         r"(elk_matmul_|gemm_kernel|fused_mlp_|"
                         r"decode_attention_kernel|flash_attention_|"
                         r"kv_quant_)")
# device kernels of one counted launch: fused_mlp's two passes (or its
# partial sums and their reduction); one for every other wrapper
DEVICE_KERNELS_PER_LAUNCH = {"fused_mlp": 2}


def device_split(fn, host_ops: bool = False) -> dict:
    """One pass ``fn`` (after a warm-up) timed on the host around a
    synchronize, then under ``torch.profiler``: the device time and launches
    of the port's kernels (``PORT_KERNEL``) apart from PyTorch's own (norms,
    activations, casts, a recurrence's steps), the device's idle share of
    the pass, and the seconds the profiled pass took.  The trace may miss
    kernels, so the launch counts are read around the profiled pass too:
    ``trace_complete`` says whether the trace holds the port's kernels
    they count (``DEVICE_KERNELS_PER_LAUNCH`` each).  With ``host_ops``
    the host side is traced too, and the five operators with the most host
    time are listed (a pass of 100k launches is traced on the device
    only)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    activities = [ProfilerActivity.CUDA] + (
        [ProfilerActivity.CPU] if host_ops else [])
    zero_launches()
    with profile(activities=activities) as prof:
        fn()
        torch.cuda.synchronize()
    counted = sum(DEVICE_KERNELS_PER_LAUNCH.get(name, 1) * launches
                  for name, launches in read_launches().items())
    events = prof.key_averages()
    us = {"port": 0.0, "other": 0.0}
    n = {"port": 0, "other": 0}
    for e in events:
        if e.device_type != DeviceType.CUDA:
            continue
        key = "port" if PORT_KERNEL.match(e.key) else "other"
        us[key] += e.self_device_time_total
        n[key] += e.count
    if not n["port"]:
        fail("torch.profiler recorded none of the port's kernels")
    busy = (us["port"] + us["other"]) * 1e-3
    out = {"wall_ms": wall, "device_busy_ms": busy,
           "device_idle_share": 1.0 - busy / wall,
           "port_kernels_ms": us["port"] * 1e-3, "port_kernels": n["port"],
           "counted_port_kernels": counted,
           "trace_complete": n["port"] == counted,
           "other_kernels_ms": us["other"] * 1e-3,
           "other_kernels": n["other"]}
    if host_ops:
        top = sorted(((e.self_cpu_time_total, e.count, e.key) for e in events
                      if e.device_type == DeviceType.CPU), reverse=True)[:5]
        out["top_host_ops"] = [[key[:60], cnt, us_ * 1e-3]
                               for us_, cnt, key in top]
    out["profiled_in_s"] = time.perf_counter() - t0
    return out


def recurrence_ms(cfg, prompt_len: int) -> dict:
    """RWKV's WKV recurrence alone (``models/rwkv.wkv_sequence``, a plain
    loop over time of PyTorch's kernels, one launch each) at a layer's
    prefill and decode-step shapes, times the layers: what a pass spends
    in it, host-bound by design."""
    h = cfg.num_heads
    hd = cfg.d_model // h
    gen = torch.Generator(device="cuda").manual_seed(7)

    def inputs(s):
        def normal(*shape):
            return torch.randn(shape, generator=gen, device="cuda")
        w = torch.rand((BATCH, h, s, hd), generator=gen, device="cuda")
        return (normal(BATCH, h, s, hd), normal(BATCH, h, s, hd),
                normal(BATCH, h, s, hd), 0.5 + 0.45 * w, normal(h, hd),
                torch.zeros((BATCH, h, hd, hd), device="cuda"))

    pre, dec = inputs(prompt_len), inputs(1)
    layers = cfg.num_layers
    return {"recurrence_prefill_ms": layers * time_ms(
                lambda: rwkv_mod.wkv_sequence(*pre), 1, warmup=1),
            "recurrence_decode_ms": layers * time_ms(
                lambda: rwkv_mod.wkv_sequence(*dec), 10)}


def family_stream(arch: str, cfg, params: dict, run: dict, prompt_len: int,
                  ring: int, kernel_rows: list[dict]) -> None:
    """``arch`` under ``elk_stream`` with the planner's knobs on
    ``h100_host()``, on the resident run's weights and prompts: rwkv6-7b and
    internvl2-1b move their layers into a layer stream (pinned host memory,
    a window of the planner's depth) and must give the resident run's
    STREAM_STEPS tokens; whisper-tiny, an encoder-decoder model, stays
    resident under ``elk_stream``, as the reference keeps it, with the same
    tokens.  Launches counted as the path ``<model> stream lock-step``."""
    streamed = streams(cfg, "elk_stream")
    if streamed and arch not in FAMILY_STREAMED:
        return
    dev = torch.device("cuda")
    scfg = elk_serve_config(cfg, batch=BATCH, cache_capacity=ring,
                            pod=h100_host())
    t0 = time.perf_counter()
    if not streamed:
        eng, ls = ServeEngine(cfg, params, scfg), None
        if eng.streamed:
            fail(f"{cfg.name}: an encoder-decoder model was streamed")
    else:
        ls = LayerStream(params["layers"], dev, depth=scfg.prefetch_depth)
        eng = ServeEngine(cfg, {**params, "layers": ls}, scfg)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    eng.generate(run["prompts"], steps=1)            # warm-up
    copies0 = ls.copies if ls else 0
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    out = eng.generate(run["prompts"], steps=STREAM_STEPS)
    torch.cuda.synchronize()
    gen_ms = (time.perf_counter() - t0) * 1e3
    path = f"{cfg.name} stream lock-step"
    record_launches(kernel_rows, path, read_launches(),
                    lockstep_expected(cfg, BATCH, prompt_len, STREAM_STEPS),
                    read_routes())
    if not torch.equal(out, run["out"][:, :prompt_len + STREAM_STEPS]):
        fail(f"{cfg.name}: elk_stream and resident weights gave different "
             f"tokens:\n{out}\n{run['out']}")
    if ls is not None and ls.copies - copies0 != cfg.num_layers * STREAM_STEPS:
        fail(f"{ls.copies - copies0} layer copies in {STREAM_STEPS} streamed "
             f"passes of {cfg.num_layers} layers")
    say("[families] " + json.dumps({
        "model": cfg.name, "mode": "elk_stream", "streamed": eng.streamed,
        "prefetch_depth": scfg.prefetch_depth,
        "prefill_chunk": scfg.prefill_chunk,
        "window_bytes": ls.depth * ls.layer_bytes if ls else 0,
        "pinned_host_bytes": ls.host_bytes if ls else 0,
        "setup_s": setup_s, "steps": STREAM_STEPS, "generate_ms": gen_ms,
        "tokens_equal_resident": True,
        **(copy_rates(ls) if ls else {}),
        "sample": out[0, prompt_len:].tolist()}))
    del eng, ls


def families_phase(kernel_rows: list[dict]) -> None:
    """The four configs of ``FAMILY_RUNS`` at full width and their depth,
    one after another, each freed before the next: drawn on the card from
    seed 0, served lock-step and resident (BATCH x the run's prompt length,
    STEPS steps, the run's ring; the VLM's patches and the enc-dec model's
    frames from the stub frontends), one ``[families]`` line each with a
    profiled prefill and decode step (and RWKV's recurrence alone); then
    the trace (``FAMILY_TRACE_N``) and ``elk_stream`` (``family_stream``)."""
    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    for arch, depth, prompt_len, ring in FAMILY_RUNS:
        t_cfg = time.perf_counter()
        full = get_config(arch)
        cfg = model_cfg(arch, depth)
        free_card(cfg.name)
        t0 = time.perf_counter()
        params = tfm.init_params(torch.Generator(device=dev).manual_seed(0),
                                 cfg, dev)
        torch.cuda.synchronize()
        draw_s = time.perf_counter() - t0
        eng = ServeEngine(cfg, params, ServeConfig(batch=BATCH,
                                                   cache_capacity=ring))
        run = lockstep_run(cfg, eng, kernel_rows, f"{cfg.name} lock-step",
                           prompt_len, STEPS, warm_steps=2)
        peak = torch.cuda.max_memory_allocated()
        t0 = time.perf_counter()
        fe = frontend_embeddings(cfg, BATCH, device=dev)
        torch.cuda.synchronize()
        stub_ms = (time.perf_counter() - t0) * 1e3
        cache = run["cache"]
        tok = run["out"][:, -1]
        split = {"prefill_profile": device_split(
                     lambda: eng.prefill(run["prompts"], cache, **fe)),
                 "decode_profile": device_split(
                     lambda: eng.decode(tok, cache), host_ops=True)}
        if cfg.rwkv:
            split.update(recurrence_ms(cfg, prompt_len))
        if cfg.encoder_layers:    # the encoder alone over the batch's frames
            split["encoder_ms"] = time_ms(lambda: tfm._encode(
                eng.params, cfg, fe["enc_embeds"]), 5)
        if cfg.ssm_state:         # a pass's fp32 casts of the SSM's weights
            p_ssm = eng.params["layers"][0]["ssm"]
            split["ssm_casts_ms"] = cfg.num_layers * time_ms(lambda: [
                p_ssm[k].to(torch.float32) for k in SSM_FP32_CASTS], 10)
        say("[families] " + json.dumps({
            "model": cfg.name, "depth": f"{cfg.num_layers} of "
            f"{full.num_layers}", "layer_kinds": sorted(set(
                tfm.layer_kinds(cfg))), "mode": "gspmd",
            "param_bytes": tree_bytes(params), "drawn_in_s": draw_s,
            "batch": BATCH, "prompt_len": prompt_len,
            "positions": seq_len(cfg, prompt_len),
            "frames": cfg.encoder_seq, "cache": ring, "steps": STEPS,
            "max_memory_allocated_bytes": peak,
            "prefill_ms": run["prefill_ms"],
            "decode_ms_per_token": run["decode_ms_per_token"],
            "generate_ms": run["generate_ms"],
            "tokens_per_s": run["tokens_per_s"],
            "stub_draw_ms": stub_ms if fe else 0.0,
            "prefill_decode_tokens_per_s": BATCH * STEPS / (
                (run["prefill_ms"] + (STEPS - 1) * run["decode_ms_per_token"])
                * 1e-3),
            "decode_tokens_per_s": BATCH / (run["decode_ms_per_token"]
                                            * 1e-3),
            **split, "launches": run["launches"],
            "launches_by_route": run["launches_by_route"],
            "sample": run["out"][0, prompt_len:].tolist()}))
        del eng, cache, fe
        if arch in FAMILY_TRACE_N:
            trace_phase(cfg, params, kernel_rows, False,
                        path=f"{cfg.name} continuous", tag="[families-trace]",
                        requests=FAMILY_TRACE_N[arch])
        family_stream(arch, cfg, params, run, prompt_len, ring, kernel_rows)
        del params, run
        say(f"[families] {cfg.name} took {time.perf_counter() - t_cfg:.1f}s")
    free_card("the end of the families phase")
    say(f"[families] phase took {time.perf_counter() - t_phase:.1f}s")


def profile_moe(eng: ServeEngine, run: dict) -> None:
    """Three kimi-k2 decode steps and a prefill under ``torch.profiler``,
    with the share of the device time that the expert products take (the
    library's matrix products: the port's own kernels all lie in anonymous
    namespaces of its CUDA sources)."""
    prompts = run["prompts"]
    logits, cache = eng.prefill(prompts)
    tok = torch.argmax(logits[:, -1, :], dim=-1)

    def decode3():
        nonlocal cache
        for _ in range(3):
            _, cache = eng.decode(tok, cache)

    for label, passes, fn, wall in (
            ("kimi-k2 decode", 3, decode3, run["decode_ms_per_token"]),
            ("kimi-k2 prefill", 1, lambda: eng.prefill(prompts, cache),
             run["prefill_ms"])):
        rows = profile_passes(label, passes, fn, wall)
        total = sum(us for us, _, _ in rows)
        experts = sum(us for us, _, key in rows
                      if "anonymous namespace" not in key and any(
                          w in key.lower() for w in ("gemm", "nvjet", "xmma",
                                                     "cutlass")))
        say("[profile] " + json.dumps({
            "pass": label, "expert_products_ms": experts * 1e-3 / passes,
            "expert_products_share": experts / total}))


def intervals_ms(events: list) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(events):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def profile_stream_step(eng: ServeEngine, prompts: torch.Tensor,
                        label: str = "stream decode") -> None:
    """One streamed decode step under ``torch.profiler``: the device's busy
    and idle share within that step (its wall time is the span of a
    ``record_function`` around the step and a synchronize, in the same
    trace), and how much of the weight copies' time compute hides (kernel
    time on the compute stream that falls inside copy time).  The copies
    of an expert (``expert_bytes`` each) are counted apart from the
    window's, with the time expert copies waited, issued but not started,
    while a window copy ran ahead of them on the copy stream."""
    from torch.profiler import ProfilerActivity, profile, record_function

    out_dir = ROOT / "build" / "profile"
    out_dir.mkdir(parents=True, exist_ok=True)
    expert_bytes = eng.params["layers"].expert_bytes
    logits, cache = eng.prefill(prompts)
    tok = torch.argmax(logits[:, -1, :], dim=-1)
    eng.decode(tok, cache)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(label):
            eng.decode(tok, cache)
            torch.cuda.synchronize()
    path = out_dir / f"trace_{label.replace(' ', '_')}.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    kernels, window, experts, step, issued = [], [], [], [], {}
    for e in events:
        if e.get("ph") != "X":
            continue
        span = (e["ts"] * 1e-3, (e["ts"] + e.get("dur", 0)) * 1e-3)
        args = e.get("args", {})
        if e.get("cat") == "kernel":
            kernels.append(span)
        elif e.get("cat") == "gpu_memcpy" and "HtoD" in e.get("name", ""):
            (experts if expert_bytes and args.get("bytes") == expert_bytes
             else window).append((span, args.get("correlation")))
        elif e.get("cat") == "cuda_runtime" and "correlation" in args:
            issued[args["correlation"]] = span[0]
        elif e.get("cat") == "user_annotation" and e.get("name") == label:
            step.append(span)
    copies = [span for span, _ in window + experts]
    if not kernels or not copies or len(step) != 1:
        fail(f"the streamed step's trace has {len(kernels)} kernels, "
             f"{len(copies)} host-to-card copies and {len(step)} step spans")
    wall_ms = step[0][1] - step[0][0]
    compute_ms, copy_ms = intervals_ms(kernels), intervals_ms(copies)
    busy_ms = intervals_ms(kernels + copies)
    overlap_ms = compute_ms + copy_ms - busy_ms
    row = {"pass": label, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "device_idle_share": 1.0 - busy_ms / wall_ms,
           "compute_ms": compute_ms, "copy_ms": copy_ms,
           "overlap_ms": overlap_ms,
           "compute_hidden_under_copies": overlap_ms / compute_ms,
           "copies_overlapped_by_compute": overlap_ms / copy_ms,
           "host_to_device_copies": len(copies),
           "device_kernels": len(kernels)}
    if experts:
        spans = [span for span, _ in experts]
        waits = [(issued[c], span[0]) for span, c in experts
                 if c in issued and issued[c] < span[0]]
        behind = [(max(a, w0), min(b, w1)) for w0, w1 in waits
                  for (a, b), _ in window if a < w1 and b > w0]
        expert_ms = intervals_ms(spans)
        row.update({
            "expert_copies": len(experts), "expert_copy_ms": expert_ms,
            "window_copy_ms": intervals_ms([span for span, _ in window]),
            "expert_copies_overlapped_by_compute": (
                expert_ms + compute_ms - intervals_ms(spans + kernels))
            / expert_ms,
            "expert_copies_waiting_ms": intervals_ms(waits),
            "expert_copies_waiting_behind_window_ms": intervals_ms(behind)})
    say("[profile] " + json.dumps(row))


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


def profile_passes(label: str, passes: int, fn, wall_ms: float) -> list:
    """``fn`` (``passes`` passes) under ``torch.profiler``: summed device
    time of its kernels beside the wall time of one pass measured without
    the profiler, and the top kernels by name.  Returns (device us, count,
    name) of every kernel."""
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
    (out_dir / f"profile_{label.replace(' ', '_')}.txt").write_text(
        events.table(sort_by="self_cuda_time_total", row_limit=40))
    return rows


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


# ---------------------------------------------------------------------------
# phase 11: training
# ---------------------------------------------------------------------------

# backward kernels: every gradient within TOL * (max|plain| + 1e-3) of the
# plain backward on the same inputs (fp32: the kernels sum in other orders,
# attention takes exp2 on the card; bf16: the kernels round P, dS, dg, du and
# h to bf16 before their products, the plain versions keep them in fp32).
# The bf16 limit is three times the largest bf16 error the sweeps measured on
# an H100: attention 0.0068 of max|plain|, the MLP 0.0022
BWD_TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}
# (tokens, K, N): x^T dy at odd shapes and at shapes TMA takes, and, on
# route "wgmma_xt", at the edges of its schedule (chip/h100.xt_schedule):
# fewer tiles than SMs (513, 64, 136: two tiles, each split over 5 blocks
# by K; 2000, 640, 640: 25 tiles over clusters of 4; 512, 32, 2048: 16
# tiles of 64 x 128 over clusters of 8, two blocks an SM), a few more tiles
# than the blocks the card holds (1000, 2176, 1024: 136 tiles of 128 x 128
# on 120 blocks, the last 16 split over clusters of 4, the tokens no
# multiple of 64), a ragged m and n with whole waves and a split one
# (4096, 1700, 2500: 280 tiles of 128 x 128, 16 over clusters of 2)
XT_SWEEP = [(100, 60, 70), (33, 129, 257), (257, 200, 328), (513, 64, 136),
            (512, 256, 384), (4096, 32, 200), (64, 512, 1024),
            (2000, 640, 640), (1000, 2176, 1024), (4096, 1700, 2500),
            (512, 32, 2048)]
# (M, D, FF, gated, bias, act): both routes ("fused" where TMA takes the
# operands, ff = 257 on "fma"), ragged m, ff no multiple of the fused pass's
# 64 or 128 columns, d and d_out past its ring of stages (640: ten 64-deep K
# steps a phase), gated and plain
MLP_BWD_SWEEP = [(128, 128, 256, True, False, "silu"),
                 (100, 80, 144, False, True, "gelu"),
                 (64, 96, 200, False, False, "relu"),
                 (33, 64, 257, True, False, "silu"),
                 (333, 256, 200, True, False, "silu"),
                 (1000, 192, 328, False, True, "gelu"),
                 (300, 640, 520, True, False, "silu")]
# (B, Hq, Hkv, Sq, Sk, D, causal, window): every mask, G 1, 4, 5, 7, 8, every
# head dim of the bf16 routes (16 and 32 on "mma_sync" only), S no multiple of
# 64 or 128, Sq != Sk, and rows enough that both rings of route "wgmma" wrap
# (520: nine key tiles of the dQ pass through its three stages; G 7 x 6
# query tiles through the dK/dV pass's four).  D 256 (the plan that splits
# the output's columns, two stages a ring): G 1 and 2; causal, windowed and
# bidirectional with Sq != Sk; S no multiple of 64; 333 rows (six tiles
# through each two-stage ring, 2 x 4 for G 2)
FLASH_BWD_SWEEP = [(2, 4, 4, 128, 128, 64, True, 0),
                   (1, 5, 1, 96, 96, 72, True, 0),
                   (1, 7, 1, 130, 130, 80, True, 48),
                   (2, 8, 1, 64, 64, 112, False, 0),
                   (1, 8, 2, 77, 150, 128, False, 0),
                   (1, 5, 1, 200, 200, 128, True, 0),
                   (1, 2, 2, 40, 40, 64, True, 16),
                   (1, 7, 1, 333, 333, 64, True, 0),
                   (1, 8, 1, 300, 300, 112, True, 100),
                   (2, 5, 1, 257, 257, 128, False, 0),
                   (1, 8, 1, 190, 450, 72, False, 0),
                   (1, 1, 1, 520, 520, 128, True, 0),
                   (1, 5, 5, 300, 300, 96, True, 64),
                   (1, 4, 2, 100, 100, 32, True, 0),
                   (1, 2, 1, 70, 70, 16, False, 0),
                   (1, 2, 2, 333, 333, 256, True, 0),
                   (2, 4, 2, 200, 200, 256, True, 70),
                   (1, 2, 1, 77, 150, 256, False, 0),
                   (1, 4, 2, 256, 256, 256, True, 0)]
# the full-width slice: qwen3-14b at TRAIN_DEPTH of its 40 layers (2.88 B
# parameters; at 12 bytes each with bf16 weights and gradients and fp32
# moments, 34.5 GB; all 40 layers would need 178 GB)
TRAIN_DEPTH, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 8, 512, 6
# gemma-7b (head dim 256) at GEMMA_TRAIN_DEPTH of its 28 layers: 1.89 B
# parameters, 22.7 GB at 12 bytes each (all 28: about 102 GB); the fewest
# steps the checks need (the first is the warm-up; the step time is the
# mean of the others)
GEMMA_TRAIN_DEPTH, GEMMA_TRAIN_STEPS = 4, 3
TRAIN_GRAD_TOL = 5e-2     # relative Frobenius error of a bf16 gradient
# relative Frobenius error of a pass's bf16 logits, the kernels against the
# plain path (``plain_check``)
PLAIN_LOGITS_TOL = 3e-2
TRAIN_PARITY_TOL = 5e-4   # fp32 smoke configs, card against CPU
TRAIN_DIR = ROOT / "build" / "train"


def _grad_err(got: torch.Tensor, ref: torch.Tensor, dtype) -> tuple:
    ref32 = ref.to(torch.float32)
    err = float((got.to(torch.float32) - ref32).abs().max()) \
        if ref.numel() else 0.0
    tol = BWD_TOL[dtype] * (float(ref32.abs().max()) + 1e-3)
    return err, err / tol


def check_xt(x, dy, x2=None, dy2=None) -> tuple[float, float]:
    """x^T dy (x stored (tokens, K), read transposed) against
    ``matmul_ref`` of the view, or the two-part x dy + x2 dy2; the limit of
    ``check_matmul`` (the sums' order, one rounding in bf16)."""
    if x2 is None:
        return check_matmul(x.t(), dy)
    out = elk_matmul_kernel(x, dy, x2, dy2)
    again = elk_matmul_kernel(x, dy, x2, dy2)
    torch.cuda.synchronize()
    where = f"two-part x{tuple(x.shape)} y{tuple(dy.shape)} {x.dtype}"
    if not torch.equal(out, again):
        fail(f"elk_matmul gave other bits the second time at {where}")
    ref32 = matmul2_ref(x, dy, x2, dy2).to(torch.float32)
    f = torch.float32
    k = 2 * x.shape[1]
    limit = 2 * k * 2.0 ** -23 * (torch.matmul(x.to(f).abs(), dy.to(f).abs())
                                  + torch.matmul(x2.to(f).abs(),
                                                 dy2.to(f).abs()))
    if x.dtype == torch.bfloat16:
        limit += 2.0 ** -7 * ref32.abs()
    diff = (out.to(f) - ref32).abs()
    over = float((diff / limit.clamp(min=1e-30)).max())
    if over > 1.0:
        fail(f"elk_matmul disagrees with matmul2_ref at {where}: "
             f"{over:.3f} x its limit")
    return float(diff.max()), over


def check_mlp_bwd(x, w_up, w_down, kw, act, dy) -> tuple[float, float]:
    """Every gradient of ``fused_mlp_bwd_kernel`` against
    ``fused_mlp_bwd_ref``; launched twice, equal bits."""
    run = lambda: fused_mlp_bwd_kernel(x, w_up, w_down, dy, act=act, **kw)
    got, again = run(), run()
    torch.cuda.synchronize()
    ref = fused_mlp_bwd_ref(x, w_up, w_down, dy, act=act, **kw)
    where = (f"x{tuple(x.shape)} ff={w_up.shape[1]} {x.dtype} act={act} "
             f"{sorted(kw)} route="
             f"{mlp_bwd_route_of(x, w_up, w_down, kw.get('w_gate'))}")
    worst = (0.0, 0.0)
    for name, r in ref.items():
        if r is None:
            continue
        g = got[name]
        if not torch.equal(g, again[name]):
            fail(f"fused_mlp_bwd gave other bits the second time: {name} "
                 f"at {where}")
        if g.shape != r.shape or g.dtype != r.dtype or \
                not torch.isfinite(g.float()).all():
            fail(f"fused_mlp_bwd {name}: {tuple(g.shape)} {g.dtype}, plain "
                 f"{tuple(r.shape)} {r.dtype}, or not finite at {where}")
        err, over = _grad_err(g, r, x.dtype)
        if over > 1:
            fail(f"fused_mlp_bwd {name} disagrees with fused_mlp_bwd_ref at "
                 f"{where}: max abs err {err:.3e}, {over:.3f} x tol")
        worst = max(worst, (over, err))
    return worst[1], worst[0]


def check_h_bits(x, w_up, w_down, kw, act, dy) -> None:
    """The h that the fused pass of ``fused_mlp_bwd`` writes (and dw_down =
    h^T dy reads) against the h of the forward's pass 1, bit for bit (the
    same K order and one rounding of act(g) u); both launched through their
    libraries' C functions, as the wrappers launch them."""
    lib, flib = fused_mlp_kernels._bwd_lib(), fused_mlp_kernels._lib()
    m, d = x.shape
    ff, dout = w_up.shape[1], w_down.shape[1]
    w_gate, b_up = kw.get("w_gate"), kw.get("b_up")
    ptr = lambda t: None if t is None else t.data_ptr()
    stream = torch.cuda.current_stream().cuda_stream
    h_fwd, h_bwd, du = (torch.empty((m, ff), dtype=x.dtype, device="cuda")
                        for _ in range(3))
    dg = None if w_gate is None else torch.empty_like(du)
    act_id = MLP_ACTS.index(act)
    errs = (flib.fused_mlp_pass1_launch(ptr(x), ptr(w_up), ptr(w_gate),
                                        ptr(b_up), ptr(h_fwd), m, d, ff,
                                        act_id, stream),
            lib.fused_mlp_bwd_fused_launch(
                ptr(x), ptr(w_up), ptr(w_gate), ptr(b_up), ptr(dy),
                ptr(w_down), ptr(dg), ptr(du), ptr(h_bwd), m, d, ff, dout,
                act_id, stream))
    torch.cuda.synchronize()
    if any(errs) or not torch.equal(h_fwd, h_bwd):
        fail(f"fused_mlp_bwd: the fused pass's h is not the forward's bit for "
             f"bit (launches {errs}) at x{tuple(x.shape)} ff={ff} act={act} "
             f"{sorted(kw)}")


def check_flash_bwd(q, k, v, dout, causal, window) -> tuple[float, float]:
    """The forward's log-sum-exp against ``mha_lse_ref``, then dq, dk, dv of
    ``flash_attention_bwd_kernel`` against ``mha_bwd_ref`` from the
    kernel's own output and log-sum-exp; launched twice, equal bits."""
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    out = flash_attention_kernel(q, k, v, causal=causal, window=window,
                                 lse=lse)
    ref_out, ref_lse = flash_ref.mha_lse_ref(q, k, v, causal=causal,
                                             window=window)
    where = (f"q{tuple(q.shape)} k{tuple(k.shape)} {q.dtype} causal={causal}"
             f" window={window} route={flash_route_of(q, k)}, backward route "
             f"{flash_bwd_route_of(q)}")
    lse_err = float((lse - ref_lse).abs().max())
    if not torch.equal(out, flash_attention_kernel(q, k, v, causal=causal,
                                                   window=window)) \
            or lse_err > 1e-3:
        fail(f"flash_attention with lse: other output bits than without, or "
             f"lse off by {lse_err:.3e}, at {where}")
    run = lambda: flash_attention_bwd_kernel(q, k, v, out, dout, lse,
                                             causal=causal, window=window)
    got, again = run(), run()
    torch.cuda.synchronize()
    ref = flash_ref.mha_bwd_ref(q, k, v, out, dout, lse, causal=causal,
                                window=window)
    worst = (0.0, 0.0)
    for name, g, a, r in zip("qkv", got, again, ref):
        if not torch.equal(g, a):
            fail(f"flash_attention_bwd gave other bits the second time: d{name}"
                 f" at {where}")
        if g.shape != r.shape or not torch.isfinite(g.float()).all():
            fail(f"flash_attention_bwd d{name} {tuple(g.shape)} against "
                 f"{tuple(r.shape)}, or not finite, at {where}")
        err, over = _grad_err(g, r, q.dtype)
        if over > 1:
            fail(f"flash_attention_bwd d{name} disagrees with mha_bwd_ref at "
                 f"{where}: max abs err {err:.3e}, {over:.3f} x tol")
        worst = max(worst, (over, err))
    return worst[1], worst[0]


def flash_bwd_bound_ms(b, hq, hkv, s, d, dtype, causal=True
                       ) -> tuple[float, str]:
    """Least time of a backward at Sq = Sk = s: q, out, dout (Hq heads), k, v
    (Hkv heads) and the fp32 lse read once, dq, dk, dv written once; five
    products over the live pairs (the causal half, or all)."""
    size = torch.empty((), dtype=dtype).element_size()
    pairs = s * (s + 1) // 2 if causal else s * s
    q_like, kv_like = b * hq * s * d, b * hkv * s * d
    t_bytes = ((3 * q_like + 2 * kv_like) * size + b * hq * s * 4
               + (q_like + 2 * kv_like) * size) / HBM_BYTES_PER_S
    t_ops = 5 * 2 * b * hq * pairs * d / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def mlp_bwd_bound_ms(m, d, ff, dtype, gated=True) -> tuple[float, str]:
    """Least time of an MLP's gradient from its inputs: x, the weights and dy
    read once, dx and the weight gradients written once (the plain MLP's
    biases and their gradients too); the products under remat, 2 m d ff
    operations each: GLU eight (g and u recomputed, dh, three weight
    gradients, two for dx), plain five (u, dh, two weight gradients, dx)."""
    size = torch.empty((), dtype=dtype).element_size()
    weights = (3 if gated else 2) * d * ff + (0 if gated else ff + d)
    t_bytes = 2 * (2 * m * d + weights) * size / HBM_BYTES_PER_S
    t_ops = (8 if gated else 5) * 2 * m * d * ff / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def mlp_bwd_launches_ms(x, w_up, w_down, dy, kw, act) -> dict:
    """Each launch of ``fused_mlp_bwd_kernel`` on route "fused" timed alone
    by CUDA events, called as the wrapper calls it: the fused pass, the
    weight gradients (dw_gate and dw_up in one launch for a GLU, dw_up on
    ``elk_matmul`` for the plain MLP), dw_down, dx, and the bias sums."""
    lib = fused_mlp_kernels._bwd_lib()
    m, d = x.shape
    ff, dout = w_up.shape[1], w_down.shape[1]
    w_gate, b_up = kw.get("w_gate"), kw.get("b_up")
    ptr = lambda t: None if t is None else t.data_ptr()
    stream = lambda: torch.cuda.current_stream().cuda_stream
    du, h = (torch.empty((m, ff), dtype=x.dtype, device="cuda") for _ in range(2))
    dg = None if w_gate is None else torch.empty_like(du)
    fused = lambda: lib.fused_mlp_bwd_fused_launch(
        ptr(x), ptr(w_up), ptr(w_gate), ptr(b_up), ptr(dy), ptr(w_down),
        ptr(dg), ptr(du), ptr(h), m, d, ff, dout, MLP_ACTS.index(act),
        stream())
    if fused():
        fail("fused_mlp_bwd: the fused pass was refused")
    out = {"fused pass": time_ms(fused, 3)}
    if w_gate is not None:
        dw = torch.empty((2, d, ff), dtype=x.dtype, device="cuda")
        wgrad = lambda: lib.fused_mlp_bwd_wgrad_launch(
            ptr(x), ptr(dg), ptr(du), ptr(dw[0]), ptr(dw[1]), m, d, ff,
            stream())
        if wgrad():
            fail("fused_mlp_bwd: the weight gradients' launch was refused")
        out["dw_gate + dw_up"] = time_ms(wgrad, 3)
        out["dx"] = time_ms(lambda: elk_matmul_kernel(dg, w_gate.t(), du,
                                                      w_up.t()), 3)
    else:
        out["dw_up"] = time_ms(lambda: elk_matmul_kernel(x.t(), du), 3)
        out["dx"] = time_ms(lambda: elk_matmul_kernel(du, w_up.t()), 3)
        db = torch.empty((ff,), dtype=x.dtype, device="cuda")
        out["db_up, db_down"] = time_ms(lambda: lib.fused_mlp_bwd_colsum_launch(
            ptr(du), ptr(db), m, ff, 1, stream()), 3) + time_ms(
            lambda: lib.fused_mlp_bwd_colsum_launch(ptr(dy), ptr(db), m, dout,
                                                    1, stream()), 3)
    out["dw_down"] = time_ms(lambda: elk_matmul_kernel(h.t(), dy), 3)
    return out


def flash_bwd_launches_ms(q, k, v, o, dout, lse, causal) -> dict:
    """The two passes of ``flash_attention_bwd_kernel`` (bf16, q and dout
    as the row gives them) each timed alone by CUDA events, called as the
    wrapper calls them: the dQ pass (which writes each row's delta), then
    the dK/dV pass (which reads it)."""
    lib, name = flash_kernels._bwd_lib(flash_bwd_route_of(q))
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    dq = torch.empty((b, sq, hq, d), dtype=q.dtype,
                     device="cuda").transpose(1, 2)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    work = torch.empty((b, hq, -(-sq // flash_kernels.BWD_TILE)
                        * flash_kernels.BWD_TILE, 2), dtype=torch.float32,
                       device="cuda")

    def launch(passes):
        err = getattr(lib, f"{name}_launch")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), work.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), b, hq, hkv, sq, sk, d,
            *q.stride()[:3], *o.stride()[:3], *dout.stride()[:3],
            *dq.stride()[:3], int(causal), 0, d ** -0.5, 1, passes,
            torch.cuda.current_stream().cuda_stream)
        if err:
            fail(f"flash_attention_bwd: pass {passes} was refused ({err})")

    return {"dQ pass": time_ms(lambda: launch(flash_kernels.BWD_PASS_DQ), 10),
            "dK/dV pass": time_ms(
                lambda: launch(flash_kernels.BWD_PASS_DKV), 10)}


def flash_bwd_row(normal, b, hq, hkv, s, hd, causal) -> dict:
    """A timed row of the attention backward at (B, Hq, Hkv, S, D) with the
    mask's ``causal`` flag: held to ``mha_bwd_ref``, timed beside its bound,
    the plain version and SDPA's backward, and pass by pass."""
    dt = torch.bfloat16
    q = normal(b, s, hq, hd, dtype=dt).transpose(1, 2)
    kk, vv = normal(b, hkv, s, hd, dtype=dt), normal(b, hkv, s, hd, dtype=dt)
    dout = normal(b, s, hq, hd, dtype=dt).transpose(1, 2)
    err, over = check_flash_bwd(q, kk, vv, dout, causal, 0)
    lse = torch.empty((b, hq, s), dtype=torch.float32, device="cuda")
    o = flash_attention_kernel(q, kk, vv, causal=causal, lse=lse)
    bound, by = flash_bwd_bound_ms(b, hq, hkv, s, hd, dt, causal)
    g = hq // hkv
    sdpa = [t.detach().requires_grad_(True) for t in
            (q, kk.repeat_interleave(g, 1), vv.repeat_interleave(g, 1))]
    with torch.enable_grad():
        lib_out = torch.nn.functional.scaled_dot_product_attention(
            *sdpa, is_causal=causal)
        library_ms = time_ms(lambda: torch.autograd.grad(
            lib_out, sdpa, dout, retain_graph=True), 10)
    del lib_out, sdpa
    run = lambda: flash_attention_bwd_kernel(q, kk, vv, o, dout, lse,
                                             causal=causal)
    row = {"shape": f"B={b} Hq={hq} Hkv={hkv} S={s} D={hd} "
                    f"{'causal' if causal else 'bidirectional'}",
           "route": flash_bwd_route_of(q), "max_abs_err": err,
           "err_over_tol": over, "ms": time_ms(run, 10),
           "plain_ms": time_ms(lambda: flash_ref.mha_bwd_ref(
               q, kk, vv, o, dout, lse, causal=causal), 2, warmup=1)
           if b * hq * s * s <= 8 * 40 * 512 * 512 else None,
           "bound_ms": bound, "bound_by": by, "library_ms": library_ms,
           "library_note": "SDPA's backward with K and V repeated to Hq heads",
           "launch_ms": flash_bwd_launches_ms(q, kk, vv, o, dout, lse, causal)}
    return row


def mlp_bwd_row(gen, normal, m, d, ff, gated, bias, act) -> dict:
    """A timed row of the MLP backward: held to ``fused_mlp_bwd_ref`` and its
    h to the forward's, timed beside its bound, the plain version and
    autograd of the ``torch.matmul`` chain, and launch by launch."""
    dt = torch.bfloat16
    xm, w_up, w_down, kw = mlp_inputs(gen, (m,), d, ff, gated, bias, dt)
    dy = normal(m, d, dtype=dt)
    err, over = check_mlp_bwd(xm, w_up, w_down, kw, act, dy)
    check_h_bits(xm, w_up, w_down, kw, act, dy)
    bound, by = mlp_bwd_bound_ms(m, d, ff, dt, gated)
    fn = act_fn(act)
    names = ("w_gate",) if gated else ("b_up", "b_down")
    leaves = [t.detach().requires_grad_(True)
              for t in (xm, w_up, w_down, *(kw[n] for n in names))]
    with torch.enable_grad():
        x_, wu, wd = leaves[:3]
        if gated:
            hid = fn(torch.matmul(x_, leaves[3])) * torch.matmul(x_, wu)
            lib_out = torch.matmul(hid, wd)
        else:
            lib_out = torch.matmul(fn(torch.matmul(x_, wu) + leaves[3]),
                                   wd) + leaves[4]
        library_ms = time_ms(lambda: torch.autograd.grad(
            lib_out, leaves, dy, retain_graph=True), 3)
    del lib_out, leaves
    run = lambda: fused_mlp_bwd_kernel(xm, w_up, w_down, dy, act=act, **kw)
    row = {"shape": f"{'GLU' if gated else 'plain'} {act}"
                    f"{' biases' if bias else ''} m={m} d={d} ff={ff}",
           "route": mlp_bwd_route_of(xm, w_up, w_down, kw.get("w_gate")),
           "max_abs_err": err, "err_over_tol": over, "ms": time_ms(run, 3),
           "plain_ms": time_ms(lambda: fused_mlp_bwd_ref(
               xm, w_up, w_down, dy, act=act, **kw), 1, warmup=1),
           "bound_ms": bound, "bound_by": by, "library_ms": library_ms,
           "library_note": "autograd of the torch.matmul chain",
           "launch_ms": mlp_bwd_launches_ms(xm, w_up, w_down, dy, kw, act)}
    return row


def xt_plan_fields(plan, k: int) -> dict:
    """A route "wgmma_xt" plan as its row prints it: tile, stages, blocks,
    split tiles and clusters, and the blocks the card holds at once in
    such clusters (``xt_capacity``) beside those the plan read
    (``XT_RESIDENT``)."""
    if plan.route != "wgmma_xt":
        return {}
    cap = xt_capacity(torch.device("cuda"), plan.bm, plan.bn, plan.splits)
    return {"plan": {"bm": plan.bm, "bn": plan.bn, "stages": plan.stages,
                     "blocks": plan.grid, "tiles": plan.tiles,
                     "split_tiles": plan.tail, "clusters_of": plan.splits,
                     "k_tiles_a_piece": plan.k_per_split},
            "resident_blocks": cap,
            "planned_resident_blocks":
                XT_RESIDENT[plan.blocks_per_sm][plan.splits - 1]}


def xt_other_plans_ms(x, dy, chosen) -> dict:
    """Times of x^T dy under every other tile of XT_TILES and cluster size
    the schedule takes at this shape, with bits checked against the plain
    version as ``check_xt`` does: what the plan's model is measured by."""
    width, k = x.shape[1], x.shape[0]
    n, k_tiles = dy.shape[1], -(-k // 64)
    ref = None
    out = {}
    for bm, bn in XT_TILES:
        stages, per_sm = xt_stages(bm, bn)
        tiles = -(-width // bm) * -(-n // bn)
        for s in range(1, 9):
            sched = xt_schedule(tiles, k_tiles, XT_RESIDENT[per_sm][s - 1],
                                s)
            if sched is None or (bm, bn, s) == (chosen.bm, chosen.bn,
                                                chosen.splits):
                continue
            plan = dataclasses.replace(
                smem_plan(width, n, k, x_trans=True), bm=bm, bn=bn,
                stages=stages, blocks_per_sm=per_sm, tiles=tiles,
                splits=sched.splits, k_per_split=sched.per,
                grid=sched.grid, tail=sched.tail)
            got = elk_matmul_kernel(x.t(), dy, xt_plan=plan)
            if ref is None:
                ref = matmul_ref(x.t(), dy).to(torch.float32)
            if float((got.to(torch.float32) - ref).abs().max()) > 2.0 ** -6 \
                    * float(ref.abs().max()):
                fail(f"x^T dy under plan {bm}x{bn}/{s} disagrees")
            out[f"{bm}x{bn}/{s}"] = time_ms(
                lambda: elk_matmul_kernel(x.t(), dy, xt_plan=plan), 10)
    return out


def train_rows(cfg) -> dict:
    """The backward sweeps (bf16 on every route, and fp32), then the timed
    rows at the training shapes (B 8, S 512 = 4096 tokens): qwen3-14b's
    products, MLP and attention, attention at S 4096, dit-xl's plain MLP and
    bidirectional attention at D 72, kimi-k2's attention at D 112, at D
    64 internvl2-1b's and whisper-tiny's encoder's, and gemma-7b's at D 256
    (B 8 x S 512, and B 1 x S 4096, the length of its train_4k cell)."""
    gen = torch.Generator(device="cuda").manual_seed(4321)

    def normal(*shape, dtype, scale=1.0):
        t = torch.randn(shape, generator=gen, device="cuda",
                        dtype=torch.float32) * scale
        return t.to(dtype)

    names = ("elk_matmul_xt", "fused_mlp_bwd", "flash_attention_bwd")
    # worst (err/tol, err) a kernel and type
    by_type = {name: {} for name in names}
    cases = dict.fromkeys(names, 0)
    xt_routes = dict.fromkeys(MATMUL_ROUTES, 0)
    bwd_routes = {"fused_mlp_bwd": {}, "flash_attention_bwd": {}}
    attn_dims = {}     # the attention backward's cases by head dim and route
    for dtype in (torch.bfloat16, torch.float32):
        worst = dict.fromkeys(names, (0.0, 0.0))
        for tok, k, n in XT_SWEEP:
            x = normal(tok, k, dtype=dtype)
            dy = normal(tok, n, dtype=dtype)
            xt_routes[matmul_route_of(x.t(), dy)] += 1
            err, over = check_xt(x, dy)
            worst["elk_matmul_xt"] = max(worst["elk_matmul_xt"], (over, err))
            # the two-part sum of the MLP's dx: dg w_gate^T + du w_up^T
            dg, du = normal(n, tok, dtype=dtype), normal(n, tok, dtype=dtype)
            wg, wu = normal(k, tok, dtype=dtype), normal(k, tok, dtype=dtype)
            err, over = check_xt(dg, wg.t(), du, wu.t())
            worst["elk_matmul_xt"] = max(worst["elk_matmul_xt"], (over, err))
            cases["elk_matmul_xt"] += 2
        for m, d, ff, gated, bias, act in MLP_BWD_SWEEP:
            x, w_up, w_down, kw = mlp_inputs(gen, (m,), d, ff, gated, bias,
                                             dtype)
            dy = normal(m, d, dtype=dtype)
            route = mlp_bwd_route_of(x, w_up, w_down, kw.get("w_gate"))
            err, over = check_mlp_bwd(x, w_up, w_down, kw, act, dy)
            if route == "fused":   # its h the forward's
                check_h_bits(x, w_up, w_down, kw, act, dy)
            worst["fused_mlp_bwd"] = max(worst["fused_mlp_bwd"], (over, err))
            cases["fused_mlp_bwd"] += 1
            bwd_routes["fused_mlp_bwd"][route] = \
                bwd_routes["fused_mlp_bwd"].get(route, 0) + 1
        for b, hq, hkv, sq, sk, d, causal, window in FLASH_BWD_SWEEP:
            q = normal(b, hq, sq, d, dtype=dtype)
            kk = normal(b, hkv, sk, d, dtype=dtype)
            vv = normal(b, hkv, sk, d, dtype=dtype)
            # dout in the (B, S, Hq, D) storage autograd hands over
            dout = normal(b, sq, hq, d, dtype=dtype).transpose(1, 2)
            err, over = check_flash_bwd(q, kk, vv, dout, causal, window)
            worst["flash_attention_bwd"] = max(worst["flash_attention_bwd"],
                                               (over, err))
            cases["flash_attention_bwd"] += 1
            route = flash_bwd_route_of(q)
            bwd_routes["flash_attention_bwd"][route] = \
                bwd_routes["flash_attention_bwd"].get(route, 0) + 1
            by_dim = attn_dims.setdefault(f"D{d}", {})
            by_dim[route] = by_dim.get(route, 0) + 1
        for name in names:
            by_type[name][str(dtype).removeprefix("torch.")] = worst[name]
    worst = {name: max(by_type[name].values()) for name in names}
    say(f"[train] backward sweeps, bf16 and fp32, every case launched twice "
        f"with equal bits, the fused pass's h the forward's bit for bit: "
        f"cases {json.dumps(cases)}; x^T dy by route "
        f"{json.dumps(xt_routes)}; the MLP and attention backward by route "
        f"{json.dumps(bwd_routes)}; attention by head dim and route "
        f"{json.dumps(attn_dims)}; worst err/tol and its err by type "
        f"{json.dumps(by_type)}")

    # timed rows at the full-width training shapes: the four projections'
    # and the LM head's x^T dy, and the MLP's dw_down = h^T dy (h of d_ff)
    dt = torch.bfloat16
    m, d = TRAIN_BATCH * TRAIN_SEQ, cfg.d_model
    out = {}
    shapes = []
    for label, width, n in (
            ("q, o", d, cfg.num_heads * cfg.resolved_head_dim),
            ("k, v", d, cfg.num_kv_heads * cfg.resolved_head_dim),
            ("lm_head", d, cfg.vocab_size),
            ("dw_down", cfg.d_ff, d)):
        x = normal(m, width, dtype=dt)
        dy = normal(m, n, dtype=dt)
        err, over = check_xt(x, dy)
        bound, by = matmul_bound_ms(width, n, m, dt)
        iters = 3 if n > 100000 else 10
        plan = plan_of(x.t(), dy)
        shapes.append({
            "shape": f"x^T dy {label} tokens={m}", "m": width, "n": n,
            "k": m, "route": plan.route, "max_abs_err": err,
            "err_over_tol": over,
            "ms": time_ms(lambda: matmul(x.t(), dy), iters),
            "plain_ms": time_ms(lambda: matmul_ref(x.t(), dy), 2, warmup=1),
            "bound_ms": bound, "bound_by": by,
            "library_ms": time_ms(lambda: torch.matmul(x.t(), dy), iters),
            **xt_plan_fields(plan, m)})
        if n < 100000:      # the plans the model did not choose, timed
            shapes[-1]["other_plans_ms"] = xt_other_plans_ms(x, dy, plan)
        say("[train] elk_matmul_xt " + json.dumps(shapes[-1]))
        del x, dy
    out["elk_matmul_xt"] = shapes
    # the blocks the card holds at once of each x^T dy instance in clusters
    # of 1-8, beside chip/h100.XT_RESIDENT, which the plan reads
    resident = {f"{bm}x{bn}": [xt_capacity(torch.device("cuda"), bm, bn, s)
                               for s in range(1, 9)] for bm, bn in XT_TILES}
    planned = {f"{bm}x{bn}": list(XT_RESIDENT[xt_stages(bm, bn)[1]])
               for bm, bn in XT_TILES}
    say(f"[train] elk_matmul_xt blocks resident in clusters of 1-8: "
        f"{json.dumps(resident)}; the plan's XT_RESIDENT: "
        f"{json.dumps(planned)}")

    dit = get_config("dit_xl")
    out["fused_mlp_bwd"] = []
    for args in ((m, d, cfg.d_ff, True, False, cfg.mlp_act),
                 (m, dit.d_model, dit.d_ff, False, True, dit.mlp_act)):
        out["fused_mlp_bwd"].append(mlp_bwd_row(gen, normal, *args))
        say("[train] fused_mlp_bwd " + json.dumps(out["fused_mlp_bwd"][-1]))
        torch.cuda.empty_cache()

    kimi = get_config("kimi_k2_1t_a32b")
    # D 64: internvl2-1b (G 7) causal, whisper-tiny's encoder over its 1500
    # frames (G 1) bidirectional
    intern, whisper = get_config("internvl2_1b"), get_config("whisper_tiny")
    gemma = get_config("gemma_7b")
    out["flash_attention_bwd"] = []
    for b, c, s, causal in ((TRAIN_BATCH, cfg, TRAIN_SEQ, True),
                            (1, cfg, 4096, True),
                            (TRAIN_BATCH, dit, TRAIN_SEQ, False),
                            (TRAIN_BATCH, kimi, TRAIN_SEQ, True),
                            (TRAIN_BATCH, intern, TRAIN_SEQ, True),
                            (TRAIN_BATCH, whisper, 1500, False),
                            (TRAIN_BATCH, gemma, TRAIN_SEQ, True),
                            (1, gemma, 4096, True)):
        out["flash_attention_bwd"].append(flash_bwd_row(
            normal, b, c.num_heads, c.num_kv_heads, s, c.resolved_head_dim,
            causal))
        say("[train] flash_attention_bwd "
            + json.dumps(out["flash_attention_bwd"][-1]))
        torch.cuda.empty_cache()

    sources = {"elk_matmul_xt": ("elk_matmul.cu",
                                 "src/repro/kernels/elk_matmul/kernel.py:31"),
               "fused_mlp_bwd": ("fused_mlp_bwd.cu",
                                 "src/repro/kernels/fused_mlp/kernel.py:79"),
               "flash_attention_bwd": (
                   "flash_attention_bwd_wgmma.cu",
                   "src/repro/kernels/flash_attention/kernel.py:86")}
    rows = []
    for name, (src, replaces) in sources.items():
        main = out[name][0]
        rows.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": replaces,
            "replaces_note": "the gradient of that TPU kernel's function; "
                             "the reference has no backward kernel and "
                             "trains through XLA's gradient",
            "launches": 0, "max_abs_err": main["max_abs_err"],
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"], "cases": cases[name],
            "max_err_over_tol": worst[name][0], "shapes": out[name]})
    return rows


def train_expected(cfg, steps: int, remat: bool = True) -> dict:
    """Launches of ``steps`` training steps of a dense GLU decoder, in all
    and by route: a layer's four projections, its MLP and its attention run
    forward once (twice under remat: the recompute of the backward), and
    backward once: dx and dW of each projection, the MLP's backward (its
    fused pass and its two weight gradients dw_gate, dw_up in
    ``fused_mlp_bwd``'s launches; dw_down and the two-part dx on
    elk_matmul, x read transposed for dw_down) and attention's; the LM head
    forward, dx and dW.  Every product of these bf16 shapes on "wgmma" but
    the x^T dy of the weight gradients, on "wgmma_xt"; the
    MLP forward on "two_pass", the attention kernels on "wgmma" over bf16
    K/V, the MLP backward on "fused"."""
    if cfg.moe_experts or cfg.rwkv or cfg.hybrid_parallel_ssm or \
            cfg.encoder_layers or not cfg.gated_mlp:
        raise ValueError("train_expected counts dense GLU decoders only")
    n, fwd = cfg.num_layers, 2 if remat else 1
    products = steps * (n * (4 * fwd + 4 + 4 + 2) + 3)
    xt = steps * (n * (4 + 1) + 1)
    counts = {"elk_matmul": products,
              "elk_matmul_xt": xt,
              "fused_mlp": steps * n * fwd, "fused_mlp_bwd": steps * n,
              "flash_attention": steps * n * fwd,
              "flash_attention_bwd": steps * n,
              "decode_attention": 0, "kv_quant": 0}
    routes = {"elk_matmul": {"wgmma": products - xt, "wgmma_xt": xt},
              "fused_mlp": {"two_pass": counts["fused_mlp"]},
              "flash_attention": {"wgmma": counts["flash_attention"]},
              "flash_attention kv": {"bfloat16": counts["flash_attention"]},
              "fused_mlp_bwd": {"fused": counts["fused_mlp_bwd"]},
              "flash_attention_bwd": {"wgmma": counts["flash_attention_bwd"]}}
    return {**counts, "routes": routes}


def _plain_dispatch():
    """Every kernel op takes its plain version, on the card too: the five
    ops modules' ``dispatch`` replaced until the context ends."""
    from repro_torch.kernels.decode_attention import ops as d_ops
    from repro_torch.kernels.elk_matmul import ops as m_ops
    from repro_torch.kernels.flash_attention import ops as f_ops
    from repro_torch.kernels.fused_mlp import ops as l_ops
    from repro_torch.kernels.kv_quant import ops as q_ops

    @contextlib.contextmanager
    def ctx():
        saved = [(mod, mod.dispatch)
                 for mod in (m_ops, f_ops, l_ops, d_ops, q_ops)]
        for mod, _ in saved:
            mod.dispatch = (lambda x, kernel_call, ref_call, meta_call=None:
                            ref_call())
        try:
            yield
        finally:
            for mod, fn in saved:
                mod.dispatch = fn
    return ctx()


def train_parity() -> None:
    """One training step (loss and every gradient, remat on) of every smoke
    config in fp32: the plain path on the CPU against the kernels on the
    card, on the same weights and batch."""
    worst = {}
    for arch in ARCH_IDS:
        cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32",
                                  param_dtype="float32")
        cpu = tfm.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
        card = tree_map(lambda t: t.to("cuda"), cpu)
        rng = np.random.default_rng(0)
        batch = {"tokens": torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (2, 12)).astype(np.int32)),
            "labels": torch.from_numpy(rng.integers(
                0, cfg.vocab_size, (2, 12)).astype(np.int32)),
            **frontend_embeddings(cfg, 2, device="cpu")}
        res = []
        for params, dev in ((cpu, "cpu"), (card, "cuda")):
            for p in tree_leaves(params):
                p.requires_grad_(True)
            b = {k: v.to(dev) for k, v in batch.items()}
            res.append(value_and_grad(make_loss_fn(cfg), params, b))
        (l_cpu, g_cpu), (l_card, g_card) = res
        if not abs(float(l_card) - float(l_cpu)) <= 1e-5 * abs(float(l_cpu)):
            fail(f"[train] {arch}: loss {float(l_card)} on the card, "
                 f"{float(l_cpu)} on the CPU")
        over = 0.0
        for (path, a), (_, r) in zip(tree_items(g_card), tree_items(g_cpu)):
            err = float((a.cpu() - r).abs().max())
            tol = TRAIN_PARITY_TOL * (float(r.abs().max()) + 1e-3)
            if err > tol:
                fail(f"[train] {arch}: gradient {path} off by {err:.3e} "
                     f"(tol {tol:.3e}) between card and CPU")
            over = max(over, err / tol)
        worst[arch] = round(over, 4)
        del cpu, card, res
    say(f"[train] parity, one fp32 step of every smoke config, card against "
        f"CPU: loss within 1e-5, worst gradient err/tol {json.dumps(worst)}")


def smoke_trainer() -> None:
    """The qwen3 smoke trainer on the card: the loss falls; a crash at step
    9 and a restart from the step-6 checkpoint give the uninterrupted run's
    losses and weights bit for bit (under
    ``torch.use_deterministic_algorithms``: the embedding's gradient
    accumulates by index, atomics otherwise); the launcher runs."""
    cfg = get_smoke_config("qwen3_14b")
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)

    def trainer(wd, steps, hook=None):
        return Trainer(cfg, DataConfig(batch=4, seq=16,
                                       vocab_size=cfg.vocab_size),
                       AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=60),
                       TrainerConfig(workdir=str(wd), total_steps=steps,
                                     ckpt_every=6), failure_hook=hook)

    class Crash(RuntimeError):
        pass

    def bomb(step):
        if step == 9:
            raise Crash()

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        ta = trainer(TRAIN_DIR / "a", 12)
        log_a = ta.run()
        tb = trainer(TRAIN_DIR / "b", 12, bomb)
        try:
            tb.run()
            fail("[train] the failure hook did not crash the run")
        except Crash:
            tb.store.wait()
        tb2 = trainer(TRAIN_DIR / "b", 12)
        if tb2.step != 6:
            fail(f"[train] the restarted trainer resumed at {tb2.step}, not 6")
        log_b = tb2.run()
    finally:
        torch.use_deterministic_algorithms(False)
    same_loss = [m["loss"] for m in log_a[6:]] == [m["loss"] for m in log_b]
    same_bits = all(torch.equal(a, b) for a, b in zip(
        tree_leaves(ta.params), tree_leaves(tb2.params)))
    if not (same_loss and same_bits):
        fail(f"[train] the restarted run differs from the uninterrupted one: "
             f"losses equal {same_loss}, weights equal {same_bits}")
    if not log_a[-1]["loss"] < log_a[0]["loss"]:
        fail(f"[train] the smoke trainer's loss did not fall: "
             f"{[m['loss'] for m in log_a]}")
    log = launch_train.main(["--arch", "qwen3-14b", "--smoke", "--steps", "4",
                             "--workdir", str(TRAIN_DIR / "launcher"),
                             "--ckpt-every", "2"])
    if len(log) != 4 or not all(np.isfinite(m["loss"]) for m in log):
        fail(f"[train] launch/train.main --smoke gave {log}")
    say(f"[train] smoke trainer: loss {log_a[0]['loss']:.4f} -> "
        f"{log_a[-1]['loss']:.4f} over 12 steps; crash at step 9 and restart "
        f"from step 6 equal to the uninterrupted run bit for bit (losses of "
        f"steps 7-12 and every weight; deterministic algorithms on); "
        f"launcher --smoke: 4 steps, final loss {log[-1]['loss']:.4f}")
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)


def train_full(rows: list[dict], arch: str = "qwen3_14b",
               depth: int = TRAIN_DEPTH, steps: int = TRAIN_STEPS,
               path: str = "train") -> dict:
    """``arch`` at full width and ``depth`` layers, bf16, B 8 x S 512,
    remat: ``steps`` AdamW steps through ``Trainer`` with the launch counts
    recorded as ``path``; then layer 0's and the LM head's gradients of one
    step against the plain versions' on the same weights and batch (a tied
    head's: the embedding's, which also takes the lookup's gradient), and
    where a step's time goes (``train_split``)."""
    cfg = model_cfg(arch, depth)
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    tr = Trainer(cfg, DataConfig(batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                                 vocab_size=cfg.vocab_size),
                 AdamWConfig(lr=1e-4, warmup_steps=2, total_steps=steps),
                 TrainerConfig(workdir=str(TRAIN_DIR), total_steps=steps,
                               ckpt_every=steps + 1))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in tree_leaves(tr.params))
    init_s = time.perf_counter() - t0
    zero_launches()
    log = tr.run()
    torch.cuda.synchronize()
    counts, routes = read_launches(train=True), read_routes(train=True)
    peak = torch.cuda.max_memory_allocated() - base
    record_launches(rows, path, counts, train_expected(cfg, steps), routes)
    losses = [m["loss"] for m in log]
    if not all(np.isfinite(losses)):
        fail(f"[train] {cfg.name} full width: losses {losses}")
    step_s = statistics.mean(m["step_time"] for m in log[1:])

    # layer 0's and the LM head's gradients against the plain versions'
    batch = {k: v.to("cuda") for k, v in tr.data.batch_at(0).items()}
    split = train_split(tr, batch)
    head = "embed" if cfg.tie_embeddings else "lm_head"
    leaves = [t for _, t in tree_items(tr.params["layers"][0])]
    leaves.append(tr.params[head])
    names = [f"layers/0/{p}" for p, _ in tree_items(tr.params["layers"][0])]
    names.append(head)
    loss_fn = make_loss_fn(cfg)
    grads = torch.autograd.grad(loss_fn(tr.params, batch), leaves)
    with _plain_dispatch():
        plain = torch.autograd.grad(loss_fn(tr.params, batch), leaves)
    checked = {}
    for name, g, r in zip(names, grads, plain):
        rel = rel_frobenius(g, r)
        checked[name] = round(rel, 5)
        if not rel < TRAIN_GRAD_TOL:
            fail(f"[train] {cfg.name} full width: gradient {name} off by "
                 f"{rel:.4f} (relative norm) from the plain versions'")
    del grads, plain, leaves, batch
    tokens = TRAIN_BATCH * TRAIN_SEQ
    line = {
        "model": cfg.name, "layers": depth,
        "of_layers": get_config(arch).num_layers,
        "d_model": cfg.d_model, "d_ff": cfg.d_ff,
        "vocab": cfg.vocab_size, "params": n_params, "dtype": "bfloat16",
        "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "remat": True,
        "steps": steps, "losses": losses,
        "step_ms": step_s * 1e3,
        "first_step_ms": log[0]["step_time"] * 1e3,
        "tokens_per_s": tokens / step_s,
        "max_memory_allocated_bytes": peak, "init_s": init_s,
        "grad_rel_err_vs_plain": checked,
        "launches": counts, "launches_by_route": routes, "split": split}
    say("[train] " + json.dumps(line))
    del tr
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return line


def train_split(tr, batch: dict) -> dict:
    """Where a training step's time goes: one step timed by CUDA events in
    its three stages (the loss's forward; the backward, with remat's
    recompute of every layer; the AdamW update), the launches of each
    stage, then the same step under ``torch.profiler``: the device's busy
    time and idle share, the port's kernels against PyTorch's own, and the
    kernels that take the most device time.  Each run is one more step of
    ``tr``'s weights."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    loss_fn = make_loss_fn(tr.cfg)
    leaves = tree_leaves(tr.params)

    def step(events=None, counts=None):
        def mark(i):
            if events:
                events[i].record()
            if counts is not None and i in (1, 2):
                counts.append(read_launches(train=True))

        mark(0)
        loss = loss_fn(tr.params, batch)
        mark(1)
        grads = torch.autograd.grad(loss, leaves)
        mark(2)
        adamw.apply_update(tr.params, tree_unflatten(tr.params, list(grads)),
                           tr.opt_state, tr.opt_cfg)
        mark(3)

    events = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    counts = []
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    step(events, counts)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    fwd, bwd = counts
    out = {"wall_ms": wall,
           "forward_ms": events[0].elapsed_time(events[1]),
           "backward_ms": events[1].elapsed_time(events[2]),
           "optimizer_ms": events[2].elapsed_time(events[3]),
           "forward_launches": {k: v for k, v in fwd.items() if v},
           "backward_launches": {k: bwd[k] - fwd[k] for k in bwd
                                 if bwd[k] - fwd[k]}}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        prof_wall = (time.perf_counter() - t0) * 1e3
    by_name, port, other = {}, 0.0, 0.0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        ms = e.self_device_time_total * 1e-3
        if PORT_KERNEL.match(e.key):
            port += ms
        else:
            other += ms
        by_name[e.key[:90]] = (by_name.get(e.key[:90], (0.0, 0))[0] + ms,
                               by_name.get(e.key[:90], (0.0, 0))[1] + e.count)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    out.update({"profiled_wall_ms": prof_wall,
                "device_busy_ms": port + other,
                "device_idle_share": 1.0 - (port + other) / prof_wall,
                "port_kernels_ms": port, "other_kernels_ms": other,
                "top_kernels": [[k, round(ms, 3), n] for k, (ms, n) in top]})
    return out


def train_phase(cfg, rows: list[dict]) -> None:
    """Phase 11, outside inference mode: the backward kernels held and
    timed (``train_rows``), their rows added to ``rows``; the fp32 parity
    of one step of every smoke config; the smoke trainer; the full-width
    slice (``train_full``), its launches the "train" path of every kernel
    it runs; gemma-7b's slice (head dim 256), the "train gemma-7b" path."""
    new = train_rows(get_config("qwen3_14b"))
    train_parity()
    smoke_trainer()
    rows.extend(new)
    train_full(rows)
    t0 = time.perf_counter()
    train_full(rows, "gemma_7b", GEMMA_TRAIN_DEPTH, GEMMA_TRAIN_STEPS,
               "train gemma-7b")
    say(f"[train] gemma-7b at {GEMMA_TRAIN_DEPTH} layers took "
        f"{time.perf_counter() - t0:.1f}s")

# ---------------------------------------------------------------------------
# phase 12: the dry run (launch/dryrun.py)
# ---------------------------------------------------------------------------

# the cells measured on the card, each at its two reduced depths
DRYRUN_MEASURED = (("qwen3_14b", "decode_32k"), ("qwen3_14b", "prefill_32k"),
                   ("qwen3_14b", "train_4k"), ("hymba_1_5b", "long_500k"))
DRYRUN_DIR = ROOT / "build" / "dryrun_torch"
DRYRUN_JOBS = 6          # counting processes beside the one that measures
DRYRUN_ITERS = {"decode": 3, "prefill": 1, "train": 1}
# the count's product FLOPs against dryrun.explained_flops: norms, biases
# and the router's few products are all that differ
FLOP_TOL = 0.01
# what PyTorch's caching allocator may hold beyond a tensor's bytes: a small
# one is rounded up to 512 bytes, and a large one keeps the rest of its
# segment when that rest is under 1 MiB (too small to split off)
ALLOC_SLACK = 1 << 20


def count_one(cell: tuple) -> dict:
    """One cell counted on the meta device on the single-pod mesh (a worker
    process of ``dryrun_phase``)."""
    return dryrun.run_cell(*cell, "single", force=True,
                           out_dir=str(DRYRUN_DIR))


def check_counts(recs: list[dict]) -> None:
    """No cell in error; the cells skipped exactly those the reference's
    ``eligible`` skips (long_500k of a model that is not sub-quadratic)."""
    for r in recs:
        if r["status"] == "error":
            fail(f"[dryrun] {r['arch']} {r['shape']}: {r['error']}")
    skipped = {(r["arch"], r["shape"]) for r in recs
               if r["status"] == "skipped"}
    want = {(a, "long_500k") for a in ARCH_IDS
            if not get_config(a).sub_quadratic}
    if skipped != want:
        fail(f"[dryrun] skipped {sorted(skipped)}, expected {sorted(want)}")


def check_measured(rec: dict) -> dict:
    """The measured cell's checks: no variant faster than its counted
    bound, the card's argument bytes those ``local_bytes`` gives on a mesh
    of one (within the allocator's slack), the count's product FLOPs
    those ``model_flops`` explains; its ``[dryrun]`` line."""
    arch, shape = rec["arch"], rec["shape"]
    if rec["status"] != "ok":
        fail(f"[dryrun] {arch} {shape}: {rec.get('error')}\n"
             f"{rec.get('traceback', '')}")
    for v in rec["variants"]:
        if v["ms"] < v["bound_ms"]:
            fail(f"[dryrun] {arch} {shape} at {v['layers']} layers ran in "
                 f"{v['ms']} ms, under its counted bound {v['bound_ms']} ms:"
                 " a fault of the count")
        gap = abs(v["arg_bytes_card"] - v["arg_bytes_local"])
        if gap > ALLOC_SLACK * v["arg_tensors"]:
            fail(f"[dryrun] {arch} {shape} at {v['layers']} layers: the card "
                 f"holds {v['arg_bytes_card']} bytes of arguments, "
                 f"local_bytes says {v['arg_bytes_local']}")
    cfg, case = get_config(arch), SHAPES[shape]
    count = rec["count"]
    products = count["flops"] - count["attention_flops"]
    explained = dryrun.explained_flops(cfg, case)
    if abs(products - explained) > FLOP_TOL * explained:
        fail(f"[dryrun] {arch} {shape}: the count's product FLOPs "
             f"{products:.6e} against {explained:.6e} that model_flops "
             f"{rec['meta']['model_flops']:.6e} explains")
    rf = rec["roofline_flash"]
    line = {
        "cell": f"{arch} {shape}", "counted_flops": count["flops"],
        "counted_bytes": count["bytes"], "host_bytes": count["host_bytes"],
        "attention_flops": count["attention_flops"],
        "product_flops": products, "explained_flops": explained,
        "model_flops": rec["meta"]["model_flops"],
        "bound_ms": rf["bound_s"] * 1e3, "dominant": rf["dominant"],
        "variants": [{k: v.get(k) for k in (
            "layers", "batch", "ms", "bound_ms", "peak_bytes",
            "arg_bytes_card", "arg_bytes_local", "fwd_bwd_ms", "opt_ms")}
            for v in rec["variants"]],
        "full_ms": rec["ms"], "full_hbm_bytes":
            rec["memory"]["total_hbm_bytes"], "fits_80gb": rec["fits_80gb"],
        "roofline_fraction": rec["roofline_fraction"],
        "reduced": rec["reduced"]}
    say(f"[dryrun] {json.dumps(line)}")
    return line


def dryrun_phase() -> None:
    """Phase 12: every cell of ``launch/specs.all_cells`` counted on the
    meta device (single-pod mesh) in ``DRYRUN_JOBS`` worker processes,
    while this process measures the ``DRYRUN_MEASURED`` cells on the card
    (``dryrun.run_cell_accounting``: two reduced depths, extrapolated)."""
    shutil.rmtree(DRYRUN_DIR, ignore_errors=True)
    cells = sorted(all_cells(), key=lambda c: c[1] != "train_4k")
    ctx = multiprocessing.get_context("spawn")
    jobs = max(1, min(DRYRUN_JOBS, (os.cpu_count() or 2) - 2))
    with concurrent.futures.ProcessPoolExecutor(jobs, mp_context=ctx) as pool:
        counts = pool.map(count_one, cells)
        t_measure = time.perf_counter()
        for arch, shape in DRYRUN_MEASURED:
            free_card(f"the dry run of {arch} {shape}")
            rec = dryrun.run_cell_accounting(
                arch, shape, force=True, out_dir=str(DRYRUN_DIR),
                iters=DRYRUN_ITERS[SHAPES[shape].kind])
            check_measured(rec)
        say(f"[dryrun] measured {len(DRYRUN_MEASURED)} cells in "
            f"{time.perf_counter() - t_measure:.1f}s")
        recs = list(counts)
    check_counts(recs)
    tally = {s: sum(r["status"] == s for r in recs) for s in ("ok", "skipped")}
    say(f"[dryrun] counted {len(recs)} cells on the meta device: {tally}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, default=0,
                    help="depth of the resident lock-step serve phase (0 = "
                    "the model's own); the other phases keep full depth")
    ap.add_argument("--profile", action="store_true",
                    help="also trace decode steps, a prefill and slot steps")
    ap.add_argument("--only", choices=("kernels", "models", "train",
                                       "dryrun", "int8step"),
                    help="run the kernel phases only, the parity, "
                    "[models] and [families] phases only, the [train] or "
                    "the [dryrun] phase only, or the int8 lock-step decode "
                    "step of [int8] alone (to iterate on one part); "
                    "prints no result line")
    args = ap.parse_args()

    # phase 1: device
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs the GPU")
    card = smi_name_and_limit()
    host = host_memory()
    nvcc = subprocess.run([_build.nvcc_path(), "--version"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    try:
        triton = importlib.metadata.version("triton")
    except importlib.metadata.PackageNotFoundError:
        triton = "absent"
    say(f"[device] host memory at the start: {json.dumps(host)}")
    say(f"[device] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, triton {triton} (unused), "
        f"nvcc: {nvcc.splitlines()[-2]} / {nvcc.splitlines()[-1]}")

    # phase 2: build
    t0 = time.perf_counter()
    logs = _build.build_all(verbose=True)
    for name, log in logs.items():
        lines = [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "error" in ln.lower()]
        if len(lines) > 8:      # many template instances: a summary
            regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
            spills = [int(b) for b in
                      re.findall(r"(\d+) bytes spill stores", log)]
            lines = [f"{len(regs)} functions, registers {min(regs or [0])}-"
                     f"{max(regs or [0])}, spill stores up to "
                     f"{max(spills or [0])} bytes"] + [
                         ln for ln in lines if "error" in ln.lower()]
        for line in lines:
            say(f"[build] {name}: {line}")
        for entry, regs, spill in ptxas_entries(log):
            if any(key in entry for key in WATCHED_INSTANCES):
                say(f"[build] {name}: {entry}: {regs} registers, {spill} "
                    "bytes spill stores")
            if spill and any(key in entry for key in NO_SPILL_INSTANCES):
                fail(f"[build] {name}: ptxas spilled {spill} bytes in "
                     f"{entry}")
        # ptxas serializing the wgmma of a kernel (C7515) costs it most of
        # the tensor cores' overlap (the fused MLP pass 11.46 against 10.12
        # ms): no kernel may be so
        for fn in sorted(set(re.findall(r"C7515\).*?function '([^']+)'", log))):
            fail(f"[build] {name}: {fn}: wgmma serialized (ptxas C7515)")
    say(f"[build] {len(logs)} source(s) {sorted(logs)} built with nvcc for "
        f"sm_90a in {time.perf_counter() - t0:.1f}s; seconds by source "
        + json.dumps({n: round(t, 1)
                      for n, t in sorted(_build.build_seconds.items())}))

    # the plain versions are the reference: full fp32 products, no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("qwen3_14b")
    lock_cfg = cfg
    if args.layers:
        lock_cfg = dataclasses.replace(cfg, num_layers=args.layers)
    say(f"[serve] lock-step depth {lock_cfg.num_layers} of {cfg.num_layers}; "
        f"continuous depth {cfg.num_layers}")
    # the chunk the batcher cuts from the planner's budget on the stream path
    chunk = _chunk_len(SLOT_CACHE, elk_serve_config(
        model_cfg("qwen3_14b", STREAM_DEPTH), batch=SLOTS,
        cache_capacity=SLOT_CACHE, pod=h100_host()).prefill_chunk)
    def timed(name: str, fn, *a):
        t_phase = time.perf_counter()
        result = fn(*a)
        say(f"[time] {name}: {time.perf_counter() - t_phase:.1f}s")
        return result

    if args.only == "dryrun":
        timed("dryrun", dryrun_phase)
        say(f"[only {args.only}] stopped; no result line")
        return
    if args.only == "train":
        rows = [{"name": name, "launches": 0} for name in SERVING_KERNELS]
        timed("train", train_phase, cfg, rows)
        say(json.dumps({"kernels": rows}))
        say(f"[only {args.only}] stopped; no result line")
        return
    with torch.inference_mode():
        if args.only == "kernels":
            for row in (elk_matmul_phase(cfg), kernels_phase(cfg),
                        attention_phase(cfg), flash_phase(cfg, chunk),
                        kv_quant_phase(cfg)):
                say(json.dumps({k: row[k] for k in ("name", "ms", "bound_ms",
                                                     "library_ms")}))
        elif args.only == "int8step":
            eng = ServeEngine(cfg, draw_params(cfg), ServeConfig(
                batch=BATCH, cache_capacity=CACHE, kv_dtype="int8"))
            say("[int8-step] " + json.dumps(int8_step(cfg, eng)))
        elif args.only == "models":
            parity_phase()
            rows = [{"name": name, "launches": 0}
                    for name in SERVING_KERNELS]
            models_phase(rows, args.profile)
            families_phase(rows)
        if args.only:
            say(f"[only {args.only}] stopped; no result line")
            return
        rows = [timed("fused_mlp kernels", kernels_phase, cfg),
                timed("decode_attention kernels", attention_phase, cfg),
                timed("flash_attention kernels", flash_phase, cfg, chunk),
                timed("elk_matmul kernels", elk_matmul_phase, cfg),
                timed("kv_quant kernels", kv_quant_phase, cfg)]
        timed("parity", parity_phase)
        timed("emulator", emulator_phase)
        params = timed("draw", draw_params, cfg)
        out = timed("serve", serve_phase, lock_cfg, {
            **params, "layers": params["layers"][:lock_cfg.num_layers]},
            rows, args.profile)
        timed("serve-trace", trace_phase, cfg, params, rows, args.profile)
        timed("oversub", oversub_phase, cfg, params, rows)
        timed("int8", int8_phase, cfg, params, rows)
        timed("fleet", fleet_phase, cfg, params, rows)
        stream_cfg = model_cfg("qwen3_14b", STREAM_DEPTH)
        stream_ref = timed("stream reference", resident_tokens, stream_cfg,
                           params)
        del params, out               # the stream phase draws its own
        timed("stream", stream_phase, stream_cfg, rows, stream_ref,
              args.profile)
        timed("models", models_phase, rows, args.profile)
        timed("families", families_phase, rows)
    # the training side, outside inference mode (its tensors take part in
    # autograd)
    timed("train", train_phase, cfg, rows)
    free_card("the dry run")
    timed("dryrun", dryrun_phase)

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
