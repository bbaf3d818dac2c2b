"""Serving engine of the port: prefill + greedy decode, lock-step and
slot-batched, with resident or streamed weights.

Counterpart of ``src/repro/serve/engine.py``.  Two execution modes:

* ``gspmd``      -- weights resident on the card (the reference's name is
  kept; on one GPU there is nothing to shard).
* ``elk_stream`` -- the decoder's layer weights live in pinned host memory
  (preload state) and are copied onto the card through a window of
  ``prefetch_depth`` layer buffers (execute state) while the layers before
  them compute (``serve/stream.py``); an MoE layer's experts are copied
  after its router, only those it picked, into one expert buffer.  Every
  pass streams: prefill, decode, prefill chunks and slot steps.
  ``elk_serve_config`` chooses ``prefetch_depth`` and ``prefill_chunk``
  with the ELK planner (``core/integration.pod_plan``), for the port on
  ``chip/h100.h100_host()``.  An encoder-decoder config is not streamed,
  as in the reference (its decoder is small and its cross-attention K/V
  live in the cache: nothing worth streaming): the engine keeps its
  weights resident and says so.

Two batching disciplines:

* lock-step   -- ``generate``: one static batch, every request advances
  together.
* slot-batched -- ``step`` / ``prefill_chunk`` / ``insert_slot`` /
  ``evict_slot``: a per-slot cache where every row sits at its own
  position; requests join and leave the running batch at slot
  granularity.  ``serve/batcher.py`` drives this as a continuous-batching
  scheduler.

The spill half of the slot API moves one request's slot state (KV ring,
recurrent states, ``pos``/``slot_pos``) between the card and host memory, the backing
tier of the oversubscribed batcher: ``offload_slot`` hands back a host
copy, ``refill_slot`` copies one back into a slot, ``slot_state_bytes``
is what either moves; ``load_request_cache`` restores a prefix snapshot
(``serve/prefix.py``) into a fresh request cache.

There is no ``mesh`` argument (one GPU).  The reference donates the cache
to each compiled step; here every step **updates the cache in place**, so
a decode step allocates no cache memory.  Everything runs under
``torch.inference_mode()``; greedy tokens are ``torch.argmax``, which
returns the first maximal index as the reference's ``jnp.argmax`` does.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

from repro_torch.models import transformer as tfm
from repro_torch.models.config import ModelConfig
from repro_torch.models.frontends import frontend_embeddings
from repro_torch.serve import stream


@dataclasses.dataclass
class ServeConfig:
    """Same fields as the reference's ``ServeConfig``.  Read here:
    ``batch``, ``cache_capacity``, ``mode``, ``prefetch_depth``,
    ``kv_dtype``, ``max_slots``, and by the batcher ``prefill_chunk``,
    ``oversub``, ``slot_spill_s`` and ``prefix_cache_bytes``."""
    batch: int
    cache_capacity: int
    mode: str = "gspmd"               # gspmd (= resident) | elk_stream
    prefetch_depth: int = 2           # ELK preload number (elk_stream)
    kv_dtype: str = "bfloat16"        # bfloat16 | float32 | int8
    max_slots: int = 0
    prefill_chunk: int = 32
    steady_interval_s: float = 0.0
    oversub: float = 1.0
    slot_spill_s: float = 0.0
    prefix_cache_bytes: int = 0

    @property
    def slots(self) -> int:
        return self.max_slots or self.batch

    @property
    def virtual_slots(self) -> int:
        return max(self.slots, int(round(self.slots * self.oversub)))


def _itemsize(dtype: str) -> int:
    """Bytes of one element of the named torch type (``"bfloat16"``, ...)."""
    return torch.empty((), dtype=getattr(torch, dtype)).element_size()


def tier_kv_capacity(cfg: ModelConfig, chip, *, batch: int,
                     kv_dtype: str = "bfloat16") -> int:
    """Per-request KV-cache tokens resident in ``chip``'s off-core memory
    tiers after weight placement, or 0 when unbounded (the reference's
    ``tier_kv_capacity``): 0 for any chip with an unbounded backing tier,
    else ``(tier_bytes - weight_spill) // (batch * per_token)`` with
    ``per_token = num_layers * 2 * num_kv_heads * head_dim *
    itemsize(kv_dtype)``."""
    if chip is None:
        return 0
    tiers = chip.mem_tiers[1:]
    if not tiers or any(t.unbounded for t in tiers):
        return 0
    left = _tier_bytes_left(cfg, chip)
    hd = cfg.resolved_head_dim
    per_token = (cfg.num_layers * 2 * cfg.num_kv_heads * hd
                 * _itemsize(kv_dtype))
    return int(left // max(batch * per_token, 1))


def _tier_bytes_left(cfg: ModelConfig, chip) -> int:
    """Off-core tier bytes left after weight placement: the summed tier
    capacity minus the weights that spill out of SRAM (placement-invariant
    in aggregate)."""
    budget = sum(t.capacity for t in chip.mem_tiers[1:])
    weight_bytes = cfg.param_count() * _itemsize(cfg.param_dtype)
    spill = max(0, weight_bytes - chip.total_sram)
    return budget - min(spill, budget)


def kv_ring_bytes(cfg: ModelConfig, capacity: int,
                  kv_dtype: str = "bfloat16") -> int:
    """Bytes one request's spillable slot state occupies: the leaves of the
    reference's batch-1 per-slot cache (``pos``, the K/V ring, int8 scales,
    ``slot_pos``, recurrent states), counted from their shapes."""
    hd, nkv, L = cfg.resolved_head_dim, cfg.num_kv_heads, cfg.num_layers
    kv = capacity * L * 2 * nkv * hd * _itemsize(kv_dtype)
    if cfg.encoder_layers:      # no per-slot serving; K/V formula only
        return kv
    total = 4                                    # pos (1,) int32
    if not cfg.rwkv:
        total += kv + 4 * capacity               # k, v; slot_pos (1, C)
        if kv_dtype == "int8":                   # k_scale, v_scale bf16
            total += 2 * L * nkv * capacity * 2
    else:
        h = cfg.num_heads
        total += L * h * (cfg.d_model // h) ** 2 * 4
    if cfg.hybrid_parallel_ssm:
        total += L * cfg.d_model * cfg.ssm_state * 4
    return total


_OVERSUB_MAX = 8.0   # spill-pool backstop: at most 8 virtual slots/physical


def tier_kv_oversub(cfg: ModelConfig, chip, *, slots: int,
                    cache_capacity: int,
                    kv_dtype: str = "bfloat16") -> float:
    """Admission multiplier K for the oversubscribed batcher: full KV rings
    the tier bytes left after weight placement can hold, per physical slot;
    1.0 when any backing tier is unbounded."""
    if chip is None:
        return 1.0
    tiers = chip.mem_tiers[1:]
    if not tiers or any(t.unbounded for t in tiers):
        return 1.0
    ring = kv_ring_bytes(cfg, cache_capacity, kv_dtype)
    rings = _tier_bytes_left(cfg, chip) // max(ring, 1)
    return float(max(1.0, min(rings / max(slots, 1), _OVERSUB_MAX)))


PREFILL_SAT = 128   # prompt tokens one weight pass saturates: the chunk
#                     size past which prefill stops being amortized


def elk_serve_config(cfg: ModelConfig, *, batch: int, cache_capacity: int,
                     kv_dtype: str = "bfloat16", num_chips: int = 256,
                     design: str = "ELK-Full", pipeline: bool = False,
                     pod=None, role: str = "mixed") -> ServeConfig:
    """ServeConfig with the serving knobs chosen by the ELK scheduler, the
    reference's ``elk_serve_config`` line for line: ``prefetch_depth`` is
    the plan's preload number p in layers, ``prefill_chunk`` the admission
    budget ``clamp(16 p)`` (or, with ``pipeline``, from the steady
    interval), both clamped to the cache; ``role`` specialises the chunk
    for a disaggregated pod.  ``pod=None`` plans on the reference's default
    pod, as the reference does; the port's launcher passes
    ``chip.h100.h100_host()``.  Repeat calls hit the process-level plan
    cache."""
    from repro_torch.core.integration import pod_plan

    cap = tier_kv_capacity(cfg, pod, batch=batch, kv_dtype=kv_dtype)
    if cap > 0:
        cache_capacity = min(cache_capacity, cap)

    oversub = tier_kv_oversub(cfg, pod, slots=batch,
                              cache_capacity=cache_capacity,
                              kv_dtype=kv_dtype)
    slot_spill_s = 0.0
    prefix_bytes = 0
    if oversub > 1.0:
        from repro_torch.core.cost_model import AnalyticCostModel

        ring = kv_ring_bytes(cfg, cache_capacity, kv_dtype)
        slot_spill_s = AnalyticCostModel(pod).spill_time(
            ring, 0, pod.backing_tier)
        used = int(round(batch * oversub)) * ring
        prefix_bytes = int(max(0, _tier_bytes_left(cfg, pod) - used))

    if role not in ("mixed", "prefill", "decode"):
        raise ValueError(f"unknown pod role {role!r}; "
                         "known: mixed, prefill, decode")
    knobs = pod_plan(cfg, batch=batch, seq=cache_capacity, phase="decode",
                     num_chips=num_chips, design=design,
                     mode="hybrid" if pipeline else "flat", chip=pod)
    depth = max(knobs.prefetch_depth, 1)
    if pipeline and knobs.microbatch > 0:
        per_interval = max(knobs.microbatch * max(knobs.microbatches, 1), 16)
        chunk = min(per_interval, PREFILL_SAT, cache_capacity)
    else:
        chunk = min(max(16, min(16 * depth, PREFILL_SAT)), cache_capacity)
    if role == "prefill":
        chunk = min(PREFILL_SAT, cache_capacity)
    elif role == "decode":
        chunk = min(16, cache_capacity)
    return ServeConfig(batch=batch, cache_capacity=cache_capacity,
                       mode="elk_stream", prefetch_depth=depth,
                       kv_dtype=kv_dtype, prefill_chunk=chunk,
                       steady_interval_s=knobs.interval_s,
                       oversub=oversub, slot_spill_s=slot_spill_s,
                       prefix_cache_bytes=prefix_bytes)


def largest_pass_experts(cfg: ModelConfig, scfg: ServeConfig) -> int:
    """Experts the largest pass of an engine can touch in one MoE layer,
    ``min(E, rows k)`` as ``core/graph.py`` counts them, where the largest
    pass is a prefill of prompts that fill the ring on every row (a chunk
    and a slot step have fewer rows); 0 for a dense config."""
    rows = max(scfg.batch, scfg.slots) * scfg.cache_capacity
    return min(cfg.moe_experts, rows * cfg.moe_top_k)


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params: dict, scfg: ServeConfig,
                 device="cuda"):
        """``params`` may lie anywhere; under ``elk_stream`` the layers are
        copied into pinned host memory (``stream.LayerStream``: dense and
        MoE layers each in its own layout, an MoE layer's experts in a bank
        of their own, fetched after its router) and the caller's own
        tensors are not kept, so a caller that drops them frees their
        device memory.  ``params["layers"]`` may also be a ``LayerStream``
        already: one that ``stream.init_streamed_params`` drew without ever
        holding the decoder on the device, or another engine's, and both
        then stream from one host copy (through at most that stream's
        ``depth`` buffers).  The engine sizes the stream's expert buffer for
        its largest pass (``largest_pass_experts``).  An enc-dec config
        under ``elk_stream`` keeps its weights resident (``streamed`` is
        False), as the reference's does, and prints that it does."""
        if scfg.mode not in ("gspmd", "resident", "elk_stream"):
            raise ValueError(f"unknown serve mode {scfg.mode!r}")
        self.cfg = cfg
        self.scfg = scfg
        self.device = tfm.resolve_device(device)
        self.streamed = stream.streams(cfg, scfg.mode)
        if scfg.mode == "elk_stream" and not self.streamed:
            if isinstance(params["layers"], stream.LayerStream):
                raise ValueError(f"{cfg.name} is an encoder-decoder model, "
                                 "which is not streamed: pass its layers "
                                 "as tensors")
            print(f"elk_stream: {cfg.name} is an encoder-decoder model; its "
                  "weights stay resident (nothing worth streaming, as in "
                  "the reference)")
        if self.streamed:
            self.params = {k: _to_device(v, self.device)
                           for k, v in params.items() if k != "layers"}
            layers = params["layers"]
            if not isinstance(layers, stream.LayerStream):
                layers = stream.LayerStream(layers, self.device,
                                            depth=scfg.prefetch_depth)
            layers.reserve_experts(largest_pass_experts(cfg, scfg))
            self.params["layers"] = layers
        else:
            self.params = _to_device(params, self.device)
        self._spec = tfm.CacheSpec(
            capacity=scfg.cache_capacity, batch=scfg.batch,
            kv_dtype=getattr(torch, scfg.kv_dtype))
        self.slot_cache: Optional[dict] = None

    def _pass(self, fn, tokens, cache):
        """One model pass ``fn``: on resident weights, or under
        ``elk_stream`` with its layers streamed through a window of the
        current ``prefetch_depth``."""
        decoder = None
        if self.streamed:
            decoder = functools.partial(stream.streaming_decoder,
                                        prefetch=self.scfg.prefetch_depth)
        return fn(self.params, self.cfg, tokens, cache, decoder=decoder)

    # -- public API --------------------------------------------------------
    @torch.inference_mode()
    def prefill(self, tokens: torch.Tensor, cache: Optional[dict] = None,
                **frontends) -> tuple[torch.Tensor, dict]:
        """Prefill the prompt (B, S).  With ``cache=None`` a fresh cache
        is made; a cache passed in is written in place (its recurrent
        states, where it has them, are where the prompt starts from, as in
        the reference).  ``frontends``: a VLM's ``embeds`` (B, P, d), an
        enc-dec model's ``enc_embeds`` (B, E, d)."""
        if cache is None:
            cache = tfm.init_cache(self.cfg, self._spec, self.device)
        fe = {k: v.to(self.device) for k, v in frontends.items()
              if v is not None}
        return self._pass(functools.partial(tfm.prefill, **fe),
                          tokens.to(self.device), cache)

    @torch.inference_mode()
    def decode(self, token: torch.Tensor, cache: dict
               ) -> tuple[torch.Tensor, dict]:
        """One lock-step decode step; ``cache`` advances in place."""
        return self._pass(tfm.decode_step, token.to(self.device), cache)

    @torch.inference_mode()
    def generate(self, prompts: torch.Tensor, steps: int) -> torch.Tensor:
        """prompts: (B, S0) -> (B, S0 + steps) greedy continuation.
        ``torch.argmax`` returns the first maximal index, the tie-break of
        the reference's ``jnp.argmax``.  A frontend's stub embeddings come
        from ``frontends.frontend_embeddings`` (seed 0), as the
        reference's ``generate`` draws them."""
        if steps <= 0:
            return prompts
        prompts = prompts.to(self.device)
        fe = frontend_embeddings(self.cfg, prompts.shape[0],
                                 device=self.device)
        logits, cache = self.prefill(prompts, **fe)
        tok = torch.argmax(logits[:, -1, :], dim=-1)
        out = [prompts, tok[:, None].to(prompts.dtype)]
        for _ in range(steps - 1):
            logits, cache = self.decode(tok, cache)
            tok = torch.argmax(logits[:, -1, :], dim=-1)
            out.append(tok[:, None].to(prompts.dtype))
        return torch.cat(out, dim=1)

    # -- slot-batched serving (continuous batching) ------------------------
    def _ensure_slots(self) -> None:
        if self.slot_cache is not None:
            return
        self._slot_spec = dataclasses.replace(
            self._spec, batch=self.scfg.slots, per_slot=True)
        self._req_spec = dataclasses.replace(
            self._spec, batch=1, per_slot=True)
        with torch.inference_mode():
            self.slot_cache = tfm.init_cache(self.cfg, self._slot_spec,
                                             self.device)

    @torch.inference_mode()
    def new_request_cache(self) -> dict:
        """Fresh single-request per-slot cache for chunked prefill."""
        self._ensure_slots()
        return tfm.init_cache(self.cfg, self._req_spec, self.device)

    @torch.inference_mode()
    def prefill_chunk(self, req_cache: dict, tokens: torch.Tensor
                      ) -> tuple[torch.Tensor, dict]:
        """Advance one request's prefill by a chunk of (1, T) tokens, in
        place.  Returns (greedy next token (1,), the same cache)."""
        self._ensure_slots()
        logits, req_cache = self._pass(
            tfm.chunk_prefill, tokens.to(self.device), req_cache)
        return torch.argmax(logits[:, -1, :], dim=-1), req_cache

    @torch.inference_mode()
    def insert_slot(self, slot: int, req_cache: dict) -> None:
        """Splice a prefilled request into ``slot`` of the running batch
        (in place)."""
        self._ensure_slots()
        tfm.cache_insert_slot(self.slot_cache, slot, req_cache)

    @torch.inference_mode()
    def evict_slot(self, slot: int, *, keep: bool = True) -> Optional[dict]:
        """Remove a finished (or preempted) request: reset the slot's
        position and mask its ring tags so the stale K/V is unreachable.
        Returns a copy of the evicted per-request state (KV ring +
        ``pos``/``slot_pos``), which ``insert_slot`` takes back
        bit-identically; with ``keep=False`` (a finished request) it copies
        nothing and returns None."""
        self._ensure_slots()
        state = tfm.cache_extract_slot(self.slot_cache, slot) if keep else None
        tfm.cache_evict_slot(self.slot_cache, slot)
        return state

    @torch.inference_mode()
    def offload_slot(self, slot: int) -> dict:
        """Spill ``slot`` to the backing tier: a **host copy** of its state
        (never a view: the slot cache is updated in place afterwards), then
        the slot is evicted.  The planned cost of this move is
        ``ServeConfig.slot_spill_s``."""
        self._ensure_slots()
        state = {key: buf.narrow(tfm._slot_batch_axis(key), slot, 1)
                 .to("cpu", copy=True)
                 for key, buf in self.slot_cache.items()}
        tfm.cache_evict_slot(self.slot_cache, slot)
        return state

    @torch.inference_mode()
    def refill_slot(self, slot: int, state: dict) -> None:
        """Refill ``slot`` from an offloaded state (host or device): its
        tensors are copied into the slot cache, so a stored state (a prefix
        snapshot, a parked request) is never aliased into it."""
        self.insert_slot(slot, state)

    def slot_state_bytes(self) -> int:
        """Bytes one ``offload_slot``/``refill_slot`` moves across the tier
        boundary: one slot's share of every tensor of the slot cache (KV
        ring and metadata)."""
        self._ensure_slots()
        return int(sum(buf.narrow(tfm._slot_batch_axis(key), 0, 1).numel()
                       * buf.element_size()
                       for key, buf in self.slot_cache.items()))

    @torch.inference_mode()
    def load_request_cache(self, state: dict) -> dict:
        """A fresh single-request cache on the device holding a copy of
        ``state`` (a prefix snapshot): chunked prefill then goes on from
        ``state["pos"]`` without touching the stored tensors."""
        cache = self.new_request_cache()
        for key, buf in cache.items():
            buf.copy_(state[key])
        return cache

    @torch.inference_mode()
    def step(self, tokens: torch.Tensor) -> torch.Tensor:
        """One continuous-batching decode step over the slot batch: tokens
        (slots,) -> greedy next token per slot (slots,).  The slot cache
        advances in place."""
        self._ensure_slots()
        logits, _ = self._pass(tfm.decode_slots, tokens.to(self.device),
                               self.slot_cache)
        return torch.argmax(logits[:, -1, :], dim=-1)


def _to_device(tree, device: torch.device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, device) for v in tree]
    return tree.to(device)
