"""Serving engine of the port: prefill + greedy decode, lock-step and
slot-batched.

Counterpart of ``src/repro/serve/engine.py``, cut to its two batching
disciplines over resident weights:

* lock-step   -- ``generate``: one static batch, every request advances
  together.
* slot-batched -- ``step`` / ``prefill_chunk`` / ``insert_slot`` /
  ``evict_slot``: a per-slot cache where every row sits at its own
  position; requests join and leave the running batch at slot
  granularity.  ``serve/batcher.py`` drives this as a continuous-batching
  scheduler.

Weights are resident on the one GPU; the reference's mode ``"gspmd"`` is
accepted under that name and means just that.  The weight-streaming mode
``"elk_stream"``, the planner-derived ``elk_serve_config``, and the spill
half of the slot API (``offload_slot`` / ``refill_slot`` /
``slot_state_bytes``) are still to be ported (ROADMAP.md, Queue 1).

There is no ``mesh`` argument (one GPU).  The reference donates the cache
to each compiled step; here every step **updates the cache in place**, so
a decode step allocates no cache memory.  Everything runs under
``torch.inference_mode()``; greedy tokens are ``torch.argmax``, which
returns the first maximal index as the reference's ``jnp.argmax`` does.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.models import transformer as tfm
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass
class ServeConfig:
    """Same fields as the reference's ``ServeConfig``.  Read here:
    ``batch``, ``cache_capacity``, ``mode``, ``kv_dtype``, ``max_slots``
    and (by the batcher) ``prefill_chunk``; ``oversub`` must stay 1."""
    batch: int
    cache_capacity: int
    mode: str = "gspmd"               # gspmd (= resident) | elk_stream
    prefetch_depth: int = 2
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


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params: dict, scfg: ServeConfig,
                 device="cuda"):
        if scfg.mode == "elk_stream":
            raise NotImplementedError(
                "mode 'elk_stream' (weight streaming) not ported yet "
                "(ROADMAP.md, Queue 1, 'serve/stream.py')")
        if scfg.mode not in ("gspmd", "resident"):
            raise ValueError(f"unknown serve mode {scfg.mode!r}")
        self.cfg = cfg
        self.scfg = scfg
        self.device = tfm.resolve_device(device)
        self.params = _to_device(params, self.device)
        self._spec = tfm.CacheSpec(
            capacity=scfg.cache_capacity, batch=scfg.batch,
            kv_dtype=getattr(torch, scfg.kv_dtype))
        self.slot_cache: Optional[dict] = None

    # -- public API --------------------------------------------------------
    @torch.inference_mode()
    def prefill(self, tokens: torch.Tensor, cache: Optional[dict] = None
                ) -> tuple[torch.Tensor, dict]:
        """Prefill the prompt (B, S).  With ``cache=None`` a fresh cache
        is made; a cache passed in is overwritten in place."""
        if cache is None:
            cache = tfm.init_cache(self.cfg, self._spec, self.device)
        return tfm.prefill(self.params, self.cfg, tokens.to(self.device),
                           cache)

    @torch.inference_mode()
    def decode(self, token: torch.Tensor, cache: dict
               ) -> tuple[torch.Tensor, dict]:
        """One lock-step decode step; ``cache`` advances in place."""
        return tfm.decode_step(self.params, self.cfg, token.to(self.device),
                               cache)

    @torch.inference_mode()
    def generate(self, prompts: torch.Tensor, steps: int) -> torch.Tensor:
        """prompts: (B, S0) -> (B, S0 + steps) greedy continuation.
        ``torch.argmax`` returns the first maximal index, the tie-break of
        the reference's ``jnp.argmax``."""
        if steps <= 0:
            return prompts
        prompts = prompts.to(self.device)
        logits, cache = self.prefill(prompts)
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
        logits, req_cache = tfm.chunk_prefill(
            self.params, self.cfg, tokens.to(self.device), req_cache)
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

    def offload_slot(self, slot: int) -> dict:
        raise NotImplementedError(
            "offload_slot (KV offload to the host) not ported yet "
            "(ROADMAP.md, Queue 1, item 10)")

    def refill_slot(self, slot: int, state: dict) -> None:
        raise NotImplementedError(
            "refill_slot (KV refill from the host) not ported yet "
            "(ROADMAP.md, Queue 1, item 10)")

    def slot_state_bytes(self) -> int:
        raise NotImplementedError(
            "slot_state_bytes (spill accounting) not ported yet "
            "(ROADMAP.md, Queue 1, item 10)")

    @torch.inference_mode()
    def step(self, tokens: torch.Tensor) -> torch.Tensor:
        """One continuous-batching decode step over the slot batch: tokens
        (slots,) -> greedy next token per slot (slots,).  The slot cache
        advances in place."""
        self._ensure_slots()
        logits, _ = tfm.decode_slots(self.params, self.cfg,
                                     tokens.to(self.device), self.slot_cache)
        return torch.argmax(logits[:, -1, :], dim=-1)


def _to_device(tree, device: torch.device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, device) for v in tree]
    return tree.to(device)
