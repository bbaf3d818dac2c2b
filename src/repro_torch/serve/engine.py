"""Lock-step serving engine of the port: prefill + greedy decode.

Counterpart of ``src/repro/serve/engine.py``, cut to the lock-step half:
one static batch in which every request advances together
(``generate``).  Weights are resident on the one GPU; the reference's
mode ``"gspmd"`` is accepted under that name and means just that.  The
weight-streaming mode ``"elk_stream"``, the slot-batched discipline
(``step`` / ``prefill_chunk`` / ``insert_slot`` ...) and the planner-derived
``elk_serve_config`` are still to be ported (ROADMAP.md, Queue 1).

There is no ``mesh`` argument (one GPU).  The reference donates the cache
to each compiled step; here every step **updates the cache in place** and
returns the same dictionary, so a decode step allocates no cache memory.
Everything runs under ``torch.inference_mode()``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.models import transformer as tfm
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass
class ServeConfig:
    """Same fields as the reference's ``ServeConfig``; the lock-step path
    reads ``batch``, ``cache_capacity``, ``mode`` and ``kv_dtype``."""
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


def _to_device(tree, device: torch.device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, device) for v in tree]
    return tree.to(device)
