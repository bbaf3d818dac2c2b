"""Content-hash prefix KV store.

Counterpart of ``src/repro/serve/prefix.py``.  A server of chat traffic
re-prefills the same system prompt again and again.  The batcher snapshots
a request's per-slot cache at chunk boundaries during prefill (a *strict*
prefix of the prompt, within ring capacity so nothing has wrapped) and
keys it by the token content.  A later request whose prompt starts with
the same tokens skips that prefix: admission becomes a refill-priced
restore of the snapshot plus a chunked prefill of the tail; since any
chunking of an in-capacity prompt gives the same result as a single pass,
the cached-prefix greedy continuation equals the cold path.

Snapshots are **host copies** of torch tensors (``.to("cpu", copy=True)``):
the slot and request caches are updated in place, so a view would change
under the store.  Restores copy back into fresh device buffers
(``ServeEngine.load_request_cache``), so a stored state is never aliased
into a cache that the model writes.  One store serves one (model, cache
capacity, kv dtype) family: tensor shapes must match the engine's
per-request cache.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch


def prefix_key(tokens) -> bytes:
    """Content hash of a token prefix.  int32-widened bytes make the key
    unambiguous in both values and length."""
    a = np.ascontiguousarray(np.asarray(tokens, np.int32))
    return hashlib.sha1(a.tobytes()).digest()


def state_bytes(state: dict) -> int:
    """Bytes of a slot state's tensors."""
    return int(sum(t.numel() * t.element_size() for t in state.values()))


def host_copy(state: dict) -> dict:
    """A copy of every tensor of ``state`` in host memory, never a view
    (``to`` with ``copy=True`` copies a CPU tensor too)."""
    return {key: t.to("cpu", copy=True) for key, t in state.items()}


class PrefixStore:
    """LRU byte-budgeted map: token-prefix hash -> host KV snapshot.

    ``put`` stores a snapshot taken at prefix length k (``state["pos"]``
    must equal k); ``lookup`` returns the longest stored prefix of a
    prompt.  Both run over the set of *distinct stored lengths*, so lookup
    hashes O(#lengths) prefixes, not O(prompt)."""

    def __init__(self, capacity_bytes: int = 64 << 20):
        self.capacity_bytes = int(capacity_bytes)
        self._entries: OrderedDict[bytes, tuple[int, int, dict]] = \
            OrderedDict()          # key -> (prefix_len, nbytes, state)
        self.bytes = 0
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._entries)

    def put(self, tokens, state: dict) -> bool:
        """Store a snapshot of ``tokens`` (the prefix itself, not the full
        prompt).  Returns False when it was already stored or cannot fit."""
        nbytes = state_bytes(state)
        if nbytes > self.capacity_bytes:
            return False
        key = prefix_key(tokens)
        if key in self._entries:
            self._entries.move_to_end(key)
            return False
        while self._entries and self.bytes + nbytes > self.capacity_bytes:
            _, (_, old_nb, _) = self._entries.popitem(last=False)
            self.bytes -= old_nb
        self._entries[key] = (len(np.asarray(tokens)), nbytes, state)
        self.bytes += nbytes
        return True

    def lookup(self, prompt, max_len: int
               ) -> Optional[tuple[int, dict[str, torch.Tensor]]]:
        """Longest stored strict prefix of ``prompt`` with length <=
        ``max_len`` (callers pass ``min(len(prompt) - 1, capacity)`` so the
        tail chunk still produces last-token logits and the snapshot never
        saw a wrapped ring).  Returns (prefix_len, host_state) or None."""
        prompt = np.asarray(prompt, np.int32)
        lens = sorted({ln for ln, _, _ in self._entries.values()},
                      reverse=True)
        for k in lens:
            if k > max_len or k > len(prompt):
                continue
            entry = self._entries.get(prefix_key(prompt[:k]))
            if entry is not None:
                self._entries.move_to_end(prefix_key(prompt[:k]))
                self.hits += 1
                return k, entry[2]
        self.misses += 1
        return None
