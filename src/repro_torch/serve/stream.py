"""ELK weight streaming on one GPU: the paper's technique at runtime.

Counterpart of ``src/repro/serve/stream.py``.  There the layer weights live
sharded over the pod's data axis (preload state) and each block is
all-gathered (execute state) ``p`` blocks ahead of the block that computes;
``p`` is the paper's preload number, chosen by the ELK scheduler.  On one
H100 "sharded over the data axis" has no meaning, and the split maps onto
the card so:

* **preload state** -- each layer's weights live in pinned host memory, one
  buffer a layer (slices of one pinned allocation), laid out as one block of
  bytes; ``init_streamed_params`` draws them there one layer at a time;
* **execute state** -- a window of ``p`` layer buffers on the card.  The copy
  of layer ``i + p`` is issued on a side CUDA stream as soon as layer ``i``
  (whose buffer it reuses) has been enqueued; an event orders each layer's
  compute after its copy, and each buffer's next copy after the compute that
  read it.  So while layer ``i`` computes, the copies of layers ``i + 1 ..
  i + p - 1`` are in flight or done, and the copy engine never waits on
  compute unless the window is full.
* the embedding, the final norm and the LM head stay resident, as they are
  outside the reference's scanned blocks.

Every pass streams: prefill, decode, prefill chunks and slot steps go through
the same window (the reference runs prefill and chunks on FSDP-sharded
weights that XLA gathers; here the weights' home is host memory).
``streaming_decoder`` is a drop-in for ``transformer._run_decoder``, as the
reference's docstring says.  On the CPU the same window logic runs with plain
tensors and no streams.

Every layer of a ``LayerStream`` has one byte layout and is copied whole,
so an MoE config is not streamed yet: its dense and MoE layers differ in
layout, and its expert weights are to be streamed as late-bound preloads
on the router's choice; ``check_streamable`` raises for it, also where
every layer is MoE (ROADMAP.md, Queue 1, item 17).
"""

from __future__ import annotations

import functools
import weakref
from typing import Optional

import torch

from repro_torch.models import transformer as tfm
from repro_torch.models.config import ModelConfig

_ALIGN = 256   # bytes: every weight starts at a multiple (kernels need 16)


def check_streamable(cfg: ModelConfig, hint: str = "") -> None:
    """Raise ``NotImplementedError`` for a config with an MoE layer: one
    pinned layout holds every layer, padding the dense layers to an MoE
    layer's size would stream bytes no layer reads, and a whole MoE layer
    copied every pass would stream the experts the router did not choose.
    ``hint`` ends the message."""
    if "moe" in tfm.layer_kinds(cfg):
        raise NotImplementedError(
            f"{cfg.name}: elk_stream of a model with MoE layers is not "
            "ported yet (ROADMAP.md, Queue 1, item 17, 'streamed "
            f"MoE'){hint}")


def _leaves(tree: dict, prefix: tuple = ()):
    for key in sorted(tree):
        val = tree[key]
        if isinstance(val, dict):
            yield from _leaves(val, prefix + (key,))
        else:
            yield prefix + (key,), val


def _view(buf: torch.Tensor, offset: int, shape: tuple,
          dtype: torch.dtype) -> torch.Tensor:
    n = torch.empty((), dtype=dtype).element_size()
    for s in shape:
        n *= s
    return buf[offset:offset + n].view(dtype).view(shape)


def _pinned(nbytes: int) -> torch.Tensor:
    """``nbytes`` of page-locked host memory, exactly: a plain host tensor
    registered with ``cudaHostRegister`` (PyTorch's pinned allocator rounds
    a request up to a power of two: 26.4 GB would take 34.4 GB).  Raises
    if the registration fails; ``_unpin`` undoes it."""
    host = torch.empty(nbytes, dtype=torch.uint8)
    err = torch.cuda.cudart().cudaHostRegister(host.data_ptr(), nbytes, 0)
    if int(err) != 0 or not host.is_pinned():
        raise RuntimeError(f"pinning {nbytes} bytes of host memory for the "
                           f"layer weights failed (cudaHostRegister: {err})")
    return host


def _unpin(host: torch.Tensor) -> None:
    torch.cuda.cudart().cudaHostUnregister(host.data_ptr())


class LayerStream:
    """The decoder's layer weights in preload state (host) and the window
    of ``depth`` layer buffers in execute state (``device``).

    ``layers`` is the per-layer parameter list of ``transformer``, or any
    iterable of ``n`` such layers: each is copied to the host as it comes
    and not kept, so an iterator that draws the layers on the card one at
    a time (``init_streamed_params``) never has the decoder there.  Every
    layer must have the same structure, shapes and types.  On a CUDA
    device the host copy is pinned, and a failed pinning raises: nothing
    falls back to resident weights.  ``copies`` counts the layer copies
    issued; ``log`` holds the last pass's ``("copy" | "compute", layer,
    buffer)`` events in the order they were issued."""

    def __init__(self, layers, device, depth: int, n: Optional[int] = None):
        self.device = torch.device(device)
        self.n = len(layers) if n is None else n
        if self.n == 0:
            raise ValueError("no layers to stream")
        got = 0                     # (enumerate would hold the last layer)
        for layer in layers:
            if got == 0:
                self._alloc_host(layer)
            elif got >= self.n:
                raise ValueError(f"more than {self.n} layers")
            self._store(got, layer)
            got += 1
            del layer               # the next layer is drawn without it
        if got != self.n:
            raise ValueError(f"{got} layers, expected {self.n}")
        off = self.layer_bytes
        cuda = self.device.type == "cuda"
        self.depth = max(1, min(depth, self.n))
        window = torch.empty(self.depth * off, dtype=torch.uint8,
                             device=self.device)
        self.buffers = [window[i * off:(i + 1) * off]
                        for i in range(self.depth)]
        self.views = [self._unflatten(buf) for buf in self.buffers]
        self.copy_stream = torch.cuda.Stream(self.device) if cuda else None
        self.copied = [torch.cuda.Event() for _ in self.buffers] if cuda else None
        self.freed = [torch.cuda.Event() for _ in self.buffers] if cuda else None
        self.copies = 0
        self.log: list[tuple[str, int, int]] = []

    def _alloc_host(self, layer: dict) -> None:
        """The byte layout of a layer (from layer 0) and the host copy of
        all ``n`` layers."""
        self.layout = []               # (path, byte offset, shape, dtype)
        off = 0
        for path, t in _leaves(layer):
            self.layout.append((path, off, tuple(t.shape), t.dtype))
            off += -(-t.numel() * t.element_size() // _ALIGN) * _ALIGN
        self.layer_bytes = off
        if self.device.type == "cuda":
            host = _pinned(self.n * off)
            weakref.finalize(self, _unpin, host).atexit = False
        else:
            host = torch.empty(self.n * off, dtype=torch.uint8)
        self.host = [host[i * off:(i + 1) * off] for i in range(self.n)]

    def _store(self, li: int, layer: dict) -> None:
        got = list(_leaves(layer))
        if [p for p, _ in got] != [p for p, *_ in self.layout]:
            raise ValueError(f"layer {li} differs in structure from layer 0")
        for (path, o, shape, dtype), (_, t) in zip(self.layout, got):
            if tuple(t.shape) != shape or t.dtype != dtype:
                raise ValueError(f"layer {li} {'/'.join(path)} is "
                                 f"{tuple(t.shape)} {t.dtype}, layer 0 "
                                 f"{shape} {dtype}")
            _view(self.host[li], o, shape, dtype).copy_(t)

    def _unflatten(self, buf: torch.Tensor) -> dict:
        out: dict = {}
        for path, o, shape, dtype in self.layout:
            node = out
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = _view(buf, o, shape, dtype)
        return out

    def issue(self, layer: int, slot: int) -> None:
        """Start the copy of ``layer`` into buffer ``slot``, after the last
        compute that read that buffer."""
        self.copies += 1
        self.log.append(("copy", layer, slot))
        if self.copy_stream is None:
            self.buffers[slot].copy_(self.host[layer])
            return
        with torch.cuda.stream(self.copy_stream):
            self.copy_stream.wait_event(self.freed[slot])
            self.buffers[slot].copy_(self.host[layer], non_blocking=True)
            self.copied[slot].record(self.copy_stream)

    def acquire(self, layer: int, slot: int) -> dict:
        """The weights of ``layer`` in buffer ``slot``, for work enqueued on
        the current stream after this call."""
        self.log.append(("compute", layer, slot))
        if self.copy_stream is not None:
            torch.cuda.current_stream(self.device).wait_event(
                self.copied[slot])
        return self.views[slot]

    def release(self, slot: int) -> None:
        """The work enqueued so far is the last that reads buffer ``slot``."""
        if self.copy_stream is not None:
            self.freed[slot].record(torch.cuda.current_stream(self.device))


def streaming_decoder(params, cfg: ModelConfig, x, ctx, cache,
                      prefetch: int = 2):
    """Drop-in replacement for ``transformer._run_decoder`` that streams the
    layer weights (``params["layers"]``, a ``LayerStream``) through a
    window of ``prefetch`` buffers (at most the stream's ``depth``): layers
    0..p-1 are copied up front (the paper's initial pipeline fill), then
    the copy of layer ``i + p`` is issued into layer ``i``'s buffer right
    after layer ``i`` is enqueued.  Same contract as ``_run_decoder``."""
    ls: LayerStream = params["layers"]
    spec = tfm.attn_spec(cfg)
    p = max(1, min(prefetch, ls.depth))
    ls.log = []
    for li in range(p):
        ls.issue(li, li)
    for li in range(ls.n):
        slot = li % p
        w = ls.acquire(li, slot)
        lc = None if cache is None else {"k": cache["k"][li],
                                         "v": cache["v"][li]}
        x = tfm._decoder_layer(x, w, cfg, spec, ctx, lc)
        ls.release(slot)
        if li + p < ls.n:
            ls.issue(li + p, slot)
    return x


def init_streamed_params(generator: torch.Generator, cfg: ModelConfig,
                         device, depth: int) -> dict:
    """``transformer.init_params`` with ``params["layers"]`` a
    ``LayerStream`` of window ``depth``: the same draws, so the same
    weights, but each layer goes to the host before the next is drawn, so
    the device never holds more of the decoder than a layer and the
    window.  The embedding, final norm and LM head stay on ``device``."""
    check_streamable(cfg)
    return tfm.init_params(generator, cfg, device, collect_layers=(
        functools.partial(LayerStream, device=device, depth=depth,
                          n=cfg.num_layers)))


def streaming_decode_step(params, cfg: ModelConfig, token, cache,
                          prefetch: int = 2):
    """``transformer.decode_step`` with its layers streamed (the
    reference's ``streaming_decode_step``)."""
    return tfm.decode_step(params, cfg, token, cache, decoder=(
        functools.partial(streaming_decoder, prefetch=prefetch)))


def streaming_decode_slots(params, cfg: ModelConfig, token, cache,
                           prefetch: int = 2):
    """``transformer.decode_slots`` with its layers streamed (the
    reference's ``streaming_decode_slots``)."""
    return tfm.decode_slots(params, cfg, token, cache, decoder=(
        functools.partial(streaming_decoder, prefetch=prefetch)))
