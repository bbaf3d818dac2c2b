"""ELK weight streaming on one GPU: the paper's technique at runtime.

Counterpart of ``src/repro/serve/stream.py``.  There the layer weights live
sharded over the pod's data axis (preload state) and each block is
all-gathered (execute state) ``p`` blocks ahead of the block that computes;
``p`` is the paper's preload number, chosen by the ELK scheduler.  On one
H100 "sharded over the data axis" has no meaning, and the split maps onto
the card so:

* **preload state** -- each layer's weights live in pinned host memory, one
  record a layer (slices of one pinned allocation), laid out as one block of
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
weights that XLA gathers; here the weights' home is host memory).  Every
layer kind streams: dense, MoE, RWKV (its record holds the time and channel
mix; its state stays in the cache) and the hybrid layer (its record holds
the ``ssm`` branch beside attention and MLP).  Encoder-decoder models are not
streamed, as in the reference (``ServeEngine`` keeps them resident).
``streaming_decoder`` is a drop-in for ``transformer._run_decoder``, as the
reference's docstring says.  On the CPU the same window logic runs with plain
tensors and no streams.

Layers of more than one layout (the reference's prefix layers and the slots
of its period, each streamed as a layout of its own) share the window: each
layer has its own record of (path, offset, shape, dtype) at its own offset
of the pinned allocation, the buffers are as large as the largest record, a
copy moves the layer's own bytes only, and the views of a buffer follow the
layer in it.  An MoE layer's experts (``w_gate``, ``w_up``, ``w_down``) are
not in its record.  They form the layer's expert bank on the host, each
expert's matrices contiguous, and are fetched late, after the layer's router,
as the paper's §7 preloads (``core/graph.py`` gives the expert fetch the
router as its ``preload_dep``): ``models/moe.moe_ffn`` reads the rows of
every expert back to the host, and exactly the experts with rows are copied,
on the copy stream, into one device expert buffer (``LayerExperts``).  A
pass that touches more experts than the buffer holds runs them in rounds.
"""

from __future__ import annotations

import functools
import weakref

import torch

from repro_torch.kernels.dispatch import count_host_copy
from repro_torch.models import transformer as tfm
from repro_torch.models.config import ModelConfig

_ALIGN = 256   # bytes: every weight starts at a multiple (kernels need 16)
_EXPERT_KEYS = ("w_gate", "w_up", "w_down")   # (E, ...) leaves of p["moe"]


def _leaves(tree: dict, prefix: tuple = ()):
    for key in sorted(tree):
        val = tree[key]
        if isinstance(val, dict):
            yield from _leaves(val, prefix + (key,))
        else:
            yield prefix + (key,), val


def _split(layer: dict) -> tuple[list, list]:
    """A layer's (path, tensor) leaves: those of its record, and its
    experts' (E, ...) ones (none for a dense layer)."""
    rest, experts = [], []
    for path, t in _leaves(layer):
        expert = path[:1] == ("moe",) and path[-1] in _EXPERT_KEYS
        (experts if expert else rest).append((path, t))
    return rest, experts


def _layout(leaves) -> tuple[list, int]:
    """(path, byte offset, shape, dtype) of each (path, tensor), every
    tensor starting on a multiple of ``_ALIGN`` bytes, and the bytes of the
    whole record."""
    out, off = [], 0
    for path, t in leaves:
        out.append((path, off, tuple(t.shape), t.dtype))
        off += -(-t.numel() * t.element_size() // _ALIGN) * _ALIGN
    return out, off


def _view(buf: torch.Tensor, offset: int, shape: tuple,
          dtype: torch.dtype) -> torch.Tensor:
    n = torch.empty((), dtype=dtype).element_size()
    for s in shape:
        n *= s
    return buf[offset:offset + n].view(dtype).view(shape)


def _unflatten(buf: torch.Tensor, layout: list) -> dict:
    out: dict = {}
    for path, o, shape, dtype in layout:
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = _view(buf, o, shape, dtype)
    return out


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


def _expert_cap(device: torch.device, expert_bytes: int) -> int:
    """Most experts the device buffer may take: half of the device memory
    free now (the caching allocator's idle blocks included), so that the
    passes keep the other half for the KV cache and their activations.
    Unbounded on the CPU."""
    if device.type != "cuda":
        return 1 << 62
    free = (torch.cuda.mem_get_info(device)[0]
            + torch.cuda.memory_reserved(device)
            - torch.cuda.memory_allocated(device))
    return max(1, free // 2 // expert_bytes)


class LayerStream:
    """The decoder's layer weights in preload state (host) and the window
    of ``depth`` layer buffers and the expert buffer in execute state
    (``device``).

    ``layers`` is the per-layer parameter list of ``transformer``, or any
    iterable of such layers: each is copied to the host as it comes and not
    kept, so an iterator that draws the layers on the card one at a time
    (``init_streamed_params``) never has the decoder there.  ``like`` gives
    each layer's structure, shapes and types before it comes (meta tensors
    do: ``transformer.layer_shapes``); it defaults to ``layers``, which must
    then be a sequence.  A layer that differs from its ``like`` raises.  On
    a CUDA device the host copy is pinned, and a failed pinning raises:
    nothing falls back to resident weights.

    ``copies`` counts the layer copies issued and ``expert_copies`` the
    expert copies; ``log`` holds the last pass's ``("copy" | "compute",
    layer, buffer)`` and ``("expert", layer, expert)`` events in the order
    they were issued, and ``bytes`` its bytes copied, ``"window"`` and
    ``"experts"`` apart.  The expert buffer holds no expert until
    ``reserve_experts`` sizes it (``ServeEngine`` does)."""

    def __init__(self, layers, device, depth: int, like=None):
        self.device = torch.device(device)
        like = layers if like is None else like
        self.n = len(like)
        if self.n == 0:
            raise ValueError("no layers to stream")
        self._alloc_host(like)
        got = 0                     # (enumerate would hold the last layer)
        for layer in layers:
            if got >= self.n:
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
        self._views: dict = {}      # (buffer, layout) -> views
        self.copy_stream = torch.cuda.Stream(self.device) if cuda else None
        self.copied = [torch.cuda.Event() for _ in self.buffers] if cuda else None
        self.freed = [torch.cuda.Event() for _ in self.buffers] if cuda else None
        self.expert_slots, self.expert_buffer, self._expert_views = 0, None, []
        self.experts_copied = torch.cuda.Event() if cuda else None
        self.experts_freed = torch.cuda.Event() if cuda else None
        self.copies = self.expert_copies = 0
        self.log: list[tuple[str, int, int]] = []
        self.bytes = {"window": 0, "experts": 0}

    def _alloc_host(self, like: list) -> None:
        """Each layer's record layout and expert bank, and the host copy of
        them all: layer after layer, each record followed by its bank."""
        self.layouts, spans, off = [], [], 0
        self.expert_layout, self.expert_bytes, self.num_experts = None, 0, 0
        for li, layer in enumerate(like):
            rest, experts = _split(layer)
            layout, size = _layout(rest)
            self.layouts.append(layout)
            bank = 0
            if experts:
                one, eb = _layout([(path[-1:], t[0]) for path, t in experts])
                if self.expert_layout is None:
                    self.expert_layout, self.expert_bytes = one, eb
                    self.num_experts = experts[0][1].shape[0]
                if one != self.expert_layout or any(
                        t.shape[0] != self.num_experts for _, t in experts):
                    raise ValueError(f"layer {li}'s experts differ from the "
                                     "first MoE layer's")
                bank = self.num_experts * eb
            spans.append((off, size, bank))
            off += size + bank
        self.host_bytes = off
        self.layer_bytes = max(size for _, size, _ in spans)
        if self.device.type == "cuda":
            host = _pinned(off)
            weakref.finalize(self, _unpin, host).atexit = False
        else:                  # the CPU, or the meta device's shapes
            host = torch.empty(off, dtype=torch.uint8, device=(
                self.device if self.device.type == "meta" else "cpu"))
        self.host = [host[o:o + size] for o, size, _ in spans]
        self.banks = [host[o + size:o + size + bank] if bank else None
                      for o, size, bank in spans]

    def _store(self, li: int, layer: dict) -> None:
        rest, experts = _split(layer)
        layout = self.layouts[li]
        names = [p[-1:] for p, _ in experts]
        if ([p for p, _ in rest] != [p for p, *_ in layout] or names != (
                [p for p, *_ in self.expert_layout]
                if self.banks[li] is not None else [])):
            raise ValueError(f"layer {li} differs in structure from its "
                             "layout")
        meta = self.device.type == "meta"     # shapes only: nothing to copy
        for (path, o, shape, dtype), (_, t) in zip(layout, rest):
            self._check(li, path, t, shape, dtype)
            if not meta:
                _view(self.host[li], o, shape, dtype).copy_(t)
        eb = self.expert_bytes
        for (name, o, shape, dtype), (path, t) in zip(self.expert_layout or (),
                                                      experts):
            self._check(li, path, t, (self.num_experts,) + shape, dtype)
            for e in range(0 if meta else self.num_experts):
                _view(self.banks[li][e * eb:(e + 1) * eb], o, shape,
                      dtype).copy_(t[e])

    @staticmethod
    def _check(li, path, t, shape, dtype) -> None:
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"layer {li} {'/'.join(path)} is "
                             f"{tuple(t.shape)} {t.dtype}, its layout "
                             f"{shape} {dtype}")

    @property
    def device_bytes(self) -> int:
        """Bytes the stream holds on its device: the window's buffers and
        the expert buffer."""
        return self.depth * self.layer_bytes + (
            self.expert_slots * self.expert_bytes)

    def issue(self, layer: int, slot: int) -> None:
        """Start the copy of ``layer``'s record into buffer ``slot``, after
        the last compute that read that buffer."""
        src = self.host[layer]
        dst = self.buffers[slot][:src.numel()]
        self.copies += 1
        self.bytes["window"] += src.numel()
        self.log.append(("copy", layer, slot))
        if self.device.type == "meta":
            count_host_copy(src.numel())
            return
        if self.copy_stream is None:
            dst.copy_(src)
            return
        with torch.cuda.stream(self.copy_stream):
            self.copy_stream.wait_event(self.freed[slot])
            dst.copy_(src, non_blocking=True)
            self.copied[slot].record(self.copy_stream)

    def acquire(self, layer: int, slot: int) -> dict:
        """The weights of ``layer`` in buffer ``slot``, for work enqueued on
        the current stream after this call; an MoE layer's ``moe`` holds
        its router and ``experts``, the ``LayerExperts`` that fetch its
        experts."""
        self.log.append(("compute", layer, slot))
        if self.copy_stream is not None:
            torch.cuda.current_stream(self.device).wait_event(
                self.copied[slot])
        layout = self.layouts[layer]
        key = (slot, tuple(layout))
        if key not in self._views:
            self._views[key] = _unflatten(self.buffers[slot], layout)
        views = self._views[key]
        if self.banks[layer] is None:
            return views
        return {**views, "moe": {**views["moe"],
                                 "experts": LayerExperts(self, layer)}}

    def release(self, slot: int) -> None:
        """The work enqueued so far is the last that reads buffer ``slot``."""
        if self.copy_stream is not None:
            self.freed[slot].record(torch.cuda.current_stream(self.device))

    def reserve_experts(self, experts: int) -> None:
        """Size the expert buffer for a pass that touches ``experts``
        experts: at most the bank's, at most what ``_expert_cap`` leaves on
        the device; a buffer never shrinks.  A pass that touches more runs
        them in rounds."""
        if not self.expert_bytes:
            return
        n = min(experts, self.num_experts,
                _expert_cap(self.device, self.expert_bytes))
        if n <= self.expert_slots:
            return
        if self.copy_stream is not None:
            torch.cuda.synchronize(self.device)    # the old buffer is idle
        self.expert_buffer = self._expert_views = None
        eb = self.expert_bytes
        self.expert_buffer = torch.empty(n * eb, dtype=torch.uint8,
                                         device=self.device)
        self._expert_views = [
            {path[-1]: _view(self.expert_buffer[s * eb:(s + 1) * eb], o,
                             shape, dtype)
             for path, o, shape, dtype in self.expert_layout}
            for s in range(n)]
        self.expert_slots = n

    def fetch_experts(self, layer: int, experts: list[int]) -> None:
        """Copy ``layer``'s ``experts`` into the first slots of the expert
        buffer, after the last compute that read it; work enqueued on the
        current stream after this call sees them."""
        if len(experts) > self.expert_slots:
            raise RuntimeError(f"{len(experts)} experts of layer {layer} "
                               f"fetched into a buffer of "
                               f"{self.expert_slots}")
        eb, bank = self.expert_bytes, self.banks[layer]
        self.expert_copies += len(experts)
        self.bytes["experts"] += len(experts) * eb
        self.log += [("expert", layer, e) for e in experts]
        if self.device.type == "meta":
            count_host_copy(len(experts) * eb)
            return
        pairs = [(self.expert_buffer[s * eb:(s + 1) * eb],
                  bank[e * eb:(e + 1) * eb]) for s, e in enumerate(experts)]
        if self.copy_stream is None:
            for dst, src in pairs:
                dst.copy_(src)
            return
        with torch.cuda.stream(self.copy_stream):
            self.copy_stream.wait_event(self.experts_freed)
            for dst, src in pairs:
                dst.copy_(src, non_blocking=True)
            self.experts_copied.record(self.copy_stream)
        torch.cuda.current_stream(self.device).wait_event(self.experts_copied)

    def release_experts(self) -> None:
        """The work enqueued so far is the last that reads the expert
        buffer."""
        if self.copy_stream is not None:
            self.experts_freed.record(torch.cuda.current_stream(self.device))


class LayerExperts:
    """The experts of MoE layer ``layer`` of a ``LayerStream``, fetched
    late: ``models/moe.moe_ffn``'s accessor.  ``rounds(experts)`` fetches
    the experts with rows, as many at a time as the expert buffer holds,
    and yields each group once its copy is ordered before the work that
    follows; ``weights(e)`` is expert ``e``'s slot of the buffer and raises
    for an expert that is not there."""

    def __init__(self, ls: LayerStream, layer: int):
        self.ls, self.layer = ls, layer
        self._slot: dict[int, int] = {}

    def rounds(self, experts: list[int]):
        step = self.ls.expert_slots
        if not step:
            raise RuntimeError("the expert buffer holds no expert: size it "
                               "with LayerStream.reserve_experts")
        for i in range(0, len(experts), step):
            group = experts[i:i + step]
            self.ls.fetch_experts(self.layer, group)
            self._slot = {e: s for s, e in enumerate(group)}
            yield group
            self._slot = {}
            self.ls.release_experts()

    def weights(self, e: int) -> dict:
        if e not in self._slot:
            raise RuntimeError(f"expert {e} of layer {self.layer} is not in "
                               "the expert buffer")
        return self.ls._expert_views[self._slot[e]]


def streaming_decoder(params, cfg: ModelConfig, x, ctx, cache,
                      prefetch: int = 2):
    """Drop-in replacement for ``transformer._run_decoder`` that streams the
    layer weights (``params["layers"]``, a ``LayerStream``) through a
    window of ``prefetch`` buffers (at most the stream's ``depth``): layers
    0..p-1 are copied up front (the paper's initial pipeline fill), then
    the copy of layer ``i + p`` is issued into layer ``i``'s buffer right
    after layer ``i`` is enqueued; an MoE layer's experts are fetched
    inside it, after its router.  Same contract as ``_run_decoder``."""
    ls: LayerStream = params["layers"]
    spec = tfm.attn_spec(cfg)
    p = max(1, min(prefetch, ls.depth))
    ls.log, ls.bytes = [], {"window": 0, "experts": 0}
    for li in range(p):
        ls.issue(li, li)
    for li in range(ls.n):
        slot = li % p
        w = ls.acquire(li, slot)
        x = tfm._decoder_layer(x, w, cfg, spec, ctx,
                               tfm.layer_slices(cache, li))
        ls.release(slot)
        if li + p < ls.n:
            ls.issue(li + p, slot)
    return x


def streams(cfg: ModelConfig, mode: str) -> bool:
    """Whether serve mode ``mode`` streams ``cfg``'s layers: ``elk_stream``
    streams every decoder-only model, and an encoder-decoder model stays
    resident, as in the reference ("nothing worth streaming")."""
    return mode == "elk_stream" and not cfg.encoder_layers


def init_streamed_params(generator: torch.Generator, cfg: ModelConfig,
                         device, depth: int) -> dict:
    """``transformer.init_params`` with ``params["layers"]`` a
    ``LayerStream`` of window ``depth``: the same draws, so the same
    weights, but each layer goes to the host before the next is drawn, so
    the device never holds more of the decoder than a layer and the
    window.  The embedding, final norm and LM head stay on ``device``.
    Raises ``ValueError`` for a config that ``streams`` keeps resident."""
    if not streams(cfg, "elk_stream"):
        raise ValueError(f"{cfg.name} is an encoder-decoder model, which is "
                         "not streamed: draw it with transformer.init_params")
    return tfm.init_params(generator, cfg, device, collect_layers=(
        functools.partial(LayerStream, device=device, depth=depth,
                          like=tfm.layer_shapes(cfg))))


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
