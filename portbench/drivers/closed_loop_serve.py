"""Closed-loop serving through the port's continuous batcher.

The system under test is ``repro_torch.serve.batcher.ContinuousBatcher``
over ``repro_torch.serve.engine.ServeEngine`` with the mix's engine
settings, on weights the benchmark draws from the seed.  ``clients``
callers each wait for their reply before sending the next request; the
requests come in the order ``traffic_gen.requests`` gives, whoever sends
them.  Set-up warms the chunk lengths the mix can send (powers of two up to
the chunk budget, as the batcher cuts prompts) and the slot step, then
serves until as many requests have completed as there are slots, so that
every slot has turned over before the window opens.

Inside the window: prompt tokens prefilled, tokens generated (each live
slot's token of a decode step, and the first token of each prompt whose
last chunk ran), the time to first token of every request whose first
token came inside the window, from its submission.  After it: a sample of
the requests finished in the window, drawn from the seed, with the one that
served the most tokens in it, checked against the fp32 reference
(``reference/checks.served_gap``) on weights drawn again from the seed.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from portbench import timeline, traffic_gen, weights
from portbench.reference import checks, dense_decoder


class ClosedLoop:
    """The batcher, its clients and the benchmark's wrappers of the two
    engine calls (token counts always; CUDA events and spans traced)."""

    def __init__(self, engine, reqs: list, clients: int,
                 tracer: timeline.Tracer):
        from repro_torch.serve.batcher import ContinuousBatcher, Request
        self._request = Request
        self.batcher = ContinuousBatcher(engine, oversub=1.0)
        self.reqs, self.tracer = reqs, tracer
        self.sent = 0
        self.seen = 0
        self.prompt_tokens = 0
        self.generated = 0
        self.passes: list[dict] = []
        self.chunks: dict[int, int] = {}
        chunk, step = engine.prefill_chunk, engine.step
        engine.prefill_chunk = lambda cache, toks: self._chunk(chunk, cache,
                                                                toks)
        engine.step = lambda toks: self._step(step, toks)
        for _ in range(clients):
            self._send()

    def _send(self) -> None:
        prompt, out = self.reqs[self.sent % len(self.reqs)]
        self.batcher.submit(self._request(
            rid=self.sent, prompt=prompt, max_new_tokens=out,
            arrival_s=self.batcher._now()))
        self.sent += 1

    def _chunk(self, call, cache, toks):
        ps = self.batcher.prefilling
        t = int(toks.shape[1])
        final = ps.off + t == len(ps.req.prompt)
        self.passes.append({"kind": "chunk", "start": ps.off, "tokens": t,
                            "final": final})
        self.chunks[ps.req.rid] = self.chunks.get(ps.req.rid, 0) + 1
        self.prompt_tokens += t
        self.generated += final
        return self.tracer.timed("prefill_chunk", call, cache, toks)

    def _step(self, call, toks):
        pos = [len(a.req.prompt) + len(a.generated) - 1
               for a in self.batcher.active.values()]
        self.passes.append({"kind": "decode", "positions": pos})
        self.generated += len(pos)
        return self.tracer.timed("step", call, toks)

    def tick(self) -> None:
        with self.tracer.span("tick"):
            self.batcher.tick()
        done = self.batcher.completed
        while self.seen < len(done):
            self.seen += 1
            self._send()


def _warm(engine, budget: int, longest: int) -> None:
    """Every chunk length the batcher can cut (powers of two up to the
    budget), then a slot step; the caches are reset after."""
    from repro_torch.models.transformer import cache_evict_slot
    cache = engine.new_request_cache()
    t = 1
    while t <= min(budget, longest):
        engine.prefill_chunk(cache, torch.zeros((1, t), dtype=torch.int64))
        with torch.inference_mode():
            cache_evict_slot(cache, 0)
        t *= 2
    engine.step(torch.zeros((engine.scfg.slots,), dtype=torch.int64))
    for s in range(engine.scfg.slots):
        engine.evict_slot(s, keep=False)
    del cache


def run(env) -> dict:
    """Set up, serve the window, check; the outcome for ``run.py``."""
    from repro_torch.serve.engine import ServeConfig, ServeEngine
    mix, model = env.mix, env.model
    cfg = env.port_config()
    params = weights.draw(model, env.seed, env.device)
    engine = ServeEngine(cfg, params, ServeConfig(**mix["engine"]),
                         device=env.device)
    reqs = traffic_gen.requests(mix, model["vocab_size"], env.seed,
                                mix["requests"])
    _warm(engine, mix["engine"]["prefill_chunk"], mix["prompt"]["max"])
    loop = ClosedLoop(engine, reqs, mix["clients"], env.tracer)
    while len(loop.batcher.completed) < engine.scfg.slots:
        loop.tick()
    env.sync()

    # -- the window ------------------------------------------------------
    env.tracer.start()
    env.sync()
    first_pass, tok0 = len(loop.passes), loop.prompt_tokens + loop.generated
    done0 = len(loop.batcher.completed)
    w0, t0, t0_ns = loop.batcher._now(), time.perf_counter(), time.time_ns()
    env.window_opened(t0)
    while time.perf_counter() - t0 < env.seconds:
        loop.tick()
    env.sync()
    window_s = time.perf_counter() - t0
    w1, t1_ns = loop.batcher._now(), time.time_ns()
    device_events = env.tracer.stop()

    b = loop.batcher
    finished = b.completed[done0:]
    firsts = [c.first_token_s - c.arrival_s for c in b.completed
              if w0 <= c.first_token_s <= w1]
    firsts += [a.first_s - a.req.arrival_s for a in b.active.values()
               if w0 <= a.first_s <= w1]
    tokens = loop.prompt_tokens + loop.generated - tok0
    env.say(f"window {window_s:.3f} s: {len(finished)} requests finished, "
            f"{len(firsts)} first tokens, {tokens} tokens "
            f"({loop.prompt_tokens} prompt, {loop.generated} generated "
            f"since set-up began)")
    outcome = {
        "window_s": window_s,
        "attempted": len(finished), "failed": 0,
        "e2e": {"serve_tok_s": tokens / window_s,
                "ttft_p90_ms": (float(np.percentile(firsts, 90)) * 1e3
                                if firsts else None)},
        "memory_peak_bytes": env.memory_peak(),
        "layer": {"model": env.dims(), "window_s": window_s,
                  "passes": loop.passes[first_pass:],
                  "device_ms": env.tracer.device_ms(),
                  "completions": finished, "chunks": dict(loop.chunks),
                  "timeline": (timeline.reduce(device_events, t0_ns, t1_ns,
                                               env.tracer.spans)
                               if env.tracer.trace else None)}}

    # -- the check, on the program's state freed --------------------------
    sample = _sample(finished, mix["check"]["requests"], env.seed)
    served = [(np.asarray(c.tokens[:c.prompt_len]),
               np.asarray(c.tokens[c.prompt_len:])) for c in sample]
    del loop, b, engine, params
    gc.collect()
    env.free()
    t_check = time.perf_counter()
    numbers = served_numbers(model, env.seed, served, env.device,
                             dense_decoder.fp8_operands
                             if "fp8" in env.controls else None)
    outcome["controls"] = ({"fp8": {"served_gap":
                                    numbers.pop("control_gap")}}
                           if "fp8" in env.controls else {})
    env.say(f"check: {len(served)} requests, "
            f"{sum(len(s) for _, s in served)} served tokens, "
            f"longest prompt {max(len(p) for p, _ in served)}, "
            f"{time.perf_counter() - t_check:.1f} s")
    outcome["check"] = checks.verdict(numbers, mix["check"]["limits"])
    return outcome


def _sample(finished: list, n: int, seed: int) -> list:
    """The request that served the most tokens, and n - 1 others drawn
    from the seed."""
    if not finished:
        raise RuntimeError("no request finished inside the window")
    order = sorted(finished, key=lambda c: (len(c.tokens) - c.prompt_len,
                                            c.rid))
    rest = order[:-1]
    pick = traffic_gen.rng(seed, "check").permutation(len(rest))[:n - 1]
    return [order[-1]] + [rest[i] for i in sorted(pick)]


def served_numbers(model: dict, seed: int, served: list, device,
                   quant=None) -> dict:
    """``served_gap`` of (prompt, served tokens) pairs against the fp32
    reference on the weights drawn again from ``seed``."""
    params = weights.draw(model, seed, device)
    seqs, rows, toks = [], [], []
    for prompt, out in served:
        seqs.append(torch.from_numpy(np.concatenate([prompt, out[:-1]])
                                     .astype(np.int64)).to(device))
        rows.append(torch.arange(len(prompt) - 1, len(prompt) - 1 + len(out),
                                 device=device))
        toks.append(torch.from_numpy(out.astype(np.int64)).to(device))
    with dense_decoder.fp32_matmuls():
        ref = dense_decoder.sequence_logits(params, model, seqs, rows)
        numbers = {"served_gap": checks.served_gap(ref, toks)}
        if quant is not None:
            low = dense_decoder.sequence_logits(params, model, seqs, rows,
                                                quant)
            numbers["control_gap"] = checks.first_choice_gap(ref, low)
    return numbers
