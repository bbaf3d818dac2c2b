"""The second slice of the port: slot-batched serving and the continuous
batcher, on the CPU.

Torch twins of ``tests/test_serve_batcher.py`` (in-place slot step, slot
cache operations, the scheduler's greedy parity), and the slice against the
JAX package on converted weights and caches: ``decode_slots`` and
``chunk_prefill`` logits function to function, and the port's
``ContinuousBatcher`` greedy tokens per request equal to the reference's on
the same ``make_trace``.

Tolerances: fp32 logits within 2e-4 * (max|ref| + 1) (the two frameworks sum
in different orders); bf16 within 6e-2 * (max|ref| + 1) (bf16 rounds at
different places).  Greedy tokens must be equal in fp32.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import transformer as jtfm
from repro.serve.batcher import ContinuousBatcher as JaxBatcher
from repro.serve.batcher import make_trace as jax_make_trace
from repro.serve.batcher import summarize as jax_summarize
from repro.serve.engine import ServeConfig as JaxServeConfig
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro.serve.prefix import PrefixStore as JaxPrefixStore
from repro_torch.configs import get_smoke_config
from repro_torch.convert import cache_from_jax, cache_to_numpy, params_from_jax
from repro_torch.models import transformer as tfm
from repro_torch.serve.batcher import (ContinuousBatcher, Request, make_trace,
                                       run_static_trace, summarize)
from repro_torch.serve.engine import ServeConfig, ServeEngine
from repro_torch.serve.prefix import PrefixStore

ARCHS = ["qwen3_14b", "llama2_13b", "gemma_7b", "opt_30b", "h2o_danube_1_8b",
         "gemma2_27b", "llama2_70b", "dit_xl", "llama4_maverick_400b_a17b",
         "kimi_k2_1t_a32b"]
# the families with a state in the slot cache (RWKV: no ring; hybrid: SSM
# state beside the ring) and the VLM (text only on the slot path)
STATE_ARCHS = ["rwkv6_7b", "hymba_1_5b", "internvl2_1b"]
TOL = {"float32": 2e-4, "bfloat16": 6e-2}


def _tol(dtype: str, ref: np.ndarray) -> float:
    return TOL[dtype] * (float(np.max(np.abs(ref))) + 1.0)


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _engine(arch="qwen3_14b", **kw) -> ServeEngine:
    cfg = get_smoke_config(arch)
    params = tfm.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    scfg = ServeConfig(**{"batch": 2, "cache_capacity": 64,
                          "prefill_chunk": 8, **kw})
    return ServeEngine(cfg, params, scfg, device="cpu")


def _prompt(cfg, n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (n,)).astype(np.int32)


def _solo(eng: ServeEngine, prompt: np.ndarray, steps: int) -> np.ndarray:
    """Lock-step ``generate`` of one prompt (tiled over the batch)."""
    p = torch.from_numpy(np.tile(prompt[None, :], (eng.scfg.batch, 1)))
    return eng.generate(p, steps=steps)[0].numpy()


def _both(arch: str, dtype: str, seed: int = 0):
    """(jax cfg, jax params, port cfg, port params) on the same weights."""
    jcfg = dataclasses.replace(jax_smoke_config(arch), dtype=dtype,
                               param_dtype=dtype)
    tcfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype,
                               param_dtype=dtype)
    jparams = jtfm.init_params(jax.random.PRNGKey(seed), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return jcfg, jparams, tcfg, tparams


class TestSlotStepInPlace:
    def test_slot_step_is_copy_free(self):
        """The counterpart of the reference's donated slot step: ``step``
        writes into the slot cache's own tensors."""
        eng = _engine()
        eng._ensure_slots()
        ptrs = {k: eng.slot_cache[k].data_ptr()
                for k in ("k", "v", "pos", "slot_pos")}
        cache = eng.slot_cache
        for _ in range(3):
            eng.step(torch.zeros((2,), dtype=torch.int64))
        assert eng.slot_cache is cache
        assert {k: cache[k].data_ptr() for k in ptrs} == ptrs
        assert cache["pos"].tolist() == [3, 3]


class TestSlotCacheOps:
    def test_chunked_prefill_invariant_to_chunking(self):
        """Any chunking of the prompt yields the same next token and the
        same ring contents as a single-chunk pass."""
        eng = _engine(kv_dtype="float32")
        prompt = torch.from_numpy(_prompt(eng.cfg, 13, 0))[None, :]
        outs = {}
        for chunks in ((13,), (8, 4, 1), (4, 4, 4, 1)):
            rc, off = eng.new_request_cache(), 0
            for t in chunks:
                tok, rc = eng.prefill_chunk(rc, prompt[:, off:off + t])
                off += t
            outs[chunks] = (int(tok[0]), cache_to_numpy(rc))
        ref_tok, ref_cache = outs[(13,)]
        for chunks, (tok, cache) in outs.items():
            assert tok == ref_tok, chunks
            np.testing.assert_array_equal(cache["pos"], [13])
            np.testing.assert_array_equal(cache["slot_pos"],
                                          ref_cache["slot_pos"])
            for key in ("k", "v"):
                np.testing.assert_allclose(cache[key], ref_cache[key],
                                           rtol=1e-5, atol=1e-5,
                                           err_msg=f"{chunks}/{key}")

    def test_insert_evict_isolation(self):
        """Inserting/evicting one slot never perturbs the other slot's
        decode stream."""
        eng = _engine()
        pa, pb = _prompt(eng.cfg, 9, 1), _prompt(eng.cfg, 5, 2)
        ref_a = _solo(eng, pa, 6)[9:]
        tok_a, rc = eng.prefill_chunk(eng.new_request_cache(),
                                      torch.from_numpy(pa)[None])
        eng.insert_slot(0, rc)
        toks = torch.zeros((2,), dtype=torch.int64)
        toks[0] = tok_a[0]
        got_a = [int(tok_a[0])]
        for i in range(5):
            if i == 1:
                tok_b, rcb = eng.prefill_chunk(eng.new_request_cache(),
                                               torch.from_numpy(pb)[None])
                eng.insert_slot(1, rcb)
                toks[1] = tok_b[0]
            if i == 3:
                eng.evict_slot(1)
            toks = eng.step(toks).clone()   # a tensor of our own to edit
            got_a.append(int(toks[0]))
        np.testing.assert_array_equal(np.asarray(got_a), ref_a)

    def test_slot_pos_wraparound(self):
        """cache_capacity < prompt_len + steps: the ring tags hold exactly
        the last C positions, in both cache layouts."""
        cap, s0, steps = 16, 12, 10
        eng = _engine(cache_capacity=cap)
        prompt = _prompt(eng.cfg, s0, 3)
        logits, cache = eng.prefill(torch.from_numpy(
            np.tile(prompt[None], (2, 1))))
        tok = torch.argmax(logits[:, -1, :], dim=-1)
        for _ in range(steps):
            logits, cache = eng.decode(tok, cache)
            tok = torch.argmax(logits[:, -1, :], dim=-1)
        end = s0 + steps
        np.testing.assert_array_equal(np.sort(cache["slot_pos"].numpy()),
                                      np.arange(end - cap, end))

        tokc, rc = eng.prefill_chunk(eng.new_request_cache(),
                                     torch.from_numpy(prompt)[None])
        eng.insert_slot(0, rc)
        cur = torch.zeros((2,), dtype=torch.int64)
        cur[0] = tokc[0]
        for _ in range(steps):
            cur = eng.step(cur)
        sp = eng.slot_cache["slot_pos"].numpy()
        np.testing.assert_array_equal(np.sort(sp[0]), np.arange(end - cap, end))
        state = eng.evict_slot(0)
        sp = eng.slot_cache["slot_pos"].numpy()
        assert (sp[0] == tfm.POS_SENTINEL).all()
        assert int(eng.slot_cache["pos"][0]) == 0
        # the evicted state is a copy: the slot cache moved on, it did not
        assert int(state["pos"][0]) == end
        np.testing.assert_array_equal(np.sort(state["slot_pos"][0].numpy()),
                                      np.arange(end - cap, end))

    def test_extract_insert_round_trip(self):
        eng = _engine()
        _, rc = eng.prefill_chunk(eng.new_request_cache(), torch.from_numpy(
            _prompt(eng.cfg, 7, 4))[None])
        eng.insert_slot(1, rc)
        state = eng.evict_slot(1)
        for key in rc:
            assert torch.equal(state[key], rc[key]), key
        eng.insert_slot(0, state)
        back = tfm.cache_extract_slot(eng.slot_cache, 0)
        for key in rc:
            assert torch.equal(back[key], rc[key]), key

    def test_evict_without_keep_frees_the_slot_only(self):
        """The batcher's eviction of a finished request (``keep=False``)
        frees the slot as ``evict_slot`` does, copies nothing and leaves
        the K/V buffers as they are."""
        eng = _engine()
        _, rc = eng.prefill_chunk(eng.new_request_cache(), torch.from_numpy(
            _prompt(eng.cfg, 7, 4))[None])
        eng.insert_slot(1, rc)
        kv = {key: eng.slot_cache[key].clone() for key in ("k", "v")}
        assert eng.evict_slot(1, keep=False) is None
        assert (eng.slot_cache["slot_pos"][1] == tfm.POS_SENTINEL).all()
        assert int(eng.slot_cache["pos"][1]) == 0
        for key, before in kv.items():
            assert torch.equal(eng.slot_cache[key], before), key


class TestContinuousBatching:
    def test_greedy_parity_and_out_of_order_completion(self):
        """Mixed-length requests through the scheduler complete out of
        arrival order, and every request's greedy continuation equals
        serving it alone and the lock-step ``generate`` path."""
        eng = _engine(batch=2, cache_capacity=64, prefill_chunk=8)
        lens = [(9, 8), (5, 2), (13, 5), (4, 9), (7, 1), (6, 3)]
        reqs = [Request(rid=i, prompt=_prompt(eng.cfg, s0, 10 + i),
                        max_new_tokens=new)
                for i, (s0, new) in enumerate(lens)]
        completions = ContinuousBatcher(eng).run(reqs)
        assert sorted(c.rid for c in completions) == list(range(len(reqs)))
        finish = [c.rid for c in completions]
        assert finish != sorted(finish), finish
        by_rid = {c.rid: c for c in completions}
        for r in reqs:
            got = by_rid[r.rid].tokens
            assert got.shape == (len(r.prompt) + r.max_new_tokens,)
            alone = ContinuousBatcher(eng).run(
                [Request(r.rid, r.prompt, r.max_new_tokens)])[0]
            np.testing.assert_array_equal(got, alone.tokens)
            np.testing.assert_array_equal(got, _solo(eng, r.prompt,
                                                     r.max_new_tokens))

    # internvl's generate puts stub patches ahead of the prompt and the slot
    # path takes text only, so it is held to the reference's batcher below
    @pytest.mark.parametrize("arch", ARCHS + STATE_ARCHS[:2])
    def test_slot_path_parity_across_families(self, arch):
        eng = _engine(arch, prefill_chunk=8)
        prompt = _prompt(eng.cfg, 11, 5)
        got = ContinuousBatcher(eng).run([Request(0, prompt, 5)])[0].tokens
        np.testing.assert_array_equal(got, _solo(eng, prompt, 5))

    def test_chunk_budget_clamped_to_capacity(self):
        """A prompt longer than the cache prefills in sub-capacity chunks
        (the ring wraps between chunks, never inside one)."""
        eng = _engine(cache_capacity=16, prefill_chunk=32)
        bat = ContinuousBatcher(eng)
        assert bat.chunk_budget == 16
        out = bat.run([Request(0, np.arange(2, 26, dtype=np.int32) % 9, 4)])
        assert out[0].tokens.shape == (28,)
        with pytest.raises(ValueError, match="exceeds cache capacity"):
            eng.prefill_chunk(eng.new_request_cache(),
                              torch.zeros((1, 17), dtype=torch.int64))

    def test_empty_prompt_rejected(self):
        with pytest.raises(ValueError, match="empty prompt"):
            ContinuousBatcher(_engine()).submit(
                Request(0, np.zeros((0,), np.int32), 4))

    def test_zero_and_one_token_requests(self):
        eng = _engine()
        reqs = [Request(0, np.arange(5, dtype=np.int32), 0),
                Request(1, np.arange(6, dtype=np.int32), 1),
                Request(2, np.arange(4, dtype=np.int32), 3)]
        out = {c.rid: c for c in ContinuousBatcher(eng).run(reqs)}
        np.testing.assert_array_equal(out[0].tokens, reqs[0].prompt)
        assert out[1].tokens.shape == (7,)
        assert out[2].tokens.shape == (7,)
        np.testing.assert_array_equal(out[1].tokens,
                                      _solo(eng, reqs[1].prompt, 1))

    def test_static_trace_baseline_accounts_all_requests(self):
        eng = _engine()
        trace = make_trace(5, vocab_size=eng.cfg.vocab_size,
                           prompt_lens=(6, 9), max_new=(2, 4))
        out = run_static_trace(eng, trace)
        assert sorted(c.rid for c in out) == list(range(5))
        stats = summarize(out, 1.0)
        assert stats["requests"] == 5
        assert stats["gen_tok_s"] == pytest.approx(
            sum(r.max_new_tokens for r in trace))

    def test_unported_parts_raise_and_name_the_roadmap(self):
        """Nothing of the batcher is left to port: the fleet's hooks work.
        A ``handoff`` batcher hands each finished prefill over (a host copy
        of its request cache, its first token, the admission stamp), frees
        the slot and decodes nothing; ``adopt`` on another batcher at K = 1
        resumes it to the tokens of serving it alone
        (``tests/test_torch_fleet.py`` holds the fleet in full)."""
        eng = _engine()
        handed = []
        src = ContinuousBatcher(eng, handoff=lambda *a: handed.append(a))
        req = Request(0, np.arange(3, dtype=np.int32), 4)
        src.submit(req)
        while src.busy:
            src.tick()
        assert not src.completed and src.decode_ticks == 0
        assert sorted(src.free) == [0, 1]
        ((got_req, state, generated, first_s, admitted_s),) = handed
        assert got_req is req and len(generated) == 1 and admitted_s >= 0.0
        assert all(t.device.type == "cpu" for t in state.values())
        assert [k for k, _ in src.spill_events] == ["spill"]
        dst = ContinuousBatcher(_engine())
        dst.adopt(req, state, generated, first_s, admitted_s=admitted_s)
        while dst.busy:
            dst.tick()
        np.testing.assert_array_equal(dst.completed[0].tokens,
                                      _solo(eng, req.prompt, 4))
        assert ContinuousBatcher(eng, oversub=2.0).virtual_slots == 4
        assert eng.slot_state_bytes() > 0

    def test_enc_dec_refused_on_the_slot_path(self):
        """whisper has no per-slot cache: the batcher's first admission
        raises the reference's ``ValueError``, as the reference's engine
        does when it builds its slot cache."""
        eng = _engine("whisper_tiny")
        with pytest.raises(ValueError, match="per-slot caches do not "
                           "support enc-dec models"):
            ContinuousBatcher(eng).run([Request(0, np.arange(4), 2)])
        with pytest.raises(ValueError, match="per-slot caches"):
            eng.new_request_cache()

    def test_rwkv_slot_state_is_the_state_after_k_tokens(self):
        """An RWKV request cache has no ring: offload and refill carry
        ``rwkv_state`` and ``pos``, and a chunk boundary's snapshot holds
        the state after exactly k tokens (a lock-step prefill of those k
        tokens gives the same state)."""
        eng = _engine("rwkv6_7b", prefill_chunk=4)
        prompt = _prompt(eng.cfg, 8, 2)
        cache = eng.new_request_cache()
        assert set(cache) == {"pos", "rwkv_state"}
        _, cache = eng.prefill_chunk(cache, torch.from_numpy(
            prompt[None, :4]).long())
        _, full = eng.prefill(torch.from_numpy(
            np.tile(prompt[None, :4], (eng.scfg.batch, 1))).long())
        assert torch.equal(cache["rwkv_state"][:, 0], full["rwkv_state"][:, 0])
        eng.insert_slot(1, cache)
        state = eng.offload_slot(1)
        assert set(state) == {"pos", "rwkv_state"}
        assert eng.slot_state_bytes() == sum(
            t.numel() * t.element_size() for t in state.values())
        eng.refill_slot(0, state)
        assert torch.equal(eng.slot_cache["rwkv_state"][:, 0],
                           cache["rwkv_state"][:, 0])
        assert int(eng.slot_cache["pos"][0]) == 4


class TestAgainstReference:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("arch", ["qwen3_14b", "h2o_danube_1_8b"])
    def test_chunk_prefill_and_decode_slots_logits(self, arch, dtype):
        """Two requests of different lengths prefill chunk by chunk into a
        per-slot cache of 2, then three ``decode_slots`` steps: logits
        function to function, caches tag for tag."""
        jcfg, jparams, tcfg, tparams = _both(arch, dtype)
        cap = 16
        jkv = jnp.float32 if dtype == "float32" else jnp.bfloat16
        jcache = jtfm.init_cache(jcfg, jtfm.CacheSpec(cap, 2, kv_dtype=jkv,
                                                      per_slot=True))
        prompts = np.stack([_prompt(tcfg, 12, 6), _prompt(tcfg, 12, 7)])
        with torch.inference_mode():
            tcache = cache_from_jax(jax.tree.map(np.asarray, jcache), "cpu")
            off = 0
            # row 1 is ahead of row 0 by the chunks' own offsets
            for t in (8, 4):
                chunk = prompts[:, off:off + t]
                jlog, jcache = jtfm.chunk_prefill(jparams, jcfg,
                                                  jnp.asarray(chunk), jcache)
                tlog, tcache = tfm.chunk_prefill(tparams, tcfg,
                                                 torch.from_numpy(chunk),
                                                 tcache)
                ref = _f32(jlog)
                assert np.max(np.abs(_f32(tlog) - ref)) <= _tol(dtype, ref)
                off += t
            for step in range(3):
                tok = np.array(jnp.argmax(jlog[:, -1, :], axis=-1), np.int32)
                if step == 1:       # rows at their own positions
                    jcache = jtfm.cache_evict_slot(jcache, jnp.int32(1))
                    tfm.cache_evict_slot(tcache, 1)
                jlog, jcache = jtfm.decode_slots(jparams, jcfg,
                                                 jnp.asarray(tok), jcache)
                tlog, tcache = tfm.decode_slots(tparams, tcfg,
                                                torch.from_numpy(tok), tcache)
                ref = _f32(jlog)
                err = np.max(np.abs(_f32(tlog) - ref))
                assert err <= _tol(dtype, ref), (arch, dtype, step, err)
        got = cache_to_numpy(tcache)
        np.testing.assert_array_equal(got["pos"], np.asarray(jcache["pos"]))
        np.testing.assert_array_equal(got["slot_pos"],
                                      np.asarray(jcache["slot_pos"]))
        kref = _f32(jcache["k"])
        assert np.max(np.abs(got["k"] - kref)) <= _tol(dtype, kref)

    @pytest.mark.parametrize("arch", ARCHS)
    def test_batcher_tokens_equal_reference(self, arch, mesh11):
        """The port's continuous batcher and the reference's, same weights,
        same trace (ring wraparound included: capacity 16 < prompt 20, 32):
        equal greedy tokens per request."""
        jcfg, jparams, tcfg, tparams = _both(arch, "float32")
        kw = dict(batch=2, cache_capacity=16, prefill_chunk=8,
                  kv_dtype="float32")
        jeng = JaxServeEngine(jcfg, mesh11, jparams, JaxServeConfig(**kw))
        teng = ServeEngine(tcfg, tparams, ServeConfig(**kw), device="cpu")
        trace = make_trace(6, vocab_size=tcfg.vocab_size, seed=3)
        ref = {c.rid: c.tokens for c in JaxBatcher(jeng).run(
            jax_make_trace(6, vocab_size=jcfg.vocab_size, seed=3))}
        got = {c.rid: c.tokens for c in ContinuousBatcher(teng).run(trace)}
        assert sorted(got) == sorted(ref) == list(range(6))
        for rid in ref:
            np.testing.assert_array_equal(got[rid], ref[rid], err_msg=rid)

    @pytest.mark.parametrize("arch", STATE_ARCHS)
    def test_state_families_batcher_equals_reference(self, arch, mesh11):
        """rwkv, hymba and internvl (text only) through both batchers on
        the same weights and trace: equal greedy tokens per request."""
        jcfg, jparams, tcfg, tparams = _both(arch, "float32")
        kw = dict(batch=2, cache_capacity=32, prefill_chunk=8,
                  kv_dtype="float32")
        jeng = JaxServeEngine(jcfg, mesh11, jparams, JaxServeConfig(**kw))
        teng = ServeEngine(tcfg, tparams, ServeConfig(**kw), device="cpu")
        ref = {c.rid: c.tokens for c in JaxBatcher(jeng).run(
            jax_make_trace(5, vocab_size=jcfg.vocab_size, seed=3))}
        got = {c.rid: c.tokens for c in ContinuousBatcher(teng).run(
            make_trace(5, vocab_size=tcfg.vocab_size, seed=3))}
        assert sorted(got) == sorted(ref) == list(range(5))
        for rid in ref:
            np.testing.assert_array_equal(got[rid], ref[rid], err_msg=rid)

    def test_rwkv_prefix_hits_and_swaps_equal_reference(self, mesh11):
        """rwkv oversubscribed (K = 2) with a prefix store and a shared
        system prompt: the snapshots are recurrent states at chunk
        boundaries; tokens, finish order, spill events and prefix counters
        equal the reference's, with at least one hit and one spill."""
        jcfg, jparams, tcfg, tparams = _both("rwkv6_7b", "float32")
        kw = dict(batch=2, cache_capacity=32, prefill_chunk=4,
                  kv_dtype="float32")
        tkw = dict(prompt_lens=(5, 9, 6, 12), max_new=(3, 6, 4, 8),
                   sys_prompt_len=8, sys_prompt_frac=0.5, seed=0)
        ref = JaxBatcher(JaxServeEngine(jcfg, mesh11, jparams,
                                        JaxServeConfig(**kw)),
                         oversub=2.0, prefix_store=JaxPrefixStore(4 << 20),
                         swap_after=2)
        got = ContinuousBatcher(ServeEngine(tcfg, tparams,
                                            ServeConfig(**kw), device="cpu"),
                                oversub=2.0, prefix_store=PrefixStore(4 << 20),
                                swap_after=2)
        rcomps = ref.run(jax_make_trace(8, vocab_size=jcfg.vocab_size, **tkw))
        tcomps = got.run(make_trace(8, vocab_size=tcfg.vocab_size, **tkw))
        assert [c.rid for c in tcomps] == [c.rid for c in rcomps]
        for a, b in zip(tcomps, rcomps):
            np.testing.assert_array_equal(a.tokens, b.tokens, err_msg=a.rid)
        assert got.spill_events == ref.spill_events
        assert got.spill_events
        assert (got.prefix_hits, got.prefix_tokens_saved) == (
            ref.prefix_hits, ref.prefix_tokens_saved)
        assert got.prefix_hits > 0

    def test_make_trace_byte_identical(self):
        kws = [dict(), dict(arrival_spacing_s=0.01, burst=2, seed=5),
               dict(sys_prompt_len=6, sys_prompt_frac=0.5, seed=2),
               dict(tenant_rates=(1.0, 3.0), arrival_spacing_s=0.02,
                    tail_frac=0.3, seed=9)]
        for kw in kws:
            a = make_trace(9, vocab_size=100, **kw)
            b = make_trace(9, vocab_size=100, **kw)
            ref = jax_make_trace(9, vocab_size=100, **kw)
            for x, y, r in zip(a, b, ref):
                assert x.prompt.tobytes() == y.prompt.tobytes() \
                    == r.prompt.tobytes()
                assert x.prompt.dtype == r.prompt.dtype
                assert (x.rid, x.max_new_tokens, x.arrival_s, x.tenant) == \
                    (r.rid, r.max_new_tokens, r.arrival_s, r.tenant)

    def test_summarize_same_keys(self):
        from repro.serve.batcher import Completion as JaxCompletion
        from repro_torch.serve.batcher import Completion
        rows = [(0, 5, 0.0, 1.0, 0.2), (1, 3, 0.1, 0.7, 0.3)]
        mine = [Completion(rid, np.zeros(6, np.int32), n, a, f, i, ft)
                for i, (rid, n, a, f, ft) in enumerate(rows)]
        ref = [JaxCompletion(rid, np.zeros(6, np.int32), n, a, f, i, ft)
               for i, (rid, n, a, f, ft) in enumerate(rows)]
        assert summarize(mine, 1.5) == jax_summarize(ref, 1.5)
