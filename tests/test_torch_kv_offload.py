"""KV offload to host memory, the oversubscribed batcher and prefix reuse in
the port, on the CPU.

Torch twins of ``tests/test_kv_offload.py``: the spillable slot API copies
exactly, the oversubscribed batcher keeps greedy parity and beats the
slot-capped one on ticks, a cached prefix gives the cold path's tokens,
the plan's K, and spill events priced on the port's copy of the
simulator.  Then the port's batcher against the reference's on the five
dense smoke configs, with K = 2 and a prefix store: equal tokens, finish
order, spill events and prefix counters.  Greedy tokens must be equal
(fp32 where the two frameworks are compared, the port's own bf16 against
itself otherwise).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import transformer as jtfm
from repro.serve.batcher import ContinuousBatcher as JaxBatcher
from repro.serve.batcher import make_trace as jax_make_trace
from repro.serve.engine import ServeConfig as JaxServeConfig
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro.serve.prefix import PrefixStore as JaxPrefixStore
from repro_torch.chip.config import GB, ipu_mk2, ipu_pod4_hbm
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.models import transformer as tfm
from repro_torch.serve.batcher import (ContinuousBatcher, Request, make_trace,
                                       run_static_trace, summarize)
from repro_torch.serve.engine import ServeConfig, ServeEngine
from repro_torch.serve.prefix import PrefixStore

DENSE = ["qwen3_14b", "llama2_13b", "gemma_7b", "opt_30b", "h2o_danube_1_8b"]


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
    """Cold-path greedy reference for one request."""
    p = torch.from_numpy(np.tile(prompt[None, :], (eng.scfg.batch, 1)))
    return eng.generate(p, steps=steps)[0].numpy()


def _tokens(*toks) -> torch.Tensor:
    return torch.tensor(toks, dtype=torch.int64)


class TestSlotSpill:
    def test_evict_insert_round_trips_bit_identically(self):
        """The evicted state goes back in and the decode stream goes on as
        if uninterrupted; evicting again gives the same tensors."""
        eng = _engine()
        prompt = _prompt(eng.cfg, 9, 0)
        ref = _solo(eng, prompt, 6)[9:]
        tok, rc = eng.prefill_chunk(eng.new_request_cache(),
                                    torch.from_numpy(prompt)[None])
        eng.insert_slot(0, rc)
        toks = _tokens(int(tok[0]), 0)
        got = [int(tok[0])]
        for i in range(5):
            if i == 2:      # interrupt mid-decode: evict, then re-insert
                state = eng.evict_slot(0)
                assert state is not None and "pos" in state
                before = {k: v.clone() for k, v in state.items()}
                eng.insert_slot(0, state)
                after = eng.evict_slot(0)
                for k in before:
                    assert torch.equal(before[k], after[k]), k
                eng.insert_slot(0, after)
            toks = eng.step(toks)
            got.append(int(toks[0]))
        np.testing.assert_array_equal(np.asarray(got, np.int32), ref)

    def test_offload_refill_to_other_slot(self):
        """``offload_slot`` hands back a host copy that refills into any slot
        and continues the stream bit-identically."""
        eng = _engine()
        prompt = _prompt(eng.cfg, 7, 1)
        ref = _solo(eng, prompt, 6)[7:]
        tok, rc = eng.prefill_chunk(eng.new_request_cache(),
                                    torch.from_numpy(prompt)[None])
        eng.insert_slot(0, rc)
        toks = _tokens(int(tok[0]), 0)
        got = [int(tok[0])]
        for _ in range(2):
            toks = eng.step(toks)
            got.append(int(toks[0]))
        state = eng.offload_slot(0)
        assert all(v.device.type == "cpu" for v in state.values())
        assert (eng.slot_cache["slot_pos"][0] == tfm.POS_SENTINEL).all()
        eng.refill_slot(1, state)
        toks = _tokens(0, got[-1])
        for _ in range(3):
            toks = eng.step(toks)
            got.append(int(toks[1]))
        np.testing.assert_array_equal(np.asarray(got, np.int32), ref)

    def test_offload_is_a_real_copy(self):
        """The offloaded state must survive the in-place engine steps that
        rewrite the slot cache it was taken from, and a refill must not
        alias it into the cache."""
        eng = _engine()
        tok, rc = eng.prefill_chunk(eng.new_request_cache(), torch.from_numpy(
            _prompt(eng.cfg, 5, 2))[None])
        eng.insert_slot(0, rc)
        state = eng.offload_slot(0)
        snap = {k: v.clone() for k, v in state.items()}
        eng.refill_slot(0, state)
        for _ in range(3):      # rewrite the slot cache in place
            eng.step(_tokens(1, 2))
        for k in snap:
            assert torch.equal(snap[k], state[k]), k
            assert (state[k].data_ptr()
                    != eng.slot_cache[k].data_ptr()), k

    def test_slot_state_bytes_matches_leaves(self):
        eng = _engine()
        eng._ensure_slots()
        state = eng.offload_slot(0)
        nbytes = sum(v.numel() * v.element_size() for v in state.values())
        assert eng.slot_state_bytes() == nbytes


class TestOversubscription:
    def test_oversubscribed_parity_with_swaps(self):
        """2 physical slots, 6 requests in one burst, K=3: every stream
        equals running the request alone although requests park offloaded
        and LRU swaps time-slice the slots."""
        eng = _engine(oversub=3.0)
        reqs = make_trace(6, vocab_size=eng.cfg.vocab_size,
                          prompt_lens=(6, 9, 12), max_new=(5, 8, 11),
                          seed=3)
        bat = ContinuousBatcher(eng, swap_after=2)
        assert bat.virtual_slots == 6
        out = {c.rid: c for c in bat.run(reqs)}
        assert len(out) == 6
        assert bat.spill_events, "no offload traffic despite 3x burst"
        for r in reqs:
            np.testing.assert_array_equal(
                out[r.rid].tokens, _solo(eng, r.prompt, r.max_new_tokens),
                err_msg=f"rid={r.rid}")

    def test_oversubscribed_beats_capped_on_ticks(self):
        """On a burst with >= 2x slot concurrency the oversubscribed
        scheduler finishes the same trace in strictly fewer ticks than the
        capacity-capped one (prefill-ahead keeps slots from idling while a
        new request prefills)."""
        eng = _engine()
        reqs = make_trace(8, vocab_size=eng.cfg.vocab_size,
                          prompt_lens=(16, 24, 32, 24),
                          max_new=(4, 6, 8, 6), seed=5)
        capped = ContinuousBatcher(eng, oversub=1.0)
        capped.run(reqs)
        over = ContinuousBatcher(eng, oversub=4.0)
        out = over.run(reqs)
        assert len(out) == 8
        assert over.ticks < capped.ticks, (over.ticks, capped.ticks)

    def test_lru_victim_is_least_recently_resident(self):
        """With every active slot equally recent, the LRU swap evicts the
        longest-resident slot once a waiter has starved ``swap_after``
        ticks, and never before."""
        eng = _engine(oversub=2.0)
        bat = ContinuousBatcher(eng, swap_after=3)
        reqs = [Request(i, np.asarray([3 + i, 5, 7 + i], np.int32), 40)
                for i in range(3)]
        for r in reqs:
            bat.submit(r)
        for _ in range(20):
            bat.tick()
            if 2 in {a.req.rid for a in bat.active.values()}:
                break
        else:
            pytest.fail("starving waiter never refilled")
        spilled_rids = {sp.req.rid for sp in bat.spilled.values()}
        assert 0 in spilled_rids, spilled_rids
        while bat.busy:
            bat.tick()
        out = {c.rid: c for c in bat.completed}
        for r in reqs:
            np.testing.assert_array_equal(
                out[r.rid].tokens, _solo(eng, r.prompt, r.max_new_tokens),
                err_msg=f"rid={r.rid}")

    def test_oversub_one_has_no_spill_traffic(self):
        """K=1 reproduces the slot-capped scheduler exactly: no spills, no
        slotless prefill."""
        eng = _engine()
        bat = ContinuousBatcher(eng)     # scfg.oversub defaults to 1.0
        bat.run(make_trace(5, vocab_size=eng.cfg.vocab_size, seed=2))
        assert bat.oversub == 1.0
        assert not bat.spill_events
        assert bat.virtual_slots == bat.slots
        assert bat.prefix is None


class TestPrefixReuse:
    def test_cached_prefix_bit_identical_to_cold_path(self):
        """A repeated system prompt resolves to a restore plus a tail
        prefill, and the greedy continuation equals cold ``generate``."""
        eng = _engine()
        sys_prompt = _prompt(eng.cfg, 8, 3)
        reqs = [Request(i, np.concatenate([sys_prompt,
                                           _prompt(eng.cfg, 6 + i, 10 + i)]),
                        5) for i in range(3)]
        store = PrefixStore(8 << 20)
        cold = ContinuousBatcher(eng, prefix_store=store)
        cold.run([reqs[0]])
        assert len(store) > 0, "no snapshots taken during prefill"
        warm = ContinuousBatcher(eng, prefix_store=store)
        out = {c.rid: c for c in warm.run(reqs[1:])}
        assert warm.prefix_hits == 2
        assert warm.prefix_tokens_saved >= 2 * len(sys_prompt)
        for r in reqs[1:]:
            np.testing.assert_array_equal(
                out[r.rid].tokens, _solo(eng, r.prompt, r.max_new_tokens),
                err_msg=f"rid={r.rid}")

    def test_identical_prompt_rerun_hits_longest_prefix(self):
        eng = _engine()
        prompt = _prompt(eng.cfg, 20, 4)
        store = PrefixStore(8 << 20)
        ContinuousBatcher(eng, prefix_store=store).run(
            [Request(0, prompt, 4)])
        warm = ContinuousBatcher(eng, prefix_store=store)
        out = warm.run([Request(1, prompt, 4)])[0]
        # chunk budget 8 -> boundaries 8, 16: longest strict prefix is 16
        assert warm.prefix_tokens_saved == 16
        np.testing.assert_array_equal(out.tokens, _solo(eng, prompt, 4))

    def test_store_respects_byte_budget(self):
        store = PrefixStore(100)
        state = {"pos": torch.zeros((1,), dtype=torch.int32),
                 "k": torch.zeros((10,), dtype=torch.int8)}     # 14 bytes
        for i in range(20):
            store.put(np.arange(i + 1, dtype=np.int32), dict(state))
        assert store.bytes <= 100
        assert len(store) <= 100 // 14

    def test_lookup_never_returns_full_prompt(self):
        store = PrefixStore(1 << 20)
        toks = np.arange(8, dtype=np.int32)
        store.put(toks, {"pos": torch.full((1,), 8, dtype=torch.int32)})
        assert store.lookup(toks, max_len=len(toks) - 1) is None
        hit = store.lookup(np.concatenate([toks, [99]]), max_len=8)
        assert hit is not None and hit[0] == 8

    def test_restored_snapshot_is_not_aliased(self):
        """Prefill after a hit writes into a fresh cache: the snapshot the
        store holds is left as it was."""
        eng = _engine()
        prompt = _prompt(eng.cfg, 20, 5)
        store = PrefixStore(8 << 20)
        ContinuousBatcher(eng, prefix_store=store).run(
            [Request(0, prompt, 3)])
        _, state = store.lookup(prompt, max_len=19)
        snap = {k: v.clone() for k, v in state.items()}
        ContinuousBatcher(eng, prefix_store=store).run(
            [Request(1, prompt, 3)])
        for k in snap:
            assert torch.equal(snap[k], state[k]), k


class TestPlanMapping:
    """The plan's K: oversubscription only where every backing tier is
    finite."""

    def test_unbounded_and_two_tier_value_identical(self):
        from repro_torch.chip.h100 import h100_host
        from repro_torch.serve.engine import tier_kv_oversub

        cfg = get_smoke_config("qwen3_14b")
        hbm = ipu_pod4_hbm()
        assert tier_kv_oversub(cfg, hbm, slots=4, cache_capacity=64) == 1.0
        assert tier_kv_oversub(cfg, hbm.with_stacked_dram(), slots=4,
                               cache_capacity=64) == 1.0
        assert tier_kv_oversub(cfg, None, slots=4, cache_capacity=64) == 1.0
        assert tier_kv_oversub(cfg, h100_host(), slots=4,
                               cache_capacity=64) == 1.0

    def test_finite_hierarchy_gets_k_above_one(self):
        from repro_torch.serve.engine import _OVERSUB_MAX, tier_kv_oversub

        cfg = get_smoke_config("qwen3_14b")
        chip = ipu_mk2().with_stacked_dram(1 * GB)
        k = tier_kv_oversub(cfg, chip, slots=2, cache_capacity=64)
        assert 1.0 < k <= _OVERSUB_MAX

    def test_k_scales_with_ring_budget(self):
        from repro_torch.serve.engine import kv_ring_bytes, tier_kv_oversub

        cfg = get_smoke_config("qwen3_14b")
        ring = kv_ring_bytes(cfg, 64)
        # room for 6 rings beyond the smoke weights, none of which spill
        chip = ipu_mk2().with_stacked_dram(6 * ring)
        k = tier_kv_oversub(cfg, chip, slots=2, cache_capacity=64)
        assert k == pytest.approx(3.0)

    def test_serve_config_exposes_plan_k(self):
        from repro_torch.serve.engine import elk_serve_config

        cfg = get_smoke_config("qwen3_14b")
        chip = ipu_mk2().with_stacked_dram(1 * GB)
        sc = elk_serve_config(cfg, batch=2, cache_capacity=64, num_chips=1,
                              pod=chip)
        assert sc.oversub > 1.0
        assert sc.slot_spill_s > 0.0
        assert sc.prefix_cache_bytes > 0
        assert sc.virtual_slots >= 2 * sc.slots
        bat = ContinuousBatcher(ServeEngine(
            cfg, tfm.init_params(torch.Generator().manual_seed(0), cfg,
                                 "cpu"),
            dataclasses.replace(sc, mode="gspmd"), device="cpu"))
        assert bat.virtual_slots == sc.virtual_slots
        assert bat.prefix is not None
        assert bat.prefix.capacity_bytes == sc.prefix_cache_bytes
        sc2 = elk_serve_config(cfg, batch=2, cache_capacity=64,
                               num_chips=4, pod=ipu_pod4_hbm())
        assert sc2.oversub == 1.0
        assert sc2.slot_spill_s == 0.0
        assert sc2.prefix_cache_bytes == 0
        assert sc2.virtual_slots == sc2.slots


class TestTrafficAndTrace:
    def test_summarize_reports_ttft(self):
        eng = _engine()
        reqs = make_trace(4, vocab_size=eng.cfg.vocab_size, seed=1)
        comps = ContinuousBatcher(eng).run(reqs)
        stats = summarize(comps, 1.0)
        assert "p50_ttft_s" in stats and "p99_ttft_s" in stats
        for c in comps:
            assert c.first_token_s >= 0
            assert 0 <= c.ttft_s <= c.latency_s + 1e-9
        sstats = summarize(run_static_trace(eng, reqs), 1.0)
        # lock-step only yields tokens at batch completion: TTFT == latency
        assert sstats["p50_ttft_s"] == sstats["p50_latency_s"]

    def test_spill_events_price_on_the_simulator(self):
        """The per-tier serial servers of the port's simulator re-price the
        batcher's spill events at the planner's price, serialised."""
        from repro_torch.chip.simulator import simulate_kv_traffic
        from repro_torch.core.cost_model import AnalyticCostModel

        chip = ipu_mk2().with_stacked_dram(1 * GB)
        cm = AnalyticCostModel(chip)
        nb = 1 << 20
        one = cm.spill_time(nb, 0, chip.backing_tier)
        res = simulate_kv_traffic(chip, [("spill", nb), ("refill", nb),
                                         ("spill", nb)])
        assert res.total_time == pytest.approx(3 * one)
        assert res.finish == pytest.approx([one, 2 * one, 3 * one])
        res2 = simulate_kv_traffic(chip, [("spill", nb, 0.0),
                                          ("refill", nb, 10 * one)])
        assert res2.total_time == pytest.approx(11 * one)

    def test_batcher_events_price_on_the_simulator(self):
        """A real run's events, on a pod whose plan funds oversubscription:
        the planned spill seconds equal the simulator's serial total."""
        from repro_torch.chip.simulator import simulate_kv_traffic
        from repro_torch.serve.engine import elk_serve_config

        cfg = get_smoke_config("qwen3_14b")
        chip = ipu_mk2().with_stacked_dram(1 * GB)
        sc = dataclasses.replace(elk_serve_config(
            cfg, batch=2, cache_capacity=64, num_chips=1, pod=chip),
            mode="gspmd", prefill_chunk=8)
        eng = ServeEngine(cfg, tfm.init_params(
            torch.Generator().manual_seed(0), cfg, "cpu"), sc, device="cpu")
        bat = ContinuousBatcher(eng, swap_after=2)
        bat.run(make_trace(6, vocab_size=cfg.vocab_size, seed=3))
        assert bat.spill_events
        assert all(nb == eng.slot_state_bytes()
                   for _, nb in bat.spill_events)
        res = simulate_kv_traffic(chip, bat.spill_events)
        assert res.total_time == pytest.approx(bat.planned_spill_s)


def _both(arch: str):
    """(jax cfg, jax params, port cfg, port params), fp32, same weights."""
    jcfg = dataclasses.replace(jax_smoke_config(arch), dtype="float32",
                               param_dtype="float32")
    tcfg = dataclasses.replace(get_smoke_config(arch), dtype="float32",
                               param_dtype="float32")
    jparams = jtfm.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, jparams, tcfg, params_from_jax(
        jax.tree.map(np.asarray, jparams), tcfg, device="cpu")


@pytest.mark.parametrize("arch", DENSE)
def test_oversubscribed_batcher_equals_reference(arch, mesh11):
    """The port's oversubscribed batcher and the reference's, on the same
    weights and trace (K = 2, a prefix store, a shared system prompt on
    half the requests, all arriving at 0): equal tokens, finish order,
    spill events and prefix counters."""
    jcfg, jparams, tcfg, tparams = _both(arch)
    kw = dict(batch=2, cache_capacity=32, prefill_chunk=4,
              kv_dtype="float32")
    tkw = dict(vocab_size=tcfg.vocab_size, prompt_lens=(5, 9, 6, 12),
               max_new=(3, 6, 4, 8), sys_prompt_len=8, sys_prompt_frac=0.5,
               seed=0)
    ref = JaxBatcher(JaxServeEngine(jcfg, mesh11, jparams,
                                    JaxServeConfig(**kw)),
                     oversub=2.0, prefix_store=JaxPrefixStore(4 << 20),
                     swap_after=2)
    got = ContinuousBatcher(ServeEngine(tcfg, tparams, ServeConfig(**kw),
                                        device="cpu"),
                            oversub=2.0, prefix_store=PrefixStore(4 << 20),
                            swap_after=2)
    rcomps = ref.run(jax_make_trace(8, **tkw))
    tcomps = got.run(make_trace(8, **tkw))
    assert [c.rid for c in tcomps] == [c.rid for c in rcomps]
    for a, b in zip(tcomps, rcomps):
        np.testing.assert_array_equal(a.tokens, b.tokens, err_msg=a.rid)
    assert got.spill_events == ref.spill_events
    assert got.spill_events, "the trace never spilled"
    assert (got.prefix_hits, got.prefix_tokens_saved) == (
        ref.prefix_hits, ref.prefix_tokens_saved)
    assert got.prefix_hits > 0
    assert got.ticks == ref.ticks
