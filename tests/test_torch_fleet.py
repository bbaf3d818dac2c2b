"""The fleet tier of the port (``repro_torch/serve/fleet.py``, the batcher's
``handoff``/``adopt`` hooks and the launcher's ``--fleet``), against the JAX
reference on the CPU.

Twins of ``tests/test_fleet.py``: tick pricing, the one-mixed-pod fleet
against the direct batcher, cross-pod migration (bit-identical refill on
another engine, the disaggregated fleet priced and unpriced, over an fp32
and an int8 ring), SLO shedding, role sizing and the fleet sweep.  Every
fleet runs twice, the port's on ``convert.params_from_jax`` of the
reference's weights and the reference's, on the same numpy traces in fp32,
and must give the reference's completions (tokens, finish order, virtual
first-token and finish times to 1e-12), ``summary()``, migration events and
``planned_migration_s``.  The virtual clock makes every time a sum of tick
costs, so the two are equal when the two schedules are.
"""

import dataclasses
import functools
import json

import jax
import numpy as np
import pytest
import torch

from repro.chip.config import GB as JGB
from repro.chip.config import ipu_mk2 as jipu_mk2
from repro.chip.config import ipu_pod4_hbm as jipu_pod4_hbm
from repro.chip.config import tpu_v5e_pod_hier as jtpu_v5e_pod_hier
from repro.chip.dse import fleet_sweep as jfleet_sweep
from repro.chip.topology import fleet_spec as jfleet_spec
from repro.configs import get_smoke_config as jax_smoke_config
from repro.launch import serve as jlaunch
from repro.models import transformer as jtfm
from repro.serve import fleet as jfleet
from repro.serve.batcher import ContinuousBatcher as JaxBatcher
from repro.serve.batcher import make_trace as jax_make_trace
from repro.serve.engine import ServeConfig as JaxServeConfig
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro.serve.engine import elk_serve_config as jelk_serve_config
from repro_torch.chip.config import ipu_pod4_hbm
from repro_torch.chip.dse import fleet_sweep
from repro_torch.chip.simulator import simulate_fleet_traffic
from repro_torch.chip.topology import fleet_spec
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve as launch
from repro_torch.models import transformer as tfm
from repro_torch.serve.batcher import (ContinuousBatcher, Request, make_trace,
                                       summarize)
from repro_torch.serve.engine import (PREFILL_SAT, ServeConfig, ServeEngine,
                                      elk_serve_config)
from repro_torch.serve.fleet import (FleetPod, FleetRouter, PodCosts,
                                     VirtualClock, predict_fleet_rates,
                                     prefill_passes, run_virtual_trace)
from repro_torch.serve.prefix import host_copy, state_bytes

ARCH = "qwen3_14b"
COSTS = dict(decode_step_s=1e-3, tick_overhead_s=5e-4)


@functools.lru_cache(maxsize=None)
def _both(arch: str = ARCH):
    """(jax cfg, jax params, port cfg, port params), fp32, same weights."""
    jcfg = dataclasses.replace(jax_smoke_config(arch), dtype="float32",
                               param_dtype="float32")
    tcfg = dataclasses.replace(get_smoke_config(arch), dtype="float32",
                               param_dtype="float32")
    jparams = jtfm.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, jparams, tcfg, params_from_jax(
        jax.tree.map(np.asarray, jparams), tcfg, device="cpu")


def _engines(mesh, **kw):
    """(reference engine, port engine) on the same weights and knobs."""
    jcfg, jparams, tcfg, tparams = _both()
    scfg = {"batch": 2, "cache_capacity": 64, "prefill_chunk": 8,
            "kv_dtype": "float32", **kw}
    return (JaxServeEngine(jcfg, mesh, jparams, JaxServeConfig(**scfg)),
            ServeEngine(tcfg, tparams, ServeConfig(**scfg), device="cpu"))


def _traces(n=6, **kw):
    """The same trace for both sides."""
    kw = {"vocab_size": _both()[2].vocab_size, "prompt_lens": (8, 12, 16),
          "max_new": (3, 4, 5), **kw}
    return jax_make_trace(n, **kw), make_trace(n, **kw)


def _fleets(mesh, roles, *, chunks=None, priced=False, slo=0.0, **kw):
    """(reference router, port router) over pods of ``roles``, each pod its
    own engine on the shared weights, with prefill chunk ``chunks[i]``."""
    chunks = chunks or [8] * len(roles)
    jpods, tpods = [], []
    for role, chunk in zip(roles, chunks):
        je, te = _engines(mesh, prefill_chunk=chunk, **kw)
        jpods.append(jfleet.FleetPod(je, role,
                                     costs=jfleet.PodCosts(**COSTS)))
        tpods.append(FleetPod(te, role, costs=PodCosts(**COSTS)))
    jfl = jfleet_spec(jipu_pod4_hbm(), len(roles)) if priced else None
    tfl = fleet_spec(ipu_pod4_hbm(), len(roles)) if priced else None
    return (jfleet.FleetRouter(jpods, fleet=jfl, ttft_slo_s=slo),
            FleetRouter(tpods, fleet=tfl, ttft_slo_s=slo))


def _assert_same_completions(got, ref):
    assert [c.rid for c in got] == [c.rid for c in ref]
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.tokens, b.tokens, err_msg=a.rid)
        assert a.finish_s == pytest.approx(b.finish_s, abs=1e-12)
        assert a.first_token_s == pytest.approx(b.first_token_s, abs=1e-12)
        assert a.admitted_s == pytest.approx(b.admitted_s, abs=1e-12)
        assert a.finish_order == b.finish_order


def _assert_same_fleet(got: FleetRouter, ref):
    _assert_same_completions(got.completed, ref.completed)
    assert got.summary() == ref.summary()
    assert got.migration_events == ref.migration_events
    assert got.planned_migration_s == ref.planned_migration_s
    assert got.migrations == ref.migrations
    assert [r.rid for r in got.shed] == [r.rid for r in ref.shed]
    assert got.routed == ref.routed


class TestPodCosts:
    @pytest.mark.parametrize("decoded", [False, True])
    @pytest.mark.parametrize("tokens", [0, 1, 16, 128, 129, 300])
    @pytest.mark.parametrize("moves", [0, 2])
    def test_tick_cost_equals_reference(self, decoded, tokens, moves):
        kw = dict(decode_step_s=1.0, tick_overhead_s=0.5, prefill_sat=128,
                  spill_s=0.25)
        a = PodCosts(**kw).tick_cost(decoded=decoded, prefill_tokens=tokens,
                                     spill_moves=moves)
        b = jfleet.PodCosts(**kw).tick_cost(
            decoded=decoded, prefill_tokens=tokens, spill_moves=moves)
        assert a == b

    def test_tick_cost_arithmetic(self):
        c = PodCosts(decode_step_s=1.0, tick_overhead_s=0.5,
                     prefill_sat=128, spill_s=0.25)
        assert c.tick_cost(decoded=False, prefill_tokens=0) == 0.5
        assert c.tick_cost(decoded=True, prefill_tokens=16) == 2.5
        assert c.tick_cost(decoded=False, prefill_tokens=129) == 2.5
        assert c.tick_cost(decoded=False, prefill_tokens=0,
                           spill_moves=2) == 1.0

    @pytest.mark.parametrize("scfg", [
        dict(steady_interval_s=2e-3, slot_spill_s=1e-4), dict()])
    def test_from_serve_config_equals_reference(self, scfg):
        a = PodCosts.from_serve_config(
            ServeConfig(batch=2, cache_capacity=64, **scfg))
        b = jfleet.PodCosts.from_serve_config(
            JaxServeConfig(batch=2, cache_capacity=64, **scfg))
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert a.prefill_sat == PREFILL_SAT

    @pytest.mark.parametrize("length,budget", [
        (96, 16), (96, 128), (1, 16), (0, 16), (1000, 48), (2047, 256)])
    def test_prefill_passes_equals_reference(self, length, budget):
        assert prefill_passes(length, budget) == \
            jfleet.prefill_passes(length, budget)


class TestDegenerateFleet:
    def test_one_mixed_pod_equals_direct_batcher_and_reference(self, mesh11):
        """A router over one mixed pod is a pass-through: the completions
        and summary of driving the batcher directly on a virtual clock
        (``run_virtual_trace``), and both equal the reference's."""
        jtrace, trace = _traces(arrival_spacing_s=2e-3)
        jfr, fr = _fleets(mesh11, ["mixed"])
        got = fr.run(trace)
        jfr.run(jtrace)
        _assert_same_fleet(fr, jfr)

        vc = VirtualClock()
        bat = ContinuousBatcher(_engines(mesh11)[1], vc)
        ref = run_virtual_trace(bat, trace, PodCosts(**COSTS))
        _assert_same_completions(got, ref)
        direct = summarize(ref, vc.t)
        merged = fr.summary()
        for k, v in direct.items():
            assert merged[k] == v, k

        # a clock that moved after the batcher read it: run_virtual_trace
        # takes t0 afresh, so the times stay relative to its start
        late = VirtualClock()
        bat = ContinuousBatcher(_engines(mesh11)[1], late)
        late.advance(0.5)
        for a, b in zip(run_virtual_trace(bat, trace, PodCosts(**COSTS)),
                        ref):
            assert a.finish_s == pytest.approx(b.finish_s, abs=1e-9)
            assert a.first_token_s == pytest.approx(b.first_token_s,
                                                    abs=1e-9)
        assert merged["routed"] == [len(ref)]
        assert merged["migrations"] == 0 and merged["shed"] == 0

    def test_run_virtual_trace_equals_reference(self, mesh11):
        je, te = _engines(mesh11)
        jtrace, trace = _traces(arrival_spacing_s=1e-3)
        jvc, vc = jfleet.VirtualClock(), VirtualClock()
        jb, tb = JaxBatcher(je, jvc), ContinuousBatcher(te, vc)
        ref = jfleet.run_virtual_trace(jb, jtrace, jfleet.PodCosts(**COSTS))
        got = run_virtual_trace(tb, trace, PodCosts(**COSTS))
        _assert_same_completions(got, ref)
        assert vc.t == jvc.t
        assert summarize(got, vc.t) == summarize(ref, jvc.t)
        with pytest.raises(TypeError):
            run_virtual_trace(ContinuousBatcher(te), trace,
                              PodCosts(**COSTS))

    def test_router_validates_roles(self, mesh11):
        eng = _engines(mesh11)[1]
        with pytest.raises(ValueError):
            FleetRouter([FleetPod(eng, "decode")])
        with pytest.raises(ValueError):
            FleetRouter([FleetPod(eng, "warp")])
        with pytest.raises(ValueError):
            FleetRouter([])
        with pytest.raises(ValueError):
            FleetRouter([FleetPod(eng, "prefill")])
        with pytest.raises(ValueError):
            FleetRouter([FleetPod(eng)], fleet=fleet_spec(ipu_pod4_hbm(), 2))


class TestMigration:
    def test_cross_pod_offload_refill_is_bit_identical(self, mesh11):
        """Offload a slot on engine A, refill it into another slot of a
        different engine B: the continued decode equals the never-migrated
        stream, and the reference's."""
        je, ea = _engines(mesh11)
        eb = _engines(mesh11)[1]
        prompt = np.random.default_rng(3).integers(
            0, ea.cfg.vocab_size, (1, 9)).astype(np.int32)
        solo = ea.generate(torch.from_numpy(np.tile(prompt, (2, 1))),
                           steps=6)[0, 9:].numpy()
        jsolo = np.asarray(je.generate(np.tile(prompt, (2, 1)),
                                       steps=6))[0, 9:]
        np.testing.assert_array_equal(solo, jsolo)

        tok, rc = ea.prefill_chunk(ea.new_request_cache(),
                                   torch.from_numpy(prompt).long())
        ea.insert_slot(0, rc)
        state = ea.offload_slot(0)
        eb.refill_slot(1, state)
        toks = torch.zeros((2,), dtype=torch.int64)
        toks[1] = tok[0]
        got = [int(tok[0])]
        for _ in range(5):
            toks = eb.step(toks)
            got.append(int(toks[1]))
        np.testing.assert_array_equal(np.asarray(got), solo)

    @pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
    def test_disagg_fleet_equals_reference(self, mesh11, kv_dtype):
        """Through the router: every request is prefilled on the prefill
        pod, migrates as a host copy and decodes on the decode pod, with
        the reference's tokens and virtual times, over an fp32 and an int8
        ring; its tokens are those of serving it alone (fp32), the first
        token before the finish."""
        jfr, fr = _fleets(mesh11, ["prefill", "decode"], chunks=[64, 8],
                          kv_dtype=kv_dtype)
        jtrace, trace = _traces()
        got = fr.run(trace)
        jfr.run(jtrace)
        _assert_same_fleet(fr, jfr)
        assert fr.migrations == len(trace) and fr.routed == [len(trace), 0]
        pf, dec = (p.batcher for p in fr.pods)
        assert not pf.completed and pf.decode_ticks == 0
        assert len(dec.completed) == len(trace)
        kinds = [k for k, _ in pf.spill_events]
        assert kinds == ["spill"] * len(trace)
        assert [k for k, _ in dec.spill_events] == ["refill"] * len(trace)
        for c in got:
            assert 0 <= c.first_token_s < c.finish_s
        if kv_dtype == "float32":
            solo = _engines(mesh11)[1]
            by_rid = {r.rid: r for r in trace}
            for c in got:
                r = by_rid[c.rid]
                p = torch.from_numpy(np.tile(r.prompt[None, :], (2, 1)))
                np.testing.assert_array_equal(
                    c.tokens, solo.generate(p, r.max_new_tokens)[0].numpy())

    @pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
    def test_migration_is_charged_and_sim_matches_plan(self, mesh11,
                                                       kv_dtype):
        """A fleet-priced router records the reference's migration events
        (bytes of the request cache, the times they leave, the pods) and
        planned time; the fleet simulator re-serves them within 2x."""
        jfr, fr = _fleets(mesh11, ["prefill", "decode"], chunks=[64, 8],
                          priced=True, kv_dtype=kv_dtype)
        jtrace, trace = _traces()
        fr.run(trace)
        jfr.run(jtrace)
        _assert_same_fleet(fr, jfr)
        assert fr.migrations > 0 and fr.planned_migration_s > 0
        assert len(fr.migration_events) == fr.migrations
        nbytes = state_bytes(fr.pods[0].batcher.engine.new_request_cache())
        assert {nb for nb, *_ in fr.migration_events} == {nbytes}
        assert nbytes == fr.pods[0].batcher.engine.slot_state_bytes()
        res = simulate_fleet_traffic(fr.fleet, fr.migration_events)
        sim = sum(f - at for f, (_, at, _, _) in
                  zip(res.finish, fr.migration_events))
        assert 0.5 <= sim / fr.planned_migration_s <= 2.0
        assert res.busy["fleet"] > 0

    def test_unpriced_fleet_migrates_for_free_but_counts(self, mesh11):
        jfr, fr = _fleets(mesh11, ["prefill", "decode", "decode"],
                          chunks=[64, 8, 8])
        jtrace, trace = _traces(n=8, arrival_spacing_s=1e-3)
        fr.run(trace)
        jfr.run(jtrace)
        _assert_same_fleet(fr, jfr)
        assert fr.migrations == 8
        assert fr.planned_migration_s == 0.0 and fr.migration_events == []

    def test_adopt_at_k1_slots_through_refill_ahead(self, mesh11):
        """``adopt`` parks a request that the refill-ahead path slots at the
        next tick, on a batcher at K = 1; nothing generated is refused."""
        te = _engines(mesh11)[1]
        src = _engines(mesh11)[1]
        prompt = np.arange(5, dtype=np.int32)
        tok, rc = src.prefill_chunk(src.new_request_cache(),
                                    torch.from_numpy(prompt[None]).long())
        bat = ContinuousBatcher(te)
        assert bat.oversub == 1.0
        req = Request(7, prompt, 4)
        with pytest.raises(ValueError, match="nothing generated"):
            bat.adopt(req, {}, [], 0.0)
        bat.adopt(req, host_copy(rc), [int(tok[0])], 0.0, admitted_s=0.0)
        assert bat.busy and 7 in bat.spilled
        while bat.busy:
            bat.tick()
        (c,) = bat.completed
        solo = src.generate(torch.from_numpy(np.tile(prompt[None], (2, 1))),
                            4)[0].numpy()
        np.testing.assert_array_equal(c.tokens, solo)
        assert [k for k, _ in bat.spill_events] == ["refill"]


class TestSLO:
    def test_shedding_equals_reference_and_keeps_p99_under_target(
            self, mesh11):
        n, slo = 8, 15e-3
        kw = dict(n=n, prompt_lens=(32,), max_new=(3,))
        jfr, fr = _fleets(mesh11, ["mixed"], chunks=[16], slo=slo, batch=1)
        jtrace, trace = _traces(**kw)
        done = fr.run(trace)
        jfr.run(jtrace)
        _assert_same_fleet(fr, jfr)
        assert 0 < len(done) < n and len(fr.shed) == n - len(done)
        assert max(c.ttft_s for c in done) <= slo + 1e-9
        assert fr.summary()["shed"] == len(fr.shed)

        jfr2, fr2 = _fleets(mesh11, ["mixed"], chunks=[16], batch=1)
        jtrace, trace = _traces(**kw)
        done2 = fr2.run(trace)
        jfr2.run(jtrace)
        _assert_same_fleet(fr2, jfr2)
        assert len(done2) == n and max(c.ttft_s for c in done2) > slo

    def test_prediction_upper_bounds_realized_ttft(self, mesh11):
        fr = FleetRouter([FleetPod(_engines(mesh11)[1], "mixed",
                                   costs=PodCosts(**COSTS))])
        preds = {}
        orig = fr.predict_ttft

        def spy(index, plen, now):
            t = orig(index, plen, now)
            preds.setdefault(plen, []).append(t)
            return t

        fr.predict_ttft = spy
        _, trace = _traces(arrival_spacing_s=1e-3)
        by_rid = {r.rid: r for r in trace}
        for c in fr.run(trace):
            assert c.ttft_s <= max(preds[len(by_rid[c.rid].prompt)]) + 1e-9

    def test_two_mixed_pods_share_the_load_as_the_reference(self, mesh11):
        jfr, fr = _fleets(mesh11, ["mixed", "mixed"], slo=12e-3)
        jtrace, trace = _traces(n=10, arrival_spacing_s=5e-4)
        fr.run(trace)
        jfr.run(jtrace)
        _assert_same_fleet(fr, jfr)
        assert all(n > 0 for n in fr.routed)


class TestRoleSizing:
    @pytest.mark.parametrize("role", ["mixed", "prefill", "decode"])
    @pytest.mark.parametrize("cache", [64, 256])
    def test_role_sizing_equals_reference(self, role, cache):
        jcfg, _, tcfg, _ = _both()
        a = elk_serve_config(tcfg, batch=2, cache_capacity=cache, role=role)
        b = jelk_serve_config(jcfg, batch=2, cache_capacity=cache, role=role)
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        want = {"prefill": min(PREFILL_SAT, cache), "decode": 16}
        if role in want:
            assert a.prefill_chunk == want[role]
        with pytest.raises(ValueError):
            elk_serve_config(tcfg, batch=2, cache_capacity=cache,
                             role="router")


class TestFleetSweep:
    @pytest.mark.parametrize("ratios", [(0.25,), (0.25, 0.0625)])
    def test_rows_equal_reference(self, ratios):
        kw = dict(smoke=True, prompt_len=1024, n_prefill_list=(1, 2),
                  inter_bw_ratios=ratios)
        rows = fleet_sweep(**kw)
        assert rows == jfleet_sweep(**kw)
        assert len(rows) == 2 * len(ratios)
        one = next(r for r in rows if r["n_prefill"] == 1)
        assert one["disagg_won"] and one["migration_ms"] > 0

    def test_predict_fleet_rates_equals_reference(self):
        for n_pf in (1, 2, 3):
            kw = dict(num_pods=4, n_prefill=n_pf, slots=4, prompt_len=300)
            assert predict_fleet_rates(PodCosts(**COSTS), **kw) == \
                jfleet.predict_fleet_rates(jfleet.PodCosts(**COSTS), **kw)
        for bad in (0, 4):
            with pytest.raises(ValueError):
                predict_fleet_rates(PodCosts(**COSTS), num_pods=4,
                                    n_prefill=bad, slots=4, prompt_len=64)


class TestLauncher:
    ARGV = ["--arch", "qwen3-14b", "--smoke", "--device", "cpu", "--mode",
            "gspmd", "--trace", "6", "--fleet", "2", "--disagg"]

    def test_fleet_summary_equals_reference(self, mesh11):
        """``--fleet 2 --disagg`` on the same pod and weights: the port's
        ``_run_fleet`` summary is the reference's."""
        args = launch.parse_args(self.ARGV)
        je, te = _engines(mesh11, batch=args.batch,
                          cache_capacity=args.cache, prefill_chunk=32)
        got = launch._run_fleet(te, args, te.cfg.vocab_size)
        want = jlaunch._run_fleet(je, args, je.cfg.vocab_size)
        assert got == want
        assert got["roles"] == ["prefill", "decode"] and got["disagg"]
        assert got["migrations"] == 6

    def test_fleet_runs_through_main(self, tmp_path, capsys):
        out = tmp_path / "stats.json"
        launch.main(self.ARGV + ["--ttft-slo-ms", "50", "--json-out",
                                 str(out)])
        stats = json.loads(out.read_text())
        assert stats["fleet"]["pods"] == 2
        assert stats["fleet"]["ttft_slo_ms"] == 50.0
        assert "fleet:" in capsys.readouterr().out

    @pytest.mark.parametrize("flag", [["--stacked-gb", "1"],
                                      ["--pipeline-pod", "4"]])
    def test_planner_knobs_equal_reference(self, flag, capsys):
        """``--stacked-gb`` / ``--pipeline-pod`` plan on the reference's
        modelled pods: the launcher's knobs are the reference's
        ``elk_serve_config`` on the same pod, and it says whose figures
        they are."""
        args = launch.parse_args(["--arch", "qwen3-14b", "--smoke", "--device",
                             "cpu", "--batch", "2", "--cache", "64"] + flag)
        tcfg, jcfg = get_smoke_config(ARCH), jax_smoke_config(ARCH)
        got = launch.serve_config(tcfg, args)
        pod = (jipu_mk2().with_stacked_dram(int(args.stacked_gb * JGB))
               if args.stacked_gb else
               jtpu_v5e_pod_hier(groups=args.pipeline_pod))
        want = jelk_serve_config(jcfg, batch=2, cache_capacity=64,
                                 kv_dtype="bfloat16",
                                 pipeline=args.pipeline_pod > 0, pod=pod)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        out = capsys.readouterr().out
        assert "not times taken on the H100" in out
        if args.stacked_gb:
            assert got.oversub > 1.0 and "oversub K=" in out
        else:
            assert got.steady_interval_s > 0 and "steady_interval=" in out

    def test_stacked_gb_serves_through_main(self, capsys):
        launch.main(["--arch", "qwen3-14b", "--smoke", "--device", "cpu",
                     "--stacked-gb", "1", "--batch", "2", "--steps", "4",
                     "--cache", "64"])
        out = capsys.readouterr().out
        assert "generated 4 tokens x 2 requests" in out

    def test_enc_dec_fleet_raises_the_reference_error(self, mesh11):
        cfg = get_smoke_config("whisper_tiny")
        eng = ServeEngine(cfg, tfm.init_params(
            torch.Generator().manual_seed(0), cfg, "cpu"),
            ServeConfig(batch=2, cache_capacity=32), device="cpu")
        args = launch.parse_args(["--arch", "whisper-tiny", "--smoke", "--device",
                             "cpu", "--trace", "2", "--fleet", "1"])
        with pytest.raises(ValueError, match="per-slot caches"):
            launch._run_fleet(eng, args, cfg.vocab_size)
