"""Weight streaming (``elk_stream``) of the port, on the CPU.

Twins of the reference's ``TestServe.test_stream_equals_gspmd``,
``test_prefetch_depth_invariance`` (``tests/test_runtime.py``) and
``test_wraparound_stream_equals_gspmd`` (``tests/test_serve_batcher.py``),
the port's ``elk_stream`` tokens against the JAX ``elk_stream`` engine on
converted weights, the window's copies (how many, in which order, into
which buffer), and the launcher's default path.  The MoE configs stream
with their dense and MoE layers in layouts of their own and each MoE
layer's experts fetched after its router: tokens against ``gspmd`` and the
reference, the experts a decode step copies, the views of mixed layouts,
the expert buffer in rounds, and the launcher.  On the CPU the window
logic is the same as on the card, with plain tensors and no streams; the
card runs it in ``chip_smoke.py``.  Tokens must be equal (fp32).
"""

import dataclasses
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import transformer as jtfm
from repro.serve.batcher import ContinuousBatcher as JaxBatcher
from repro.serve.batcher import make_trace as jax_make_trace
from repro.serve.engine import ServeConfig as JaxServeConfig
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.models import transformer as tfm
from repro_torch.serve import stream
from repro_torch.serve.batcher import ContinuousBatcher, make_trace
from repro_torch.serve.engine import ServeConfig, ServeEngine

# the dense configs (the MoE configs' tests are below)
ARCHS = ["qwen3_14b", "llama2_13b", "gemma_7b", "opt_30b", "h2o_danube_1_8b",
         "gemma2_27b", "llama2_70b", "dit_xl"]


def _params(cfg, seed: int = 0) -> dict:
    return tfm.init_params(torch.Generator().manual_seed(seed), cfg, "cpu")


def _fp32(arch: str):
    return dataclasses.replace(get_smoke_config(arch), dtype="float32",
                               param_dtype="float32")


def _prompts(cfg, batch: int, length: int, seed: int = 0) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (batch, length)).astype(np.int64))


@pytest.mark.parametrize("arch", ARCHS)
def test_stream_equals_gspmd(arch):
    cfg = get_smoke_config(arch)
    params = _params(cfg)
    prompts = _prompts(cfg, 2, 8)
    outs = {}
    for mode in ("gspmd", "elk_stream"):
        eng = ServeEngine(cfg, params, ServeConfig(
            batch=2, cache_capacity=32, mode=mode, prefetch_depth=2), "cpu")
        outs[mode] = eng.generate(prompts, steps=5)
    assert torch.equal(outs["gspmd"], outs["elk_stream"])


def test_prefetch_depth_invariance():
    """The ELK preload number changes scheduling, never results."""
    cfg = dataclasses.replace(get_smoke_config("qwen3_14b"), num_layers=5)
    params = _params(cfg)
    prompts = _prompts(cfg, 2, 6)
    ref = None
    for p in (1, 2, 4, 8):
        eng = ServeEngine(cfg, params, ServeConfig(
            batch=2, cache_capacity=16, mode="elk_stream",
            prefetch_depth=p), "cpu")
        assert eng.params["layers"].depth == min(p, 5)
        out = eng.generate(prompts, steps=4)
        if ref is None:
            ref = out
        assert torch.equal(ref, out)


def test_wraparound_stream_equals_gspmd():
    """elk_stream and gspmd agree under ring-buffer wraparound too."""
    cfg = get_smoke_config("h2o_danube_1_8b")   # SWA family
    params = _params(cfg)
    prompts = _prompts(cfg, 2, 12)
    outs = {}
    for mode in ("gspmd", "elk_stream"):
        eng = ServeEngine(cfg, params, ServeConfig(
            batch=2, cache_capacity=16, mode=mode), "cpu")
        outs[mode] = eng.generate(prompts, steps=10)
    assert torch.equal(outs["gspmd"], outs["elk_stream"])


MOE = ["llama4_maverick_400b_a17b", "kimi_k2_1t_a32b"]


@pytest.mark.parametrize("arch", ["qwen3_14b", "h2o_danube_1_8b", *MOE])
def test_stream_tokens_equal_reference(arch, mesh11):
    """The port's ``elk_stream`` engine against the reference's, on the same
    converted weights, lock-step and through the continuous batcher; on the
    MoE configs the port fetches each MoE layer's picked experts after its
    router, the reference gathers whole blocks."""
    jcfg = dataclasses.replace(jax_smoke_config(arch), dtype="float32",
                               param_dtype="float32")
    tcfg = _fp32(arch)
    jparams = jtfm.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    kw = dict(batch=2, cache_capacity=16, mode="elk_stream",
              prefetch_depth=2, prefill_chunk=8, kv_dtype="float32")
    jeng = JaxServeEngine(jcfg, mesh11, jparams, JaxServeConfig(**kw))
    teng = ServeEngine(tcfg, tparams, ServeConfig(**kw), device="cpu")
    prompts = _prompts(tcfg, 2, 10, seed=3)
    ref = np.asarray(jeng.generate(jnp.asarray(prompts.numpy(), jnp.int32),
                                   steps=8))
    np.testing.assert_array_equal(teng.generate(prompts, steps=8).numpy(),
                                  ref)
    ref = {c.rid: c.tokens for c in JaxBatcher(jeng).run(
        jax_make_trace(6, vocab_size=jcfg.vocab_size, seed=4))}
    got = {c.rid: c.tokens for c in ContinuousBatcher(teng).run(
        make_trace(6, vocab_size=tcfg.vocab_size, seed=4))}
    assert sorted(got) == sorted(ref) == list(range(6))
    for rid in ref:
        np.testing.assert_array_equal(got[rid], ref[rid], err_msg=rid)


@pytest.mark.parametrize("p", [1, 2, 3, 5])
def test_window_copies_and_their_order(p):
    """Every pass copies each layer once: layers 0..p-1 up front, then layer
    i + p into layer i's buffer right after layer i computed, so a buffer
    is refilled only after the compute that read it, and each layer
    computes after its own copy."""
    cfg = dataclasses.replace(get_smoke_config("qwen3_14b"), num_layers=5)
    eng = ServeEngine(cfg, _params(cfg), ServeConfig(
        batch=1, cache_capacity=16, mode="elk_stream", prefetch_depth=p),
        "cpu")
    ls = eng.params["layers"]
    logits, cache = eng.prefill(_prompts(cfg, 1, 6))
    assert ls.copies == 5
    eng.decode(torch.argmax(logits[:, -1], dim=-1), cache)
    assert ls.copies == 10
    n, w = 5, min(p, 5)
    want = [("copy", i, i) for i in range(w)]
    for i in range(n):
        want.append(("compute", i, i % w))
        if i + w < n:
            want.append(("copy", i + w, i % w))
    assert ls.log == want
    # each buffer holds at most one layer between its copy and its compute
    held: dict = {}
    for what, layer, slot in ls.log:
        if what == "copy":
            assert slot not in held
            held[slot] = layer
        else:
            assert held.pop(slot) == layer


def test_stream_weights_are_the_layers():
    """The window's views hold each layer's weights exactly, in the
    layer's own structure, shapes and types."""
    cfg = get_smoke_config("opt_30b")          # biases: more leaves
    params = _params(cfg)
    ls = stream.LayerStream(params["layers"], "cpu", depth=2)
    assert ls.layer_bytes % 256 == 0 and ls.expert_bytes == 0
    for li in (0, 1):
        ls.issue(li, 0)
        got = ls.acquire(li, 0)
        ref = params["layers"][li]
        for group in ref:
            if isinstance(ref[group], dict):
                for name, t in ref[group].items():
                    assert got[group][name].dtype == t.dtype
                    assert torch.equal(got[group][name], t)
            else:
                assert torch.equal(got[group], ref[group])
    bad = [params["layers"][0], {**params["layers"][1], "ln1": torch.zeros(3)}]
    with pytest.raises(ValueError, match="layer 1"):
        stream.LayerStream(bad, "cpu", depth=1, like=params["layers"])


def test_streamed_init_draws_the_same_weights():
    """``init_streamed_params`` makes ``init_params``' weights, layer for
    layer in the host copy, and an engine on it gives the resident
    engine's tokens."""
    cfg = _fp32("qwen3_14b")
    params = _params(cfg)
    sparams = stream.init_streamed_params(torch.Generator().manual_seed(0),
                                          cfg, "cpu", depth=2)
    ls = sparams["layers"]
    assert ls.n == cfg.num_layers and ls.depth == 2
    for key in ("embed", "final_norm", "lm_head"):
        assert torch.equal(sparams[key], params[key])
    for li, layer in enumerate(params["layers"]):
        for (path, off, shape, dtype), (_, t) in zip(
                ls.layouts[li], stream._leaves(layer)):
            assert torch.equal(stream._view(ls.host[li], off, shape, dtype),
                               t), (li, path)
    prompts = _prompts(cfg, 2, 8)
    kw = dict(batch=2, cache_capacity=32, prefetch_depth=2)
    got = ServeEngine(cfg, sparams, ServeConfig(mode="elk_stream", **kw),
                      "cpu").generate(prompts, steps=4)
    ref = ServeEngine(cfg, params, ServeConfig(**kw), "cpu").generate(
        prompts, steps=4)
    assert torch.equal(got, ref)


def test_stream_holds_one_drawn_layer_at_a_time():
    """``LayerStream`` keeps no drawn layer: when the next is drawn, the
    last one is already gone (so drawing on the card never holds the
    decoder), and a wrong count of layers raises."""
    cfg = dataclasses.replace(get_smoke_config("qwen3_14b"), num_layers=4)
    layers = _params(cfg)["layers"]

    def draw(n):
        last = None
        for li in range(n):
            assert last is None or last() is None, f"layer {li - 1} held"
            layer = {g: ({k: t.clone() for k, t in v.items()}
                         if isinstance(v, dict) else v.clone())
                     for g, v in layers[li % 4].items()}
            last = weakref.ref(layer["attn"]["w_q"])
            yield layer
            del layer

    ls = stream.LayerStream(draw(4), "cpu", depth=2, like=layers)
    ls.issue(3, 0)
    assert torch.equal(ls.acquire(3, 0)["attn"]["w_q"],
                       layers[3]["attn"]["w_q"])
    for n in (3, 5):
        with pytest.raises(ValueError, match="layers"):
            stream.LayerStream(draw(n), "cpu", depth=2, like=layers)


@pytest.mark.parametrize("which", ["decode_step", "decode_slots"])
def test_streaming_decode_passes_equal_resident(which):
    """``streaming_decode_step`` / ``streaming_decode_slots`` (the
    reference's names) give the resident pass's logits and cache."""
    cfg = _fp32("qwen3_14b")
    params = _params(cfg)
    sparams = {**params, "layers": stream.LayerStream(params["layers"],
                                                      "cpu", depth=2)}
    spec = tfm.CacheSpec(capacity=16, batch=2,
                         per_slot=which == "decode_slots")
    prompts = _prompts(cfg, 2, 6)
    outs = []
    for fn, p in ((getattr(tfm, which), params),
                  (getattr(stream, f"streaming_{which}"), sparams)):
        cache = tfm.init_cache(cfg, spec, "cpu")
        if spec.per_slot:
            for t in range(prompts.shape[1]):
                _, cache = tfm.decode_slots(params, cfg, prompts[:, t], cache)
        else:
            _, cache = tfm.prefill(params, cfg, prompts, cache)
        logits, cache = fn(p, cfg, prompts[:, -1], cache)
        outs.append((logits, cache["k"]))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])


def test_engines_share_one_host_copy():
    """A second engine built on the first one's ``LayerStream`` streams
    from the same host copy, and the slot path streams too."""
    cfg = _fp32("qwen3_14b")
    params = _params(cfg)
    eng = ServeEngine(cfg, params, ServeConfig(
        batch=2, cache_capacity=32, mode="elk_stream", prefetch_depth=2),
        "cpu")
    slot = ServeEngine(cfg, dict(eng.params), ServeConfig(
        batch=2, cache_capacity=32, mode="elk_stream", prefetch_depth=2,
        prefill_chunk=8), "cpu")
    assert slot.params["layers"] is eng.params["layers"]
    resident = ServeEngine(cfg, params, ServeConfig(
        batch=2, cache_capacity=32, prefill_chunk=8), "cpu")
    trace = make_trace(4, vocab_size=cfg.vocab_size, seed=6)
    before = eng.params["layers"].copies
    got = {c.rid: c.tokens for c in ContinuousBatcher(slot).run(trace)}
    ref = {c.rid: c.tokens for c in ContinuousBatcher(resident).run(trace)}
    assert eng.params["layers"].copies > before
    for rid in ref:
        np.testing.assert_array_equal(got[rid], ref[rid])


def test_launcher_default_is_planned_elk_stream(capsys):
    """``--device cpu --smoke`` runs the reference's default: elk_stream
    with the knobs the planner chose on one H100; ``--pipeline-pod`` and
    ``--stacked-gb`` plan on the reference's modelled pods instead."""
    from repro_torch.launch import serve
    serve.main(["--arch", "qwen3-14b", "--smoke", "--device", "cpu",
                "--batch", "2", "--steps", "4", "--cache", "64"])
    out = capsys.readouterr().out
    assert "ELK scheduler: prefetch_depth=" in out and "prefill_chunk=" in out
    assert "generated 4 tokens x 2 requests" in out
    serve.main(["--arch", "qwen3-14b", "--smoke", "--device", "cpu",
                "--batch", "2", "--steps", "4", "--cache", "64",
                "--prefetch-depth", "2"])
    assert "ELK scheduler" not in capsys.readouterr().out
    # the reference's modelled pods plan the knobs, and the launcher says
    # whose figures they are
    for flag in ("--pipeline-pod", "--stacked-gb"):
        serve.main(["--arch", "qwen3-14b", "--smoke", "--device", "cpu",
                    "--batch", "2", "--steps", "4", "--cache", "64", flag,
                    "2"])
        out = capsys.readouterr().out
        assert "planned on the modelled pod" in out
        assert "not times taken on the H100" in out
        assert "generated 4 tokens x 2 requests" in out


UNIFORM = dict(moe_first_dense=0, moe_every=1, moe_offset=0)


def _moe_cfg(arch: str, depth: int = 0, uniform: bool = False, fp32=False):
    cfg = _fp32(arch) if fp32 else get_smoke_config(arch)
    return dataclasses.replace(cfg, num_layers=depth or cfg.num_layers,
                               **(UNIFORM if uniform else {}))


def _serve(cfg, params, prompts, mode: str, p: int = 2, steps: int = 4):
    eng = ServeEngine(cfg, params, ServeConfig(
        batch=prompts.shape[0], cache_capacity=32, mode=mode,
        prefetch_depth=p, prefill_chunk=8), "cpu")
    return eng, eng.generate(prompts, steps=steps)


@pytest.mark.parametrize("arch", MOE)
def test_elk_stream_of_moe_serves(arch):
    """``elk_stream`` of an MoE config serves at every entry point: the
    layers drawn into the stream by ``init_streamed_params`` are the ones
    ``init_params`` draws (records and expert banks), and engines on them
    and on resident layers handed over give ``gspmd``'s tokens, with the
    expert buffer sized ``min(E, rows k)`` for the largest pass."""
    cfg = get_smoke_config(arch)
    params = _params(cfg)
    sparams = stream.init_streamed_params(torch.Generator().manual_seed(0),
                                          cfg, "cpu", 2)
    ls = sparams["layers"]
    for li, layer in enumerate(params["layers"]):
        ls.issue(li, 0)
        got = ls.acquire(li, 0)
        assert torch.equal(got["attn"]["w_q"], layer["attn"]["w_q"])
        if "moe" in layer:
            e = cfg.moe_experts - 1
            bank = ls.banks[li][e * ls.expert_bytes:(e + 1) * ls.expert_bytes]
            for path, off, shape, dtype in ls.expert_layout:
                assert torch.equal(stream._view(bank, off, shape, dtype),
                                   layer["moe"][path[-1]][e])
    prompts = _prompts(cfg, 2, 6)
    eng, ref = _serve(cfg, params, prompts, "gspmd")
    assert ref.shape == (2, 10)
    for p in (sparams, params):
        eng, out = _serve(cfg, p, prompts, "elk_stream")
        assert torch.equal(out, ref)
        assert eng.params["layers"].expert_slots == min(
            cfg.moe_experts, 2 * 32 * cfg.moe_top_k)


def test_elk_stream_of_uniform_moe_serves():
    """A config whose every layer is MoE (no dense prefix, an MoE layer
    every layer) streams too: one layout, every layer's experts fetched
    after its router; tokens equal ``gspmd``'s."""
    cfg = _moe_cfg("kimi_k2_1t_a32b", uniform=True)
    assert set(tfm.layer_kinds(cfg)) == {"moe"}
    params = _params(cfg)
    sparams = stream.init_streamed_params(torch.Generator().manual_seed(0),
                                          cfg, "cpu", 2)
    assert all(bank is not None for bank in sparams["layers"].banks)
    prompts = _prompts(cfg, 2, 6)
    _, ref = _serve(cfg, params, prompts, "gspmd")
    eng, out = _serve(cfg, sparams, prompts, "elk_stream")
    assert torch.equal(out, ref)
    assert eng.params["layers"].expert_copies > 0


@pytest.mark.parametrize("arch,depth,uniform", [
    ("llama4_maverick_400b_a17b", 2, False),
    ("llama4_maverick_400b_a17b", 3, False),
    ("llama4_maverick_400b_a17b", 4, False),
    ("llama4_maverick_400b_a17b", 6, False),
    ("kimi_k2_1t_a32b", 3, False),
    ("kimi_k2_1t_a32b", 5, False),
    ("kimi_k2_1t_a32b", 2, True),
    ("kimi_k2_1t_a32b", 4, True),
    ("kimi_k2_1t_a32b", 6, True)])
def test_moe_stream_equals_gspmd_at_depths(arch, depth, uniform):
    """Streamed MoE against resident at depths the reference's
    ``block_structure`` takes, through windows of 1-3 layers: equal tokens
    (the batcher's are held by the reference and rounds tests)."""
    cfg = _moe_cfg(arch, depth, uniform)
    tfm.block_structure(cfg)
    params = _params(cfg)
    prompts = _prompts(cfg, 2, 7, seed=depth)
    _, ref = _serve(cfg, params, prompts, "gspmd", steps=5)
    for p in (1, 2, 3):
        _, out = _serve(cfg, params, prompts, "elk_stream", p, steps=5)
        assert torch.equal(out, ref), p


@pytest.mark.parametrize("arch,uniform", [(a, False) for a in MOE] + [
    ("kimi_k2_1t_a32b", True)])
def test_decode_copies_exactly_the_picked_experts(arch, uniform, monkeypatch):
    """A streamed decode step copies, in every MoE layer and after its
    router, exactly the experts the router picked for the step's rows,
    once each and in order; no unpicked expert, and none in a dense layer.
    The bytes of the pass are the layers' records and the fetched experts,
    against the host copy a whole-layer stream would move."""
    from repro_torch.models import moe as moe_mod
    cfg = _moe_cfg(arch, 4, uniform)
    eng = ServeEngine(cfg, _params(cfg), ServeConfig(
        batch=1, cache_capacity=16, mode="elk_stream", prefetch_depth=2),
        "cpu")
    ls = eng.params["layers"]
    logits, cache = eng.prefill(_prompts(cfg, 1, 6))
    route = moe_mod.router_weights
    picked = {}

    def traced(logits, top_k):
        gates, idx = route(logits, top_k)
        layer = [ev for ev in ls.log if ev[0] == "compute"][-1][1]
        picked[layer] = sorted(set(idx.flatten().tolist()))
        ls.log.append(("router", layer, -1))
        return gates, idx

    monkeypatch.setattr(moe_mod, "router_weights", traced)
    eng.decode(torch.argmax(logits[:, -1], dim=-1), cache)
    kinds = tfm.layer_kinds(cfg)
    assert sorted(picked) == [i for i, k in enumerate(kinds) if k == "moe"]
    fetched = 0
    for li in range(cfg.num_layers):
        at = ls.log.index(("compute", li, li % 2))
        got = [e for what, layer, e in ls.log if what == "expert"
               and layer == li]
        if kinds[li] == "dense":
            assert got == [] and ("router", li, -1) not in ls.log
            continue
        first = ls.log.index(("expert", li, got[0]))
        assert at < ls.log.index(("router", li, -1)) < first
        assert ls.log[first:first + len(got)] == [
            ("expert", li, e) for e in got]
        assert got == picked[li]
        fetched += len(got)
    assert ls.bytes == {"window": sum(h.numel() for h in ls.host),
                        "experts": fetched * ls.expert_bytes}
    assert sum(ls.bytes.values()) < ls.host_bytes


@pytest.mark.parametrize("arch", MOE)
def test_mixed_layouts_keep_each_layers_views(arch):
    """Dense and MoE layers through one buffer: each copy moves the layer's
    own record, the views follow the layer in the buffer and hold its
    weights, each weight on 256 bytes; the experts come from the expert
    buffer, one round or several, and an expert that was not fetched
    raises."""
    cfg = _moe_cfg(arch, 3)
    layers = _params(cfg)["layers"]
    ls = stream.LayerStream(layers, "cpu", depth=1)
    sizes = [h.numel() for h in ls.host]
    assert len(set(sizes)) == 2 and ls.layer_bytes == max(sizes)
    buf = ls.buffers[0]
    for li, layer in enumerate(layers):
        ls.bytes["window"] = 0
        ls.issue(li, 0)
        assert ls.bytes["window"] == sizes[li]
        w = ls.acquire(li, 0)
        for path, t in stream._split(layer)[0]:
            got = w
            for key in path:
                got = got[key]
            assert got.dtype == t.dtype and torch.equal(got, t), (li, path)
            assert (got.data_ptr() - buf.data_ptr()) % 256 == 0
        if "moe" not in layer:
            assert "moe" not in w
            continue
        experts = w["moe"]["experts"]
        with pytest.raises(RuntimeError, match="reserve_experts"):
            next(experts.rounds([0]))
        for slots in (1, 3, cfg.moe_experts):
            ls.reserve_experts(slots)
            assert ls.expert_slots == slots
            want = list(range(cfg.moe_experts))
            for group in experts.rounds(want):
                assert len(group) <= slots
                for e in group:
                    for name, t in experts.weights(e).items():
                        assert torch.equal(t, layer["moe"][name][e])
                        assert (t.data_ptr()
                                - ls.expert_buffer.data_ptr()) % 256 == 0
                with pytest.raises(RuntimeError, match="not in the expert"):
                    experts.weights(want[-1] + 1)
        ls.expert_slots, ls.expert_buffer = 0, None


@pytest.mark.parametrize("arch", MOE)
def test_expert_rounds_give_the_same_tokens(arch, monkeypatch):
    """An expert buffer smaller than a pass's touched experts (what a card
    too small for a prefill's bank gets) runs them in rounds: the same
    tokens, lock-step and continuous, and every round's experts fetched
    after the last product of the round before."""
    cfg = _fp32(arch)
    params = _params(cfg)
    monkeypatch.setattr(stream, "_expert_cap", lambda device, nbytes: 1)
    prompts = _prompts(cfg, 2, 8)
    _, ref = _serve(cfg, params, prompts, "gspmd", steps=5)
    eng, out = _serve(cfg, params, prompts, "elk_stream", steps=5)
    assert eng.params["layers"].expert_slots == 1
    assert torch.equal(out, ref)
    trace = make_trace(3, vocab_size=cfg.vocab_size, seed=2)
    want = {c.rid: c.tokens for c in ContinuousBatcher(ServeEngine(
        cfg, params, ServeConfig(batch=2, cache_capacity=32,
                                 prefill_chunk=8), "cpu")).run(trace)}
    got = {c.rid: c.tokens for c in ContinuousBatcher(eng).run(trace)}
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])


@pytest.mark.parametrize("arch", MOE)
def test_launcher_serves_moe_in_every_mode(arch, capsys):
    """The launcher serves the MoE ids in its default ``elk_stream`` mode,
    with the planner's window and with a fixed one, lock-step and
    continuous, printing the window and the expert buffer it allocated;
    ``--mode gspmd`` serves them lock-step and continuous too."""
    from repro_torch.launch import serve
    dashed = arch.replace("_", "-")
    base = ["--arch", dashed, "--smoke", "--device", "cpu"]
    serve.main(base + ["--batch", "2", "--steps", "3", "--cache", "32"])
    out = capsys.readouterr().out
    assert "ELK scheduler: prefetch_depth=" in out
    assert "expert buffer of 4 experts" in out
    assert "generated 3 tokens x 2 requests" in out
    serve.main(base + ["--batch", "2", "--steps", "3", "--cache", "32",
                       "--prefetch-depth", "2"])
    out = capsys.readouterr().out
    assert "ELK scheduler" not in out
    assert "prefetch_depth=2; window of 2" in out
    serve.main(base + ["--trace", "3", "--cache", "64"])
    out = capsys.readouterr().out
    assert "elk_stream:" in out and "continuous:" in out
    serve.main(base + ["--mode", "gspmd", "--batch", "2", "--steps", "3",
                       "--cache", "32"])
    out = capsys.readouterr().out
    assert "generated 3 tokens x 2 requests" in out and "elk_stream" not in out
    serve.main(base + ["--mode", "gspmd", "--trace", "3", "--cache", "64"])
    assert "continuous:" in capsys.readouterr().out


@pytest.mark.parametrize("arch", MOE)
def test_planner_knobs_for_moe(arch):
    """``elk_serve_config`` plans an MoE config with the port's copy of
    the planner (expert weights as late-bound preloads) on one H100."""
    from repro_torch.chip.h100 import h100_host
    from repro_torch.serve.engine import elk_serve_config
    scfg = elk_serve_config(get_smoke_config(arch), batch=2,
                            cache_capacity=64, pod=h100_host())
    assert scfg.mode == "elk_stream" and scfg.prefetch_depth >= 1
    assert 1 <= scfg.prefill_chunk <= 64


# the families with state in the cache (RWKV: none but the state; hybrid: an
# SSM state beside the ring) and the VLM, all streamed like the others
STATE_ARCHS = ["rwkv6_7b", "hymba_1_5b", "internvl2_1b"]


@pytest.mark.parametrize("arch", STATE_ARCHS)
def test_state_families_stream_equal_resident_and_reference(
        arch, mesh11, monkeypatch):
    """rwkv, hymba and internvl under ``elk_stream`` against ``gspmd`` on
    the port (lock-step with the VLM's stub patches, and the batcher) and
    against the reference's ``elk_stream`` engine on the same converted
    weights (its stub arrays handed to the port's ``generate``)."""
    from repro.models.frontends import frontend_embeddings as jax_frontends
    from repro_torch.convert import tensor_from_numpy
    from repro_torch.serve import engine as engine_mod

    jcfg = dataclasses.replace(jax_smoke_config(arch), dtype="float32",
                               param_dtype="float32")
    tcfg = _fp32(arch)
    jparams = jtfm.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    fe = {k: tensor_from_numpy(np.asarray(v), "cpu")
          for k, v in jax_frontends(jcfg, 2).items()}
    monkeypatch.setattr(engine_mod, "frontend_embeddings",
                        lambda cfg, batch, **kw: fe)
    kw = dict(batch=2, cache_capacity=32, prefetch_depth=2, prefill_chunk=8,
              kv_dtype="float32")
    teng = {mode: ServeEngine(tcfg, tparams, ServeConfig(mode=mode, **kw),
                              "cpu") for mode in ("gspmd", "elk_stream")}
    assert isinstance(teng["elk_stream"].params["layers"], stream.LayerStream)
    jeng = JaxServeEngine(jcfg, mesh11, jparams,
                          JaxServeConfig(mode="elk_stream", **kw))
    prompts = _prompts(tcfg, 2, 10, seed=3)
    ref = np.asarray(jeng.generate(jnp.asarray(prompts.numpy(), jnp.int32),
                                   steps=6))
    for eng in teng.values():
        np.testing.assert_array_equal(eng.generate(prompts, steps=6).numpy(),
                                      ref)
    ref = {c.rid: c.tokens for c in JaxBatcher(jeng).run(
        jax_make_trace(5, vocab_size=jcfg.vocab_size, seed=4))}
    for mode, eng in teng.items():
        got = {c.rid: c.tokens for c in ContinuousBatcher(eng).run(
            make_trace(5, vocab_size=tcfg.vocab_size, seed=4))}
        assert sorted(got) == sorted(ref) == list(range(5))
        for rid in ref:
            np.testing.assert_array_equal(got[rid], ref[rid],
                                          err_msg=f"{mode} {rid}")


def test_rwkv_and_hybrid_layers_stream_whole():
    """An RWKV layer's record holds its time and channel mix (its state
    stays in the cache); a hybrid layer's holds its ``ssm`` branch beside
    attention and MLP: one copy a layer a pass, the views the layers'."""
    for arch in ("rwkv6_7b", "hymba_1_5b"):
        cfg = get_smoke_config(arch)
        params = _params(cfg)
        eng = ServeEngine(cfg, params, ServeConfig(
            batch=2, cache_capacity=16, mode="elk_stream", prefetch_depth=1),
            "cpu")
        ls = eng.params["layers"]
        paths = [path for path, *_ in ls.layouts[0]]
        assert (("w_decay",) in paths) == cfg.rwkv
        assert (("ssm", "w_bc") in paths) == cfg.hybrid_parallel_ssm
        before = ls.copies
        eng.generate(_prompts(cfg, 2, 5), steps=3)
        assert ls.copies - before == 3 * cfg.num_layers
        for li in range(cfg.num_layers):
            ls.issue(li, 0)
            view = ls.acquire(li, 0)
            for path, t in stream._leaves(params["layers"][li]):
                node = view
                for key in path:
                    node = node[key]
                assert torch.equal(node, t), (arch, li, path)


def test_whisper_under_elk_stream_runs_resident(capsys):
    """An encoder-decoder model is not streamed, as in the reference:
    under ``elk_stream`` the engine keeps its weights resident, says so,
    and serves the tokens ``gspmd`` serves; ``init_streamed_params``
    refuses to draw it and the engine refuses a ``LayerStream``; the
    launcher serves it in both modes."""
    cfg = get_smoke_config("whisper_tiny")
    params = _params(cfg)
    prompts = _prompts(cfg, 2, 6)
    outs = {}
    for mode in ("gspmd", "elk_stream"):
        eng = ServeEngine(cfg, params, ServeConfig(
            batch=2, cache_capacity=16, mode=mode), "cpu")
        assert not eng.streamed
        assert isinstance(eng.params["layers"], list)
        outs[mode] = eng.generate(prompts, steps=4)
    assert "weights stay resident" in capsys.readouterr().out
    assert torch.equal(outs["gspmd"], outs["elk_stream"])
    with pytest.raises(ValueError, match="not streamed"):
        stream.init_streamed_params(torch.Generator().manual_seed(0), cfg,
                                    "cpu", 1)
    layers = stream.LayerStream(params["layers"], torch.device("cpu"),
                                depth=1)
    with pytest.raises(ValueError, match="not streamed"):
        ServeEngine(cfg, {**params, "layers": layers},
                    ServeConfig(batch=2, cache_capacity=16, mode="elk_stream"),
                    "cpu")
    from repro_torch.launch import serve
    for mode in ("elk_stream", "gspmd"):
        serve.main(["--arch", "whisper-tiny", "--smoke", "--device", "cpu",
                    "--mode", mode, "--batch", "2", "--steps", "3",
                    "--cache", "32"])
        out = capsys.readouterr().out
        assert "generated 3 tokens x 2 requests" in out
        assert ("weights stay resident" in out) == (mode == "elk_stream")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_streams_every_decoder_only_model(arch):
    """``stream.streams`` is the one rule of what ``elk_stream`` streams:
    every decoder-only config, and no encoder-decoder one; ``gspmd``
    streams nothing."""
    cfg = get_smoke_config(arch)
    assert stream.streams(cfg, "elk_stream") == (not cfg.encoder_layers)
    assert not stream.streams(cfg, "gspmd")


@pytest.mark.parametrize("arch", STATE_ARCHS)
def test_launcher_serves_the_state_families(arch, capsys):
    """The launcher serves rwkv, hymba and internvl in its default
    ``elk_stream`` mode, lock-step and continuous, and with ``--mode
    gspmd``."""
    from repro_torch.launch import serve
    base = ["--arch", arch.replace("_", "-"), "--smoke", "--device", "cpu"]
    serve.main(base + ["--batch", "2", "--steps", "3", "--cache", "32"])
    out = capsys.readouterr().out
    assert "ELK scheduler: prefetch_depth=" in out
    assert "generated 3 tokens x 2 requests" in out
    serve.main(base + ["--trace", "3", "--cache", "64"])
    assert "continuous:" in capsys.readouterr().out
    serve.main(base + ["--mode", "gspmd", "--batch", "2", "--steps", "3",
                       "--cache", "32"])
    assert "generated 3 tokens x 2 requests" in capsys.readouterr().out
