"""Weight streaming (``elk_stream``) of the port, on the CPU.

Twins of the reference's ``TestServe.test_stream_equals_gspmd``,
``test_prefetch_depth_invariance`` (``tests/test_runtime.py``) and
``test_wraparound_stream_equals_gspmd`` (``tests/test_serve_batcher.py``),
the port's ``elk_stream`` tokens against the JAX ``elk_stream`` engine on
converted weights, the window's copies (how many, in which order, into
which buffer), and the launcher's default path.  On the CPU the window
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
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.models import transformer as tfm
from repro_torch.serve import stream
from repro_torch.serve.batcher import ContinuousBatcher, make_trace
from repro_torch.serve.engine import ServeConfig, ServeEngine

# the dense configs: every layer has one layout (MoE configs raise, below)
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


@pytest.mark.parametrize("arch", ["qwen3_14b", "h2o_danube_1_8b"])
def test_stream_tokens_equal_reference(arch, mesh11):
    """The port's ``elk_stream`` engine against the reference's, on the same
    converted weights, lock-step and through the continuous batcher."""
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
    assert ls.layer_bytes % 256 == 0
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
        stream.LayerStream(bad, "cpu", depth=1)


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
                ls.layout, stream._leaves(layer)):
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

    ls = stream.LayerStream(draw(4), "cpu", depth=2, n=4)
    ls.issue(3, 0)
    assert torch.equal(ls.acquire(3, 0)["attn"]["w_q"],
                       layers[3]["attn"]["w_q"])
    for n in (3, 5):
        with pytest.raises(ValueError, match="layers"):
            stream.LayerStream(draw(n), "cpu", depth=2, n=4)


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
    with the knobs the planner chose on one H100."""
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
    for flag in ("--pipeline-pod", "--stacked-gb"):
        with pytest.raises(NotImplementedError, match="ROADMAP.*item 13"):
            serve.main(["--arch", "qwen3-14b", "--smoke", "--device", "cpu",
                        flag, "2"])


MOE = ["llama4_maverick_400b_a17b", "kimi_k2_1t_a32b"]


@pytest.mark.parametrize("arch", MOE)
def test_elk_stream_of_moe_raises(arch):
    """Dense and MoE layers differ in layout, and one pinned layout holds
    every streamed layer: ``elk_stream`` of an MoE config raises, naming
    the ROADMAP item, at every entry point; ``gspmd`` serves it."""
    cfg = get_smoke_config(arch)
    with pytest.raises(NotImplementedError, match="ROADMAP.*item 17"):
        stream.init_streamed_params(torch.Generator(), cfg, "cpu", 2)
    params = _params(cfg)
    with pytest.raises(NotImplementedError, match="streamed MoE"):
        ServeEngine(cfg, params, ServeConfig(
            batch=2, cache_capacity=32, mode="elk_stream"), "cpu")
    eng = ServeEngine(cfg, params, ServeConfig(batch=2, cache_capacity=32),
                      "cpu")
    assert eng.generate(_prompts(cfg, 2, 6), steps=3).shape == (2, 9)


def test_elk_stream_of_uniform_moe_raises():
    """A config whose every layer is MoE (no dense prefix, an MoE layer
    every layer) has one layout too, and still raises: its experts are to
    be streamed as late-bound preloads on the router's choice, not copied
    whole every pass."""
    cfg = dataclasses.replace(get_smoke_config("kimi_k2_1t_a32b"),
                              moe_first_dense=0, moe_every=1, moe_offset=0)
    assert set(tfm.layer_kinds(cfg)) == {"moe"}
    with pytest.raises(NotImplementedError, match="ROADMAP.*item 17"):
        stream.init_streamed_params(torch.Generator(), cfg, "cpu", 2)
    with pytest.raises(NotImplementedError, match="streamed MoE"):
        ServeEngine(cfg, _params(cfg), ServeConfig(
            batch=2, cache_capacity=32, mode="elk_stream"), "cpu")


@pytest.mark.parametrize("arch", MOE)
def test_launcher_serves_moe_resident_only(arch, capsys):
    """The launcher takes the MoE ids: the default ``elk_stream`` raises
    and says that ``--mode gspmd`` runs it, which serves lock-step and
    continuous."""
    from repro_torch.launch import serve
    dashed = arch.replace("_", "-")
    with pytest.raises(NotImplementedError, match="--mode gspmd"):
        serve.main(["--arch", dashed, "--smoke", "--device", "cpu"])
    serve.main(["--arch", dashed, "--smoke", "--device", "cpu", "--mode",
                "gspmd", "--batch", "2", "--steps", "3", "--cache", "32"])
    assert "generated 3 tokens x 2 requests" in capsys.readouterr().out
    serve.main(["--arch", dashed, "--smoke", "--device", "cpu", "--mode",
                "gspmd", "--trace", "3", "--cache", "64"])
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
