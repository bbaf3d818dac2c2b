"""The port's training runtime against the reference's: the optimizer, the
compression, the data pipeline, checkpoints, the trainer and its launcher.

Twins of the reference's ``tests/test_runtime.py`` (``TestTrainer``,
``TestCheckpoint``, ``TestCompression``) on the CPU, plus parity with the
reference where the two compute the same numbers: ``apply_update`` and
``cosine_schedule`` (fp32, within 1e-6 relative: the two frameworks take
``pow`` and ``sqrt`` in their own ways), ``compress_grads`` (bit for bit:
the same fp32 operations, the scale divided as a tensor, ties to even),
``MemmapDataset`` (bit for bit: the same numpy draws).  And the model's
remat and the serving invariant ``prefill + decode == forward_train``.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import MemmapDataset as JaxMemmapDataset
from repro.distributed import compression as jcomp
from repro.models import transformer as jtfm
from repro.optim import adamw as jadamw
from repro_torch.checkpoint.store import CheckpointStore
from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.convert import opt_state_from_jax, params_from_jax
from repro_torch.data.pipeline import DataConfig, MemmapDataset, SyntheticLM
from repro_torch.distributed import compression as comp
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import Mesh
from repro_torch.models import transformer as tfm
from repro_torch.models.frontends import frontend_embeddings
from repro_torch.optim import adamw
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.step import make_train_step
from repro_torch.train.trainer import Trainer, TrainerConfig
from repro_torch.tree import tree_items, tree_leaves, tree_map

ROOT = Path(__file__).resolve().parents[1]


def _close(a: torch.Tensor, b, rel: float = 1e-6) -> bool:
    b = np.asarray(b, np.float32)
    return float(np.max(np.abs(a.float().numpy() - b))) \
        <= rel * (float(np.max(np.abs(b))) + 1e-12)


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("step", [0, 1, 5, 10, 11, 40, 60, 200])
def test_cosine_schedule_matches_the_reference(step):
    cfg = AdamWConfig(lr=3e-3, warmup_steps=10, total_steps=60)
    ref = float(jadamw.cosine_schedule(jadamw.AdamWConfig(
        **dataclasses.asdict(cfg)))(jnp.asarray(step)))
    assert adamw.cosine_schedule(cfg)(step) == pytest.approx(ref, rel=1e-6)


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_apply_update_matches_the_reference(state_dtype, monkeypatch):
    """Two AdamW steps on qwen3's smoke parameters with the reference's
    gradients (converted), against the reference's ``apply_update``; the
    state carried over through ``opt_state_from_jax``.  The slabs of a
    large leaf (forced here by a small ``SLAB_BYTES``) change nothing."""
    monkeypatch.setattr(adamw, "SLAB_BYTES", 4096)
    jcfg = dataclasses.replace(jax_smoke_config("qwen3_14b"),
                               dtype="float32", param_dtype="float32")
    tcfg = get_smoke_config("qwen3_14b")
    tcfg = dataclasses.replace(tcfg, dtype="float32", param_dtype="float32")
    ocfg = AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=10,
                       state_dtype=state_dtype, grad_clip=0.5)
    jocfg = jadamw.AdamWConfig(**dataclasses.asdict(ocfg))
    jp = jtfm.init_params(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(0)
    jstate = jadamw.init_state(jp, jocfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    tstate = opt_state_from_jax(jax.tree.map(np.asarray, jstate), tcfg,
                                device="cpu")
    for _ in range(2):
        jg = jax.tree.map(lambda a: jnp.asarray(
            rng.normal(size=a.shape).astype(np.float32)), jp)
        tg = params_from_jax(jax.tree.map(np.asarray, jg), tcfg, device="cpu")
        jp, jstate, jm = jadamw.apply_update(jp, jg, jstate, jocfg)
        tp, tstate, tm = adamw.apply_update(tp, tg, tstate, ocfg)
        assert float(tm["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=1e-6)
        assert tm["lr"] == pytest.approx(float(jm["lr"]), rel=1e-6)
    want = opt_state_from_jax(jax.tree.map(np.asarray, jstate), tcfg, "cpu")
    assert tstate["step"] == want["step"] == 2
    rel = 1e-5 if state_dtype == "float32" else 1e-2
    for got, ref in ((tp, params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                                          device="cpu")),
                     (tstate["m"], want["m"]), (tstate["v"], want["v"])):
        for (path, a), (_, b) in zip(tree_items(got), tree_items(ref)):
            assert a.dtype == b.dtype, path
            assert _close(a, b.float().numpy(), rel), path


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", ["none", "bf16", "int8"])
def test_compress_grads_matches_the_reference(method):
    """Three steps of the same stream of gradients through both
    compressors, error feedback carried: the wire and the residuals equal
    bit for bit."""
    rng = np.random.default_rng(1)
    shapes = {"w": (16, 9), "b": {"c": (33,)}}
    jerr = jcomp.init_error_feedback(
        jax.tree.map(lambda s: jnp.zeros(s), shapes,
                     is_leaf=lambda x: isinstance(x, tuple)), method)
    terr = None if method != "int8" else comp.init_error_feedback(
        {"w": torch.zeros(16, 9), "b": {"c": torch.zeros(33)}}, method)
    for _ in range(3):
        g = {"w": rng.normal(size=(16, 9)).astype(np.float32),
             "b": {"c": (rng.normal(size=(33,)) * 1e-3).astype(np.float32)}}
        jwire, jerr = jcomp.compress_grads(jax.tree.map(jnp.asarray, g),
                                           jerr, method)
        twire, terr = comp.compress_grads(tree_map(torch.from_numpy, g),
                                          terr, method)
        for (p, a), (_, b) in zip(tree_items(twire), tree_items(
                {"w": np.asarray(jwire["w"], np.float32),
                 "b": {"c": np.asarray(jwire["b"]["c"], np.float32)}})):
            assert np.array_equal(a.float().numpy(), b), p
        if method == "int8":
            assert np.array_equal(terr["w"].numpy(), np.asarray(jerr["w"]))
            assert np.array_equal(terr["b"]["c"].numpy(),
                                  np.asarray(jerr["b"]["c"]))


class TestCompression:
    def test_bf16_roundtrip_close(self):
        g = {"w": torch.linspace(-1, 1, 128)}
        wire, _ = comp.compress_grads(g, None, "bf16")
        assert wire["w"].dtype == torch.bfloat16
        assert float(torch.max(torch.abs(wire["w"].float() - g["w"]))) < 1e-2

    def test_int8_error_feedback_telescopes(self):
        """Repeated identical grads: error feedback makes the running mean
        of the decoded stream converge to the true gradient."""
        g = {"w": torch.tensor([0.301, -0.007, 0.513, 0.002])}
        err = comp.init_error_feedback(g, "int8")
        acc = torch.zeros(4)
        n = 50
        for _ in range(n):
            wire, err = comp.compress_grads(g, err, "int8")
            acc = acc + wire["w"]
        np.testing.assert_allclose((acc / n).numpy(), g["w"].numpy(),
                                   atol=1e-3)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

def test_memmap_dataset_is_the_references_bit_for_bit(tmp_path):
    path = str(tmp_path / "tokens.bin")
    np.random.default_rng(3).integers(0, 60000, 5000).astype(
        np.uint16).tofile(path)
    ref = JaxMemmapDataset(path, JaxDataConfig(batch=4, seq=32, seed=7))
    ours = MemmapDataset(path, DataConfig(batch=4, seq=32, seed=7))
    for step in (0, 1, 9):
        a, b = ours.batch_at(step), ref.batch_at(step)
        for k in ("tokens", "labels"):
            assert a[k].dtype == torch.int32
            assert np.array_equal(a[k].numpy(), np.asarray(b[k]))


def test_synthetic_lm_is_deterministic_and_markov():
    cfg = get_smoke_config("internvl2_1b")
    data = SyntheticLM(DataConfig(batch=4, seq=64, vocab_size=97, seed=2),
                       cfg)
    a, b = data.batch_at(5), data.batch_at(5)
    for k in a:
        assert torch.equal(a[k], b[k])
    assert not torch.equal(a["tokens"], data.batch_at(6)["tokens"])
    assert torch.equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    assert a["embeds"].shape == (4, cfg.vision_patches, cfg.d_model)
    t = a["tokens"].long()
    follows = ((t[:, :-1] * 7 + 3) % 97 == t[:, 1:]).float().mean()
    assert 0.4 < float(follows) < 0.65


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

class TestCheckpoint:
    def test_atomic_roundtrip(self, tmp_path):
        store = CheckpointStore(str(tmp_path), keep=2)
        tree = {"a": torch.arange(6.0).reshape(2, 3),
                "b": {"c": torch.randn(4).to(torch.bfloat16)},
                "l": [torch.ones(3, dtype=torch.int32)], "step": 7}
        store.save(3, tree)
        store.save(7, tree)
        store.save(9, tree)
        assert store.steps() == [7, 9]      # keep=2 garbage-collects
        manifest = json.load(open(tmp_path / "step_000000009" /
                                  "manifest.json"))
        assert manifest["leaves"]["b/c"]["dtype"] == "bfloat16"
        assert np.load(tmp_path / "step_000000009" / "b__c.npy").dtype \
            == np.uint16
        out = store.restore(9, tree)
        for (p, a), (_, b) in zip(tree_items(out), tree_items(tree)):
            if isinstance(b, torch.Tensor):
                assert a.dtype == b.dtype and torch.equal(a, b), p
            else:
                assert a == b
        # the async path writes the same files
        store.save_async(11, tree)
        store.wait()
        assert store.latest_step() == 11

    def test_restore_onto_likes_device_and_type(self, tmp_path):
        """One GPU: where the reference reshards onto a mesh, the port puts
        every leaf on the device and in the type of ``like``'s."""
        store = CheckpointStore(str(tmp_path))
        store.save(1, {"w": torch.ones(8, 4)})
        like = {"w": torch.empty(8, 4, dtype=torch.float64,
                                 device="meta")}
        out = store.restore(1, like)
        assert out["w"].device.type == "meta"
        assert out["w"].dtype == torch.float64
        out = store.restore(1, {"w": torch.empty(8, 4)})
        assert torch.equal(out["w"], torch.ones(8, 4))

    def test_crash_during_write_keeps_previous(self, tmp_path):
        store = CheckpointStore(str(tmp_path))
        store.save(1, {"a": torch.zeros(2)})
        os.makedirs(os.path.join(str(tmp_path), "step_000000002.tmp"))
        assert store.latest_step() == 1


# ---------------------------------------------------------------------------
# trainer
# ---------------------------------------------------------------------------

def _mk_trainer(wd, steps=20, ckpt_every=5, failure_hook=None, mesh=None,
                **tkw):
    cfg = get_smoke_config("qwen3_14b")
    return Trainer(
        cfg, DataConfig(batch=4, seq=16, vocab_size=cfg.vocab_size),
        AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=60),
        TrainerConfig(workdir=str(wd), total_steps=steps,
                      ckpt_every=ckpt_every, **tkw),
        failure_hook=failure_hook, device="cpu", mesh=mesh)


class TestTrainer:
    def test_loss_decreases(self, tmp_path):
        log = _mk_trainer(tmp_path, steps=25).run()
        assert log[-1]["loss"] < log[0]["loss"]

    def test_crash_restart_resumes(self, tmp_path):
        class Crash(RuntimeError):
            pass

        def bomb(step):
            if step == 7:
                raise Crash()

        t = _mk_trainer(tmp_path, steps=20, ckpt_every=3, failure_hook=bomb)
        with pytest.raises(Crash):
            t.run()
        t.store.wait()
        t2 = _mk_trainer(tmp_path, steps=20, ckpt_every=3)
        assert t2.step == 6
        t2.run()
        assert t2.step == 20

    def test_restart_is_deterministic(self, tmp_path):
        """A resumed run reproduces the uninterrupted run bit for bit: the
        deterministic data pipeline and the checkpointed state."""
        ta = _mk_trainer(tmp_path / "a", steps=12, ckpt_every=6)
        log_a = ta.run()
        tb = _mk_trainer(tmp_path / "b", steps=6, ckpt_every=6)
        tb.run()
        tb2 = _mk_trainer(tmp_path / "b", steps=12, ckpt_every=6)
        assert tb2.step == 6
        log_b = tb2.run()
        assert [m["loss"] for m in log_a[6:]] == [m["loss"] for m in log_b]
        for a, b in zip(tree_leaves(ta.params), tree_leaves(tb2.params)):
            assert torch.equal(a, b)

    def test_heartbeat_written(self, tmp_path):
        _mk_trainer(tmp_path, steps=6).run()
        hb = json.load(open(os.path.join(str(tmp_path), "heartbeat.json")))
        assert hb["step"] == 6

    def test_straggler_hook_fires(self, tmp_path):
        t = _mk_trainer(tmp_path, steps=14, straggler_factor=1e-9,
                        straggler_patience=2)
        t.run()
        assert t.straggler_events >= 1

    def test_grad_accum_matches_full_batch(self):
        """ga=2 over batch B == ga=1 over batch B (same update)."""
        cfg = get_smoke_config("qwen3_14b")
        batch = SyntheticLM(DataConfig(batch=8, seq=16,
                                       vocab_size=cfg.vocab_size)).batch_at(0)
        ocfg = AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=10)
        outs = {}
        for ga in (1, 2):
            params = tfm.init_params(torch.Generator().manual_seed(0), cfg,
                                     device="cpu")
            for p in tree_leaves(params):
                p.requires_grad_(True)
            step = make_train_step(cfg, ocfg, grad_accum=ga)
            p2, _, m, _ = step(params, adamw.init_state(params, ocfg), batch,
                               None)
            outs[ga] = (float(m["loss"]), p2)
        # the reference's bounds: bf16 weights, a step of lr moves them
        assert outs[1][0] == pytest.approx(outs[2][0], rel=3e-2)
        for a, b in zip(tree_leaves(outs[1][1]), tree_leaves(outs[2][1])):
            assert float(torch.max(torch.abs(a.detach().float()
                                             - b.detach().float()))) < 1e-1

    def test_fsdp_is_refused(self, tmp_path):
        """FSDP over a mesh of more than one device is refused: the port
        trains on one GPU (on a mesh of one device ``fsdp`` is accepted
        and changes nothing, ``test_torch_dryrun.py``)."""
        mesh = Mesh(("data", "model"), (2, 1), (torch.device("cpu"),) * 2)
        with pytest.raises(ValueError, match="one GPU"):
            _mk_trainer(tmp_path, fsdp=True, mesh=mesh)

    def test_cuda_is_the_default_device(self, tmp_path):
        if torch.cuda.is_available():
            pytest.skip("a card is present: cuda would be taken")
        cfg = get_smoke_config("qwen3_14b")
        with pytest.raises(RuntimeError, match="CUDA device"):
            Trainer(cfg, DataConfig(batch=2, seq=8), AdamWConfig(),
                    TrainerConfig(workdir=str(tmp_path)))


def test_launcher_trains_on_the_cpu(tmp_path):
    log = launch_train.main(["--arch", "qwen3-14b", "--smoke", "--device",
                             "cpu", "--steps", "4", "--workdir",
                             str(tmp_path), "--ckpt-every", "2",
                             "--compression", "int8", "--grad-accum", "2"])
    assert [m["step"] for m in log] == [1, 2, 3, 4]
    assert all(np.isfinite(m["loss"]) for m in log)
    assert CheckpointStore(str(tmp_path / "ckpt")).steps() == [2, 4]
    assert json.load(open(tmp_path / "metrics.json"))[-1]["step"] == 4


def test_train_example_runs_without_jax(tmp_path):
    """``examples/train_e2e_torch.py`` on the CPU in a process whose
    ``jax`` cannot be imported: the loss falls."""
    block = tmp_path / "block"
    block.mkdir()
    (block / "jax.py").write_text("raise ImportError('no jax here')\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(block), str(ROOT / "src")]))
    res = subprocess.run([sys.executable, str(ROOT / "examples" /
                                              "train_e2e_torch.py"),
                          "--steps", "30", "--device", "cpu"],
                         capture_output=True, text=True, env=env, cwd=ROOT,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "loss" in res.stdout


# ---------------------------------------------------------------------------
# the model's training pass
# ---------------------------------------------------------------------------

B, S = 2, 12


@pytest.mark.parametrize("arch", ["qwen3_14b", "whisper_tiny", "rwkv6_7b",
                                  "kimi_k2_1t_a32b"])
def test_remat_gives_the_same_values(arch):
    """``checkpoint`` per layer recomputes the same activations: the loss
    and every gradient equal with and without remat, bit for bit on the
    CPU."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32",
                              param_dtype="float32")
    params = tfm.init_params(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    for p in tree_leaves(params):
        p.requires_grad_(True)
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)),
        "labels": torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (B, S)).astype(np.int32)),
        **frontend_embeddings(cfg, B, device="cpu")}
    out = []
    for remat in (False, True):
        loss = tfm.loss_fn(params, cfg, batch, remat=remat)
        grads = torch.autograd.grad(loss, tree_leaves(params))
        out.append((float(loss.detach()), grads))
    assert out[0][0] == out[1][0]
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decode_matches_forward(arch):
    """prefill(S-1) + decode(1) last-token logits == forward_train(S)
    last-token logits: the reference's serving-correctness invariant
    (MoE: dropless capacity)."""
    cfg = get_smoke_config(arch)
    if cfg.moe_experts:
        cfg = dataclasses.replace(cfg,
                                  moe_capacity_factor=float(cfg.moe_experts))
    params = tfm.init_params(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int64))
    fe = frontend_embeddings(cfg, B, device="cpu")
    with torch.no_grad():
        full = tfm.forward_train(params, cfg, tokens, remat=False, **fe)
        cache = tfm.init_cache(cfg, tfm.CacheSpec(capacity=S + 4, batch=B),
                               device="cpu")
        _, cache = tfm.prefill(params, cfg, tokens[:, :S - 1], cache, **fe)
        last, _ = tfm.decode_step(params, cfg, tokens[:, S - 1], cache)
    err = float(torch.max(torch.abs(full[:, -1].float()
                                    - last[:, 0].float())))
    scale = float(torch.max(torch.abs(full[:, -1].float()))) + 1e-9
    assert err / scale < 0.02, f"{arch}: decode diverges from forward"
