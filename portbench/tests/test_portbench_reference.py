"""The plain fp32 reference against the port's CPU path at smoke widths.

The test imports both; the reference itself imports nothing of the port.
In fp32 the two compute the same layer the same way, so they agree to
round-off: prefill by chunks and decode through the slot ring against the
reference's whole-sequence logits (opt-30b's biased relu MLP at G 1,
h2o-danube-1.8b's GLU at G 4 past its window), and one training step's
loss, gradients and updated weights."""

import pytest
import torch
import portbench_smoke as smoke

from portbench import weights
from portbench.drivers import train_steps
from portbench.reference import adamw as ref_adamw
from portbench.reference import dense_decoder

F32 = torch.float32


def _port(model):
    from repro_torch.models.config import ModelConfig
    return ModelConfig(**model)


@pytest.mark.parametrize("workload,prompt_len", [(smoke.SERVE, 37),
                                                 (smoke.TRAIN, 41)])
def test_chunked_prefill_and_decode_match_the_reference(workload,
                                                        prompt_len):
    from repro_torch.models import transformer as tfm
    model = smoke.small_model(workload, "float32")
    cfg = _port(model)
    params = weights.draw(model, 11, "cpu")
    gen = torch.Generator().manual_seed(5)
    toks = torch.randint(0, model["vocab_size"], (prompt_len + 4,),
                         generator=gen)
    cache = tfm.init_cache(cfg, tfm.CacheSpec(capacity=64, batch=1,
                                               kv_dtype=F32, per_slot=True),
                           "cpu")
    got = []
    with torch.inference_mode():
        off = 0
        for t in (16, 16, prompt_len - 32):
            logits, cache = tfm.chunk_prefill(params, cfg,
                                              toks[None, off:off + t], cache)
            off += t
        got.append(logits[0, -1])
        for i in range(4):
            logits, cache = tfm.decode_slots(params, cfg,
                                             toks[prompt_len + i][None],
                                             cache)
            got.append(logits[0, -1])
    rows = torch.arange(prompt_len - 1, prompt_len + 4)
    ref = dense_decoder.sequence_logits(params, model, [toks], [rows])[0]
    torch.testing.assert_close(torch.stack(got), ref, rtol=1e-4, atol=1e-4)


def test_one_training_step_matches_the_reference():
    import repro_torch.optim.adamw as adamw
    import repro_torch.train.step as step_mod
    from repro_torch.tree import tree_leaves
    plan = smoke.small_plan(smoke.TRAIN)
    model = smoke.small_model(smoke.TRAIN, "float32")
    job = plan["mix"]
    batch = train_steps.batch_at(job, model["vocab_size"], 3, 0, "cpu")
    params = weights.draw(model, 3, "cpu")
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    opt_cfg = adamw.AdamWConfig(**job["optimizer"])
    loss, grads = step_mod.value_and_grad(
        step_mod.make_loss_fn(_port(model)), params, batch)
    state = adamw.init_state(params, opt_cfg)
    adamw.apply_update(params, grads, state, opt_cfg)

    p32 = weights.draw(model, 3, "cpu")
    ref_leaves = tree_leaves(p32)
    for p in ref_leaves:
        p.requires_grad_(True)
    ref_loss = dense_decoder.loss(p32, model, batch["tokens"],
                                  batch["labels"])
    ref_grads = torch.autograd.grad(ref_loss, ref_leaves)
    torch.testing.assert_close(loss, ref_loss.detach(), rtol=1e-5, atol=0)
    for g, r in zip(tree_leaves(grads), ref_grads):
        torch.testing.assert_close(g, r, rtol=1e-3, atol=1e-6)
    m = [torch.zeros_like(p) for p in ref_leaves]
    v = [torch.zeros_like(p) for p in ref_leaves]
    ref_adamw.update(ref_leaves, list(ref_grads), m, v, 1, job["optimizer"])
    for p, r in zip(leaves, ref_leaves):
        torch.testing.assert_close(p.detach(), r.detach(), rtol=1e-5,
                                   atol=1e-6)
    for mp, mr in zip(tree_leaves(state["m"]), m):
        torch.testing.assert_close(mp, mr, rtol=1e-3, atol=1e-8)


def test_the_weights_are_the_ports_tree():
    from repro_torch.models import transformer as tfm
    for workload in (smoke.SERVE, smoke.TRAIN):
        model = smoke.small_model(workload)
        drawn = weights.draw(model, 1, "cpu")
        like = tfm.param_shapes(_port(model))

        def shapes(tree, out, prefix=""):
            if isinstance(tree, dict):
                for k, v in tree.items():
                    shapes(v, out, f"{prefix}/{k}")
            elif isinstance(tree, list):
                for i, v in enumerate(tree):
                    shapes(v, out, f"{prefix}/{i}")
            else:
                out.append((prefix, tuple(tree.shape), tree.dtype))
            return out

        assert shapes(drawn, []) == shapes(like, [])


def test_same_seed_same_weights_other_seed_other():
    model = smoke.small_model(smoke.SERVE)
    a = weights.draw(model, 2 ** 33 + 1, "cpu")["layers"][1]["mlp"]["b_up"]
    b = weights.draw(model, 2 ** 33 + 1, "cpu")["layers"][1]["mlp"]["b_up"]
    c = weights.draw(model, 2 ** 33 + 2, "cpu")["layers"][1]["mlp"]["b_up"]
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.abs().max() > 0


def test_fp8_operands_round_and_pass_the_gradient():
    t = torch.linspace(-3, 3, 50, requires_grad=True)
    q = dense_decoder.fp8_operands(t[None], -1)
    assert not torch.equal(q.detach()[0], t.detach())
    assert (q.detach()[0] - t.detach()).abs().max() <= 3 * 2 ** -4
    q.sum().backward()
    assert torch.equal(t.grad, torch.ones(50))
