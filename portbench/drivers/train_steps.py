"""Training steps through the port's step function.

The system under test is the step of ``repro_torch.train.step.
make_train_step`` (what ``Trainer.run`` calls each step) with remat as the
job says, on parameters the benchmark draws from the seed (bf16, requiring
grad) and AdamW state from ``repro_torch.optim.adamw.init_state``.  Each
step takes a fresh batch drawn on the device from the seed and the step's
number (tokens uniform over the vocabulary; labels the next tokens), and
reads its loss back, as ``Trainer.run`` does.

Set-up draws the weights and drives the step through its first
``check.steps`` steps, reading what the check compares: each step's loss,
the first gradient as the optimizer took it (its first moment after one
step over 1 - b1), and each leaf's change over those steps.  The window
then runs the same object on: the tokens of every whole step inside it.
After it the program's state is freed and the fp32 reference
(``reference/dense_decoder.loss``, ``reference/adamw.update``) follows
the first steps on the weights and batches drawn again from the seed.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from portbench import timeline, weights
from portbench.reference import adamw as ref_adamw
from portbench.reference import checks, dense_decoder


def batch_at(job: dict, vocab: int, seed: int, step: int, device) -> dict:
    """Step ``step``'s batch: (B, S) tokens and labels, drawn on the
    device."""
    key = np.random.SeedSequence([int(seed) & (2 ** 64 - 1), 5, step])
    gen = torch.Generator(device=device).manual_seed(
        int(key.generate_state(1, np.uint64)[0]) & (2 ** 63 - 1))
    seq = torch.randint(0, vocab, (job["batch"], job["seq"] + 1),
                        generator=gen, device=device, dtype=torch.int32)
    return {"tokens": seq[:, :-1], "labels": seq[:, 1:]}


def _leaves(tree) -> list:
    """A tree's tensors in order (dict keys as stored, list items in
    order), walked without the program's helpers, for the reference's
    tree as for the program's."""
    out = []
    if isinstance(tree, dict):
        for v in tree.values():
            out += _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            out += _leaves(v)
    elif tree is not None:
        out.append(tree)
    return out


def run(env) -> dict:
    import repro_torch.optim.adamw as adamw
    import repro_torch.train.step as step_mod
    job, model = env.mix, env.model
    cfg = env.port_config()
    n_check = job["check"]["steps"]
    params = weights.draw(model, env.seed, env.device)
    leaves = _leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    opt_cfg = adamw.AdamWConfig(**job["optimizer"])
    opt_state = adamw.init_state(params, opt_cfg)
    step_fn = step_mod.make_train_step(cfg, opt_cfg, remat=job["remat"])
    vocab = model["vocab_size"]
    tracer = env.tracer

    def vg(*args):
        return tracer.timed("value_and_grad", vag, *args)

    def upd(*args):
        return tracer.timed("apply_update", update, *args)

    vag, update = step_mod.value_and_grad, adamw.apply_update
    step_mod.value_and_grad, adamw.apply_update = vg, upd
    state = {"params": params, "opt": opt_state, "err": None, "step": 0}

    def one_step() -> float:
        batch = batch_at(job, vocab, env.seed, state["step"], env.device)
        out = step_fn(state["params"], state["opt"], batch, state["err"])
        state["params"], state["opt"], metrics, state["err"] = out
        state["step"] += 1
        return float(metrics["loss"])           # waits for the step

    try:
        # -- set-up: the first steps, read for the check ------------------
        first = [p.detach().clone() for p in leaves]
        prog = {"loss": []}
        for k in range(n_check):
            prog["loss"].append(one_step())
            if k == 0:
                moments = _leaves(state["opt"]["m"])
                prog["grad"] = [v / (1 - opt_cfg.b1)
                                for v in dense_decoder.leaf_norms(moments)]
        prog["change"] = dense_decoder.leaf_norms(
            p.detach().float() - q.float() for p, q in zip(leaves, first))
        del first
        env.sync()

        # -- the window ------------------------------------------------------
        tracer.start()
        env.sync()
        t0, t0_ns = time.perf_counter(), time.time_ns()
        env.window_opened(t0)
        losses = []
        passes = []
        while time.perf_counter() - t0 < env.seconds:
            with tracer.span("step"):
                losses.append(one_step())
            passes.append({"kind": "train", "batch": job["batch"],
                           "seq": job["seq"]})
        env.sync()
        window_s = time.perf_counter() - t0
        t1_ns = time.time_ns()
        device_events = tracer.stop()
    finally:
        step_mod.value_and_grad, adamw.apply_update = vag, update

    steps = len(losses)
    tokens = steps * job["batch"] * job["seq"]
    env.say(f"window {window_s:.3f} s: {steps} steps, {tokens} tokens, "
            f"losses {losses[:1]} .. {losses[-1:]}")
    outcome = {
        "window_s": window_s,
        "attempted": steps,
        "failed": sum(1 for v in losses if not np.isfinite(v)),
        "e2e": {"train_tok_s": tokens / window_s},
        "memory_peak_bytes": env.memory_peak(),
        "layer": {"model": env.dims(), "window_s": window_s,
                  "passes": passes, "device_ms": tracer.device_ms(),
                  "timeline": (timeline.reduce(device_events, t0_ns, t1_ns,
                                               tracer.spans)
                               if tracer.trace else None)}}

    # -- the check, on the program's state freed --------------------------
    del params, leaves, opt_state, state, step_fn
    gc.collect()
    env.free()
    t_check = time.perf_counter()
    ref = reference_readings(model, job, env.seed, env.device)
    numbers = checks.train_numbers(prog, ref)
    env.say("check: program losses " + ", ".join(f"{v:.6f}" for v in
                                                 prog["loss"])
            + "; reference " + ", ".join(f"{v:.6f}" for v in ref["loss"])
            + f"; {numbers['leaves_left_out']} leaves left out of the change"
            + f"; {time.perf_counter() - t_check:.1f} s")
    outcome["check"] = checks.verdict(numbers, job["check"]["limits"])
    planted = {"fp8": {"quant": dense_decoder.fp8_operands},
               "half_batch": {"rows": slice(0, job["batch"] // 2)}}
    outcome["controls"] = {
        name: checks.train_numbers(reference_readings(
            model, job, env.seed, env.device, **planted[name]), ref)
        for name in env.controls}
    return outcome


def reference_readings(model: dict, job: dict, seed: int, device,
                       quant=None, rows: slice = slice(None)) -> dict:
    """The fp32 reference through the first ``check.steps`` steps, from the
    weights and batches drawn again from the seed: each step's loss, the
    first gradient as AdamW takes it, each leaf's change.  ``quant`` and
    ``rows`` (a part of each batch) plant the control and a fault."""
    opt = job["optimizer"]
    store = getattr(torch, model["param_dtype"])
    with dense_decoder.fp32_matmuls():
        base = weights.draw(model, seed, device)
        p32 = dense_decoder.to_f32(base)
        first = _leaves(base)
        leaves = _leaves(p32)
        for p in leaves:
            p.requires_grad_(True)
        m = [torch.zeros_like(p) for p in leaves]
        v = [torch.zeros_like(p) for p in leaves]
        out: dict = {"loss": []}
        for k in range(job["check"]["steps"]):
            batch = batch_at(job, model["vocab_size"], seed, k, device)
            loss = dense_decoder.loss(p32, model, batch["tokens"][rows],
                                      batch["labels"][rows], quant)
            grads = torch.autograd.grad(loss, leaves)
            out["loss"].append(float(loss.detach()))
            scale = ref_adamw.update(leaves, grads, m, v, k + 1, opt, store)
            if k == 0:
                out["grad"] = [g * scale
                               for g in dense_decoder.leaf_norms(grads)]
            del grads, loss
        out["change"] = dense_decoder.leaf_norms(p.detach() - q.float()
                               for p, q in zip(leaves, first))
    return out
