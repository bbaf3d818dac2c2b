"""Fault-tolerant training loop on one GPU.

Counterpart of ``src/repro/train/trainer.py``, with the same contract:

* **checkpoint/restart**: async atomic checkpoints every ``ckpt_every``
  steps; a new Trainer restores the latest checkpoint if there is one (the
  deterministic data pipeline replays from the step counter);
* **heartbeat**: a per-step heartbeat file (step + walltime + step time);
* **straggler strikes**: a step slower than ``straggler_factor`` x the
  rolling median is a strike; ``straggler_patience`` strikes in a row call
  ``on_straggler`` (default: checkpoint now);
* **failure injection**: ``failure_hook(step)`` raising mid-run is the
  crash; a fresh Trainer resumes.

What differs: ``device`` (default ``"cuda"``, through
``transformer.resolve_device``: it raises without a card unless the CPU is
asked for) holds the parameters, moments and batches; weights are drawn on
it from ``torch.Generator(device).manual_seed(seed)``.  ``mesh`` (default:
the local mesh of one device on ``device``) must span one device: on it
every spec of ``jit_train_step`` is met, so ``fsdp`` changes nothing, as
on the reference's (1, 1) mesh.  A mesh of more devices is refused: the
port has no multi-GPU placement.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from statistics import median
from typing import Callable, Optional

import torch

from repro_torch.checkpoint.store import CheckpointStore
from repro_torch.data.pipeline import DataConfig, make_dataset
from repro_torch.distributed import compression as comp
from repro_torch.launch.mesh import make_local_mesh, mesh_num_devices
from repro_torch.models import transformer as tfm
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw
from repro_torch.train.step import jit_train_step
from repro_torch.tree import tree_leaves


@dataclasses.dataclass
class TrainerConfig:
    workdir: str
    total_steps: int = 100
    ckpt_every: int = 20
    keep_ckpts: int = 3
    grad_accum: int = 1
    compression: str = "none"
    fsdp: bool = False
    straggler_factor: float = 3.0
    straggler_patience: int = 3
    heartbeat_file: str = "heartbeat.json"
    seed: int = 0


class Trainer:
    def __init__(self, model_cfg: ModelConfig, data_cfg: DataConfig,
                 opt_cfg: adamw.AdamWConfig, tcfg: TrainerConfig,
                 failure_hook: Optional[Callable[[int], None]] = None,
                 on_straggler: Optional[Callable[["Trainer"], None]] = None,
                 device="cuda", mesh=None):
        self.device = tfm.resolve_device(device)
        mesh = mesh or make_local_mesh(device=self.device)
        if mesh_num_devices(mesh) != 1:
            raise ValueError(
                f"a mesh of {mesh_num_devices(mesh)} devices "
                f"({dict(mesh.shape)}): the port trains on one GPU and has "
                "no multi-GPU placement of parameters or batches")
        self.mesh = mesh
        self.cfg = model_cfg
        self.tcfg = tcfg
        self.opt_cfg = opt_cfg
        self.data = make_dataset(data_cfg, model_cfg)
        self.store = CheckpointStore(os.path.join(tcfg.workdir, "ckpt"),
                                     keep=tcfg.keep_ckpts)
        self.failure_hook = failure_hook
        self.on_straggler = on_straggler or (lambda t: t.checkpoint())
        self.step_times: list[float] = []
        self.straggler_strikes = 0
        self.straggler_events = 0
        self.metrics_log: list[dict] = []

        gen = torch.Generator(self.device).manual_seed(tcfg.seed)
        params = tfm.init_params(gen, model_cfg, self.device)
        opt_state = adamw.init_state(params, opt_cfg)
        batch0 = self.data.batch_at(0)
        self.step_fn, self.specs = jit_train_step(
            model_cfg, mesh, opt_cfg, params, batch0,
            grad_accum=tcfg.grad_accum, compression=tcfg.compression,
            fsdp=tcfg.fsdp)
        self.err_fb = comp.init_error_feedback(params, tcfg.compression)

        latest = self.store.latest_step()
        if latest is not None:
            state = self.store.restore(latest, {"params": params,
                                                "opt": opt_state})
            params, opt_state = state["params"], state["opt"]
            self.step = latest
        else:
            self.step = 0
        for p in tree_leaves(params):
            p.requires_grad_(True)
        self.params, self.opt_state = params, opt_state

    # -- fault-tolerance plumbing -----------------------------------------
    def _heartbeat(self, step: int, step_time: float) -> None:
        path = os.path.join(self.tcfg.workdir, self.tcfg.heartbeat_file)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"step": step, "time": time.time(),
                       "step_time": step_time}, f)
        os.replace(tmp, path)

    def _check_straggler(self, dt: float) -> None:
        self.step_times.append(dt)
        window = self.step_times[-32:]
        if len(window) < 5:
            return
        med = median(window[:-1])
        if dt > self.tcfg.straggler_factor * med:
            self.straggler_strikes += 1
            if self.straggler_strikes >= self.tcfg.straggler_patience:
                self.straggler_events += 1
                self.straggler_strikes = 0
                self.on_straggler(self)
        else:
            self.straggler_strikes = 0

    def checkpoint(self) -> None:
        self.store.save_async(self.step, {"params": self.params,
                                          "opt": self.opt_state})

    # -- main loop ----------------------------------------------------------
    def run(self, steps: Optional[int] = None) -> list[dict]:
        end = self.step + steps if steps is not None else self.tcfg.total_steps
        while self.step < end:
            if self.failure_hook is not None:
                self.failure_hook(self.step)
            batch = {k: v.to(self.device, non_blocking=True)
                     for k, v in self.data.batch_at(self.step).items()}
            t0 = time.perf_counter()
            out = self.step_fn(self.params, self.opt_state, batch,
                               self.err_fb)
            self.params, self.opt_state, metrics, self.err_fb = out
            m = {k: float(v) for k, v in metrics.items()}   # waits for the step
            dt = time.perf_counter() - t0
            self.step += 1
            m["step"] = self.step
            m["step_time"] = dt
            self.metrics_log.append(m)
            self._heartbeat(self.step, dt)
            self._check_straggler(dt)
            if self.step % self.tcfg.ckpt_every == 0:
                self.checkpoint()
        self.store.wait()
        return self.metrics_log
