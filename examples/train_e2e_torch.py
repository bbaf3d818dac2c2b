"""End-to-end training run of the port: train a small model a few
hundred steps with the whole stack (grad accumulation, checkpointing, the
fault-tolerant trainer) and check that the loss falls.  The twin of
``examples/train_e2e.py``.

    PYTHONPATH=src python examples/train_e2e_torch.py [--steps 200] [--device cpu]

Runs on the GPU unless ``--device cpu`` is given.
"""

import argparse
import os
import tempfile

from repro_torch.configs import get_smoke_config
from repro_torch.data.pipeline import DataConfig
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.trainer import Trainer, TrainerConfig


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--arch", default="qwen3_14b")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    cfg = get_smoke_config(args.arch)
    wd = tempfile.mkdtemp(prefix="repro_torch_train_")
    trainer = Trainer(
        cfg,
        DataConfig(batch=8, seq=64, vocab_size=cfg.vocab_size),
        AdamWConfig(lr=3e-3, warmup_steps=10, total_steps=args.steps),
        TrainerConfig(workdir=wd, total_steps=args.steps, ckpt_every=50,
                      grad_accum=2),
        device=args.device,
    )
    print(f"training {cfg.name} ({cfg.param_count() / 1e6:.1f}M params) for "
          f"{args.steps} steps on {trainer.device}; workdir {wd}")
    log = trainer.run()
    first, last = log[0]["loss"], log[-1]["loss"]
    print(f"loss {first:.3f} -> {last:.3f} "
          f"({log[-1]['step_time'] * 1e3:.0f} ms/step)")
    assert last < first, "loss did not decrease"
    print("checkpoints:", sorted(os.listdir(os.path.join(wd, "ckpt"))))


if __name__ == "__main__":
    main()
