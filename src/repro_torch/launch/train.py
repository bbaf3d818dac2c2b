"""Training launcher of the port.

Runs on the GPU unless ``--device cpu`` is given (``--smoke`` makes that
bearable):

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-14b \\
      --smoke --device cpu --steps 4

The reference's flags.  ``--production-mesh`` builds the (16, 16) mesh,
whose 256 devices one GPU cannot host, and the run is refused with that
mesh's device-count error; ``--fsdp`` trains on the local mesh of one
device, where it changes nothing (as on the reference's (1, 1) mesh).
Metrics go to ``<workdir>/metrics.json``; the default workdir lies under
the temporary directory.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
from typing import Optional

from repro_torch.configs import ARCH_IDS, canonical, get_config, \
    get_smoke_config
from repro_torch.data.pipeline import DataConfig
from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.trainer import Trainer, TrainerConfig


def parse_args(argv: Optional[list] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True,
                    help=f"one of {ARCH_IDS} (dashed aliases ok)")
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced config of the same family")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--compression", default="none",
                    choices=["none", "bf16", "int8"])
    ap.add_argument("--fsdp", action="store_true",
                    help="the FSDP specs; on one device they change "
                         "nothing")
    ap.add_argument("--workdir", default=os.path.join(tempfile.gettempdir(),
                                                      "repro_torch_train"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu (the plain path)")
    ap.add_argument("--production-mesh", action="store_true",
                    help="the (16, 16) mesh: needs 256 devices, refused")
    return ap.parse_args(argv)


def main(argv: Optional[list] = None) -> list[dict]:
    args = parse_args(argv)
    arch = canonical(args.arch)
    cfg = get_smoke_config(arch) if args.smoke else get_config(arch)
    if args.production_mesh:
        make_production_mesh().devices           # raises: 256 devices
    mesh = make_local_mesh(device=args.device)
    dcfg = DataConfig(batch=args.batch, seq=args.seq,
                      vocab_size=cfg.vocab_size)
    ocfg = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 2),
                       total_steps=args.steps)
    tcfg = TrainerConfig(workdir=args.workdir, total_steps=args.steps,
                         ckpt_every=args.ckpt_every,
                         grad_accum=args.grad_accum,
                         compression=args.compression, fsdp=args.fsdp)
    os.makedirs(args.workdir, exist_ok=True)
    trainer = Trainer(cfg, dcfg, ocfg, tcfg, device=args.device, mesh=mesh)
    print(f"training {cfg.name} ({cfg.param_count() / 1e6:.1f}M params) on "
          f"{trainer.device}, resuming from step {trainer.step}")
    log = trainer.run()
    out = os.path.join(args.workdir, "metrics.json")
    with open(out, "w") as f:
        json.dump(log, f, indent=1)
    if log:
        print(f"final loss {log[-1]['loss']:.4f} "
              f"({log[-1]['step_time'] * 1e3:.0f} ms/step); metrics -> {out}")
    return log


if __name__ == "__main__":
    main()
