"""Design-space exploration with the PyTorch port's copy of the ICCA
simulator toolkit (paper §6.4, ``repro_torch.chip.dse``): sweep HBM
bandwidth, NoC bandwidth and interconnect topology, reproduce the paper's
insight that the two bandwidths must scale together and the §6.4
topology-sensitivity story.  Planner only: runs on the CPU, no card.

    PYTHONPATH=src python examples/dse_explore_torch.py [--model M] \
        [--topologies all2all,mesh2d,...] [--csv PATH] [--fast]

``--fast`` truncates the model to two layers and skips the bandwidth
sweeps.
"""

from __future__ import annotations

import argparse
import csv
import dataclasses
import os

from repro_torch.chip.config import TB, ipu_pod4_hbm
from repro_torch.chip.dse import topology_sweep
from repro_torch.chip.topology import TOPOLOGIES
from repro_torch.configs import get_config
from repro_torch.core.elk import compile_model

DEFAULT_TOPOLOGIES = ("all2all", "mesh2d", "torus2d", "ring", "hier_pod")


def bandwidth_sweeps(cfg, max_orders: int) -> None:
    print("HBM bandwidth sweep (ELK-Full per-token latency, ms):")
    for bw in (2, 4, 8, 16, 32):
        chip = ipu_pod4_hbm(hbm_bw=bw * TB)
        p = compile_model(cfg, chip, batch=32, seq=2048, phase="decode",
                          design="ELK-Full", max_orders=max_orders)
        print(f"  hbm={bw:2d} TB/s -> {p.total_time*1e3:7.3f} ms  "
              f"(hbm util {p.util.hbm:5.1%})")

    print("\nNoC x HBM joint sweep (the 'scale together' insight):")
    base = ipu_pod4_hbm()
    for noc_scale in (0.5, 1.0, 2.0):
        row = f"  noc x{noc_scale:3.1f}: "
        for bw in (8, 16, 32):
            chip = base.scaled(link_bw=base.link_bw * noc_scale,
                               hbm_bw=bw * TB)
            p = compile_model(cfg, chip, batch=32, seq=2048, phase="decode",
                              design="ELK-Full", max_orders=max_orders)
            row += f"hbm{bw:2d}TB={p.total_time*1e3:7.3f}ms  "
        print(row)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="llama2_13b")
    ap.add_argument("--topologies",
                    default=",".join(DEFAULT_TOPOLOGIES),
                    help="comma-separated topology registry keys "
                         f"(known: {sorted(TOPOLOGIES)})")
    ap.add_argument("--csv",
                    default=os.path.join(os.path.dirname(__file__), "..",
                                         "build", "dse_topology.csv"),
                    help="where to write the topology-sweep CSV (default "
                         "under build/, so that a run leaves the tracked "
                         "experiment data alone)")
    ap.add_argument("--fast", action="store_true",
                    help="2-layer truncation, topology sweep only (CI smoke)")
    args = ap.parse_args(argv)

    topologies = [s for s in args.topologies.split(",") if s]
    if not topologies:
        ap.error("no topologies given")
    for topo in topologies:
        if topo not in TOPOLOGIES:
            ap.error(f"unknown topology {topo!r}; known: {sorted(TOPOLOGIES)}")

    cfg = get_config(args.model)
    max_orders = 2 if args.fast else 4
    if args.fast:
        cfg = dataclasses.replace(cfg, num_layers=min(cfg.num_layers, 2))
    else:
        bandwidth_sweeps(cfg, max_orders)

    print("\ntopology sweep:")
    rows = topology_sweep(cfg, topologies, designs=("ELK-Full",),
                          max_orders=max_orders)
    for r in rows:
        print(f"  {r['topology']:8s}: {r['latency_ms']:8.3f} ms plan / "
              f"{r['sim_ms']:8.3f} ms sim  (noc util {r['noc_util']:5.1%}, "
              f"delivery {r['delivery_tbps']:6.2f} TB/s)")
    os.makedirs(os.path.dirname(os.path.abspath(args.csv)), exist_ok=True)
    with open(args.csv, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        w.writeheader()
        w.writerows(rows)
    print(f"wrote {args.csv}")


if __name__ == "__main__":
    main()
