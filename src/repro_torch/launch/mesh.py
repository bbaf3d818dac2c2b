"""Meshes of the port: the production mesh for accounting, the local one
for running.

Counterpart of ``src/repro/launch/mesh.py``.  A ``Mesh`` is a small frozen
object with the reference mesh's ``shape`` (an ordered ``{axis: size}``
mapping, as ``jax.sharding.Mesh.shape``) and ``axis_names``, and the torch
devices it spans.  The sharding rules (``distributed/sharding.py``) and the
dry run read only ``shape``.

* ``make_production_mesh`` is the reference's (data 16, model 16) or (pod 2,
  data 16, model 16) with no devices: the port runs on one GPU and uses it
  for per-device accounting only.  Asking it for its devices raises and
  names the 256 or 512 it needs, as ``jax.make_mesh`` fails on a machine
  with too few.
* ``make_local_mesh`` spans the visible CUDA devices, or the CPU when asked;
  like the reference it falls back to (n, 1) when the request exceeds them.

There is no ``_make_mesh`` with its ``AxisType`` branch: axis types are a
JAX sharding notion with no PyTorch counterpart.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Axis names and sizes, in order, and the devices (None: an abstract
    mesh, for accounting only)."""
    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]
    device_list: Optional[tuple[torch.device, ...]] = None

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.sizes:
            n *= s
        return n

    @property
    def devices(self) -> tuple[torch.device, ...]:
        """The devices the mesh spans; an abstract mesh raises."""
        if self.device_list is None:
            shape = ", ".join(f"{a} {s}" for a, s in self.shape.items())
            raise RuntimeError(
                f"the production mesh ({shape}) needs {self.size} devices; "
                f"this machine has {visible_devices()} CUDA device(s). It "
                "serves per-device accounting only (launch/dryrun.py)")
        return self.device_list


def visible_devices() -> int:
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """Single pod: (data=16, model=16) = 256 devices.  Multi-pod: a leading
    pod axis of pure data parallelism, (pod=2, data=16, model=16) = 512.
    Abstract: ``devices`` raises."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def make_local_mesh(data: int = 1, model: int = 1, device="cuda") -> Mesh:
    """Mesh over the visible CUDA devices (or the CPU, ``device="cpu"``):
    (data, model), or (n, 1) when data x model exceeds them."""
    device = torch.device(device)
    if device.type == "cuda":
        n = visible_devices()
        if n == 0:
            raise RuntimeError(
                "repro_torch runs on a CUDA device and none is available; "
                "pass device='cpu' for a mesh of the CPU")
        devs = [torch.device("cuda", i) for i in range(n)]
    else:
        n, devs = 1, [device]
    if data * model > n:
        data, model = n, 1
    return Mesh(("data", "model"), (data, model),
                tuple(devs[:data * model]))


def mesh_num_devices(mesh: Mesh) -> int:
    return mesh.size
