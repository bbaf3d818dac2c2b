"""Atomic, async checkpoint store (the reference's layout).

Counterpart of ``src/repro/checkpoint/store.py``: one ``.npy`` per leaf,
keyed by the ``/``-joined path of the leaf in the tree (dictionary keys and
list indices), plus a ``manifest.json`` with the step and every leaf's
file, type and shape.  Writes go to a temporary directory renamed into
place, so a crashed writer never corrupts the latest checkpoint;
``save_async`` copies the tensors to the host (the only part the train
loop waits for) and writes on a worker thread; ``keep`` checkpoints are
kept.

What differs: bf16 leaves are stored as their ``uint16`` bits with
``"bfloat16"`` in the manifest and read back by reinterpreting the bits
(the reference does the same, but reads through ``ml_dtypes``, which the
card's machine does not have); ``restore`` puts every leaf on the device
and in the type of the matching leaf of ``like`` (one GPU: there is no
mesh to reshard onto).  Python numbers (the optimizer's step) are stored
as 0-d int64 arrays and come back as ints.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.tree import tree_items, tree_unflatten

_MANIFEST = "manifest.json"


def _to_numpy(leaf: Any) -> np.ndarray:
    """A leaf on the host: a tensor's bits (bf16 as uint16), or a number."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).cpu().numpy().view(np.uint16)
        return t.cpu().numpy()
    return np.asarray(leaf, dtype=np.int64)


def _flatten(tree: Any) -> dict[str, tuple[np.ndarray, str]]:
    """path -> (host array, stored type name)."""
    out = {}
    for path, leaf in tree_items(tree):
        name = (str(leaf.dtype).removeprefix("torch.")
                if isinstance(leaf, torch.Tensor) else "int")
        out[path] = (_to_numpy(leaf), name)
    return out


class CheckpointStore:
    def __init__(self, root: str, keep: int = 3):
        self.root = root
        self.keep = keep
        os.makedirs(root, exist_ok=True)
        self._worker: Optional[threading.Thread] = None

    # -- write -----------------------------------------------------------
    def _dir(self, step: int) -> str:
        return os.path.join(self.root, f"step_{step:09d}")

    def save(self, step: int, tree: Any) -> str:
        return self._write(step, _flatten(tree))

    def save_async(self, step: int, tree: Any) -> None:
        self.wait()
        flat = _flatten(tree)   # blocking part: device -> host
        self._worker = threading.Thread(
            target=self._write, args=(step, flat), daemon=True)
        self._worker.start()

    def wait(self) -> None:
        if self._worker is not None:
            self._worker.join()
            self._worker = None

    def _write(self, step: int, flat: dict) -> str:
        final = self._dir(step)
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "leaves": {}}
        for key, (arr, dtype) in flat.items():
            fname = key.replace("/", "__") + ".npy"
            np.save(os.path.join(tmp, fname), arr)
            manifest["leaves"][key] = {"file": fname, "dtype": dtype,
                                       "shape": list(arr.shape)}
        with open(os.path.join(tmp, _MANIFEST), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)    # atomic publish
        self._gc()
        return final

    def _gc(self) -> None:
        for s in self.steps()[:-self.keep]:
            shutil.rmtree(self._dir(s), ignore_errors=True)

    # -- read ------------------------------------------------------------
    def steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.root):
            if name.startswith("step_") and not name.endswith(".tmp"):
                if os.path.exists(os.path.join(self.root, name, _MANIFEST)):
                    out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like: Any) -> Any:
        """The checkpoint of ``step`` in the structure of ``like``: each
        tensor leaf on the device and in the type of ``like``'s, each
        number an int."""
        d = self._dir(step)
        with open(os.path.join(d, _MANIFEST)) as f:
            manifest = json.load(f)
        leaves = []
        for key, ref in tree_items(like):
            meta = manifest["leaves"][key]
            arr = np.load(os.path.join(d, meta["file"]))
            if meta["dtype"] == "int":
                leaves.append(int(arr))
                continue
            if meta["dtype"] == "bfloat16":
                t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
            else:
                t = torch.from_numpy(arr)
            leaves.append(t.to(device=ref.device, dtype=ref.dtype))
        return tree_unflatten(like, leaves)
