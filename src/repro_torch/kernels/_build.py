"""Builds the CUDA sources under ``csrc/`` and loads them with ``ctypes``.

Each ``csrc/<name>.cu`` has a plain C interface and becomes one shared
library, compiled with ``nvcc`` for ``sm_90a`` (Hopper) from the sources
in the repository and nothing else.  The build happens at first use, never
at import: a machine without ``nvcc`` or without a card can import every
module of the port.  Libraries go to ``build/`` at the repository root
(listed in ``.gitignore``), named by a hash of source and flags so that an
edited source is rebuilt.  ``build_all`` starts one ``nvcc`` per source at
once and records each one's seconds (``build_seconds``); a failed build
raises with the compiler's output.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_loaded: dict[str, ctypes.CDLL] = {}
build_seconds: dict[str, float] = {}   # the last build of each source


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (neither on PATH nor under CUDA_HOME): the CUDA "
        "kernels of repro_torch are built on the machine with the card")


def sources() -> list[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _lib_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha1(src.read_bytes())
    for inc in sorted(CSRC.glob("*.cuh")):
        h.update(inc.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


class _Build:
    """One running ``nvcc``: compiles to a temporary name and moves the
    library into place when it succeeded, so a reader never sees half a
    file."""

    def __init__(self, name: str, extra: list[str]):
        self.name, self.out = name, _lib_path(name)
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        self.tmp = self.out.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [nvcc_path(), *NVCC_FLAGS, *extra, "-o", str(self.tmp),
               str(CSRC / f"{name}.cu")]
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True)

    def finish(self) -> str:
        log, _ = self.proc.communicate()
        build_seconds[self.name] = time.perf_counter() - self.t0
        if self.proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {self.name}.cu "
                               f"(exit {self.proc.returncode}):\n{log}")
        os.replace(self.tmp, self.out)
        return log


def build_all(verbose: bool = False) -> dict[str, str]:
    """Compile every source, all ``nvcc`` processes started together;
    without ``verbose`` only those not built yet.  Returns the compiler's
    output by source name (``verbose`` adds ``-Xptxas -v``: registers,
    shared memory, spills)."""
    extra = ["-Xptxas", "-v"] if verbose else []
    builds = [_Build(n, extra) for n in sources()
              if verbose or not _lib_path(n).exists()]
    # a thread a build reads its output as it comes, so that each one's
    # seconds are its own and no full pipe stalls a compiler
    with concurrent.futures.ThreadPoolExecutor(max(1, len(builds))) as ex:
        done = [ex.submit(b.finish) for b in builds]
    failed = [str(f.exception()) for f in done if f.exception() is not None]
    if failed:      # every source that failed, not only the first
        raise RuntimeError("\n".join(failed))
    return {b.name: f.result() for b, f in zip(builds, done)}


def load(name: str) -> ctypes.CDLL:
    """The shared library of ``csrc/<name>.cu``, built if need be.  Loaded
    as a ``PyDLL``: its functions enqueue work and return within
    microseconds, so a call keeps the GIL instead of giving it up and
    taking it back around every launch."""
    if name not in _loaded:
        if not _lib_path(name).exists():
            _Build(name, []).finish()
        _loaded[name] = ctypes.PyDLL(str(_lib_path(name)))
    return _loaded[name]
