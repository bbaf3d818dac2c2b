"""The card's distributed shared memory (DSMEM) rate, measured (port only).

``measure_dsmem`` runs the probe ``kernels/csrc/dsmem_probe.cu``: clusters
of 2 blocks, one block an SM, as many clusters as the card holds at once,
each block reading its peer's 64 KB of shared memory ``rounds`` times in
16-byte loads.  It times the launch with CUDA events and gives the rate in
the unit of ``ChipConfig.link_bw``: one SM reading another, one direction
(``chip/h100.DSMEM_BYTES_PER_S`` holds the measured number).  The sum of the
words each block read is held against its peer's words, so a read that did
not reach the peer's memory fails the measurement.

The library is built and loaded only when ``measure_dsmem`` is called, so
this module, and ``chip/h100.py`` with it, imports on a machine without a
card or ``nvcc``.
"""

from __future__ import annotations

import ctypes
import json
import statistics
import subprocess

import numpy as np
import torch

from repro_torch.kernels import _build

MASK = 2 ** 32 - 1


def _lib() -> ctypes.CDLL:
    lib = _build.load("dsmem_probe")
    if lib.dsmem_probe_launch.argtypes is None:
        lib.dsmem_probe_launch.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_void_p]
        lib.dsmem_probe_launch.restype = ctypes.c_int
        lib.dsmem_probe_max_clusters.argtypes = []
        lib.dsmem_probe_max_clusters.restype = ctypes.c_int
        lib.dsmem_probe_buffer_bytes.argtypes = []
        lib.dsmem_probe_buffer_bytes.restype = ctypes.c_int
    return lib


def word_sum(rank: int, words: int) -> int:
    """Sum (mod 2**32) of the ``words`` words the probe's block of cluster
    rank ``rank`` writes: word i is ``rank * 0x9E3779B9 + i * 0x85EBCA6B +
    1`` (mod 2**32), as ``word_of`` of the source."""
    i = np.arange(words, dtype=np.uint64)
    w = (rank * 0x9E3779B9 + i * 0x85EBCA6B + 1) & MASK
    return int(w.sum()) & MASK


def expected_sums(clusters: int, rounds: int, words: int) -> np.ndarray:
    """What each of the ``2 * clusters`` blocks must add up: its peer's
    (rank ^ 1) words, ``rounds`` times, mod 2**32."""
    per_rank = [word_sum(rank ^ 1, words) * rounds & MASK for rank in (0, 1)]
    return np.array(per_rank * clusters, dtype=np.uint64)


def measure_dsmem(rounds: int = 1024, repeats: int = 5,
                  device="cuda") -> dict:
    """The DSMEM rate of the card ``device``: ``bytes_per_s_per_sm`` (one
    SM reading its peer, one direction; the median of ``repeats`` timed
    launches after one untimed), ``bytes_per_s`` (every SM at once),
    ``clusters``, ``sms``, ``rounds``, ``buffer_bytes`` and ``ms``.  Raises
    if the card holds no cluster of 2, if a launch is refused, or if a
    block's sum differs from its peer's words."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"the DSMEM probe runs on a CUDA device, not "
                         f"{device}")
    lib = _lib()
    clusters = lib.dsmem_probe_max_clusters()
    if clusters < 1:
        raise RuntimeError(f"the card holds no cluster of 2 probe blocks "
                           f"(cudaOccupancyMaxActiveClusters: {clusters})")
    buf = lib.dsmem_probe_buffer_bytes()
    want = expected_sums(clusters, rounds, buf // 4)
    sums = torch.zeros(2 * clusters, dtype=torch.int32, device=device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        for rep in range(repeats + 1):
            sums.zero_()
            start.record()
            err = lib.dsmem_probe_launch(sums.data_ptr(), clusters, rounds,
                                         stream)
            end.record()
            if err != 0:
                raise RuntimeError(f"dsmem_probe_launch refused: error {err}")
            torch.cuda.synchronize(device)
            got = sums.cpu().numpy().view(np.uint32).astype(np.uint64)
            if not np.array_equal(got, want):
                bad = int(np.flatnonzero(got != want)[0])
                raise RuntimeError(
                    f"dsmem probe block {bad} read {got[bad]:#x}, its "
                    f"peer's words sum to {want[bad]:#x}")
            if rep:                 # the first launch is a warm-up
                times.append(start.elapsed_time(end))
    ms = statistics.median(times)
    per_sm = buf * rounds / (ms * 1e-3)
    return {"bytes_per_s_per_sm": per_sm, "bytes_per_s": per_sm * 2 * clusters,
            "clusters": clusters, "sms": 2 * clusters, "rounds": rounds,
            "buffer_bytes": buf, "ms": ms}


def main() -> None:
    """``python -m repro_torch.chip.dsmem``: the card's name and power limit
    as ``nvidia-smi`` gives them, then the measurement as one JSON line."""
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout
    print(card.strip().splitlines()[0])
    print(json.dumps(measure_dsmem()))


if __name__ == "__main__":
    main()
