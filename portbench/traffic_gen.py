"""The one generator of serving traffic: requests from a mix file and a seed.

A mix gives its prompt and output lengths as clipped log-normals
(``median``, ``sigma``, ``min``, ``max``).  Lengths are drawn by strata:
every block of ``stratum`` consecutive requests holds the same ``stratum``
quantiles of each distribution, at (i + 0.5) / stratum, and the seed only
orders them inside the block (prompt and output lengths each by their own
permutation) and draws the token ids, uniform over the vocabulary.  So
every seed serves the same set of sizes in another order, and a window
that takes some tens of requests sees the same mix on every seed.  Each
part has its own substream of ``numpy.random.SeedSequence([seed, part])``.
"""

from __future__ import annotations

import math
import statistics

import numpy as np

_STREAMS = {"prompt_order": 1, "output_order": 2, "tokens": 3, "check": 4}


def rng(seed: int, part: str) -> np.random.Generator:
    """The substream ``part`` of ``seed`` (any whole number)."""
    return np.random.default_rng(
        np.random.SeedSequence([int(seed) & (2 ** 64 - 1), _STREAMS[part]]))


def quantiles(dist: dict, n: int) -> np.ndarray:
    """The n stratum lengths of a clipped log-normal, as integers."""
    if dist["dist"] != "lognormal":
        raise ValueError(f"unknown length distribution {dist['dist']!r}")
    z = statistics.NormalDist()
    vals = [dist["median"] * math.exp(dist["sigma"] * z.inv_cdf((i + 0.5) / n))
            for i in range(n)]
    return np.clip(np.rint(vals), dist["min"], dist["max"]).astype(np.int64)


def requests(mix: dict, vocab: int, seed: int, count: int
             ) -> list[tuple[np.ndarray, int]]:
    """``count`` requests of ``mix``: (prompt token ids (int32), output
    length) in the order they are sent."""
    k = mix["stratum"]
    p_len, o_len = quantiles(mix["prompt"], k), quantiles(mix["output"], k)
    po, oo = rng(seed, "prompt_order"), rng(seed, "output_order")
    toks = rng(seed, "tokens")
    out = []
    for block in range(-(-count // k)):
        prompts, outputs = po.permutation(p_len), oo.permutation(o_len)
        for i in range(k):
            if len(out) == count:
                break
            prompt = toks.integers(0, vocab, size=int(prompts[i]),
                                   dtype=np.int32)
            out.append((prompt, int(outputs[i])))
    return out
