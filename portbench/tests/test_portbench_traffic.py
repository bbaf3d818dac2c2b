"""The serving traffic generator: seeded, clipped, stratified."""

import numpy as np
import portbench_smoke  # noqa: F401  (puts the benchmark on the path)

from portbench import traffic_gen

MIX = {"prompt": {"dist": "lognormal", "median": 1024, "sigma": 0.5,
                  "min": 256, "max": 1920},
       "output": {"dist": "lognormal", "median": 24, "sigma": 0.75,
                  "min": 4, "max": 128},
       "stratum": 16}


def test_same_seed_same_requests():
    a = traffic_gen.requests(MIX, 50272, 3141592653, 40)
    b = traffic_gen.requests(MIX, 50272, 3141592653, 40)
    assert [len(p) for p, _ in a] == [len(p) for p, _ in b]
    assert all(np.array_equal(p, q) and o == u
               for (p, o), (q, u) in zip(a, b))


def test_other_seed_same_sizes_other_order_and_tokens():
    a = traffic_gen.requests(MIX, 50272, 2 ** 31 + 11, 32)
    b = traffic_gen.requests(MIX, 50272, 2 ** 31 + 12, 32)
    for blk in (slice(0, 16), slice(16, 32)):
        assert sorted(len(p) for p, _ in a[blk]) == \
            sorted(len(p) for p, _ in b[blk])
        assert sorted(o for _, o in a[blk]) == sorted(o for _, o in b[blk])
    assert [len(p) for p, _ in a] != [len(p) for p, _ in b]
    assert not np.array_equal(a[0][0][:8], b[0][0][:8])


def test_lengths_in_clips_with_the_stated_medians():
    reqs = traffic_gen.requests(MIX, 50272, 7, 160)
    prompts = np.array([len(p) for p, _ in reqs])
    outs = np.array([o for _, o in reqs])
    assert prompts.min() >= 256 and prompts.max() <= 1920
    assert outs.min() >= 4 and outs.max() <= 128
    assert abs(np.median(prompts) - 1024) <= 0.05 * 1024
    assert abs(np.median(outs) - 24) <= 0.1 * 24
    assert all(p.dtype == np.int32 and p.min() >= 0 and p.max() < 50272
               for p, _ in reqs)


def test_quantiles_are_the_distribution_strata():
    q = traffic_gen.quantiles({"dist": "lognormal", "median": 100,
                               "sigma": 0.5, "min": 1, "max": 10 ** 6}, 2)
    z = 0.6744897501960817          # the standard normal at 0.75
    assert list(q) == [round(100 * np.exp(-0.5 * z)),
                       round(100 * np.exp(0.5 * z))]


def test_large_and_negative_seeds_are_taken():
    assert len(traffic_gen.requests(MIX, 100, 2 ** 40 + 3, 3)) == 3
    assert len(traffic_gen.requests(MIX, 100, -5, 3)) == 3
