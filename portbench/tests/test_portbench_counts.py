"""The yardstick's arithmetic against hand-computed values."""

import pytest
import portbench_smoke  # noqa: F401  (puts the benchmark on the path)

from portbench import counts

TINY = {"num_layers": 1, "d_model": 4, "num_heads": 2, "num_kv_heads": 1,
        "d_ff": 8, "vocab_size": 10, "qkv_bias": True, "gated_mlp": False}


def test_product_counts_operations_and_each_byte_once():
    assert counts.product(2, 3, 4) == (48, 2 * (6 + 12 + 8))
    assert counts.product(2, 3, 4, bias=True) == (48, 2 * (6 + 12 + 8 + 4))


@pytest.mark.parametrize("window,start,count,keys", [
    (0, 2, 3, 3 + 4 + 5), (4, 0, 6, 1 + 2 + 3 + 4 + 4 + 4), (4, 5, 3, 12),
    (4, 2, 3, 3 + 4 + 4)])
def test_keys_seen_causal_and_windowed(window, start, count, keys):
    m = counts.dims(dict(TINY, sliding_window=window,
                         swa_layers="all" if window else "none"))
    assert counts.keys_seen_sum(m, start, count) == keys
    assert keys == sum(counts.keys_seen(m, p)
                       for p in range(start, start + count))


def test_attention_reads_live_keys_once():
    m = counts.dims(TINY)                   # hq 2, hkv 1, hd 2
    flops, nbytes = counts.attention(m, 0, 3)
    assert flops == 4 * 2 * 2 * (1 + 2 + 3)
    assert nbytes == 2 * 2 * (2 * 2 * 3 + 2 * 1 * 3)
    mw = counts.dims(dict(TINY, sliding_window=2, swa_layers="all"))
    assert counts.attention(mw, 10, 3) == (4 * 2 * 2 * 6,
                                           2 * 2 * (2 * 2 * 3 + 2 * 1 * 4))


def test_lm_head_only_where_logits_are_needed():
    m = counts.dims(TINY)
    mid = counts.chunk_pass(m, 0, 3, final=False)["matmul"]
    last = counts.chunk_pass(m, 0, 3, final=True)["matmul"]
    assert last.flops - mid.flops == 2 * 1 * 4 * 10
    assert last.bytes - mid.bytes == 2 * (4 + 40 + 10)
    dec = counts.decode_pass(m, [0, 4])
    layer = sum(f for f, _ in counts.layer_products(m, 2))
    assert dec["matmul"].flops == layer + 2 * 2 * 4 * 10
    assert dec["attention"].flops == 4 * 2 * 2 * (1 + 5)


def test_layer_products_with_biases_and_one_mlp_operation():
    m = counts.dims(TINY)
    ops = counts.layer_products(m, 3)
    assert ops[0] == counts.product(3, 4, 4, bias=True)
    assert ops[3] == counts.product(3, 4, 4)
    assert ops[4] == (2 * 3 * 4 * 8 * 2,
                      2 * (3 * 4 + 2 * 4 * 8 + 3 * 4 + 8 + 4))


def test_train_model_flops_six_n_t_plus_attention():
    m = counts.dims(TINY)
    params = 4 * 4 * 2 + 2 * 2 * 4 + 2 * 4 * 8 + 4 * 10
    assert counts.train_model_flops(m, 1, 3) == 6 * params * 3 + 3 * 96


def test_train_step_counts_the_recompute():
    m = counts.dims(TINY)
    step = counts.train_step(m, 1, 3)
    fwd = sum(f for f, _ in counts.layer_products(m, 3))
    assert step["matmul"].flops == 4 * fwd + 3 * 2 * 3 * 4 * 10
    assert step["attention"].flops == 4.5 * 96


def test_least_time_is_the_larger_bound():
    assert counts.least_seconds(989e12, 1.0) == pytest.approx(1.0)
    assert counts.least_seconds(1.0, 3.35e12) == pytest.approx(1.0)
