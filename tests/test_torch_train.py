"""The training side of the port as a whole, against the JAX reference.

For every architecture's smoke config in fp32, on the reference's weights
carried over by ``convert.params_from_jax`` and the same numpy batch: the
port's ``forward_train`` logits, ``loss_fn`` and every gradient (autograd
through the kernel ops, whose backward passes on the CPU are the plain
versions ``matmul_bwd_ref``, ``fused_mlp_bwd_ref`` and ``mha_bwd_ref``)
against ``jax.value_and_grad`` of the reference's ``loss_fn``.  Remat is
off on both sides for the parity; the port's remat is held to its own
run without.

Tolerances: logits within 2e-4 * (max|ref| + 1), the fp32 bound of the
serving tests (the two frameworks sum in other orders); the loss within
1e-5 relative; each gradient leaf within 2e-4 * (max|ref leaf| + 1e-3)
(the smallest leaves, norm scales of a few layers, are of order 1e-3).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import transformer as jtfm
from repro.models.frontends import frontend_embeddings as jax_frontends
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.convert import params_from_jax, tensor_from_numpy
from repro_torch.models import transformer as tfm
from repro_torch.tree import tree_items, tree_leaves

B, S = 2, 12


def _setup(arch: str, seed: int = 0, **narrow):
    """The reference's smoke config of ``arch`` in fp32, or with ``narrow``
    its full config with those fields replaced, and the port's twin."""
    if narrow:
        jcfg = dataclasses.replace(jax_config(arch), **narrow)
        tcfg = dataclasses.replace(get_config(arch), **narrow)
    else:
        jcfg, tcfg = jax_smoke_config(arch), get_smoke_config(arch)
    jcfg = dataclasses.replace(jcfg, dtype="float32", param_dtype="float32")
    tcfg = dataclasses.replace(tcfg, dtype="float32", param_dtype="float32")
    jparams = jtfm.init_params(jax.random.PRNGKey(seed), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    labels = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    fe = jax_frontends(jcfg, B)
    jbatch = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels),
              **fe}
    tbatch = {"tokens": torch.from_numpy(tokens),
              "labels": torch.from_numpy(labels)}
    for k, v in fe.items():
        tbatch[k] = tensor_from_numpy(np.asarray(v), "cpu")
    for p in tree_leaves(tparams):
        p.requires_grad_(True)
    return jcfg, jparams, jbatch, tcfg, tparams, tbatch


# gemma-7b narrowed but at its head dim of 256 (G 1, GeGLU, tied and scaled
# embedding): the smoke configs keep head dims of 16
GEMMA_D256 = dict(num_layers=2, d_model=64, num_heads=2, num_kv_heads=2,
                  head_dim=256, d_ff=128, vocab_size=256)


def _check_loss_and_gradients(jcfg, jparams, jbatch, tcfg, tparams, tbatch):
    jloss, jgrads = jax.value_and_grad(
        lambda p: jtfm.loss_fn(p, jcfg, jbatch, remat=False))(jparams)
    jlogits = jtfm.forward_train(jparams, jcfg, jbatch["tokens"],
                                 remat=False,
                                 embeds=jbatch.get("embeds"),
                                 enc_embeds=jbatch.get("enc_embeds"))
    logits = tfm.forward_train(tparams, tcfg, tbatch["tokens"], remat=False,
                               embeds=tbatch.get("embeds"),
                               enc_embeds=tbatch.get("enc_embeds"))
    ref = np.asarray(jlogits, np.float32)
    assert logits.shape == ref.shape
    assert np.max(np.abs(logits.detach().numpy() - ref)) \
        < 2e-4 * (np.max(np.abs(ref)) + 1)

    loss = tfm.loss_fn(tparams, tcfg, tbatch, remat=False)
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=1e-5)
    loss.backward()
    want = dict(tree_items(params_from_jax(
        jax.tree.map(np.asarray, jgrads), tcfg, device="cpu")))
    got = dict(tree_items(tparams))
    assert set(got) == set(want)
    for path, p in got.items():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        w = want[path].numpy()
        err = float(np.max(np.abs(g.numpy() - w)))
        assert err < 2e-4 * (float(np.max(np.abs(w))) + 1e-3), (path, err)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_loss_and_every_gradient_match_the_reference(arch):
    _check_loss_and_gradients(*_setup(arch))


def test_gemma_at_head_dim_256_matches_the_reference():
    _check_loss_and_gradients(*_setup("gemma_7b", **GEMMA_D256))
