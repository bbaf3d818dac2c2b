"""The port's meshes and sharding rules against the JAX package's.

The reference's rule functions read only ``mesh.shape``, so both take a
stub with the production shapes: no 256 devices are needed.  Parameters
are compared leaf by leaf at full size for every architecture id: the
reference's ``jax.eval_shape`` of ``init_params`` (stacked layout) against
the port's meta tensors (a list of layers), each port leaf mapped to its
reference leaf by ``sharding.reference_path``.
"""

import functools
import types

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.distributed import sharding as ref_sh
from repro.launch import mesh as ref_mesh
from repro.launch import specs as ref_specs
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.distributed import sharding as sh
from repro_torch.launch import mesh as pmesh
from repro_torch.launch import specs
from repro_torch.models import transformer as tfm
from repro_torch.tree import tree_items

MESHES = {"single": {"data": 16, "model": 16},
          "multi": {"pod": 2, "data": 16, "model": 16},
          "one": {"data": 1, "model": 1}}
RULES = [(False, "tp"), (True, "tp"), (False, "fsdp2d"), (True, "fsdp2d")]


def stub(name):
    return types.SimpleNamespace(shape=dict(MESHES[name]))


def norm(spec) -> tuple:
    """A spec with each one-axis tuple written as its axis (the same
    placement; ``PartitionSpec`` may keep either form)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


@functools.lru_cache(maxsize=None)
def ref_leaves(arch: str) -> dict:
    """{reference path: (stacked shape, itemsize)} of the reference's
    full-size parameters, from ``jax.eval_shape``."""
    tree = ref_specs.params_struct(ref_get_config(arch))
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {ref_sh._path_str(p): (tuple(leaf.shape),
                                  np.dtype(leaf.dtype).itemsize)
            for p, leaf in flat}


def test_production_meshes_are_the_references_and_refuse_to_place():
    for multi, n in ((False, 256), (True, 512)):
        m = pmesh.make_production_mesh(multi_pod=multi)
        want = {"pod": 2, "data": 16, "model": 16} if multi else \
            {"data": 16, "model": 16}
        assert m.shape == want
        assert list(m.shape) == list(want)          # ordered, as jax's
        assert m.axis_names == tuple(want)
        assert pmesh.mesh_num_devices(m) == n
        with pytest.raises(RuntimeError, match=f"needs {n} devices"):
            m.devices


def test_local_mesh_clamps_as_the_reference(mesh11):
    for data, model in ((1, 1), (2, 1), (2, 4)):
        ref = ref_mesh.make_local_mesh(data, model)
        got = pmesh.make_local_mesh(data, model, device="cpu")
        assert got.shape == dict(ref.shape)
        assert got.devices == (torch.device("cpu"),)
    assert dict(mesh11.shape) == pmesh.make_local_mesh(device="cpu").shape


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_the_references(arch):
    """Every leaf's shape, and its spec under fsdp on and off in both
    layouts on the three meshes, equal the reference's once the stacked
    leading dim is dropped; every reference leaf is reached."""
    cfg = get_config(arch)
    ref = ref_leaves(arch)
    port = tfm.param_shapes(cfg)
    items = list(tree_items(port))
    seen = set()
    for path, leaf in items:
        rpath, stacked = sh.reference_path(path, cfg)
        seen.add(rpath)
        rshape = ref[rpath][0]
        assert rshape == ((stacked,) if stacked else ()) + tuple(leaf.shape)
    assert seen == set(ref)
    for name in MESHES:
        mesh = stub(name)
        for fsdp, layout in RULES:
            specs_tree = sh.param_specs(port, mesh, fsdp, layout, cfg=cfg)
            for (path, _), (_, spec) in zip(items, sh._zip_leaves(
                    port, specs_tree)):
                rpath, stacked = sh.reference_path(path, cfg)
                want = tuple(ref_sh.param_pspec(rpath, ref[rpath][0], mesh,
                                                fsdp, layout))
                assert norm(spec) == norm(want[1 if stacked else 0:]), \
                    (path, name)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_local_bytes_equal_the_references_shards(arch):
    """Per-device bytes of the parameters under the rules: the port's
    ``local_bytes`` against the same sum over the reference's stacked
    leaves and specs."""
    cfg = get_config(arch)
    ref = ref_leaves(arch)
    port = tfm.param_shapes(cfg)
    for name in MESHES:
        mesh = stub(name)
        for fsdp, layout in RULES[:3]:
            want = 0
            for rpath, (shape, size) in ref.items():
                spec = ref_sh.param_pspec(rpath, shape, mesh, fsdp, layout)
                n = size
                for d, entry in zip(shape, tuple(spec) + (None,) * 8):
                    axes = () if entry is None else (
                        entry if isinstance(entry, tuple) else (entry,))
                    n *= d // int(np.prod([mesh.shape[a] for a in axes]))
                want += n
            got = sh.local_bytes(port, sh.param_specs(port, mesh, fsdp,
                                                      layout, cfg=cfg), mesh)
            assert got == want, (name, fsdp, layout)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_equal_the_references(arch):
    """Every cache leaf of the serving cells (the int8 ring of decode_32k,
    the bf16 rings, recurrent states, cross K/V) on the three meshes."""
    cfg = get_config(arch)
    for shape in ("prefill_32k", "decode_32k", "long_500k"):
        kv = torch.int8 if shape == "decode_32k" and not cfg.rwkv \
            else torch.bfloat16
        case = specs.SHAPES[shape]
        cache = specs.cache_struct(cfg, case, kv)
        for name in MESHES:
            mesh = stub(name)
            got = sh.cache_specs(cache, mesh)
            for key, leaf in cache.items():
                shp = tuple(getattr(leaf, "shape", ()))
                assert norm(got[key]) == norm(ref_sh.cache_pspec(key, shp,
                                                                 mesh))


def test_batch_axes_and_specs_equal_the_references():
    for name in MESHES:
        mesh = stub(name)
        assert sh.batch_axes(mesh) == ref_sh.batch_axes(mesh)
        assert norm(sh.batch_pspec(mesh)) == norm(ref_sh.batch_pspec(mesh))
        batch = {"tokens": torch.empty((32, 8), device="meta"),
                 "embeds": torch.empty((32, 4, 16), device="meta")}
        want = (ref_sh.batch_axes(mesh),)
        assert sh.batch_specs(batch, mesh) == {
            "tokens": want + (None,), "embeds": want + (None, None)}


def test_local_shape_and_the_identities_of_one_device():
    mesh = stub("single")
    assert sh.local_shape((64, 4096), (None, ("data", "model")), mesh) \
        == (64, 16)
    assert sh.local_shape((8, 40, 30), ("data", "model", None), mesh) \
        == (1, 3, 30)
    x = torch.ones(4, 3)
    assert sh.constrain_batch(x, stub("one")) is x
    assert sh.replicated(mesh).spec == ()
