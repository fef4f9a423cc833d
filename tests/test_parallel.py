"""Mesh/sharding rule tests on the 8-device virtual CPU mesh."""

import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from text2video.parallel.mesh import (
    batch_sharding,
    make_mesh,
    param_specs,
    shard_params,
)


def test_make_mesh_shapes():
    mesh = make_mesh()
    assert mesh.shape["data"] == 8 and mesh.shape["model"] == 1
    mesh = make_mesh(n_data=4, n_model=2)
    assert mesh.shape == {"data": 4, "model": 2}


def test_param_specs_rules():
    mesh = make_mesh(n_data=4, n_model=2)
    params = {
        "wide_conv": np.zeros((3, 3, 64, 512), np.float32),
        "narrow_conv": np.zeros((3, 3, 8, 16), np.float32),
        "odd_channels": np.zeros((3, 3, 64, 257), np.float32),
        "bias": np.zeros((512,), np.float32),
    }
    specs = param_specs(params, mesh)
    assert specs["wide_conv"] == P(None, None, None, "model")
    assert specs["narrow_conv"] == P()
    assert specs["odd_channels"] == P()  # not divisible by n_model
    assert specs["bias"] == P()


def test_shard_params_placement():
    mesh = make_mesh(n_data=4, n_model=2)
    params = {"w": np.arange(3 * 3 * 4 * 512, dtype=np.float32).reshape(
        3, 3, 4, 512)}
    placed = shard_params(params, mesh)
    w = placed["w"]
    # Sharded over model axis: each shard holds half the output channels.
    shard_shapes = {tuple(s.data.shape) for s in w.addressable_shards}
    assert shard_shapes == {(3, 3, 4, 256)}
    np.testing.assert_array_equal(np.asarray(w), params["w"])


def test_batch_sharding_spec():
    mesh = make_mesh()
    s = batch_sharding(mesh, ndim=3)
    assert s.spec == P("data", None, None)
