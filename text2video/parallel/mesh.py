"""Mesh construction and sharding rules.

Replaces the reference's torch ``DataParallel`` (reference: README.md:171-174,
8-GPU NCCL replication) with jax.sharding: one mesh, named axes,
compiler-inserted collectives between devices.

Axes:
  * "data"  — batch / utterance axis (DP). Gradients all-reduce over it.
  * "model" — output-channel axis of the widest conv kernels (TP-flavoured
    weight sharding; XLA inserts all-gathers where needed).
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(
    n_data: Optional[int] = None,
    n_model: int = 1,
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """Build a ("data", "model") mesh over the available devices.

    Defaults to all devices on the data axis. ``n_data * n_model`` must
    divide into the device count.
    """
    devs = list(devices if devices is not None else jax.devices())
    if n_data is None:
        n_data = len(devs) // n_model
    use = n_data * n_model
    arr = np.array(devs[:use]).reshape(n_data, n_model)
    return Mesh(arr, ("data", "model"))


def batch_sharding(mesh: Mesh, ndim: int = 4) -> NamedSharding:
    """Leading-axis ("data",) sharding for a batch of rank ``ndim``."""
    return NamedSharding(mesh, P("data", *([None] * (ndim - 1))))


def replicate(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def _leaf_spec(path: str, shape) -> P:
    """Partition rule for one parameter leaf.

    Conv kernels are HWIO; shard the output-channel (last) axis over
    "model" when it divides evenly and is wide enough to be worth the
    all-gather. Everything else is replicated.
    """
    if len(shape) == 4 and shape[-1] >= 256:
        return P(None, None, None, "model")
    return P()


def shard_params(params: Any, mesh: Mesh) -> Any:
    """Device_put a param pytree with model-axis sharding rules applied."""
    n_model = mesh.shape["model"]

    def place(leaf):
        arr = np.asarray(leaf) if not isinstance(leaf, jax.Array) else leaf
        spec = _leaf_spec("", arr.shape)
        if spec != P() and arr.shape[-1] % n_model != 0:
            spec = P()
        return jax.device_put(arr, NamedSharding(mesh, spec))

    return jax.tree.map(place, params)


def param_specs(params: Any, mesh: Mesh) -> Any:
    """PartitionSpec pytree matching :func:`shard_params`."""
    n_model = mesh.shape["model"]

    def spec_of(leaf):
        shape = np.shape(leaf)
        spec = _leaf_spec("", shape)
        if spec != P() and shape[-1] % n_model != 0:
            spec = P()
        return spec

    return jax.tree.map(spec_of, params)
