"""Device-mesh parallelism: sharding rules and collectives.

The reference has no distributed runtime (SURVEY.md §2.5) — its only
parallelism is torch DataParallel inside the external vid2vid fork. Here
multi-device scaling is first-class: a ``jax.sharding.Mesh`` with axes
("data", "model"), batch/utterance axes sharded over "data", wide conv
channels sharded over "model", and XLA collectives between devices.
"""

from text2video.parallel.mesh import (
    batch_sharding,
    make_mesh,
    replicate,
    shard_params,
)

__all__ = ["make_mesh", "batch_sharding", "replicate", "shard_params"]
