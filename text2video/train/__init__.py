"""GAN training: states, objectives, sharded train step, checkpoints.

Capability parity with the reference's vid2vid training recipe
(reference: README.md:169-177 — pose-conditioned clips, multiscale +
temporal + face discriminators, 8-way data parallelism) re-designed in
JAX: one jitted train step differentiating through the temporal
``lax.scan``, DP/TP sharding from parallel/mesh.py, Orbax checkpoints.
"""

from text2video.train.trainer import (
    TrainConfig,
    TrainerState,
    create_trainer_state,
    make_train_step,
)

__all__ = [
    "TrainConfig",
    "TrainerState",
    "create_trainer_state",
    "make_train_step",
]
