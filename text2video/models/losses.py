"""Training objectives for the pose2frame GAN.

The reference's vid2vid objective family (SURVEY.md §2.3): LSGAN
adversarial terms for multiscale image Ds, a temporal D, and a face D;
discriminator feature matching; VGG perceptual loss; flow losses (warped
previous *real* frame vs current real frame, plus smoothness). All terms
are means over per-element float32 values, so they shard trivially under
DP — a ``psum`` of per-shard means is inserted by pjit.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import jax
import jax.numpy as jnp

from text2video.ops.warp import flow_tv, flow_warp

DiscOut = Tuple[jax.Array, List[jax.Array]]  # (logits, features)


def lsgan_d(real: Sequence[DiscOut], fake: Sequence[DiscOut]) -> jax.Array:
    """Least-squares D loss: real -> 1, fake -> 0, summed over scales."""
    loss = 0.0
    for (lr, _), (lf, _) in zip(real, fake):
        lr = lr.astype(jnp.float32)
        lf = lf.astype(jnp.float32)
        loss += jnp.mean((lr - 1.0) ** 2) + jnp.mean(lf**2)
    return 0.5 * loss


def lsgan_g(fake: Sequence[DiscOut]) -> jax.Array:
    """Least-squares G loss: fake -> 1, summed over scales."""
    loss = 0.0
    for lf, _ in fake:
        loss += jnp.mean((lf.astype(jnp.float32) - 1.0) ** 2)
    return 0.5 * loss


def feature_matching(
    real: Sequence[DiscOut], fake: Sequence[DiscOut]
) -> jax.Array:
    """L1 between D features of real and fake, averaged over layers and
    scales (real features are stop-gradient targets)."""
    loss = 0.0
    n = 0
    for (_, fr), (_, ff) in zip(real, fake):
        for r, f in zip(fr, ff):
            r = jax.lax.stop_gradient(r.astype(jnp.float32))
            loss += jnp.mean(jnp.abs(f.astype(jnp.float32) - r))
            n += 1
    return loss / max(n, 1)


_VGG_LAYER_W = (1 / 32, 1 / 16, 1 / 8, 1 / 4, 1.0)


def perceptual(
    feats_fake: Sequence[jax.Array], feats_real: Sequence[jax.Array]
) -> jax.Array:
    """Weighted L1 over VGG feature maps (deep layers weighted highest)."""
    loss = 0.0
    for w, f, r in zip(_VGG_LAYER_W, feats_fake, feats_real):
        r = jax.lax.stop_gradient(r.astype(jnp.float32))
        loss += w * jnp.mean(jnp.abs(f.astype(jnp.float32) - r))
    return loss


# Keep any single warp-gather operand under this many bytes. The
# 896x512 batch-4 clip-8 train step flattens the photometric warp to 28
# f32 frames whose 4x-stacked gather operand is 28*512*896*12*4 B =
# 2.46 GiB — just past the 2^31-byte line, where the step's losses
# turned NaN on the earlier accelerator while every under-the-line shape
# was finite (tools/nan_probe.py bisect; unverified on the GPU).
# Chunking the loss over the frame axis keeps every operand well under
# the line with identical math.
_WARP_CHUNK_BYTES = 1 << 30


def _warp_chunks(n: int, h: int, w: int, c: int) -> int:
    """Largest divisor of ``n`` whose stacked gather operand stays under
    _WARP_CHUNK_BYTES (f32 compute, 4x channel stack)."""
    frame_bytes = h * w * 4 * c * 4
    chunk = max(int(_WARP_CHUNK_BYTES // max(frame_bytes, 1)), 1)
    while n % chunk:
        chunk -= 1
    return chunk


def flow_loss(
    flow: jax.Array,
    real_prev: jax.Array,
    real_cur: jax.Array,
    tv_weight: float = 0.01,
) -> jax.Array:
    """Supervise flow by warping the previous *real* frame onto the
    current real frame (self-supervised photometric loss) + smoothness.

    The warp runs in frame chunks (lax.map) when the batch is large
    enough that one gather would cross the 2^31-byte hazard line (see
    _WARP_CHUNK_BYTES)."""
    n, h, w, c = real_prev.shape
    prev_f = real_prev.astype(jnp.float32)
    cur_f = real_cur.astype(jnp.float32)
    chunk = _warp_chunks(n, h, w, c)
    if chunk >= n:
        warped = flow_warp(prev_f, flow)
        photo = jnp.mean(jnp.abs(warped - cur_f))
    else:
        groups = n // chunk

        def _group_abs_sum(args):
            fl, rp, rc = args
            return jnp.sum(jnp.abs(flow_warp(rp, fl) - rc))

        sums = jax.lax.map(
            _group_abs_sum,
            (
                flow.astype(jnp.float32).reshape(
                    (groups, chunk, h, w, 2)
                ),
                prev_f.reshape((groups, chunk, h, w, c)),
                cur_f.reshape((groups, chunk, h, w, c)),
            ),
        )
        photo = jnp.sum(sums) / (n * h * w * c)
    return photo + tv_weight * flow_tv(flow)


def flow_supervised_loss(
    flow: jax.Array,
    flow_gt: jax.Array,
    tv_weight: float = 0.01,
) -> jax.Array:
    """Supervise flow against a reference flow field (vid2vid uses
    FlowNet2 output as ground truth; here train/data.py provides
    Farneback flow between the sampled real frames): mean endpoint L1 +
    smoothness."""
    epe = jnp.mean(
        jnp.abs(flow.astype(jnp.float32) - flow_gt.astype(jnp.float32))
    )
    return epe + tv_weight * flow_tv(flow)


def l1(a: jax.Array, b: jax.Array) -> jax.Array:
    return jnp.mean(
        jnp.abs(a.astype(jnp.float32) - jax.lax.stop_gradient(b).astype(jnp.float32))
    )
