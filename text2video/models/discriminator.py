"""Discriminators for the pose2frame GAN.

Capability parity with the reference's vid2vid training setup
(reference: README.md:169-177 — ``--num_D 2`` multiscale image
discriminators, a temporal discriminator, ``--add_face_disc`` face
discriminator). Fresh implementation: NHWC, bfloat16, spectral-free
PatchGAN towers; the multiscale pyramid reuses one tower definition per
scale.
"""

from __future__ import annotations

from typing import Any, List, Tuple

import jax
import jax.numpy as jnp

from text2video.models.layers import (
    Conv,
    InstanceNorm,
    Module,
    Scope,
    downscale2x,
    module,
)

Dtype = Any

_PAD2 = ((2, 2), (2, 2))


@module
class PatchDiscriminator(Module):
    """70x70-receptive-field PatchGAN tower.

    Returns (logits, features): per-patch real/fake logits plus the
    intermediate activations used by the feature-matching loss.
    """

    base_ch: int = 64
    n_layers: int = 3
    dtype: Dtype = jnp.bfloat16

    def forward(
        self, s: Scope, x: jax.Array
    ) -> Tuple[jax.Array, List[jax.Array]]:
        feats: List[jax.Array] = []
        ch = self.base_ch
        dt = self.dtype
        x = x.astype(dt)
        x = s(Conv(ch, kernel=4, stride=2, padding=_PAD2, dtype=dt), x)
        x = jax.nn.leaky_relu(x, 0.2)
        feats.append(x)
        for i in range(1, self.n_layers):
            ch = min(ch * 2, 512)
            x = s(Conv(ch, kernel=4, stride=2, padding=_PAD2, dtype=dt), x)
            x = s(InstanceNorm(dtype=dt), x)
            x = jax.nn.leaky_relu(x, 0.2)
            feats.append(x)
        ch = min(ch * 2, 512)
        x = s(Conv(ch, kernel=4, padding=_PAD2, dtype=dt), x)
        x = s(InstanceNorm(dtype=dt), x)
        x = jax.nn.leaky_relu(x, 0.2)
        feats.append(x)
        logits = s(Conv(1, kernel=4, padding=_PAD2, dtype=jnp.float32), x)
        return logits, feats


@module
class MultiscaleDiscriminator(Module):
    """num_D PatchGAN towers over a 2x average-pool image pyramid
    (reference trains with --num_D 2)."""

    num_d: int = 2
    base_ch: int = 64
    n_layers: int = 3
    dtype: Dtype = jnp.bfloat16

    def forward(
        self, s: Scope, x: jax.Array
    ) -> List[Tuple[jax.Array, List[jax.Array]]]:
        outs = []
        cur = x
        for i in range(self.num_d):
            tower = PatchDiscriminator(
                base_ch=self.base_ch, n_layers=self.n_layers, dtype=self.dtype
            )
            outs.append(s(tower, cur, name=f"scale{i}"))
            if i + 1 < self.num_d:
                cur = downscale2x(cur)
        return outs


def face_crop(
    imgs: jax.Array, centers: jax.Array, crop: int
) -> jax.Array:
    """Extract a [crop, crop] window around per-sample face centres.

    The reference's ``--add_face_disc`` crops the mouth/face region from
    the label-derived face bbox. Here the pose stage already knows the
    mouth centre (ops/smooth.py), so we dynamic-slice a fixed-size window
    — static shapes keep the crop jittable.

    Args:
      imgs: [B, H, W, C]; centers: [B, 2] (x, y) pixel coords.
    """
    b, h, w, c = imgs.shape
    half = crop // 2
    x0 = jnp.clip(centers[:, 0].astype(jnp.int32) - half, 0, w - crop)
    y0 = jnp.clip(centers[:, 1].astype(jnp.int32) - half, 0, h - crop)

    def one(img, yy, xx):
        return jax.lax.dynamic_slice(img, (yy, xx, 0), (crop, crop, c))

    return jax.vmap(one)(imgs, y0, x0)
