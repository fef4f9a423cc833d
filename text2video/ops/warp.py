"""Dense bilinear flow warping — the core of the composite renderer.

The reference's neural renderer (the modified NVIDIA vid2vid fork,
SURVEY.md §2.3; invoked at text2video_audio.sh:42) composes each output
frame as ``mask * hallucinated + (1 - mask) * warp(prev_frame, flow)``.
Its torch implementation uses ``grid_sample``. Here the warp is a gather
of each pixel's 2x2 neighbourhood plus a weighted blend that fuses into
neighbouring elementwise work. Layout is NHWC throughout.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def flow_warp(img: jax.Array, flow: jax.Array) -> jax.Array:
    """Warp ``img`` by ``flow`` with bilinear sampling.

    Args:
      img: [B, H, W, C] source image (any float dtype).
      flow: [B, H, W, 2] pixel-space displacement; ``flow[..., 0]`` is dx
        (columns), ``flow[..., 1]`` is dy (rows). Output pixel (y, x)
        samples ``img`` at (y + dy, x + dx), clamped to the border
        (border-replicate, matching grid_sample(padding_mode='border')).

    Returns:
      [B, H, W, C] warped image in ``img``'s dtype.
    """
    b, h, w, c = img.shape
    compute_dtype = jnp.float32

    yy = jnp.arange(h, dtype=compute_dtype)[:, None]
    xx = jnp.arange(w, dtype=compute_dtype)[None, :]
    sx = xx + flow[..., 0].astype(compute_dtype)  # [B,H,W]
    sy = yy + flow[..., 1].astype(compute_dtype)

    sx = jnp.clip(sx, 0.0, w - 1.0)
    sy = jnp.clip(sy, 0.0, h - 1.0)

    x0 = jnp.floor(sx)
    y0 = jnp.floor(sy)
    wx = (sx - x0)[..., None]  # [B,H,W,1]
    wy = (sy - y0)[..., None]

    x0i = x0.astype(jnp.int32)
    y0i = y0.astype(jnp.int32)

    # ONE gather instead of four: pre-stack each pixel's 2x2 neighbourhood
    # on the channel axis with cheap rolls (right/down neighbours; the
    # last row/column clamps), then gather the top-left corner once:
    # 3 gathers become 3 shifted copies and a 4x-wide channel axis.
    # Whether that beats four gathers on the GPU is not yet measured.
    right = jnp.concatenate([img[:, :, 1:], img[:, :, -1:]], axis=2)
    down = jnp.concatenate([img[:, 1:], img[:, -1:]], axis=1)
    down_right = jnp.concatenate([right[:, 1:], right[:, -1:]], axis=1)
    stacked = jnp.concatenate([img, right, down, down_right], axis=-1)

    flat = stacked.reshape(b, h * w, 4 * c)
    idx = (y0i * w + x0i).reshape(b, h * w, 1)
    gathered = jnp.take_along_axis(flat, idx, axis=1).reshape(b, h, w, 4, c)
    v00 = gathered[..., 0, :]
    v01 = gathered[..., 1, :]
    v10 = gathered[..., 2, :]
    v11 = gathered[..., 3, :]

    # Blend in f32: the gathered VALUES ride the image dtype (that is
    # where the gather bytes are), but the subpixel lerp weights stay at
    # full precision — quantizing wx/wy to bf16 (~2^-8) injects
    # position-dependent error that the autoregressive warp recurrence
    # feeds back every frame (round-4 advisor finding). The upcast is
    # elementwise and fuses into the blend; only the final result
    # rounds back to img.dtype.
    top = v00.astype(compute_dtype) + (v01 - v00).astype(compute_dtype) * wx
    bot = v10.astype(compute_dtype) + (v11 - v10).astype(compute_dtype) * wx
    return (top + (bot - top) * wy).astype(img.dtype)


def flow_tv(flow: jax.Array) -> jax.Array:
    """Total-variation smoothness penalty on a [B, H, W, 2] flow field.

    Mean absolute forward difference along both spatial axes — the flow
    regulariser of the composite objective.
    """
    dy = jnp.abs(flow[:, 1:, :, :] - flow[:, :-1, :, :])
    dx = jnp.abs(flow[:, :, 1:, :] - flow[:, :, :-1, :])
    return dy.mean() + dx.mean()
