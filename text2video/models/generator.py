"""Composite pose2frame generator (vid2vid-equivalent).

Capability target: the reference's neural renderer — a modified NVIDIA
vid2vid fork driven as ``python test.py --dataset_mode pose --input_nc 3
--loadSize 512 --openpose_only --no_first_img`` (reference:
text2video_audio.sh:42, README.md:169-177; SURVEY.md §2.3). That design is
a *composite* sequential generator: from the current pose-label map, a few
previous label maps, and the previously generated frames, predict

  * a hallucinated frame ``h``,
  * a dense flow ``w`` from the last generated frame to the current one,
  * an occlusion mask ``m``,

and output ``o = m * h + (1 - m) * warp(prev, w)``. The first frame of an
utterance has no previous frame (``--no_first_img``), so the mask is
forced open.

This implementation is a fresh JAX design, not a port:

  * NHWC + bfloat16; instance-norm stats in float32.
  * One traced program per step; the autoregressive loop lives in
    ``lax.scan`` (see ``render.py``), so an utterance compiles once.
  * ``has_prev`` is a traced [B] weight rather than a Python branch —
    first-frame handling costs one multiply instead of a recompile.
  * Upsampling = resize + conv; all convs reflect-padded VALID.
  * Coarse-to-fine: a global trunk at 1/2**n_local resolution plus
    optional local-enhancer stages (pix2pixHD-style) for higher
    resolutions; heads sit on the finest stage.
"""

from __future__ import annotations

from typing import Any, Tuple

import jax
import jax.numpy as jnp

from text2video.models.layers import (
    Conv,
    ConvBlock,
    Module,
    ResBlock,
    Scope,
    Upsample,
    downscale2x,
    module,
    reflect_pad,
)
from text2video.ops.phase_conv import head_conv_phase
from text2video.ops.warp import flow_warp

Dtype = Any


@module
class GlobalTrunk(Module):
    """Single encoder over channel-concatenated inputs -> resblocks ->
    decoder. Returns the pre-head feature map at input resolution.

    Labels and previous frames concatenate on channels into ONE encoder
    (vid2vid conditions the same way); a two-branch encoder costs 2x the
    conv FLOPs for a first layer that channel-concat already subsumes.

    ``phase_form``: decoder upsamples run as exact coarse-resolution
    phase convs (ops/phase_conv.py); with ``emit_phase_last`` the final
    stage returns the [B, H/2, W/2, 4*base_ch] phase tensor (for the
    phase-aware heads) instead of the materialised full-res map."""

    base_ch: int = 64
    n_downsample: int = 3
    n_blocks: int = 9
    dtype: Dtype = jnp.bfloat16
    phase_form: bool = False
    emit_phase_last: bool = False

    def forward(
        self, s: Scope, labels: jax.Array, prev_imgs: jax.Array
    ) -> jax.Array:
        ch = self.base_ch
        x = jnp.concatenate([labels, prev_imgs], axis=-1)
        # Phase-form stem: run the 7x7 full-res conv as a half-res window
        # conv over space_to_depth(input) and hand the phase tensor
        # straight to the first stride-2 downsample, so the [B, H, W, 64]
        # map is never materialised. Exact; same parameters
        # (ops/phase_conv.py).
        phase_stem = (
            self.phase_form
            and self.n_downsample >= 1
            and x.shape[1] % 2 == 0
            and x.shape[2] % 2 == 0
        )
        x = s(ConvBlock(ch, kernel=7, dtype=self.dtype,
                        phase_stem=phase_stem), x)
        for i in range(self.n_downsample):
            ch *= 2
            x = s(ConvBlock(
                ch,
                stride=2,
                dtype=self.dtype,
                from_phase=phase_stem and i == 0,
            ), x)
        for _ in range(self.n_blocks):
            x = s(ResBlock(ch, dtype=self.dtype), x)
        for i in range(self.n_downsample):
            ch //= 2
            last = i == self.n_downsample - 1
            x = s(Upsample(
                ch,
                dtype=self.dtype,
                phase_form=self.phase_form,
                emit_phase=self.phase_form and self.emit_phase_last and last,
            ), x)
        return x  # [B, H, W, base_ch] (or phase [B, H/2, W/2, 4*base_ch])


@module
class CompositeGenerator(Module):
    """Flow-warped composite frame generator.

    Args (shapes):
      labels: [B, H, W, 3 * n_label_ctx] — pose label maps, current first.
      prev_imgs: [B, H, W, 3 * n_prev] — previously generated frames,
        most recent first; zeros on the first step.
      has_prev: [B] float in {0, 1} — 0 forces pure hallucination
        (first frame of an utterance), 1 enables the warp composite.

    Returns:
      (frame, flow, mask): [B,H,W,3] in [-1,1], [B,H,W,2] pixels,
      [B,H,W,1] in [0,1] (after first-frame forcing).
    """

    base_ch: int = 64
    n_downsample: int = 3
    n_blocks: int = 9
    n_local_enhancers: int = 0
    n_local_blocks: int = 3
    flow_scale: float = 10.0
    dtype: Dtype = jnp.bfloat16
    # Exact phase-form decoder tail (ops/phase_conv.py): identical math
    # and parameters. Kept as a flag so equality with the plain path is
    # testable (tests/test_phase_conv.py) and so the plain path serves as
    # the float32 reference.
    phase_form: bool = True

    def forward(
        self,
        s: Scope,
        labels: jax.Array,
        prev_imgs: jax.Array,
        has_prev: jax.Array,
    ) -> Tuple[jax.Array, jax.Array, jax.Array]:
        dt = self.dtype
        labels = labels.astype(dt)
        prev_imgs = prev_imgs.astype(dt)

        # Coarse-to-fine: run the global trunk at reduced resolution, then
        # refine with local enhancers at successively finer scales.
        pyramid_l = [labels]
        pyramid_i = [prev_imgs]
        for _ in range(self.n_local_enhancers):
            pyramid_l.append(downscale2x(pyramid_l[-1]))
            pyramid_i.append(downscale2x(pyramid_i[-1]))

        feat = s(GlobalTrunk(
            base_ch=self.base_ch,
            n_downsample=self.n_downsample,
            n_blocks=self.n_blocks,
            dtype=dt,
            phase_form=self.phase_form,
            emit_phase_last=self.n_local_enhancers == 0,
        ), pyramid_l[-1], pyramid_i[-1])

        for lvl in range(self.n_local_enhancers - 1, -1, -1):
            ch = self.base_ch // 2
            y = jnp.concatenate([pyramid_l[lvl], pyramid_i[lvl]], axis=-1)
            y = s(ConvBlock(ch, kernel=7, dtype=dt), y)
            y = s(ConvBlock(2 * ch, stride=2, dtype=dt), y)
            b, h, w, _ = y.shape
            feat = jax.image.resize(
                feat, (b, h, w, feat.shape[-1]), method="nearest"
            )
            y = y + s(Conv(2 * ch, padding="SAME", dtype=dt), feat)
            for _ in range(self.n_local_blocks):
                y = s(ResBlock(2 * ch, dtype=dt), y)
            feat = s(Upsample(
                ch, dtype=dt, phase_form=self.phase_form,
                emit_phase=self.phase_form and lvl == 0,
            ), y)

        # Heads: ONE 7x7 conv producing all 6 channels (img 3 + flow 2 +
        # mask 1), then a split — mathematically identical to separate
        # convs. In phase form the conv consumes the decoder's phase
        # tensor at half resolution (ops/phase_conv.py::head_conv_phase),
        # exactly the same function again.
        head_conv = Conv(6, kernel=7, dtype=dt)
        hs = s.child(head_conv, name="heads")
        if self.phase_form:
            k7, b7 = head_conv.weights(hs, feat.shape[-1] // 4)
            heads = head_conv_phase(feat, k7.astype(dt))
            heads = (heads + b7.astype(dt)).astype(jnp.float32)
        else:
            heads = head_conv.forward(hs, reflect_pad(feat, 3))
            heads = heads.astype(jnp.float32)
        raw = jnp.tanh(heads[..., 0:3])
        flow = heads[..., 3:5] * self.flow_scale
        mask = jax.nn.sigmoid(heads[..., 5:6])

        # Warp in the compute dtype: prev_imgs was already cast to ``dt``
        # above, so an f32 upcast here would add no information, only
        # gather bytes. Sample positions stay f32 inside flow_warp.
        prev = prev_imgs[..., :3]
        warped = flow_warp(prev, flow).astype(jnp.float32)
        # First frame: no previous image to warp — force the mask open.
        hp = has_prev.astype(jnp.float32).reshape(-1, 1, 1, 1)
        mask = mask * hp + (1.0 - hp)
        frame = mask * raw + (1.0 - mask) * warped
        return frame, flow, mask
