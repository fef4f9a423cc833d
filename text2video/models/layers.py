"""Shared building blocks for the pose2frame renderer networks.

Conventions:
  * NHWC layout everywhere.
  * bfloat16 activations by default, float32 parameters and
    normalisation stats.
  * Upsampling = nearest-resize + conv (no transposed convs, no
    checkerboard).
  * Reflection padding + VALID convs where the reference generator family
    (pix2pixHD/vid2vid-style) uses ReflectionPad2d.

The networks are plain ``jax``/``lax`` functions over a nested dict of
parameters. A :class:`Module` is a frozen dataclass of hyperparameters
with ``init(rng, *inputs) -> {"params": tree}`` and ``apply(variables,
*inputs)``; its ``forward`` reads (on init: creates) parameters through a
:class:`Scope`. Child scopes are auto-named ``<Class>_<n>`` per class
within their parent, so parameter trees keep the key paths of checkpoints
written by earlier versions of this package
(``tests/goldens/param_trees.json`` pins them).
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Any, Callable, Optional, Tuple, Union

import jax
import jax.numpy as jnp

from text2video.ops.phase_conv import (
    depth_to_space2,
    down2x_conv_phase,
    head_conv_phase,
    space_to_depth2,
    upsample2x_conv_phase,
)

Dtype = Any
Padding = Union[str, Tuple[Tuple[int, int], Tuple[int, int]]]

lecun_normal = jax.nn.initializers.lecun_normal()
zeros = jax.nn.initializers.zeros
ones = jax.nn.initializers.ones


class Scope:
    """One module call's parameter namespace.

    With ``rng`` set (init) a missing parameter is created from a key
    folded from its path; without it (apply) parameters are only read.
    """

    def __init__(self, params: dict, rng: Optional[jax.Array] = None,
                 path: Tuple[str, ...] = ()):
        self.params = params
        self.rng = rng
        self.path = path
        self._counts: dict = {}

    def param(self, name: str, init: Callable, shape: Tuple[int, ...]):
        if self.rng is not None and name not in self.params:
            tag = zlib.crc32("/".join(self.path + (name,)).encode())
            key = jax.random.fold_in(self.rng, tag)
            self.params[name] = init(key, shape, jnp.float32)
        return self.params[name]

    def child(self, module: "Module", name: Optional[str] = None) -> "Scope":
        if name is None:
            kind = type(module).__name__
            n = self._counts.get(kind, 0)
            self._counts[kind] = n + 1
            name = f"{kind}_{n}"
        if self.rng is not None:
            self.params.setdefault(name, {})
        return Scope(self.params[name], self.rng, self.path + (name,))

    def __call__(self, module: "Module", *args, name: Optional[str] = None):
        """Run ``module`` as a child of this scope."""
        return module.forward(self.child(module, name), *args)


class Module:
    """Base class: subclasses are frozen dataclasses with ``forward``."""

    def forward(self, s: Scope, *args):
        raise NotImplementedError

    def init(self, rng: jax.Array, *args) -> dict:
        params: dict = {}
        self.forward(Scope(params, rng), *args)
        return {"params": params}

    def apply(self, variables: dict, *args):
        return self.forward(Scope(variables["params"]), *args)


def module(cls):
    return dataclasses.dataclass(frozen=True)(cls)


def reflect_pad(x: jax.Array, pad: int) -> jax.Array:
    if pad == 0:
        return x
    return jnp.pad(
        x, ((0, 0), (pad, pad), (pad, pad), (0, 0)), mode="reflect"
    )


@module
class Conv(Module):
    """NHWC conv: kernel [kh, kw, cin, cout] float32 under "kernel",
    bias [cout] under "bias", computed in ``dtype``.

    ``weights`` lets phase-form callers (ConvBlock upsample2x, the
    generator heads) reparameterise the SAME weights into
    coarse-resolution window kernels (ops/phase_conv.py) instead of
    running the padded full-resolution conv.
    """

    features: int
    kernel: int = 3
    stride: int = 1
    padding: Padding = "VALID"
    dtype: Dtype = jnp.bfloat16

    def weights(self, s: Scope, in_features: int):
        w = s.param(
            "kernel",
            lecun_normal,
            (self.kernel, self.kernel, in_features, self.features),
        )
        return w, s.param("bias", zeros, (self.features,))

    def forward(self, s: Scope, x: jax.Array) -> jax.Array:
        w, b = self.weights(s, x.shape[-1])
        y = jax.lax.conv_general_dilated(
            x.astype(self.dtype),
            w.astype(self.dtype),
            (self.stride, self.stride),
            self.padding,
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
        )
        return y + b.astype(self.dtype)


@module
class InstanceNorm(Module):
    """Instance normalisation with float32 statistics.

    The vid2vid generator family normalises per-sample, per-channel over
    the spatial axes. Stats are computed in float32 regardless of the
    activation dtype to keep bfloat16 training stable.

    ``phase > 1``: the input is a phase tensor whose channel axis holds
    ``phase`` interleaved spatial copies of each real channel
    (ops/phase_conv.py layout). Stats pool over space AND phases —
    exactly the stats of the full-resolution map — and the (C,) params
    keep their non-phase shape, so checkpoints are layout-independent.
    """

    epsilon: float = 1e-5
    dtype: Dtype = jnp.bfloat16
    phase: int = 1

    def forward(self, s: Scope, x: jax.Array) -> jax.Array:
        # f32-accumulating reductions without an f32 copy of the
        # activation; var = E[x^2] - E[x]^2 on O(1)-scale activations is
        # numerically fine.
        c = x.shape[-1] // self.phase
        if self.phase > 1:
            b, h, w, _ = x.shape
            xg = x.reshape(b, h, w, self.phase, c)
            mean = jnp.mean(xg, axis=(1, 2, 3), dtype=jnp.float32)
            m2 = jnp.mean(jnp.square(xg), axis=(1, 2, 3), dtype=jnp.float32)
        else:
            mean = jnp.mean(x, axis=(1, 2), dtype=jnp.float32)  # [B, C]
            m2 = jnp.mean(jnp.square(x), axis=(1, 2), dtype=jnp.float32)
        var = jnp.maximum(m2 - jnp.square(mean), 0.0)
        scale = s.param("scale", ones, (c,))
        bias = s.param("bias", zeros, (c,))
        rstd = jax.lax.rsqrt(var + self.epsilon)
        mul = (rstd * scale).astype(self.dtype)
        add = (bias - mean * rstd * scale).astype(self.dtype)
        if self.phase > 1:
            mul = jnp.tile(mul, (1, self.phase))
            add = jnp.tile(add, (1, self.phase))
        return x * mul[:, None, None, :] + add[:, None, None, :]


@module
class ConvBlock(Module):
    """ReflectPad -> Conv -> InstanceNorm -> ReLU (norm/act optional).

    ``upsample2x``: compute ``nearest-up(2x) -> this block`` exactly, in
    phase form at the COARSE resolution (ops/phase_conv.py) — same
    parameters and math, no materialised 2x intermediate. Requires
    kernel=3, stride=1. ``emit_phase`` keeps the output as a [B, h, w,
    4*C] phase tensor for a consumer that is itself phase-aware (the
    generator heads).

    ``phase_stem``: the input is a full-resolution map with even H/W;
    run this (stride-1) block as a half-resolution phase window conv
    (head_conv_phase over space_to_depth2(x)) and emit the phase tensor.
    ``from_phase``: the input is a phase tensor and this is a stride-2
    block; consume it directly (down2x_conv_phase), producing the plain
    half-res output. Both are exact reparameterisations of the same Conv
    parameters.
    """

    features: int
    kernel: int = 3
    stride: int = 1
    norm: bool = True
    act: bool = True
    dtype: Dtype = jnp.bfloat16
    upsample2x: bool = False
    emit_phase: bool = False
    phase_stem: bool = False
    from_phase: bool = False

    def _finish(self, s: Scope, y: jax.Array, phase: int) -> jax.Array:
        if self.norm:
            y = s(InstanceNorm(dtype=self.dtype, phase=phase), y)
        return jax.nn.relu(y) if self.act else y

    def forward(self, s: Scope, x: jax.Array) -> jax.Array:
        in_features = x.shape[-1] // 4 if self.from_phase else x.shape[-1]
        conv = Conv(
            self.features,
            kernel=self.kernel,
            stride=self.stride,
            dtype=self.dtype,
        )
        cs = s.child(conv)
        dt = self.dtype
        if self.phase_stem:
            if self.stride != 1 or self.kernel != 7:
                raise ValueError("phase_stem requires stride=1, kernel=7")
            k, b = conv.weights(cs, in_features)
            y = head_conv_phase(
                space_to_depth2(x.astype(dt)), k.astype(dt), emit_phase=True
            )
            return self._finish(s, y + jnp.tile(b, 4).astype(dt), phase=4)
        if self.from_phase:
            if self.kernel != 3 or self.stride != 2:
                raise ValueError("from_phase requires kernel=3, stride=2")
            k, b = conv.weights(cs, in_features)
            y = down2x_conv_phase(x.astype(dt), k.astype(dt))
            return self._finish(s, y + b.astype(dt), phase=1)
        if self.upsample2x:
            if self.kernel != 3 or self.stride != 1:
                raise ValueError("upsample2x requires kernel=3, stride=1")
            k, b = conv.weights(cs, in_features)
            y = upsample2x_conv_phase(x.astype(dt), k.astype(dt))
            y = self._finish(s, y + jnp.tile(b, 4).astype(dt), phase=4)
            return y if self.emit_phase else depth_to_space2(y)
        y = conv.forward(cs, reflect_pad(x, self.kernel // 2))
        return self._finish(s, y, phase=1)


@module
class ResBlock(Module):
    """Two 3x3 reflect-padded convs with a residual skip (pix2pixHD-style)."""

    features: int
    dtype: Dtype = jnp.bfloat16

    def forward(self, s: Scope, x: jax.Array) -> jax.Array:
        h = s(ConvBlock(self.features, dtype=self.dtype), x)
        h = s(ConvBlock(self.features, act=False, dtype=self.dtype), h)
        return x + h


@module
class Upsample(Module):
    """2x nearest-neighbour upsample followed by a 3x3 conv block.

    ``phase_form``: run the mathematically-identical coarse-resolution
    phase conv instead (ConvBlock.upsample2x); ``emit_phase``
    additionally skips the final depth-to-space so a phase-aware head
    can consume the [B, h, w, 4*C] tensor directly.
    """

    features: int
    dtype: Dtype = jnp.bfloat16
    phase_form: bool = False
    emit_phase: bool = False

    def forward(self, s: Scope, x: jax.Array) -> jax.Array:
        if self.phase_form:
            return s(ConvBlock(
                self.features,
                dtype=self.dtype,
                upsample2x=True,
                emit_phase=self.emit_phase,
            ), x)
        b, h, w, c = x.shape
        x = jax.image.resize(x, (b, 2 * h, 2 * w, c), method="nearest")
        return s(ConvBlock(self.features, dtype=self.dtype), x)


def downscale2x(x: jax.Array) -> jax.Array:
    """3x3 average-pool stride 2, zero padding counted in the mean (the
    multiscale-D pyramid downsampler)."""
    # Python-scalar init values let JAX pick its differentiable
    # reduce_window_sum / _max primitives.
    y = jax.lax.reduce_window(
        x, 0.0, jax.lax.add,
        (1, 3, 3, 1), (1, 2, 2, 1), ((0, 0), (1, 1), (1, 1), (0, 0)),
    )
    return y / 9


def max_pool2x(x: jax.Array) -> jax.Array:
    """2x2 max-pool stride 2 (VALID)."""
    return jax.lax.reduce_window(
        x, -jnp.inf, jax.lax.max,
        (1, 2, 2, 1), (1, 2, 2, 1), "VALID",
    )
