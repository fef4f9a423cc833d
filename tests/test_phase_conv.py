"""Exactness of the phase-form decoder tail (ops/phase_conv.py).

The phase reformulation claims to be the SAME function as the plain
path (nearest-up + reflect-pad + conv; reflect-pad + 7x7 heads) with the
SAME parameters — these tests pin that claim in float32 to tight
tolerance, at odd/even and tiny shapes, plus param-tree compatibility so
round-3 checkpoints load into the phase-form generator unchanged.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from text2video.models.generator import CompositeGenerator
from text2video.models.layers import reflect_pad
from text2video.ops.phase_conv import (
    depth_to_space2,
    down2x_conv_phase,
    head_conv_phase,
    space_to_depth2,
    upsample2x_conv_phase,
)


def _ref_upsample_conv(x, k3):
    b, h, w, c = x.shape
    up = jax.image.resize(x, (b, 2 * h, 2 * w, c), method="nearest")
    return jax.lax.conv_general_dilated(
        reflect_pad(up, 1), k3, (1, 1), "VALID",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
    )


def _ref_head_conv(f, k7):
    return jax.lax.conv_general_dilated(
        reflect_pad(f, 3), k7, (1, 1), "VALID",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
    )


@pytest.mark.parametrize("h,w", [(4, 4), (3, 5), (8, 6), (5, 3)])
def test_upsample_phase_exact(h, w):
    key = jax.random.PRNGKey(0)
    k1, k2 = jax.random.split(key)
    x = jax.random.normal(k1, (2, h, w, 7), jnp.float32)
    k3 = jax.random.normal(k2, (3, 3, 7, 5), jnp.float32)
    ref = _ref_upsample_conv(x, k3)
    got = depth_to_space2(upsample2x_conv_phase(x, k3))
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)


def test_space_depth_roundtrip():
    x = jax.random.normal(jax.random.PRNGKey(1), (2, 6, 8, 12))
    np.testing.assert_array_equal(
        np.asarray(depth_to_space2(space_to_depth2(x))), np.asarray(x)
    )


@pytest.mark.parametrize("h,w", [(8, 8), (5, 7), (4, 6), (7, 4)])
def test_head_phase_exact(h, w):
    """head_conv_phase(P) == reflect-pad(3) + 7x7 conv of d2s(P)."""
    key = jax.random.PRNGKey(2)
    k1, k2 = jax.random.split(key)
    f = jax.random.normal(k1, (2, 2 * h, 2 * w, 6), jnp.float32)
    k7 = jax.random.normal(k2, (7, 7, 6, 4), jnp.float32)
    ref = _ref_head_conv(f, k7)
    got = head_conv_phase(space_to_depth2(f), k7)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=1e-4, atol=1e-4)


def _ref_down_conv(f, k3):
    return jax.lax.conv_general_dilated(
        reflect_pad(f, 1), k3, (2, 2), "VALID",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
    )


@pytest.mark.parametrize("h,w", [(4, 4), (5, 7), (8, 6), (3, 4)])
def test_down_phase_exact(h, w):
    """down2x_conv_phase(P) == reflect-pad(1) + 3x3 stride-2 of d2s(P)."""
    key = jax.random.PRNGKey(11)
    k1, k2 = jax.random.split(key)
    f = jax.random.normal(k1, (2, 2 * h, 2 * w, 5), jnp.float32)
    k3 = jax.random.normal(k2, (3, 3, 5, 8), jnp.float32)
    ref = _ref_down_conv(f, k3)
    got = down2x_conv_phase(space_to_depth2(f), k3)
    assert got.shape == ref.shape
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("h,w", [(8, 8), (6, 10)])
def test_stem_phase_exact(h, w):
    """Phase stem chain == plain 7x7 stem + stride-2 downsample:
    head_conv_phase(s2d(x), k7, emit_phase) into down2x_conv_phase is
    the exact reflect-pad(3)+7x7 then reflect-pad(1)+3x3/2 composite."""
    key = jax.random.PRNGKey(12)
    k1, k2, k3k = jax.random.split(key, 3)
    x = jax.random.normal(k1, (2, 2 * h, 2 * w, 15), jnp.float32)
    k7 = jax.random.normal(k2, (7, 7, 15, 4), jnp.float32) * 0.2
    k3 = jax.random.normal(k3k, (3, 3, 4, 8), jnp.float32) * 0.2
    ref = _ref_down_conv(_ref_head_conv(x, k7), k3)
    p = head_conv_phase(space_to_depth2(x), k7, emit_phase=True)
    got = down2x_conv_phase(p, k3)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=1e-4, atol=1e-4)


def _make_inputs(key, b=2, h=32, w=32):
    k1, k2 = jax.random.split(key)
    labels = jax.random.normal(k1, (b, h, w, 9), jnp.float32)
    prev = jax.random.normal(k2, (b, h, w, 6), jnp.float32)
    has_prev = jnp.array([0.0, 1.0])[:b]
    return labels, prev, has_prev


def test_generator_phase_form_matches_plain():
    """Same params, phase on vs off: identical outputs (f32 tolerance)."""
    labels, prev, has_prev = _make_inputs(jax.random.PRNGKey(3))
    plain = CompositeGenerator(base_ch=8, n_blocks=2, dtype=jnp.float32,
                               phase_form=False)
    phased = CompositeGenerator(base_ch=8, n_blocks=2, dtype=jnp.float32,
                                phase_form=True)
    params = plain.init(jax.random.PRNGKey(4), labels, prev, has_prev)
    f0, w0, m0 = plain.apply(params, labels, prev, has_prev)
    f1, w1, m1 = phased.apply(params, labels, prev, has_prev)
    np.testing.assert_allclose(np.asarray(f1), np.asarray(f0),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(np.asarray(w1), np.asarray(w0),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(np.asarray(m1), np.asarray(m0),
                               rtol=2e-4, atol=2e-4)


def test_generator_phase_form_matches_plain_with_enhancer():
    labels, prev, has_prev = _make_inputs(jax.random.PRNGKey(5))
    kw = dict(base_ch=8, n_blocks=1, n_local_enhancers=1,
              n_local_blocks=1, dtype=jnp.float32)
    plain = CompositeGenerator(phase_form=False, **kw)
    phased = CompositeGenerator(phase_form=True, **kw)
    params = plain.init(jax.random.PRNGKey(6), labels, prev, has_prev)
    f0, _, _ = plain.apply(params, labels, prev, has_prev)
    f1, _, _ = phased.apply(params, labels, prev, has_prev)
    np.testing.assert_allclose(np.asarray(f1), np.asarray(f0),
                               rtol=2e-4, atol=2e-4)


def test_param_tree_identical_across_forms():
    """Init under either form yields the SAME pytree (paths, shapes, and
    values — same rng folds), so round-3 checkpoints load unchanged."""
    labels, prev, has_prev = _make_inputs(jax.random.PRNGKey(7))
    plain = CompositeGenerator(base_ch=8, n_blocks=2, dtype=jnp.float32,
                               phase_form=False)
    phased = CompositeGenerator(base_ch=8, n_blocks=2, dtype=jnp.float32,
                                phase_form=True)
    p0 = plain.init(jax.random.PRNGKey(8), labels, prev, has_prev)
    p1 = phased.init(jax.random.PRNGKey(8), labels, prev, has_prev)
    flat0 = jax.tree_util.tree_flatten_with_path(p0)
    flat1 = jax.tree_util.tree_flatten_with_path(p1)
    paths0 = [jax.tree_util.keystr(k) for k, _ in flat0[0]]
    paths1 = [jax.tree_util.keystr(k) for k, _ in flat1[0]]
    assert paths0 == paths1
    for (_, a), (_, b) in zip(flat0[0], flat1[0]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_generator_phase_form_bf16_close():
    """bf16: the phase path's error vs the f32 truth stays at the same
    scale as the plain bf16 path's own rounding error (phase kernels
    fold taps in f32 before the cast, so no extra error source)."""
    labels, prev, has_prev = _make_inputs(jax.random.PRNGKey(9))
    kw = dict(base_ch=8, n_blocks=2)
    truth = CompositeGenerator(dtype=jnp.float32, phase_form=False, **kw)
    plain = CompositeGenerator(dtype=jnp.bfloat16, phase_form=False, **kw)
    phased = CompositeGenerator(dtype=jnp.bfloat16, phase_form=True, **kw)
    params = truth.init(jax.random.PRNGKey(10), labels, prev, has_prev)
    ft, _, _ = truth.apply(params, labels, prev, has_prev)
    f0, _, _ = plain.apply(params, labels, prev, has_prev)
    f1, _, _ = phased.apply(params, labels, prev, has_prev)
    e_plain = float(jnp.mean(jnp.abs(f0.astype(jnp.float32) - ft)))
    e_phase = float(jnp.mean(jnp.abs(f1.astype(jnp.float32) - ft)))
    assert e_phase < 3.0 * e_plain + 1e-3, (e_phase, e_plain)
