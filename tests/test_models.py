"""Shape/correctness tests for the renderer model family."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from text2video.models import CompositeGenerator
from text2video.models.discriminator import MultiscaleDiscriminator, face_crop
from text2video.models.vgg import VGG19Features, init_params
from text2video.ops.warp import flow_warp

H, W = 64, 64


def test_flow_warp_identity():
    img = np.random.RandomState(0).rand(2, 16, 24, 3).astype(np.float32)
    out = flow_warp(jnp.asarray(img), jnp.zeros((2, 16, 24, 2)))
    np.testing.assert_allclose(np.asarray(out), img, atol=1e-6)


def test_flow_warp_shift():
    # Integer flow of +1 in x samples the pixel one column to the right.
    img = np.arange(2 * 8 * 8 * 1, dtype=np.float32).reshape(2, 8, 8, 1)
    flow = np.zeros((2, 8, 8, 2), np.float32)
    flow[..., 0] = 1.0
    out = np.asarray(flow_warp(jnp.asarray(img), jnp.asarray(flow)))
    np.testing.assert_allclose(out[:, :, :-1], img[:, :, 1:], atol=1e-5)
    # Border column clamps.
    np.testing.assert_allclose(out[:, :, -1], img[:, :, -1], atol=1e-5)


@pytest.fixture(scope="module")
def gen_and_params():
    gen = CompositeGenerator(base_ch=8, n_blocks=2, dtype=jnp.float32)
    labels = jnp.zeros((2, H, W, 9))
    prev = jnp.zeros((2, H, W, 6))
    has_prev = jnp.ones((2,))
    params = gen.init(jax.random.PRNGKey(0), labels, prev, has_prev)
    return gen, params


def test_generator_shapes(gen_and_params):
    gen, params = gen_and_params
    labels = jnp.ones((2, H, W, 9)) * 0.5
    prev = jnp.ones((2, H, W, 6)) * 0.1
    frame, flow, mask = jax.jit(gen.apply)(params, labels, prev, jnp.ones((2,)))
    assert frame.shape == (2, H, W, 3)
    assert flow.shape == (2, H, W, 2)
    assert mask.shape == (2, H, W, 1)
    assert np.all(np.abs(np.asarray(frame)) <= 1.0)


def test_generator_first_frame_ignores_prev(gen_and_params):
    """has_prev=0 must make the output independent of prev_imgs content."""
    gen, params = gen_and_params
    labels = jnp.ones((2, H, W, 9)) * 0.3
    z = jnp.zeros((2,))
    f1, _, m1 = gen.apply(params, labels, jnp.zeros((2, H, W, 6)), z)
    f2, _, m2 = gen.apply(params, labels, jnp.zeros((2, H, W, 6)), z)
    np.testing.assert_allclose(np.asarray(f1), np.asarray(f2), atol=1e-6)
    np.testing.assert_allclose(np.asarray(m1), 1.0, atol=1e-6)


def test_generator_local_enhancer():
    gen = CompositeGenerator(
        base_ch=8, n_blocks=1, n_local_enhancers=1, n_local_blocks=1,
        dtype=jnp.float32,
    )
    labels = jnp.zeros((1, H, W, 3))
    prev = jnp.zeros((1, H, W, 3))
    params = gen.init(jax.random.PRNGKey(0), labels, prev, jnp.ones((1,)))
    frame, flow, mask = gen.apply(params, labels, prev, jnp.ones((1,)))
    assert frame.shape == (1, H, W, 3)


def test_multiscale_discriminator():
    d = MultiscaleDiscriminator(num_d=2, base_ch=8, dtype=jnp.float32)
    x = jnp.zeros((2, H, W, 6))
    params = d.init(jax.random.PRNGKey(0), x)
    outs = d.apply(params, x)
    assert len(outs) == 2
    logits0, feats0 = outs[0]
    assert logits0.shape[0] == 2 and logits0.shape[-1] == 1
    assert len(feats0) == 4
    # Second scale sees a 2x-downsampled image -> smaller patch grid.
    assert outs[1][0].shape[1] < logits0.shape[1]


def test_face_crop():
    imgs = jnp.arange(2 * 32 * 32 * 3, dtype=jnp.float32).reshape(2, 32, 32, 3)
    centers = jnp.array([[16.0, 16.0], [0.0, 0.0]])
    crops = face_crop(imgs, centers, 8)
    assert crops.shape == (2, 8, 8, 3)
    np.testing.assert_allclose(
        np.asarray(crops[0]), np.asarray(imgs[0, 12:20, 12:20]), atol=0
    )
    # Near-border centre clamps into the image.
    np.testing.assert_allclose(
        np.asarray(crops[1]), np.asarray(imgs[1, 0:8, 0:8]), atol=0
    )


def test_vgg_features():
    model = VGG19Features(dtype=jnp.float32)
    params = init_params(dtype=jnp.float32)
    x = jnp.zeros((1, 64, 64, 3))
    feats = model.apply({"params": params}, x)
    assert [f.shape[1] for f in feats] == [64, 32, 16, 8, 4]
    assert [f.shape[-1] for f in feats] == [64, 128, 256, 512, 512]


def test_flow_loss_chunked_matches_unchunked(monkeypatch):
    """Chunked photometric flow loss (the 2^31-byte warp-gather hazard
    workaround, models/losses.py::_WARP_CHUNK_BYTES) is the same math as
    the single-gather path, value and gradient."""
    import jax

    from text2video.models import losses as L

    rng = np.random.RandomState(0)
    n, h, w, c = 6, 8, 10, 3
    flow = jnp.asarray(rng.randn(n, h, w, 2).astype(np.float32))
    prev = jnp.asarray(rng.rand(n, h, w, c).astype(np.float32) * 2 - 1)
    cur = jnp.asarray(rng.rand(n, h, w, c).astype(np.float32) * 2 - 1)

    whole_v, whole_g = jax.value_and_grad(L.flow_loss)(flow, prev, cur)
    # Force chunking: each group's operand "exceeds" a tiny budget.
    monkeypatch.setattr(L, "_WARP_CHUNK_BYTES", h * w * 4 * c * 4 * 2)
    assert L._warp_chunks(n, h, w, c) == 2
    chunk_v, chunk_g = jax.value_and_grad(L.flow_loss)(flow, prev, cur)
    np.testing.assert_allclose(whole_v, chunk_v, rtol=1e-6)
    np.testing.assert_allclose(whole_g, chunk_g, rtol=1e-5, atol=1e-7)


def _tree_shapes(tree):
    return {
        "/".join(str(k.key) for k in path): list(leaf.shape)
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]
    }


def _param_tree(name):
    """Abstract init of each network as the renderer and trainer build it
    (parameter shapes do not depend on the frame size)."""
    from text2video.train.trainer import TrainConfig, create_trainer_state

    h = w = 64
    args = (jnp.zeros((1, h, w, 9)), jnp.zeros((1, h, w, 6)), jnp.ones((1,)))
    if name == "generator":
        gen = CompositeGenerator(base_ch=64, n_blocks=9)
    elif name == "generator_enhancer":
        gen = CompositeGenerator(base_ch=16, n_blocks=1, n_local_enhancers=1,
                                 n_local_blocks=1)
    else:
        state = jax.eval_shape(lambda: create_trainer_state(
            TrainConfig(height=h, width=w, face_crop=32, use_vgg=True)))
        return state.d_params if name == "trainer_d_params" else (
            state.vgg_params)
    return jax.eval_shape(lambda: gen.init(jax.random.PRNGKey(0), *args))


@pytest.mark.parametrize(
    "name",
    ["generator", "generator_enhancer", "trainer_d_params",
     "trainer_vgg_params"],
)
def test_param_tree_matches_golden(name):
    """Key paths and shapes of every network's parameters are pinned to
    tests/goldens/param_trees.json (the layout existing checkpoints were
    written with); init values are free."""
    import json
    import os

    golden = os.path.join(os.path.dirname(__file__), "goldens",
                          "param_trees.json")
    with open(golden) as f:
        want = json.load(f)[name]
    assert _tree_shapes(_param_tree(name)) == want
