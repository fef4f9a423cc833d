"""Autoregressive render engine tests (tiny model, CPU mesh)."""

import jax.numpy as jnp
import numpy as np

from text2video.config import RenderConfig
from text2video.render import Renderer


def _tiny_renderer(**kw):
    return Renderer.create(
        height=32, width=32, base_ch=8, n_blocks=1, dtype=jnp.float32, **kw
    )


def test_render_shapes_and_padding():
    r = _tiny_renderer()
    r.time_bucket = 8
    labels = np.random.RandomState(0).randint(
        0, 256, size=(5, 32, 32, 3), dtype=np.uint8
    )
    frames = r.render(labels)
    assert frames.shape == (5, 32, 32, 3)
    assert frames.dtype == np.uint8


def test_render_autoregressive_consistency():
    """Padding frames must not change the un-padded prefix (causality)."""
    r = _tiny_renderer()
    r.time_bucket = 4
    rng = np.random.RandomState(1)
    labels8 = rng.randint(0, 256, size=(8, 32, 32, 3), dtype=np.uint8)
    f8 = r.render(labels8)
    f4 = r.render(labels8[:4])
    np.testing.assert_allclose(
        f8[:4].astype(np.int32), f4.astype(np.int32), atol=1
    )


def test_render_max_frames_cap():
    r = _tiny_renderer(config=RenderConfig(max_frames=6))
    r.time_bucket = 2
    labels = np.zeros((10, 32, 32, 3), np.uint8)
    frames = r.render(labels)
    assert frames.shape[0] == 6


def test_render_many_sharded_matches_single():
    """Utterance-batch axis sharded over the 8-device mesh must
    reproduce per-utterance rendering exactly (batch parallelism is
    embarrassing)."""
    from text2video.parallel.mesh import make_mesh

    r = _tiny_renderer()
    r.time_bucket = 4
    rng = np.random.RandomState(3)
    labels = rng.randint(0, 256, size=(8, 6, 32, 32, 3), dtype=np.uint8)
    singles = np.stack([r.render(labels[i]) for i in range(8)])
    mesh = make_mesh(n_data=8, n_model=1)
    batched = r.render_many(labels, mesh=mesh)
    assert batched.shape == singles.shape
    np.testing.assert_array_equal(batched, singles)


def test_render_from_device_chunks_matches_host_path():
    import jax.numpy as jnp

    r = _tiny_renderer()
    r.time_bucket = 4
    rng = np.random.RandomState(5)
    labels = rng.randint(0, 256, size=(10, 32, 32, 3), dtype=np.uint8)
    via_host = r.render(labels)
    # Device chunks as the rasterizer's to_host=False path would yield.
    chunks = [
        jnp.asarray(
            np.pad(labels[lo : lo + 4], ((0, max(0, lo + 4 - 10)), (0, 0),
                                         (0, 0), (0, 0)))
        )
        for lo in range(0, 10, 4)
    ]
    via_device = r.render_from_device_chunks(chunks, 10)
    np.testing.assert_array_equal(via_host, via_device)


def test_render_from_device_chunks_short_chunks():
    """External callers may hand arbitrary chunk lists — a short FINAL
    chunk (fewer than n_frames_ctx-1 frames) pads internally, and a
    short MID-STREAM chunk re-chunks via the exact concat fallback
    (render.py::_normalize_chunks); neither raises, both reproduce the
    whole-timeline render."""
    r = _tiny_renderer()
    r.time_bucket = 4
    rng = np.random.RandomState(7)
    labels = rng.randint(0, 256, size=(9, 32, 32, 3), dtype=np.uint8)
    via_host = r.render(labels)

    # short final chunk: 4 + 4 + 1
    chunks = [jnp.asarray(labels[0:4]), jnp.asarray(labels[4:8]),
              jnp.asarray(labels[8:9])]
    out = r.render_from_device_chunks(chunks, 9)
    np.testing.assert_array_equal(via_host, out)

    # short mid-stream chunk: 3 + 1 + 5 -> concat fallback
    chunks = [jnp.asarray(labels[0:3]), jnp.asarray(labels[3:4]),
              jnp.asarray(labels[4:9])]
    out = r.render_from_device_chunks(chunks, 9)
    np.testing.assert_array_equal(via_host, out)

    # 1-frame utterance
    out1 = r.render_from_device_chunks([jnp.asarray(labels[:1])], 1)
    np.testing.assert_array_equal(r.render(labels[:1]), out1)


def test_render_load_size_scale_height():
    """RenderConfig.load_size resizes labels to the GAN's working height
    (the reference's --resize_or_crop scaleHeight --loadSize)."""
    r = Renderer.create(
        height=64, width=64, base_ch=8, n_blocks=1, dtype=jnp.float32,
        config=RenderConfig(load_size=64),
    )
    r.time_bucket = 4
    assert r.target_hw(128, 192) == (64, 128)  # scaleHeight + /64 rounding
    assert r.target_hw(64, 64) == (64, 64)     # already at load_size
    labels = np.zeros((4, 128, 192, 3), np.uint8)
    frames = r.render(labels)
    assert frames.shape == (4, 64, 128, 3)
