"""Truncated-DCT wire codec (ops/dct.py) — roundtrip quality and the
streaming render path's codec dispatch.

Frames leave the device as int8 DCT coefficients at ~4x fewer bytes
than YUV420. These tests bound the quality cost (roundtrip PSNR) and verify
the "dct" and "yuv420" wire formats produce matching videos.
"""

import numpy as np
import pytest

from text2video.ops.dct import (
    ZIGZAG,
    decode_plane_np,
    decode_yuv_np,
    encode_plane,
    encode_yuv,
    quant_tables,
)


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 10 * np.log10(255.0**2 / max(mse, 1e-12))


def _smooth_plane(h=64, w=96, seed=0):
    """GAN-frame-like content: smooth gradients + a few soft blobs."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    p = 110 + 60 * np.sin(xx / 23.0) + 40 * np.cos(yy / 17.0)
    for _ in range(4):
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        p += 35 * np.exp(-(((yy - cy) / 9.0) ** 2 + ((xx - cx) / 9.0) ** 2))
    return np.clip(p, 0, 255)


def test_zigzag_is_a_permutation():
    assert sorted(ZIGZAG.tolist()) == list(range(64))


def test_quant_tables_int8_safe():
    # |DCT coeff| of a 128-shifted uint8 block is <= 1024; the DC floor
    # must keep 1024/q below the int8 clip for every quality.
    for q in (1, 25, 50, 75, 80, 95, 100):
        lq, cq = quant_tables(q)
        assert lq[0, 0] >= 1024.0 / 127.0
        assert cq[0, 0] >= 1024.0 / 127.0
        assert lq.min() >= 1.0 and cq.min() >= 1.0


def test_flat_extremes_roundtrip_exact():
    # Flat black/white blocks are pure DC — the int8 path must not clip
    # them into visible level shifts.
    lq, _ = quant_tables(80)
    for val in (0.0, 255.0, 128.0):
        plane = np.full((16, 16), val)
        dec = decode_plane_np(np.asarray(encode_plane(plane, lq, 8)), lq)
        assert np.abs(dec.astype(float) - val).max() <= lq[0, 0] / 2 + 1


def test_plane_roundtrip_psnr():
    plane = _smooth_plane()
    lq, _ = quant_tables(80)
    dec = decode_plane_np(np.asarray(encode_plane(plane, lq, 20)), lq)
    assert dec.shape == plane.shape
    assert _psnr(np.round(plane), dec) > 36.0


def test_hard_edge_stays_reasonable():
    # A full-contrast step exercises the largest AC coefficients the
    # int8 clip can see; quality should degrade gracefully, not wrap.
    plane = np.zeros((32, 32))
    plane[:, 16:] = 255.0
    lq, _ = quant_tables(80)
    dec = decode_plane_np(np.asarray(encode_plane(plane, lq, 20)), lq)
    assert _psnr(plane, dec) > 24.0
    # sides stay near their levels (no DC wraparound)
    assert dec[:, :8].mean() < 40 and dec[:, 24:].mean() > 215


def test_yuv_roundtrip_and_wire_bytes():
    h, w = 64, 96
    y = _smooth_plane(h, w, 1)
    u = _smooth_plane(h // 2, w // 2, 2)
    v = _smooth_plane(h // 2, w // 2, 3)
    yq, uq, vq = encode_yuv(y, u, v, quality=80, k_luma=20, k_chroma=8)
    # ~4x fewer wire bytes than uint8 YUV420
    yuv_bytes = y.size + u.size + v.size
    wire_bytes = np.asarray(yq).size + np.asarray(uq).size + np.asarray(vq).size
    assert wire_bytes * 3.5 < yuv_bytes
    yd, ud, vd = decode_yuv_np(yq, uq, vq, quality=80)
    assert _psnr(np.round(y), yd) > 36.0
    assert _psnr(np.round(u), ud) > 36.0
    assert _psnr(np.round(v), vd) > 36.0


@pytest.mark.parametrize("wire", ["yuv420", "dct"])
def test_render_stream_formats_agree(wire):
    """The streaming render path yields near-identical planes under both
    wire formats (tiny renderer, skeleton-ish labels)."""
    import dataclasses

    import jax.numpy as jnp

    from text2video.config import RenderConfig
    from text2video.render import Renderer

    h, w = 64, 64
    renderer = Renderer.create(
        config=RenderConfig(wire_format=wire),
        height=h, width=w, base_ch=4, n_blocks=1,
    )
    renderer.time_bucket = 4
    rng = np.random.RandomState(0)
    labels = jnp.asarray(
        rng.randint(0, 256, size=(8, h, w, 3), dtype=np.uint8)
    )
    chunks = [labels[:4], labels[4:]]
    outs = list(renderer.render_stream_yuv(chunks, 8))
    ys = np.concatenate([o[0] for o in outs])
    assert ys.shape == (8, h, w)
    # Stash per-format output on the test module for the cross-check.
    store = globals().setdefault("_stream_out", {})
    store[wire] = ys
    if len(store) == 2:
        # A random-init generator fed random labels emits near-noise —
        # the worst case for a truncated-DCT codec. Real GAN frames are
        # far smoother (>36 dB, see the plane roundtrip tests above).
        assert _psnr(store["yuv420"], store["dct"]) > 28.0


def test_plane_roundtrip_non_multiple_of_8():
    """Planes whose dims are not multiples of 8 (e.g. the 540x960 chroma
    of a 1080p canvas) edge-pad on encode; the decoder returns padded
    dims and the caller crops. Regression: encode_plane used to reshape
    and crash."""
    p = _smooth_plane(h=44, w=52)
    lq, _ = quant_tables(80)
    co = encode_plane(np.asarray(p)[None], lq, 20)
    assert co.shape == (1, 6, 7, 20)  # ceil(44/8), ceil(52/8)
    out = decode_plane_np(np.asarray(co), lq)[0]
    assert out.shape == (48, 56)
    assert _psnr(np.round(p), out[:44, :52]) > 36.0


def test_render_stream_dct_odd_chroma():
    """Streaming DCT render at a resolution whose half-planes are not
    8-multiples (40x48 -> 20x24 chroma, the 1080p-canvas shape class)
    yields correctly cropped planes."""
    import jax.numpy as jnp

    from text2video.config import RenderConfig
    from text2video.render import Renderer

    h, w = 40, 48
    renderer = Renderer.create(
        config=RenderConfig(wire_format="dct"),
        height=h, width=w, base_ch=4, n_blocks=1,
    )
    renderer.time_bucket = 4
    rng = np.random.RandomState(0)
    labels = jnp.asarray(
        rng.randint(0, 256, size=(4, h, w, 3), dtype=np.uint8)
    )
    outs = list(renderer.render_stream_yuv([labels], 4))
    (y, u, v), = outs
    assert y.shape == (4, h, w)
    assert u.shape == (4, h // 2, w // 2)
    assert v.shape == (4, h // 2, w // 2)


def test_pack_plane_shift_roundtrip_exact():
    """Bit-pack -> unpack is exactly the shift-round-unshift model (DC
    exact, ACs rounded to the block's 2-bit shift), at the documented
    byte count (ops/dct.py::pack_plane_shift)."""
    import jax
    import jax.numpy as jnp

    from text2video.ops.dct import (
        W_AC_CHROMA,
        W_AC_LUMA,
        pack_plane_shift,
        packed_plane_bytes,
        unpack_plane_shift_np,
    )

    rng = np.random.RandomState(0)
    for shape, w in [((3, 8, 8, 12), W_AC_LUMA), ((2, 4, 4, 6), W_AC_CHROMA),
                     ((1, 5, 7, 12), 5)]:
        k = shape[-1]
        coeffs = rng.randint(-127, 128, size=shape).astype(np.int8)
        packed = np.asarray(
            jax.jit(lambda c, w=w: pack_plane_shift(c, w))(
                jnp.asarray(coeffs)
            )
        )
        n_blocks = int(np.prod(shape[:-1]))
        assert packed.size == packed_plane_bytes(n_blocks, k, w)
        assert packed.size < coeffs.size  # it actually packs
        un = unpack_plane_shift_np(packed, shape, w)
        flat = coeffs.reshape(-1, k).astype(np.int32)
        lim = (1 << (w - 1)) - 1
        m = np.abs(flat[:, 1:]).max(1)
        s = np.ceil(
            np.log2(np.maximum(m, 1.0) / lim)
        ).clip(0, 3).astype(np.int32)
        half = np.where(s > 0, 1 << np.maximum(s - 1, 0), 0)
        ac = np.clip(
            (flat[:, 1:] + half[:, None]) >> s[:, None], -lim - 1, lim
        ) << s[:, None]
        exp = np.concatenate([flat[:, :1], ac], 1).reshape(shape)
        np.testing.assert_array_equal(un.astype(np.int32), exp)


def test_render_stream_packed_wire_matches_unpacked():
    """config.wire_packed only changes the wire encoding: the streamed
    planes match the raw-int8 wire within the shift-rounding bound."""
    import jax.numpy as jnp

    from text2video.config import RenderConfig
    from text2video.render import Renderer

    h, w = 64, 64
    rng = np.random.RandomState(1)
    labels = jnp.asarray(
        rng.randint(0, 256, size=(8, h, w, 3), dtype=np.uint8)
    )
    outs = {}
    for packed in (False, True):
        r = Renderer.create(
            config=RenderConfig(wire_format="dct", wire_packed=packed),
            height=h, width=w, base_ch=4, n_blocks=1,
        )
        r.time_bucket = 4
        ys = np.concatenate([
            o[0] for o in r.render_stream_yuv([labels[:4], labels[4:]], 8)
        ])
        outs[packed] = ys
    assert outs[True].shape == outs[False].shape
    # random-init output is codec worst case; real clips measure -0.5 dB
    assert _psnr(outs[True], outs[False]) > 30.0
