"""Native wire codec (native/wire/wire.cc via io/wire_native.py).

The streaming muxer hands raw truncated-DCT wire coefficients to the
native library: fused coefficient->BGR decode for the cv2 VideoWriter
and direct coefficient->JPEG assembly for the MJPEG-AVI container.
These tests pin the native decode to the numpy reference path
(ops/dct.py + io/video.py) and verify the JPEGs are standard-decodable
at matching pixels.
"""

import os

import numpy as np

from text2video.io import wire_native
from text2video.ops.dct import (
    ZIGZAG,
    decode_plane_np,
    dct_matrix8,
    quant_tables,
)


def _encode_np(plane, q, k):
    """Host mirror of ops/dct.py::encode_plane (numpy, exact-ish)."""
    h, w = plane.shape[-2:]
    ph, pw = (-h) % 8, (-w) % 8
    if ph or pw:
        pad = [(0, 0)] * (plane.ndim - 2) + [(0, ph), (0, pw)]
        plane = np.pad(plane, pad, mode="edge")
        h, w = h + ph, w + pw
    d = dct_matrix8()
    x = plane.reshape(-1, h // 8, 8, w // 8, 8).transpose(0, 1, 3, 2, 4)
    co = np.einsum("ij,nbcjk,lk->nbcil", d, x - 128.0, d)
    co = co.reshape(-1, h // 8, w // 8, 64)[..., ZIGZAG[:k]]
    qz = q[ZIGZAG[:k] // 8, ZIGZAG[:k] % 8]
    return np.clip(np.round(co / qz), -127, 127).astype(np.int8)


def _smooth(h, w, seed):
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    p = 110 + 60 * np.sin(xx / 23.0) + 40 * np.cos(yy / 17.0)
    for _ in range(4):
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        p += 35 * np.exp(-(((yy - cy) / 19.0) ** 2 + ((xx - cx) / 19.0) ** 2))
    return np.clip(p, 16, 235)


def _coeffs(t=3, h=96, w=128, quality=80, kl=20, kc=8):
    lq, cq = quant_tables(quality)
    y = np.stack([_smooth(h, w, i) for i in range(t)])
    u = np.stack([_smooth(h // 2, w // 2, i + 50) for i in range(t)])
    v = np.stack([_smooth(h // 2, w // 2, i + 90) for i in range(t)])
    return _encode_np(y, lq, kl), _encode_np(u, cq, kc), _encode_np(v, cq, kc)


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 10 * np.log10(255.0**2 / max(mse, 1e-12))


def test_decode_bgr_matches_numpy_path():
    """Native fused decode == numpy decode_plane_np + cv2 I420->BGR
    (same dequant kernel; only float-vs-fixed-point rounding differs)."""
    from text2video.io.video import yuv420_to_bgr

    h, w = 96, 128
    yq, uq, vq = _coeffs(h=h, w=w)
    lq, cq = quant_tables(80)
    ref = yuv420_to_bgr(
        decode_plane_np(yq, lq),
        decode_plane_np(uq, cq),
        decode_plane_np(vq, cq),
    )
    out = wire_native.decode_bgr(yq, uq, vq, h, w)
    assert out.shape == ref.shape == (3, h, w, 3)
    diff = np.abs(ref.astype(int) - out.astype(int))
    assert diff.mean() < 1.0
    assert _psnr(ref, out) > 40.0


def test_jpegs_standard_decodable_and_match():
    """Coefficient-assembled JPEGs decode with cv2 (libjpeg) to the same
    pixels as the BGR path; the full-range JFIF rescale happens in the
    coefficient domain."""
    import cv2

    h, w = 96, 128
    yq, uq, vq = _coeffs(h=h, w=w)
    bgr = wire_native.decode_bgr(yq, uq, vq, h, w)
    jpegs = wire_native.to_jpegs(yq, uq, vq, h, w)
    assert len(jpegs) == 3
    for f, data in enumerate(jpegs):
        assert data[:2] == b"\xff\xd8" and data[-2:] == b"\xff\xd9"
        img = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
        assert img is not None and img.shape == (h, w, 3)
        # libjpeg's fancy chroma upsampling vs the decoder's nearest
        # neighbour costs a little at chroma edges; smooth GAN-like
        # content sits well above this bound.
        assert _psnr(img, bgr[f]) > 38.0


def test_streaming_muxer_coeff_path(tmp_path):
    """StreamingMuxer.add_coeffs drives both containers from raw wire
    coefficients via the native codec."""
    from text2video.io.video import StreamingMuxer

    h, w = 96, 128
    yq, uq, vq = _coeffs(h=h, w=w)
    audio = np.sin(np.linspace(0, 440 * 2 * np.pi, 16000 // 5)).astype(
        np.float32
    )
    base = os.path.join(str(tmp_path), "clip")
    muxer = StreamingMuxer(
        base, w, h, fps=25.0, sample_rate=16000, audio=audio
    )
    muxer.add_coeffs(yq, uq, vq)
    files = muxer.close()
    assert muxer.n_frames == 3
    exts = {f.rsplit(".", 1)[-1] for f in files}
    assert "mp4" in exts and ("avi" in exts or any("_audio" in f for f in files))
    for f in files:
        assert os.path.getsize(f) > 0


def test_odd_dims_jpeg():
    """Non-multiple-of-16 pixel dims (odd MCU grids) edge-clamp blocks;
    the JPEG still decodes at the declared size."""
    import cv2

    h, w = 40, 56  # 3x4 MCUs over a 5x7 luma block grid
    yq, uq, vq = _coeffs(t=1, h=h, w=w)
    jpegs = wire_native.to_jpegs(yq, uq, vq, h, w)
    img = cv2.imdecode(np.frombuffer(jpegs[0], np.uint8), cv2.IMREAD_COLOR)
    assert img is not None and img.shape == (h, w, 3)
    bgr = wire_native.decode_bgr(yq, uq, vq, h, w)
    assert _psnr(img, bgr[0]) > 34.0


def test_native_unpack_matches_numpy():
    """native/wire/wire.cc::t2v_wire_unpack reproduces the numpy
    bit-plane unpack byte-for-byte on random packed buffers."""
    import jax
    import jax.numpy as jnp

    from text2video.io import wire_native
    from text2video.ops.dct import (
        _unpack_plane_shift_numpy,
        pack_plane_shift,
    )

    rng = np.random.RandomState(0)
    for shape, w in [((4, 8, 8, 12), 5), ((3, 4, 4, 6), 4),
                     ((1, 5, 7, 12), 5)]:
        coeffs = rng.randint(-127, 128, size=shape).astype(np.int8)
        packed = np.asarray(
            jax.jit(lambda c, w=w: pack_plane_shift(c, w))(
                jnp.asarray(coeffs)
            )
        )
        ref = _unpack_plane_shift_numpy(packed, shape, w)
        nat = wire_native.unpack_plane(packed, shape, w)
        assert nat is not None
        np.testing.assert_array_equal(nat, ref)
