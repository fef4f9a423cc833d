"""Truncated-DCT wire codec for the frame-return path.

Frames leave the device in the form the muxer needs anyway. YUV420
already halves raw RGB; this codec takes the remaining step the final
containers take anyway (mp4/MJPEG are 8x8-DCT codecs): each YUV plane is
transformed on device with an 8x8 blockwise DCT, quantized with
JPEG-style tables, and only the first K zigzag coefficients cross the
link as int8 — ~4x fewer bytes than YUV420 at visually transparent
quality (roundtrip PSNR bounds in tests/test_wire_codec.py). The host
side (dequantize + IDCT, two small matmuls over all blocks at once) runs
between chunk pulls, off the critical path.

Everything device-side is static-shaped dense math (one stride-8
convolution against the quant-scaled DCT basis); there is no entropy
coding because variable-length output would force a
host round trip, and the fixed-K truncation already captures most of the
win.
"""

from __future__ import annotations

import numpy as np

try:  # jax is optional for the host-side decoder
    import jax.numpy as jnp
except Exception:  # pragma: no cover
    jnp = None

# Standard JPEG zigzag order: ZIGZAG[i] = row-major index of the i-th
# zigzag coefficient.
ZIGZAG = np.array(
    [
        0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
        12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
        35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
        58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    ],
    dtype=np.int32,
)

# Annex-K JPEG base quantization tables (quality 50).
_LUMA_BASE = np.array(
    [
        [16, 11, 10, 16, 24, 40, 51, 61],
        [12, 12, 14, 19, 26, 58, 60, 55],
        [14, 13, 16, 24, 40, 57, 69, 56],
        [14, 17, 22, 29, 51, 87, 80, 62],
        [18, 22, 37, 56, 68, 109, 103, 77],
        [24, 35, 55, 64, 81, 104, 113, 92],
        [49, 64, 78, 87, 103, 121, 120, 101],
        [72, 92, 95, 98, 112, 100, 103, 99],
    ],
    dtype=np.float64,
)
_CHROMA_BASE = np.array(
    [
        [17, 18, 24, 47, 99, 99, 99, 99],
        [18, 21, 26, 66, 99, 99, 99, 99],
        [24, 26, 56, 99, 99, 99, 99, 99],
        [47, 66, 99, 99, 99, 99, 99, 99],
        [99, 99, 99, 99, 99, 99, 99, 99],
        [99, 99, 99, 99, 99, 99, 99, 99],
        [99, 99, 99, 99, 99, 99, 99, 99],
        [99, 99, 99, 99, 99, 99, 99, 99],
    ],
    dtype=np.float64,
)

# int8 coefficient safety floors: the orthonormal DCT of a 128-shifted
# uint8 block is bounded by |coef| <= 1024, so a quantizer step below
# 1024/127 ~ 8.07 could clip the DC of an extreme flat block. AC floors
# guard hard synthetic edges (real GAN frames sit far inside the range).
_DC_MIN = 9.0
_AC_MIN = 5.0


def dct_matrix8() -> np.ndarray:
    """Orthonormal 8-point DCT-II matrix (float32)."""
    k = np.arange(8)[:, None]
    n = np.arange(8)[None, :]
    d = np.cos((2 * n + 1) * k * np.pi / 16.0)
    d[0] *= 1.0 / np.sqrt(2.0)
    return (d * 0.5).astype(np.float32)


def quant_tables(quality: int = 80):
    """JPEG-style quality scaling -> (luma, chroma) float32 8x8 tables,
    floored so quantized coefficients always fit int8."""
    quality = int(np.clip(quality, 1, 100))
    scale = 5000.0 / quality if quality < 50 else 200.0 - 2.0 * quality

    def _scaled(base):
        q = np.floor((base * scale + 50.0) / 100.0)
        q = np.clip(q, _AC_MIN, 255.0)
        q[0, 0] = max(q[0, 0], _DC_MIN)
        return q.astype(np.float32)

    return _scaled(_LUMA_BASE), _scaled(_CHROMA_BASE)


def _encode_kernel(quant: np.ndarray, k: int) -> np.ndarray:
    """[8, 8, 1, k] conv kernel whose output channel c is the c-th zigzag
    DCT-II basis function pre-divided by its quantizer step:
    K[u, v, 0, c] = D[zr(c), u] * D[zc(c), v] / quant[zr(c), zc(c)]."""
    d = dct_matrix8()
    zr, zc = ZIGZAG[:k] // 8, ZIGZAG[:k] % 8
    basis = d[zr][:, :, None] * d[zc][:, None, :]  # [k, 8, 8]
    scale = quant.astype(np.float32)[zr, zc]  # [k]
    return np.transpose(
        basis / scale[:, None, None], (1, 2, 0)
    )[:, :, None, :].astype(np.float32)


def encode_plane(plane, quant, k: int):
    """Device encode: [..., H, W] float plane (0..255) -> [..., ceil(H/8),
    ceil(W/8), k] int8 of zigzag-truncated quantized DCT coefficients.

    The blockwise 8x8 DCT + quantize + zigzag-truncate collapses into ONE
    stride-8 convolution with a [8, 8, 1, k] kernel of quant-scaled basis
    functions: a single dense op instead of per-block 8x8 contractions
    (an einsum formulation lowers to thousands of tiny dots).

    Planes whose dims are not multiples of 8 (e.g. the 540x960 chroma of
    a 1080p canvas) are edge-padded up; the decoder returns the padded
    size and the caller crops (render.py::render_stream_yuv)."""
    h, w = plane.shape[-2:]
    ph, pw = (-h) % 8, (-w) % 8
    if ph or pw:
        pad = [(0, 0)] * (plane.ndim - 2) + [(0, ph), (0, pw)]
        plane = jnp.pad(plane, pad, mode="edge")
        h, w = h + ph, w + pw
    lead = plane.shape[:-2]
    x = plane.astype(jnp.float32).reshape((-1, h, w, 1)) - 128.0
    kern = jnp.asarray(_encode_kernel(np.asarray(quant), k))
    import jax

    q = jax.lax.conv_general_dilated(
        x, kern,
        window_strides=(8, 8),
        padding="VALID",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
    )
    q = jnp.round(q).reshape(lead + (h // 8, w // 8, k))
    return jnp.clip(q, -127.0, 127.0).astype(jnp.int8)


_DECODE_KERNELS: dict = {}


def _decode_kernel(quant: np.ndarray, k: int) -> np.ndarray:
    """[k, 64] dequant+IDCT matrix: row c is the c-th zigzag basis block
    (flattened row-major) scaled by its quantizer step, so decoding is
    ONE BLAS matmul ``coeffs @ K``. (A 3-operand np.einsum here ran the
    naive nested-loop path: 25 s per 32-frame plane — 100x the
    transfer it was supposed to hide.)"""
    key = (quant.tobytes(), k)
    kern = _DECODE_KERNELS.get(key)
    if kern is None:
        d = dct_matrix8()
        zr, zc = ZIGZAG[:k] // 8, ZIGZAG[:k] % 8
        basis = d[zr][:, :, None] * d[zc][:, None, :]  # [k, 8, 8]
        scale = quant.astype(np.float32)[zr, zc]  # [k]
        kern = (basis * scale[:, None, None]).reshape(k, 64)
        _DECODE_KERNELS[key] = kern
    return kern


def decode_plane_np(coeffs: np.ndarray, quant: np.ndarray) -> np.ndarray:
    """Host decode: [..., Hb, Wb, k] int8 -> [..., Hb*8, Wb*8] uint8.

    Dequantize + IDCT as a single [N*Hb*Wb, k] @ [k, 64] matmul —
    ~25 MFLOP/frame at 512x384, negligible next to the transfer it
    replaces."""
    *lead, hb, wb, k = coeffs.shape
    kern = _decode_kernel(np.asarray(quant), k)
    flat = coeffs.reshape(-1, k).astype(np.float32) @ kern
    blocks = flat.reshape(*lead, hb, wb, 8, 8)
    pix = np.moveaxis(blocks, -3, -2).reshape(*lead, hb * 8, wb * 8)
    # np.rint, not np.round: round's decimals machinery ran ~1000x
    # slower on this host class for large arrays.
    return np.clip(np.rint(pix + 128.0), 0.0, 255.0).astype(np.uint8)


# ---- per-block-shift bit packing -------------------------------------
#
# The int8 wire spends 8 bits on every coefficient, but at quality 75
# the AC distributions measured on the committed GAN clips are far
# narrower (luma AC1-2 p99.9 = 72, AC6+ p99.9 <= 19; chroma ACs p99.9
# <= 11), with the mass concentrated in a few high-energy edge blocks.
# Plain fixed-width clipping loses 3-7 dB on the sharpest synthetic
# content (measured), so the pack is BLOCK-ADAPTIVE: each block carries
# a 2-bit shift s and its ACs as (ac >> s) in W_AC bits — range doubles
# where the block needs it, precision halves only there (the perceptual
# masking case). DC stays exact at 8 bits. Measured on the committed
# clips at (W_AC_LUMA, W_AC_CHROMA) = (5, 4): 67% of the int8 bytes at
# -0.5 dB on the worst clip (45.1/42.8/42.2 vs 46.0/43.3/42.7 dB).
# No entropy coding — the device side stays one static-shape program
# and the host unpack is a vectorized np.unpackbits. Packing is
# COLUMNAR BIT-PLANE: per field (DC, shift, each AC), bias the column
# to unsigned and emit one byte per 8 blocks per bit plane (MSB-first,
# matching np.unpackbits).

W_AC_LUMA = 5
W_AC_CHROMA = 4


def packed_plane_bytes(n_blocks: int, k: int, w_ac: int) -> int:
    """Wire bytes for one plane of n_blocks shift-packed blocks."""
    m = -(-n_blocks // 8)  # byte groups per bit plane
    return int(m * (8 + 2 + (k - 1) * w_ac))


def _pack_columns(cols, widths):
    """cols: list of [n] uint arrays (values < 2^w); -> flat uint8 of
    concatenated bit planes, one byte per 8 values, MSB-first."""
    out = []
    weights = jnp.asarray([128, 64, 32, 16, 8, 4, 2, 1], jnp.uint8)
    for col, w in zip(cols, widths):
        n = col.shape[0]
        pad = (-n) % 8
        if pad:
            col = jnp.pad(col, (0, pad))
        grp = col.astype(jnp.uint8).reshape(-1, 8)
        for b in range(int(w) - 1, -1, -1):
            bits = (grp >> b) & 1
            out.append(jnp.sum(bits * weights, axis=1, dtype=jnp.uint8))
    return jnp.concatenate(out)


def pack_plane_shift(coeffs, w_ac: int):
    """Device pack: [..., Hb, Wb, k] int8 coefficients -> flat uint8.

    Per block: DC exact (8 bits), shift s = min{0..3 : max|AC| >> s
    fits signed w_ac bits} (2 bits), ACs rounded-shifted ((ac + 2^(s-1))
    >> s, floor semantics) in w_ac bits each. Safety-clipped after the
    shift, so s = 3 still bounds every representable input."""
    k = coeffs.shape[-1]
    flat = coeffs.reshape(-1, k).astype(jnp.int32)
    dc = flat[:, 0] + 128  # [n] in [1, 255]
    ac = flat[:, 1:]
    lim = (1 << (w_ac - 1)) - 1
    m = jnp.max(jnp.abs(ac), axis=1).astype(jnp.float32)
    s = jnp.clip(
        jnp.ceil(jnp.log2(jnp.maximum(m, 1.0) / lim)), 0, 3
    ).astype(jnp.int32)
    half = jnp.where(s > 0, 1 << jnp.maximum(s - 1, 0), 0)
    ac_s = jnp.clip((ac + half[:, None]) >> s[:, None], -lim - 1, lim)
    cols = [dc, s] + [ac_s[:, i] + (lim + 1) for i in range(k - 1)]
    widths = [8, 2] + [w_ac] * (k - 1)
    return _pack_columns(cols, widths)


def unpack_plane_shift_np(
    buf: np.ndarray, shape, w_ac: int
) -> np.ndarray:
    """Host unpack: flat uint8 -> [..., Hb, Wb, k] int8 in the same
    quantized-coefficient domain as the unpacked wire (ACs carry the
    block shift back in: value << s, max 120, fits int8) — drop-in for
    decode_plane_np and the native codec.

    Runs the native codec's bit-plane unpack
    (native/wire/wire.cc::t2v_wire_unpack), which keeps host cycles off
    the transfer path; ``_unpack_plane_shift_numpy`` is the reference
    implementation, pinned equal by tests/test_wire_native.py."""
    from text2video.io import wire_native

    return wire_native.unpack_plane(buf, shape, w_ac)


def _unpack_plane_shift_numpy(
    buf: np.ndarray, shape, w_ac: int
) -> np.ndarray:
    k = shape[-1]
    n = int(np.prod(shape[:-1]))
    m = -(-n // 8)
    widths = [8, 2] + [w_ac] * (k - 1)
    fields = []
    pos = 0
    for w in widths:
        planes = buf[pos : pos + w * m].reshape(w, m)
        pos += w * m
        bits = np.unpackbits(planes, axis=-1)  # [w, m*8]
        val = np.zeros(m * 8, np.int32)
        for b in range(w):
            val |= bits[b].astype(np.int32) << (w - 1 - b)
        fields.append(val)
    lim = (1 << (w_ac - 1)) - 1
    out = np.empty((m * 8, k), np.int8)
    out[:, 0] = (fields[0] - 128).astype(np.int8)
    s = fields[1]
    for i in range(k - 1):
        out[:, i + 1] = ((fields[2 + i] - (lim + 1)) << s).astype(np.int8)
    return out[:n].reshape(shape)


def encode_yuv(y, u, v, quality: int = 80, k_luma: int = 20,
               k_chroma: int = 8):
    """Device encode of float YUV planes (0..255) -> int8 coefficient
    arrays (yq, uq, vq)."""
    lq, cq = quant_tables(quality)
    return (
        encode_plane(y, lq, k_luma),
        encode_plane(u, cq, k_chroma),
        encode_plane(v, cq, k_chroma),
    )


def decode_yuv_np(yq, uq, vq, quality: int = 80):
    """Host decode of pulled int8 coefficient arrays -> uint8 planes."""
    lq, cq = quant_tables(quality)
    return (
        decode_plane_np(np.asarray(yq), lq),
        decode_plane_np(np.asarray(uq), cq),
        decode_plane_np(np.asarray(vq), cq),
    )
