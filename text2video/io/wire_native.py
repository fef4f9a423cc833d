"""ctypes bindings for the native wire codec (libt2v_wire.so).

The streaming renderer pulls frames off the device as zigzag-truncated
quantized DCT coefficients (ops/dct.py). This module hands those raw
coefficients to native/wire/wire.cc, which produces muxer-ready output
with no Python-side pixel work:

  * :func:`decode_bgr` — fused dequantize + IDCT + chroma upsample +
    BT.601 YUV->BGR, for the cv2 VideoWriter path (replaces the numpy
    decode_plane_np + cv2.cvtColor chain).
  * :func:`to_jpegs` — baseline JFIF images assembled directly from the
    quantized coefficients (entropy coding only, no IDCT and no JPEG
    re-compression), for the self-contained MJPEG-AVI muxer. The
    reference's muxer re-encoded pixel frames it read back from disk
    (reference: *phoneme_data/VidTIMIT/fadg0/image2video_real.py:20-37).

Build is shared with the alignment toolchain (native/CMakeLists.txt,
frontend/native.py::ensure_built). The streamed dct path needs this
library: a failed build or load raises rather than switching paths.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional

import numpy as np

from text2video.ops.dct import _decode_kernel, quant_tables

_lib: Optional[ctypes.CDLL] = None

_I8P = ctypes.POINTER(ctypes.c_int8)
_F32P = ctypes.POINTER(ctypes.c_float)
_U8P = ctypes.POINTER(ctypes.c_uint8)
_I64P = ctypes.POINTER(ctypes.c_int64)


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    from text2video.frontend.native import ensure_built

    lib = ctypes.CDLL(
        ensure_built().replace("libt2v_align.so", "libt2v_wire.so")
    )
    lib.t2v_wire_decode_bgr.restype = ctypes.c_int
    lib.t2v_wire_decode_bgr.argtypes = [
        _I8P, _I8P, _I8P,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        _F32P, _F32P, ctypes.c_int, ctypes.c_int, _U8P,
    ]
    lib.t2v_wire_to_jpeg.restype = ctypes.c_int64
    lib.t2v_wire_to_jpeg.argtypes = [
        _I8P, _I8P, _I8P,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        _F32P, _F32P, ctypes.c_int, ctypes.c_int,
        _U8P, ctypes.c_int64, _I64P,
    ]
    lib.t2v_wire_unpack.restype = ctypes.c_int
    lib.t2v_wire_unpack.argtypes = [
        _U8P, ctypes.c_int64, ctypes.c_int, ctypes.c_int, _I8P,
    ]
    _lib = lib
    return _lib


def unpack_plane(buf: np.ndarray, shape, w_ac: int) -> np.ndarray:
    """Native bit-plane unpack of the per-block-shift packed wire
    (ops/dct.py::pack_plane_shift layout) -> int8 coefficient array of
    ``shape``."""
    lib = _load()
    k = int(shape[-1])
    n_blocks = 1
    for d in shape[:-1]:
        n_blocks *= int(d)
    buf = np.ascontiguousarray(buf, dtype=np.uint8)
    out = np.empty((n_blocks, k), np.int8)
    rc = lib.t2v_wire_unpack(
        buf.ctypes.data_as(_U8P),
        ctypes.c_int64(n_blocks),
        ctypes.c_int(k),
        ctypes.c_int(w_ac),
        out.ctypes.data_as(_I8P),
    )
    if rc != 0:
        raise RuntimeError(f"t2v_wire_unpack failed: rc={rc}")
    return out.reshape(shape)


def _prep(yq: np.ndarray, uq: np.ndarray, vq: np.ndarray, quality: int):
    yq = np.ascontiguousarray(yq, dtype=np.int8)
    uq = np.ascontiguousarray(uq, dtype=np.int8)
    vq = np.ascontiguousarray(vq, dtype=np.int8)
    n, yhb, ywb, kl = yq.shape
    chb, cwb, kc = uq.shape[1:]
    lq, cq = quant_tables(quality)
    return yq, uq, vq, n, yhb, ywb, chb, cwb, kl, kc, lq, cq


def decode_bgr(
    yq: np.ndarray,
    uq: np.ndarray,
    vq: np.ndarray,
    h: int,
    w: int,
    quality: int = 80,
) -> np.ndarray:
    """[n, yhb, ywb, kl] / [n, chb, cwb, kc] int8 coefficient arrays ->
    [n, h, w, 3] uint8 BGR frames (cropped to the true pixel dims)."""
    lib = _load()
    yq, uq, vq, n, yhb, ywb, chb, cwb, kl, kc, lq, cq = _prep(
        yq, uq, vq, quality
    )
    lkern = np.ascontiguousarray(_decode_kernel(lq, kl))
    ckern = np.ascontiguousarray(_decode_kernel(cq, kc))
    out = np.empty((n, h, w, 3), np.uint8)
    rc = lib.t2v_wire_decode_bgr(
        yq.ctypes.data_as(_I8P), uq.ctypes.data_as(_I8P),
        vq.ctypes.data_as(_I8P),
        n, yhb, ywb, chb, cwb, kl, kc,
        lkern.ctypes.data_as(_F32P), ckern.ctypes.data_as(_F32P),
        h, w, out.ctypes.data_as(_U8P),
    )
    if rc != 0:
        raise RuntimeError(f"t2v_wire_decode_bgr failed: rc={rc}")
    return out


def to_jpegs(
    yq: np.ndarray,
    uq: np.ndarray,
    vq: np.ndarray,
    h: int,
    w: int,
    quality: int = 80,
) -> List[bytes]:
    """Coefficient arrays -> one baseline JFIF byte string per frame."""
    lib = _load()
    yq, uq, vq, n, yhb, ywb, chb, cwb, kl, kc, lq, cq = _prep(
        yq, uq, vq, quality
    )
    lqf = np.ascontiguousarray(lq, dtype=np.float32).reshape(-1)
    cqf = np.ascontiguousarray(cq, dtype=np.float32).reshape(-1)
    # Capacity bound mirrors the encoder's exact worst case (fixed-length
    # symbols: <=15 DC + 18*k AC bits per block, stuffing can double the
    # bytes); MCU-derived block counts cover edge-clamped odd grids.
    mcux, mcuy = (w + 15) // 16, (h + 15) // 16
    wb = lambda k: 2 * ((15 + 18 * k + 7) // 8)  # noqa: E731
    cap = n * (mcuy * mcux * (4 * wb(kl) + 2 * wb(kc)) + 2048)
    out = np.empty(cap, np.uint8)
    sizes = np.zeros(n, np.int64)
    total = lib.t2v_wire_to_jpeg(
        yq.ctypes.data_as(_I8P), uq.ctypes.data_as(_I8P),
        vq.ctypes.data_as(_I8P),
        n, yhb, ywb, chb, cwb, kl, kc,
        lqf.ctypes.data_as(_F32P), cqf.ctypes.data_as(_F32P),
        h, w, out.ctypes.data_as(_U8P), cap,
        sizes.ctypes.data_as(_I64P),
    )
    if total < 0:
        raise RuntimeError("t2v_wire_to_jpeg: output capacity overflow")
    res: List[bytes] = []
    off = 0
    for s in sizes:
        res.append(out[off : off + int(s)].tobytes())
        off += int(s)
    return res
