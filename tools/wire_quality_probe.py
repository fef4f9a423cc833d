#!/usr/bin/env python3
"""Measure the DCT wire codec's roundtrip quality vs bytes on REAL
rendered frames, sweeping (k_luma, k_chroma, quality).

This picks the smallest wire config that stays visually transparent. Frames come from the committed
artifact clips (GAN output — the actual payload the wire carries).

  python tools/wire_quality_probe.py artifacts/fadg0_Shehadyour_gan.mp4
"""

import io
import json
import sys

import numpy as np
from PIL import Image

sys.path.insert(0, ".")

from text2video.ops.dct import (  # noqa: E402
    decode_yuv_np,
    encode_plane,
    quant_tables,
)


def jpeg_frames(path, limit=6):
    data = open(path, "rb").read()
    out, i = [], 0
    while len(out) < limit:
        s = data.find(b"\xff\xd8\xff", i)
        if s < 0:
            break
        e = data.find(b"\xff\xd9", s) + 2
        out.append(np.asarray(Image.open(io.BytesIO(data[s:e]))))
        i = e
    return out


def rgb_to_yuv420(rgb):
    f = rgb.astype(np.float32)
    y = 0.299 * f[..., 0] + 0.587 * f[..., 1] + 0.114 * f[..., 2]
    u = -0.168736 * f[..., 0] - 0.331264 * f[..., 1] + 0.5 * f[..., 2] + 128
    v = 0.5 * f[..., 0] - 0.418688 * f[..., 1] - 0.081312 * f[..., 2] + 128
    sub = lambda p: p.reshape(p.shape[0] // 2, 2, p.shape[1] // 2, 2).mean((1, 3))
    return y, sub(u), sub(v)


def psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 10 * np.log10(255.0**2 / max(mse, 1e-9))


def main() -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")

    path = sys.argv[1] if len(sys.argv) > 1 else \
        "artifacts/fadg0_Shehadyour_gan.mp4"
    frames = jpeg_frames(path)
    planes = [rgb_to_yuv420(f) for f in frames]
    h, w = planes[0][0].shape

    for kl, kc, q in [(20, 8, 80), (16, 8, 80), (12, 6, 80), (12, 6, 70),
                      (10, 4, 70), (8, 4, 60), (14, 6, 75)]:
        lq, cq = quant_tables(q)
        ps = []
        for y, u, v in planes:
            yq = np.asarray(encode_plane(y[None], lq, kl))
            uq = np.asarray(encode_plane(u[None], cq, kc))
            vq = np.asarray(encode_plane(v[None], cq, kc))
            y2, u2, v2 = decode_yuv_np(yq, uq, vq, quality=q)
            ps.append(psnr(y2[0][:h, :w], np.clip(y, 0, 255).astype(np.uint8)))
        bpf = (-(-h // 8) * -(-w // 8) * kl
               + 2 * -(-h // 16) * -(-w // 16) * kc)
        print(json.dumps({
            "k_luma": kl, "k_chroma": kc, "quality": q,
            "luma_psnr_db": round(float(np.mean(ps)), 2),
            "bytes_per_frame_512x512": int(bpf * (512 * 512) / (h * w)),
            "bytes_per_frame_here": bpf,
        }))


if __name__ == "__main__":
    main()
