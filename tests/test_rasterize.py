"""Rasterizer parity tests against reference-rendered golden PNGs.

Host renderer must be pixel-exact; the batched device renderer must reach
SSIM >= 0.96 (it intentionally replaces the reference's sequential
vector-stamp fringe artifacts with a per-pixel blend; see
ops/rasterize.py module docstring).
"""

import json
import os

import numpy as np
import pytest

from text2video.io.openpose import frame_from_raw
from text2video.ops.rasterize import (
    rasterize_batch,
    rasterize_frame_host,
)

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "fadg0_Shehadyour")
SIZE = (512, 384)


def _golden_frames(sub_json, sub_png):
    cv2 = pytest.importorskip("cv2")
    frames = []
    for name in sorted(os.listdir(os.path.join(GOLDEN, sub_png))):
        stem = os.path.splitext(name)[0]
        with open(os.path.join(GOLDEN, sub_json, stem + ".json")) as f:
            raw = json.load(f)
        img = cv2.imread(os.path.join(GOLDEN, sub_png, name))
        frames.append((stem, frame_from_raw(raw), img))
    return frames


def _ssim(a, b):
    a = a.astype(np.float64)
    b = b.astype(np.float64)
    mu_a, mu_b = a.mean(), b.mean()
    va, vb = a.var(), b.var()
    cov = ((a - mu_a) * (b - mu_b)).mean()
    c1, c2 = (0.01 * 255) ** 2, (0.03 * 255) ** 2
    return ((2 * mu_a * mu_b + c1) * (2 * cov + c2)) / (
        (mu_a ** 2 + mu_b ** 2 + c1) * (va + vb + c2)
    )


@pytest.mark.parametrize("sub_json,sub_png", [("pose", "png"), ("pose_smooth", "png_smooth")])
def test_host_rasterizer_pixel_exact(sub_json, sub_png):
    for stem, kf, golden in _golden_frames(sub_json, sub_png):
        mine = rasterize_frame_host(kf.face, kf.pose, kf.hand_l, kf.hand_r, SIZE)
        assert (mine == golden).all(), f"{sub_json}/{stem} not pixel-exact"


def test_device_rasterizer_ssim():
    frames = _golden_frames("pose", "png")
    face = np.stack([k.face for _, k, _ in frames])
    pose = np.stack([k.pose for _, k, _ in frames])
    hl = np.stack([k.hand_l for _, k, _ in frames])
    hr = np.stack([k.hand_r for _, k, _ in frames])
    imgs = rasterize_batch(face, pose, hl, hr, SIZE, chunk=len(frames))
    for i, (stem, _, golden) in enumerate(frames):
        s = _ssim(imgs[i], golden)
        assert s >= 0.96, f"frame {stem}: SSIM {s:.4f}"


def test_device_rasterizer_padding_chunks():
    # Odd chunk size exercises final-chunk padding.
    frames = _golden_frames("pose", "png")[:5]
    face = np.stack([k.face for _, k, _ in frames])
    pose = np.stack([k.pose for _, k, _ in frames])
    hl = np.stack([k.hand_l for _, k, _ in frames])
    hr = np.stack([k.hand_r for _, k, _ in frames])
    a = rasterize_batch(face, pose, hl, hr, SIZE, chunk=2)
    b = rasterize_batch(face, pose, hl, hr, SIZE, chunk=5)
    assert (a == b).all()


def test_empty_keypoints_draw_corner_circles_only():
    # All-zero keypoints: no segments drawn, but the reference's corner
    # circle quirk (hand centers at (0,0)) is preserved.
    face = np.zeros((1, 210))
    pose = np.zeros((1, 75))
    hands = np.zeros((1, 63))
    img = rasterize_batch(face, pose, hands, hands, SIZE, chunk=1)[0]
    host = rasterize_frame_host(face[0], pose[0], hands[0], hands[0], SIZE)
    assert (img == host).all()
    assert img[0, 0].tolist() == [255, 0, 0]  # blue circle drawn last
    assert (img[100:, 100:] == 0).all()


def test_device_rasterizer_highres_henan():
    """Device vs host parity at the henan canvas (1920x1080) — catches
    sample-count / tiling bugs that 512x384 wouldn't."""
    golden = os.path.join(
        os.path.dirname(__file__), "goldens", "henan_111", "pose"
    )
    if not os.path.isdir(golden):
        pytest.skip("run tools/make_goldens.py first")
    names = sorted(os.listdir(golden))[:2]
    kfs = []
    for name in names:
        with open(os.path.join(golden, name)) as f:
            kfs.append(frame_from_raw(json.load(f)))
    size = (1920, 1080)
    face = np.stack([k.face for k in kfs])
    pose = np.stack([k.pose for k in kfs])
    hl = np.stack([k.hand_l for k in kfs])
    hr = np.stack([k.hand_r for k in kfs])
    imgs = rasterize_batch(face, pose, hl, hr, size, chunk=2)
    for i, k in enumerate(kfs):
        host = rasterize_frame_host(k.face, k.pose, k.hand_l, k.hand_r, size)
        s = _ssim(imgs[i], host)
        assert s >= 0.96, f"frame {names[i]}: SSIM {s:.4f}"
