"""Generate deterministic avatar frames from OpenPose keypoints.

The reference trains its per-person GANs on recorded video frames, but
this mirror ships only the *keypoints* for the Chinese identities
(reference: *pinyin_data/{henan,xuesong}/keypoints_* — the recordings,
like the trained vid2vid checkpoints, were external downloads,
README.md:20-34). To still train and drive the full
pose->frame->loadSize-512 path for a Chinese person end-to-end, this
tool renders a stylized but fully articulated avatar per frame — shaded
head from the face contour, moving lips/eyes/brows, torso from the body
skeleton — which serves as the photometric ground truth. The GAN then
genuinely learns pose->appearance (lip shapes, head pose, shading), and
PSNR/SSIM against these targets measures that learning; the avatar
targets are documented wherever the resulting numbers are reported.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys

import cv2
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _scaled_points(vec: np.ndarray, n: int, sx: float, sy: float):
    pts = np.asarray(vec, np.float64).reshape(n, 3).copy()
    pts[:, 0] *= sx
    pts[:, 1] *= sy
    return pts


def render_avatar(
    face: np.ndarray,
    pose: np.ndarray,
    size,
    source_size,
) -> np.ndarray:
    """face [210], pose [75] OpenPose vectors -> [h, w, 3] uint8 RGB."""
    w, h = size
    sx, sy = w / source_size[0], h / source_size[1]
    f = _scaled_points(face, 70, sx, sy)
    p = _scaled_points(pose, 25, sx, sy)

    # Background: vertical gradient.
    img = np.zeros((h, w, 3), np.uint8)
    grad = np.linspace(38, 70, h, dtype=np.uint8)
    img[:] = np.stack([grad, grad, (grad * 1.25).astype(np.uint8)], -1)[
        :, None, :
    ]

    def ok(pts):
        return pts[pts[:, 2] > 0.05][:, :2].astype(np.int32)

    skin = (214, 178, 148)
    skin_dark = (176, 138, 112)
    cloth = (96, 52, 54)

    # Torso: neck(1), shoulders(2,5), hips(8..) quadrilateral.
    neck, rsho, lsho = p[1], p[2], p[5]
    if neck[2] > 0.05 and rsho[2] > 0.05 and lsho[2] > 0.05:
        hip = p[8] if p[8][2] > 0.05 else neck + [0, h * 0.45, 0]
        half = abs(lsho[0] - rsho[0]) * 0.75 + 1
        quad = np.array(
            [
                [rsho[0] - half * 0.25, rsho[1]],
                [lsho[0] + half * 0.25, lsho[1]],
                [hip[0] + half, min(hip[1], h * 2)],
                [hip[0] - half, min(hip[1], h * 2)],
            ],
            np.int32,
        )
        cv2.fillPoly(img, [quad], cloth)
        # Simple collar shading.
        cv2.circle(
            img, (int(neck[0]), int(neck[1])), int(half * 0.3),
            (cloth[0] + 24, cloth[1] + 16, cloth[2] + 16), -1,
        )

    # Head: jaw contour 0-16 mirrored over the brow line for a forehead.
    jaw = f[0:17]
    if (jaw[:, 2] > 0.05).sum() >= 10:
        brow_y = f[17:27, 1].mean()
        top = jaw[::-1].copy()
        # Forehead: compressed mirror of the jaw about the brow line
        # (a full reflection gives an unnaturally tall dome).
        top[:, 1] = brow_y - (top[:, 1] - brow_y) * 0.45
        hull = np.concatenate([jaw[:, :2], top[:, :2]]).astype(np.int32)
        # Neck column beneath the jaw.
        cx = int(jaw[8, 0])
        cv2.rectangle(
            img,
            (cx - int(0.12 * abs(jaw[16, 0] - jaw[0, 0]) * 2), int(brow_y)),
            (cx + int(0.12 * abs(jaw[16, 0] - jaw[0, 0]) * 2),
             int(jaw[8, 1] + h * 0.08)),
            skin_dark,
            -1,
        )
        cv2.fillPoly(img, [hull], skin)
        # Cheek shading.
        cv2.fillPoly(
            img,
            [jaw[[4, 8, 12], :2].astype(np.int32)],
            (skin[0] - 14, skin[1] - 14, skin[2] - 12),
        )
        # Hair cap above the forehead.
        hair = top.copy()
        hair2 = top.copy()
        hair2[:, 1] -= (f[8, 1] - brow_y) * 0.12
        capped = np.concatenate([hair[:, :2], hair2[::-1, :2]]).astype(
            np.int32
        )
        cv2.fillPoly(img, [capped], (42, 30, 26))

    # Brows.
    for lo, hi in [(17, 22), (22, 27)]:
        pts = ok(f[lo:hi])
        if len(pts) >= 2:
            cv2.polylines(img, [pts], False, (60, 40, 30), 2)
    # Nose.
    pts = ok(f[27:36])
    if len(pts) >= 3:
        cv2.polylines(img, [pts], False, skin_dark, 2)
    # Eyes: white fill + pupil.
    for lo, hi, pupil in [(36, 42, 68), (42, 48, 69)]:
        pts = ok(f[lo:hi])
        if len(pts) >= 3:
            cv2.fillPoly(img, [pts], (240, 240, 240))
            pu = f[pupil]
            center = (
                (int(pu[0]), int(pu[1]))
                if pu[2] > 0.05
                else tuple(pts.mean(0).astype(int))
            )
            cv2.circle(img, center, 2, (40, 30, 30), -1)
    # Lips: outer fill + inner (mouth opening) dark — the articulation
    # signal the GAN must reproduce.
    outer = ok(f[48:60])
    if len(outer) >= 3:
        cv2.fillPoly(img, [outer], (156, 74, 78))
    inner = ok(f[60:68])
    if len(inner) >= 3:
        cv2.fillPoly(img, [inner], (52, 24, 28))

    return img


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--keypoints", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--width", type=int, default=896)
    ap.add_argument("--height", type=int, default=512)
    ap.add_argument("--source-width", type=int, required=True)
    ap.add_argument("--source-height", type=int, required=True)
    ap.add_argument("--limit", type=int, default=0)
    args = ap.parse_args()

    from text2video.io.openpose import load_keypoint_frame

    os.makedirs(args.out, exist_ok=True)
    paths = sorted(
        glob.glob(os.path.join(args.keypoints, "*_keypoints.json"))
    )
    if args.limit:
        paths = paths[: args.limit]
    for i, path in enumerate(paths):
        stem = os.path.basename(path)[: -len("_keypoints.json")]
        kf = load_keypoint_frame(path)
        img = render_avatar(
            kf.face,
            kf.pose,
            (args.width, args.height),
            (args.source_width, args.source_height),
        )
        cv2.imwrite(
            os.path.join(args.out, stem + ".jpg"),
            cv2.cvtColor(img, cv2.COLOR_RGB2BGR),
            [cv2.IMWRITE_JPEG_QUALITY, 96],
        )
        if (i + 1) % 500 == 0:
            print(f"{i + 1}/{len(paths)}")
    print(f"wrote {len(paths)} frames -> {args.out}")


if __name__ == "__main__":
    main()
