#!/usr/bin/env python3
"""Objective GAN evaluation: PSNR/SSIM of generated vs ground-truth frames.

The reference's only quality evidence is a user study (SURVEY.md §6).
This tool gives a reproducible proxy: render clips from pose labels with
the trained generator and compare to the real frames.

Honesty defaults: ``--split holdout`` evaluates on the deterministic
held-out partition (train/data.py::_split_runs — the same split
``cli train-gan --split train`` reserves), so the reported numbers are
for frames the model never saw; SSIM is the standard 11x11 Gaussian
*windowed* SSIM (Wang et al. 2004), not a single global-moment formula
(global moments inflate scores by ignoring local structure).

Alongside the whole-frame numbers it reports MOUTH-crop PSNR/SSIM: a
square region around the label keypoints' mouth center (the same points
48-59 average that drives the re-pin in ops/smooth.py) — the
quantitative stand-in for the reference poster's Q3 lip-sync user study
(BASELINE.md): whole-frame SSIM barely weights the one region the
pipeline exists to get right.

Usage:
  python tools/eval_gan.py --ckpt checkpoints/fadg0 \
      --images ".../images_fadg0" --keypoints ".../keypoints_fadg0" \
      [--split holdout|train|all] [--clips 4] [--clip-len 16]
Prints one JSON line {"psnr_db", "ssim", "mouth_psnr_db", "mouth_ssim",
"split", "clips", "frames"}.
"""

import argparse
import json
import sys

import numpy as np

sys.path.insert(0, ".")


def windowed_ssim(a: np.ndarray, b: np.ndarray) -> float:
    """Mean local SSIM over 11x11 Gaussian windows (sigma 1.5), averaged
    over channels — the standard formulation. a, b: [H, W, C] uint8."""
    import cv2

    a = a.astype(np.float64)
    b = b.astype(np.float64)
    c1, c2 = (0.01 * 255) ** 2, (0.03 * 255) ** 2
    blur = lambda x: cv2.GaussianBlur(x, (11, 11), 1.5)
    mu_a, mu_b = blur(a), blur(b)
    mu_aa, mu_bb, mu_ab = mu_a * mu_a, mu_b * mu_b, mu_a * mu_b
    var_a = blur(a * a) - mu_aa
    var_b = blur(b * b) - mu_bb
    cov = blur(a * b) - mu_ab
    ssim_map = ((2 * mu_ab + c1) * (2 * cov + c2)) / (
        (mu_aa + mu_bb + c1) * (var_a + var_b + c2)
    )
    return float(ssim_map.mean())


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--ckpt", required=True)
    p.add_argument("--images", required=True)
    p.add_argument("--keypoints", required=True)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--height", type=int, default=384)
    p.add_argument("--source-width", type=int, default=None,
                   help="resolution the keypoints were annotated at "
                   "(e.g. 1280x720 for a 896x512 eval)")
    p.add_argument("--source-height", type=int, default=None)
    p.add_argument("--split", choices=["holdout", "train", "all"],
                   default="holdout")
    p.add_argument("--holdout-fraction", type=float, default=0.1)
    p.add_argument("--clips", type=int, default=4)
    p.add_argument("--clip-len", type=int, default=16)
    args = p.parse_args()

    from text2video.config import PersonProfile
    from text2video.train.checkpoints import load_renderer
    from text2video.train.data import PoseClipDataset

    dataset = PoseClipDataset(
        images_dir=args.images,
        keypoints_dir=args.keypoints,
        canvas=(args.width, args.height),
        source_canvas=(
            (args.source_width, args.source_height)
            if args.source_width
            else None
        ),
        clip_len=args.clip_len,
        cache_labels=False,
        split=args.split,
        holdout_fraction=args.holdout_fraction,
    )
    profile = PersonProfile(
        name="eval", language="en", canvas=(args.width, args.height),
        dict_path="", keypoints_dir="", keypoint_layout="clip",
    )
    renderer = load_renderer(args.ckpt, profile)
    renderer.time_bucket = args.clip_len

    # Mouth crop side: a quarter of the canvas height (~the lip region
    # plus jaw context at every trained shape), even for clean halving.
    mside = max(32, (args.height // 4) & ~1)

    def mouth_crop(img: np.ndarray, center: np.ndarray) -> np.ndarray:
        cx = int(np.clip(round(center[0]), mside // 2,
                         img.shape[1] - mside // 2))
        cy = int(np.clip(round(center[1]), mside // 2,
                         img.shape[0] - mside // 2))
        return img[cy - mside // 2 : cy + mside // 2,
                   cx - mside // 2 : cx + mside // 2]

    def psnr(a: np.ndarray, b: np.ndarray) -> float:
        mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
        return 10 * np.log10(255.0**2 / max(mse, 1e-9))

    rng = np.random.RandomState(7)
    psnrs, ssims, mpsnrs, mssims, n_frames = [], [], [], [], 0
    for _ in range(args.clips):
        labels, reals, centers = dataset.sample_clip(rng)
        fakes = renderer.render(labels)
        # Centers are annotated on the label canvas == eval canvas here
        # (dataset rasterizes at (width, height)); scale defensively in
        # case the renderer worked at a different load size.
        sy = fakes.shape[1] / labels.shape[1]
        sx = fakes.shape[2] / labels.shape[2]
        for t in range(labels.shape[0]):
            psnrs.append(psnr(fakes[t], reals[t]))
            ssims.append(windowed_ssim(fakes[t], reals[t]))
            c = centers[t] * np.array([sx, sy])
            mf, mr = mouth_crop(fakes[t], c), mouth_crop(reals[t], c)
            mpsnrs.append(psnr(mf, mr))
            mssims.append(windowed_ssim(mf, mr))
            n_frames += 1

    print(
        json.dumps(
            {
                "psnr_db": round(float(np.mean(psnrs)), 2),
                "ssim": round(float(np.mean(ssims)), 4),
                "mouth_psnr_db": round(float(np.mean(mpsnrs)), 2),
                "mouth_ssim": round(float(np.mean(mssims)), 4),
                "mouth_crop_px": mside,
                "split": args.split,
                "clips": args.clips,
                "frames": n_frames,
            }
        )
    )


if __name__ == "__main__":
    main()
