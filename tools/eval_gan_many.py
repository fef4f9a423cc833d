#!/usr/bin/env python3
"""Evaluate SEVERAL checkpoints of the same architecture in one process.

tools/eval_gan.py per checkpoint pays the remote compile (~10 min) and
the dataset staging again each run; for checkpoint-step selection
(tools/train_xuesong_mouth_r5.sh stage 3) that multiplies into hours.
Here the renderer compiles once and only ``params`` swap between
checkpoints — same metrics, same split, one JSON line per checkpoint.

  python tools/eval_gan_many.py --ckpts a b c --out-prefix out/eval_r5_ \
      --images ... --keypoints ... --width 896 --height 512 \
      --source-width 1280 --source-height 720 --split holdout
"""

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tools.eval_gan import windowed_ssim  # noqa: E402


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--ckpts", nargs="+", required=True)
    p.add_argument("--out-prefix", default="")
    p.add_argument("--images", required=True)
    p.add_argument("--keypoints", required=True)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--height", type=int, default=384)
    p.add_argument("--source-width", type=int, default=None)
    p.add_argument("--source-height", type=int, default=None)
    p.add_argument("--split", choices=["holdout", "train", "all"],
                   default="holdout")
    p.add_argument("--holdout-fraction", type=float, default=0.1)
    p.add_argument("--clips", type=int, default=4)
    p.add_argument("--clip-len", type=int, default=16)
    args = p.parse_args()

    from text2video.config import PersonProfile
    from text2video.train.checkpoints import (
        load_renderer,
        restore_generator_params,
    )
    from text2video.train.data import PoseClipDataset

    dataset = PoseClipDataset(
        images_dir=args.images,
        keypoints_dir=args.keypoints,
        canvas=(args.width, args.height),
        source_canvas=(
            (args.source_width, args.source_height)
            if args.source_width else None
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
    renderer = load_renderer(args.ckpts[0], profile)
    renderer.time_bucket = args.clip_len

    mside = max(32, (args.height // 4) & ~1)

    def mouth_crop(img, center):
        cx = int(np.clip(round(center[0]), mside // 2,
                         img.shape[1] - mside // 2))
        cy = int(np.clip(round(center[1]), mside // 2,
                         img.shape[0] - mside // 2))
        return img[cy - mside // 2 : cy + mside // 2,
                   cx - mside // 2 : cx + mside // 2]

    def psnr(a, b):
        mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
        return 10 * np.log10(255.0**2 / max(mse, 1e-9))

    # Same clip sample for every checkpoint (seeded once per ckpt with
    # the SAME seed so the comparison is paired).
    for ckpt in args.ckpts:
        renderer.params = restore_generator_params(ckpt)
        rng = np.random.RandomState(7)
        psnrs, ssims, mpsnrs, mssims, n_frames = [], [], [], [], 0
        for _ in range(args.clips):
            labels, reals, centers = dataset.sample_clip(rng)
            fakes = renderer.render(labels)
            sy = fakes.shape[1] / labels.shape[1]
            sx = fakes.shape[2] / labels.shape[2]
            for t in range(labels.shape[0]):
                psnrs.append(psnr(fakes[t], reals[t]))
                ssims.append(windowed_ssim(fakes[t], reals[t]))
                c = centers[t] * np.array([sx, sy])
                mf = mouth_crop(fakes[t], c)
                mr = mouth_crop(reals[t], c)
                mpsnrs.append(psnr(mf, mr))
                mssims.append(windowed_ssim(mf, mr))
                n_frames += 1
        row = {
            "ckpt": ckpt,
            "psnr_db": round(float(np.mean(psnrs)), 2),
            "ssim": round(float(np.mean(ssims)), 4),
            "mouth_psnr_db": round(float(np.mean(mpsnrs)), 2),
            "mouth_ssim": round(float(np.mean(mssims)), 4),
            "mouth_crop_px": mside,
            "split": args.split,
            "clips": args.clips,
            "frames": n_frames,
        }
        print(json.dumps(row), flush=True)
        if args.out_prefix:
            name = os.path.basename(ckpt.rstrip("/"))
            with open(
                f"{args.out_prefix}{name}_{args.split}.json", "w"
            ) as f:
                json.dump(row, f)


if __name__ == "__main__":
    main()
