#!/usr/bin/env python3
"""Jacobi-vs-scan decoding fidelity on TRAINED weights.

tests/test_render_jacobi.py proves convergence structurally on random
weights; this measures what users of ``--decode jacobi --sweeps k``
actually get: PSNR between the exact sequential scan and k-sweep Jacobi
decoding with a trained checkpoint on real (held-out) label maps, per k.

  python tools/jacobi_quality.py --ckpt checkpoints/fadg0 \
      --images .../images_fadg0 --keypoints .../keypoints_fadg0 \
      [--sweeps 1,2,3,4] [--clip-len 32]
Prints one JSON line {"psnr_vs_scan": {k: dB}, "frames": N}.
"""

import argparse
import json
import sys

import numpy as np

sys.path.insert(0, ".")


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--ckpt", required=True)
    p.add_argument("--images", required=True)
    p.add_argument("--keypoints", required=True)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--height", type=int, default=384)
    p.add_argument("--source-width", type=int, default=None,
                   help="resolution the keypoints were annotated at")
    p.add_argument("--source-height", type=int, default=None)
    p.add_argument("--split", choices=["holdout", "train", "all"],
                   default="holdout")
    p.add_argument("--sweeps", default="1,2,3,4")
    p.add_argument("--clip-len", type=int, default=32)
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
            if args.source_width else None
        ),
        clip_len=args.clip_len,
        max_t_step=1,
        cache_labels=False,
        split=args.split,
    )
    profile = PersonProfile(
        name="eval", language="en", canvas=(args.width, args.height),
        dict_path="", keypoints_dir="", keypoint_layout="clip",
    )
    renderer = load_renderer(args.ckpt, profile)
    renderer.time_bucket = args.clip_len

    rng = np.random.RandomState(7)
    labels, reals, _ = dataset.sample_clip(rng)
    scan = renderer.render(labels)

    def psnr(a, b):
        mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
        return 10 * np.log10(255.0**2 / max(mse, 1e-12))

    out = {}
    out_real = {}
    for k in (int(s) for s in args.sweeps.split(",") if s):
        jac = renderer.render_jacobi(labels, sweeps=k)
        out[str(k)] = round(psnr(scan, jac), 2)
        out_real[str(k)] = round(psnr(jac, reals), 2)

    # Ground-truth anchor: how far the exact scan itself is from the
    # real frames — Jacobi error only matters relative to model error.
    print(
        json.dumps(
            {
                "psnr_vs_scan": out,
                "psnr_vs_real": out_real,
                "scan_vs_real_psnr": round(psnr(scan, reals), 2),
                "split": args.split,
                "frames": int(labels.shape[0]),
            }
        )
    )


if __name__ == "__main__":
    main()
