"""Bisect the 896x512 batch-4 NaN (README known issue).

Runs ONE jitted train step at a given resolution/batch/clip with chosen
loss components and prints per-metric finiteness plus gradient-norm
finiteness per parameter group. Each invocation costs one remote
compile; run the variants one at a time:

  python tools/nan_probe.py --height 512 --width 896 --batch 4 --clip 8
  python tools/nan_probe.py ... --no-vgg
  python tools/nan_probe.py ... --lambda-adv 0
  python tools/nan_probe.py ... --parts image        # image D only
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--width", type=int, default=896)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--clip", type=int, default=8)
    p.add_argument("--no-vgg", action="store_true")
    p.add_argument("--lambda-adv", type=float, default=1.0)
    p.add_argument("--l1", type=float, default=0.0)
    p.add_argument("--no-remat", action="store_true")
    p.add_argument("--temporal-strides", default="1,2")
    p.add_argument("--lambda-face", type=float, default=1.0)
    p.add_argument("--lambda-temp", type=float, default=1.0)
    p.add_argument("--grad-accum", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args()

    import jax
    import jax.numpy as jnp

    from text2video.train.trainer import (
        TrainConfig,
        create_trainer_state,
        make_train_step,
    )

    cfg = TrainConfig(
        height=args.height,
        width=args.width,
        use_vgg=not args.no_vgg,
        lambda_adv=args.lambda_adv,
        lambda_l1=args.l1,
        lambda_face=args.lambda_face,
        lambda_temp=args.lambda_temp,
        remat=not args.no_remat,
        grad_accum=args.grad_accum,
        temporal_strides=tuple(
            int(s) for s in args.temporal_strides.split(",") if s
        ),
        dtype=jnp.bfloat16,
    )
    print("config:", cfg)
    state = create_trainer_state(cfg, seed=args.seed)
    step = jax.jit(make_train_step(cfg), donate_argnums=(0,))

    rng = np.random.RandomState(args.seed)
    b, t, h, w = args.batch, args.clip, args.height, args.width
    batch = {
        "labels": jnp.asarray(
            rng.randint(0, 2, (b, t, h, w, 3)).astype(np.float32) * 2 - 1
        ),
        "reals": jnp.asarray(
            rng.rand(b, t, h, w, 3).astype(np.float32) * 2 - 1
        ),
        "face_centers": jnp.asarray(
            np.stack(
                [
                    rng.uniform(w * 0.3, w * 0.7, (b, t)),
                    rng.uniform(h * 0.3, h * 0.7, (b, t)),
                ],
                axis=-1,
            ).astype(np.float32)
        ),
    }
    new_state, metrics = step(state, batch)
    for k, v in sorted(metrics.items()):
        val = float(v)
        print(f"  {k:10s} = {val:.6g}  finite={np.isfinite(val)}")

    def group_finite(tree, name):
        leaves = jax.tree.leaves(tree)
        bad = [
            i
            for i, x in enumerate(leaves)
            if not bool(jnp.all(jnp.isfinite(x.astype(jnp.float32))))
        ]
        print(f"  {name}: {len(leaves)} leaves, non-finite: {len(bad)}")

    group_finite(new_state.g_params, "g_params after update")
    group_finite(new_state.d_params, "d_params after update")


if __name__ == "__main__":
    main()
