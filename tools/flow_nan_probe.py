"""Bisect the 896x512 batch-4 g_flow NaN inside the generator unroll.

tools/warp_probe.py cleared flow_warp itself at the suspect size, and
tools/nan_probe.py --lambda-adv 0 --no-vgg --l1 10 shows g_flow = NaN
with finite g_fm/g_vgg metrics — so the fault is in the generator's
flows (forward) or in the gradient through scan+remat. This runs, in one
process (one remote compile each):

  1. forward:   _generate_clip at [B, T] — finiteness of fakes & flows
  2. flow grad: d/d(g_params) of flow_loss over those flows
  3. l1 grad:   d/d(g_params) of L1(fakes, reals) as a control

  python tools/flow_nan_probe.py --height 512 --width 896 --batch 4 --clip 8
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
    p.add_argument("--no-remat", action="store_true")
    p.add_argument("--tv-weight", type=float, default=0.01)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--stages", default="fwd,flow,l1")
    args = p.parse_args()

    import jax
    import jax.numpy as jnp

    import text2video.models.losses as L
    from text2video.train.trainer import (
        TrainConfig,
        _flatten_bt,
        _generate_clip,
        _models,
        create_trainer_state,
    )

    cfg = TrainConfig(
        height=args.height,
        width=args.width,
        remat=not args.no_remat,
        dtype=jnp.bfloat16,
    )
    state = create_trainer_state(cfg, seed=args.seed)
    gen = _models(cfg)[0]

    rng = np.random.RandomState(args.seed)
    b, t, h, w = args.batch, args.clip, args.height, args.width
    labels = jnp.asarray(
        rng.randint(0, 2, (b, t, h, w, 3)).astype(np.float32) * 2 - 1
    )
    reals = jnp.asarray(rng.rand(b, t, h, w, 3).astype(np.float32) * 2 - 1)

    stages = set(args.stages.split(","))

    def finite(name, x):
        arr = np.asarray(x)
        n_bad = int(np.size(arr) - np.isfinite(arr).sum())
        print(
            f"  {name}: finite={n_bad == 0}"
            + (f" ({n_bad}/{arr.size} bad)" if n_bad else "")
            + f" |max|={np.nanmax(np.abs(arr)):.4g}"
        )

    # labels/reals MUST be jit arguments, not closure constants — captured
    # constants are inlined into the HLO (~350 MB of constants).
    if "fwd" in stages:
        fwd = jax.jit(
            lambda gp, la, re: _generate_clip(gen, cfg, gp, la, re)
        )
        fakes, flows = fwd(state.g_params, labels, reals)
        print("forward:")
        finite("fakes", fakes)
        finite("flows", flows)

    if "flow" in stages:
        def flow_obj(gp, la, re):
            fakes, flows = _generate_clip(gen, cfg, gp, la, re)
            return L.flow_loss(
                _flatten_bt(flows[:, 1:]),
                _flatten_bt(re[:, :-1].astype(jnp.float32)),
                _flatten_bt(re[:, 1:].astype(jnp.float32)),
                tv_weight=args.tv_weight,
            )

        val, grads = jax.jit(jax.value_and_grad(flow_obj))(
            state.g_params, labels, reals
        )
        print(f"flow_loss={float(val):.6g} finite={np.isfinite(float(val))}")
        leaves = jax.tree.leaves(grads)
        bad = sum(
            0 if bool(jnp.all(jnp.isfinite(x.astype(jnp.float32)))) else 1
            for x in leaves
        )
        print(f"  flow grads: {len(leaves)} leaves, non-finite: {bad}")

    if "l1" in stages:
        def l1_obj(gp, la, re):
            fakes, _ = _generate_clip(gen, cfg, gp, la, re)
            return L.l1(_flatten_bt(fakes), _flatten_bt(re))

        val, grads = jax.jit(jax.value_and_grad(l1_obj))(
            state.g_params, labels, reals
        )
        print(f"l1={float(val):.6g} finite={np.isfinite(float(val))}")
        leaves = jax.tree.leaves(grads)
        bad = sum(
            0 if bool(jnp.all(jnp.isfinite(x.astype(jnp.float32)))) else 1
            for x in leaves
        )
        print(f"  l1 grads: {len(leaves)} leaves, non-finite: {bad}")


if __name__ == "__main__":
    main()
