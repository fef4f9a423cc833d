"""Minimal probe for the flow_warp >2GB-operand NaN (README known issue).

Evaluates mean(flow_warp(img, flow)) and its gradient w.r.t. flow at a
given [B, H, W] on the live backend and prints finiteness. The 896x512
batch-4 clip-8 train step flattens to B=28 f32 frames, whose 4x-stacked
gather operand is 28*512*896*12*4B = 2.46 GB — past the 2^31-byte line;
every finite config stays under it.

  python tools/warp_probe.py --b 28 --height 512 --width 896   # suspect
  python tools/warp_probe.py --b 20 --height 512 --width 896   # control
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--b", type=int, default=28)
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--width", type=int, default=896)
    p.add_argument("--c", type=int, default=3)
    p.add_argument("--dtype", default="float32")
    args = p.parse_args()

    import jax
    import jax.numpy as jnp

    from text2video.ops.warp import flow_warp

    b, h, w, c = args.b, args.height, args.width, args.c
    dt = jnp.dtype(args.dtype)
    print(
        f"stacked operand: {b}x{h}x{w}x{4 * c} {dt.name} = "
        f"{b * h * w * 4 * c * dt.itemsize / 2**30:.2f} GiB"
    )

    rng = np.random.RandomState(0)
    img = jnp.asarray(rng.rand(b, h, w, c).astype(np.float32) * 2 - 1, dt)
    flow = jnp.asarray(rng.randn(b, h, w, 2).astype(np.float32), jnp.float32)

    def loss(fl):
        return jnp.mean(flow_warp(img, fl).astype(jnp.float32))

    val, grad = jax.jit(jax.value_and_grad(loss))(flow)
    gsum = float(jnp.sum(jnp.abs(grad)))
    print(f"loss={float(val):.6g} finite={np.isfinite(float(val))}")
    print(f"grad |sum|={gsum:.6g} finite={np.isfinite(gsum)}")


if __name__ == "__main__":
    main()
