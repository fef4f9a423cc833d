"""Second bisect: feed IDENTICAL inputs to (a) a fresh jitted
generator.apply, (b) renderer._jacobi_sweep, and (c) a hand-inlined copy
of jacobi_device's context assembly, to find whether the frame-0
divergence is input assembly or compilation differences."""

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from text2video.render import Renderer  # noqa: E402
from text2video.config import RenderConfig  # noqa: E402


def maxdiff(a, b):
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


def main():
    rng = np.random.RandomState(0)
    t = 6
    r = Renderer.create(
        config=RenderConfig(load_size=128),
        height=128, width=192, base_ch=4, n_blocks=1,
    )
    cfg = r.config
    dt = r.generator.dtype
    labels_u8 = rng.randint(0, 256, size=(t, 128, 192, 3), dtype=np.uint8)
    labels = jnp.asarray(labels_u8.astype(np.float32) / 127.5 - 1.0)

    ctx = [labels]
    for k in range(1, cfg.n_frames_ctx):
        ctx.append(jnp.pad(labels, ((k, 0), (0, 0), (0, 0), (0, 0)))[:t])
    labels_ctx = jnp.concatenate(ctx, axis=-1).astype(dt)
    prev = jnp.zeros((t, 128, 192, 3 * cfg.use_prev_frames), dt)
    hp = (jnp.arange(t) > 0).astype(jnp.float32)

    apply = jax.jit(lambda lab, pv, h: r.generator.apply(r.params, lab, pv, h)[0])
    fa = apply(labels_ctx, prev, hp).astype(dt)
    fb = r._jacobi_sweep(r.params, labels_ctx, prev, hp)
    print("fresh-jit vs _jacobi_sweep, same inputs:", maxdiff(fa, fb))

    # eager (unjitted) apply for ground truth
    fc = r.generator.apply(r.params, labels_ctx, prev, hp)[0].astype(dt)
    print("eager vs fresh-jit:", maxdiff(fc, fa))
    print("eager vs _jacobi_sweep:", maxdiff(fc, fb))


if __name__ == "__main__":
    main()
