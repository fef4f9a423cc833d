"""Probe: is the generator forward per-sample deterministic across batch
sizes? Feeds the SAME sample at batch 1 and inside a batch 18 and
compares outputs — the noise source for the scan-vs-Jacobi divergence
(tools/jacobi_divergence_probe.py)."""

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from text2video.render import Renderer  # noqa: E402
from text2video.config import RenderConfig  # noqa: E402


def main():
    rng = np.random.RandomState(0)
    r = Renderer.create(
        config=RenderConfig(load_size=128),
        height=128, width=192, base_ch=4, n_blocks=1,
    )
    cfg = r.config
    b = 18
    labels = jnp.asarray(
        rng.rand(b, 128, 192, 3 * cfg.n_frames_ctx).astype(np.float32) * 2 - 1
    )
    prev = jnp.asarray(
        rng.rand(b, 128, 192, 3 * cfg.use_prev_frames).astype(np.float32) * 2 - 1
    )
    hp = jnp.ones((b,), jnp.float32)

    apply = jax.jit(lambda lab, pv, h: r.generator.apply(r.params, lab, pv, h))
    f_b, flow_b, mask_b = apply(labels, prev, hp)
    for i in [0, 3, 9]:
        f_1, flow_1, mask_1 = apply(labels[i : i + 1], prev[i : i + 1], hp[:1])
        d = np.abs(np.asarray(f_b[i], np.float64) - np.asarray(f_1[0], np.float64))
        df = np.abs(np.asarray(flow_b[i], np.float64) - np.asarray(flow_1[0], np.float64))
        dm = np.abs(np.asarray(mask_b[i], np.float64) - np.asarray(mask_1[0], np.float64))
        print(f"sample {i}: frame max {d.max():.3e}  flow max {df.max():.3e} "
              f"mask max {dm.max():.3e}")


if __name__ == "__main__":
    main()
