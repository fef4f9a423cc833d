"""Probe: where do the scan and Jacobi-at-full-sweeps decoders diverge?

Reproduces tests/test_pipeline_e2e.py::test_jacobi_decode_pipeline's
renderer (bf16, base 4, 1 block, 128x192, load_size 128) on random
labels, renders both ways, and prints per-frame max |diff| so we can see
whether the error is injected at frame 0 (batched-vs-scanned conv
nondeterminism) or grows through the recurrence (warp noise
amplification). Run on CPU (conftest-style)."""

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from text2video.render import Renderer  # noqa: E402
from text2video.config import RenderConfig  # noqa: E402


def main():
    rng = np.random.RandomState(0)
    t = 18
    labels = rng.randint(0, 256, size=(t, 128, 192, 3), dtype=np.uint8)
    r = Renderer.create(
        config=RenderConfig(load_size=128),
        height=128, width=192, base_ch=4, n_blocks=1,
    )
    r.time_bucket = 32
    seq = r.render(labels)
    jac = r.render_jacobi(labels, sweeps=32)
    diff = np.abs(seq.astype(int) - jac.astype(int))
    for i in range(t):
        print(f"frame {i:2d}: max {diff[i].max():3d} mean {diff[i].mean():.3f}")
    mse = np.mean((seq.astype(np.float64) - jac.astype(np.float64)) ** 2)
    print("psnr", 10 * np.log10(255.0**2 / max(mse, 1e-12)))


if __name__ == "__main__":
    main()
