"""Bisect the scan-vs-Jacobi divergence: run (a) a manual sequential
recurrence with direct batch-1 generator calls, (b) a manual Jacobi
iteration with direct batched generator calls, (c) the production
_scan_chunk, (d) the production jacobi_device — and diff all pairs.
The generator forward is bit-deterministic across batch sizes
(tools/batch_determinism_probe.py), so any mismatch is a semantic
difference in input assembly."""

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
    r.time_bucket = 32
    cfg = r.config
    dt = r.generator.dtype
    labels_u8 = rng.randint(0, 256, size=(t, 128, 192, 3), dtype=np.uint8)
    labels = jnp.asarray(labels_u8.astype(np.float32) / 127.5 - 1.0)

    apply = jax.jit(lambda lab, pv, h: r.generator.apply(r.params, lab, pv, h)[0])

    # Label context [t, H, W, 3*n_ctx] in dt, zeros before start.
    ctx = [labels]
    for k in range(1, cfg.n_frames_ctx):
        ctx.append(jnp.pad(labels, ((k, 0), (0, 0), (0, 0), (0, 0)))[:t])
    labels_ctx = jnp.concatenate(ctx, axis=-1).astype(dt)

    # (a) manual sequential, batch-1 calls, dt carry
    frames_seq = []
    prev = jnp.zeros((1, 128, 192, 3 * cfg.use_prev_frames), dt)
    for i in range(t):
        hp = jnp.asarray([1.0 if i > 0 else 0.0], jnp.float32)
        f = apply(labels_ctx[i : i + 1], prev, hp).astype(dt)
        prev = jnp.concatenate([f, prev[..., :-3]], axis=-1)
        frames_seq.append(f[0])
    frames_seq = jnp.stack(frames_seq)

    # (b) manual Jacobi, batched calls, dt frames
    hp_all = (jnp.arange(t) > 0).astype(jnp.float32)
    frames_jac = jnp.zeros((t, 128, 192, 3), dt)
    for _ in range(t + 1):
        prevs = jnp.concatenate(
            [jnp.pad(frames_jac, ((k, 0), (0, 0), (0, 0), (0, 0)))[:t]
             for k in range(1, cfg.use_prev_frames + 1)], axis=-1)
        frames_jac = apply(labels_ctx, prevs, hp_all).astype(dt)

    print("manual seq vs manual jacobi:", maxdiff(frames_seq, frames_jac))

    # (c) production scan
    carry = r.init_carry(1, 128, 192)
    frames_scan, _ = jax.jit(r._scan_chunk)(r.params, labels[None], carry)
    for i in range(t):
        print(f"  frame {i}: manual-vs-scan {maxdiff(frames_seq[i], frames_scan[0, i]):.6f}")
    print("manual seq vs _scan_chunk:", maxdiff(frames_seq, frames_scan[0]))

    # (d) production jacobi_device
    frames_jdev = r.jacobi_device(labels, sweeps=t + 1)
    for i in range(t):
        print(f"  frame {i}: manual-vs-jdev {maxdiff(frames_jac[i].astype(jnp.float32), frames_jdev[i]):.6f}")
    print("manual jacobi vs jacobi_device:", maxdiff(frames_jac.astype(jnp.float32), frames_jdev))
    print("scan vs jacobi_device:", maxdiff(frames_scan[0], frames_jdev))


if __name__ == "__main__":
    main()
