"""Jacobi parallel decoding (render.py::render_jacobi).

The sequential scan is the fixed point of the autoregressive recurrence;
each Jacobi sweep propagates exact prefixes at least one frame further
(frame 0 is exact on sweep 1), so ``sweeps >= T`` reproduces the scan in
exact arithmetic. In float the batched-vs-scanned reduction-order
differences (~1e-6) amplify through the recurrence's bilinear warp —
measured ~5-20x per frame on a random-weight generator fed noise labels
(the worst case; trained weights on smooth frames amplify far less) — so
the tests assert the structural properties (exact prefix, monotone
convergence) with tolerances that acknowledge the chain amplification.
"""

import numpy as np

from text2video.render import Renderer


def _renderer(h=32, w=32):
    import jax.numpy as jnp

    r = Renderer.create(
        height=h, width=w, base_ch=8, n_blocks=1, dtype=jnp.float32
    )
    r.time_bucket = 4
    return r


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 10 * np.log10(255.0**2 / max(mse, 1e-12))


def test_jacobi_full_sweeps_match_scan():
    r = _renderer()
    rng = np.random.RandomState(0)
    t = 6
    labels = rng.randint(0, 256, size=(t, 32, 32, 3), dtype=np.uint8)
    seq = r.render(labels)
    jac = r.render_jacobi(labels, sweeps=t)
    diff = np.abs(seq.astype(int) - jac.astype(int))
    # Frame 0 has no recurrence: bit-equal up to uint8 rounding.
    assert diff[0].max() <= 1, diff[0].max()
    # Early prefix: amplification hasn't compounded yet.
    assert diff[: t // 2].max() <= 2, diff[: t // 2].max()
    # Whole clip agrees to high fidelity despite chain amplification.
    assert _psnr(seq, jac) >= 35.0, _psnr(seq, jac)


def test_jacobi_few_sweeps_approximate():
    r = _renderer()
    rng = np.random.RandomState(1)
    t = 8
    labels = rng.randint(0, 256, size=(t, 32, 32, 3), dtype=np.uint8)
    seq = r.render(labels)
    jac3 = r.render_jacobi(labels, sweeps=3)
    jac1 = r.render_jacobi(labels, sweeps=1)
    # More sweeps converge toward the sequential output.
    assert _psnr(seq, jac3) >= _psnr(seq, jac1)
    # The exact-prefix property: after s sweeps frames 0..s-1 match.
    diff_prefix = np.abs(seq[:3].astype(int) - jac3[:3].astype(int))
    assert diff_prefix.max() <= 2, diff_prefix.max()


def test_jacobi_chunked_tail_padding():
    """T not divisible by the bucket exercises the padded tail path."""
    r = _renderer()
    rng = np.random.RandomState(2)
    t = 7  # bucket 4 -> pad 1
    labels = rng.randint(0, 256, size=(t, 32, 32, 3), dtype=np.uint8)
    jac = r.render_jacobi(labels, sweeps=t)
    seq = r.render(labels)
    assert jac.shape == (t, 32, 32, 3)
    assert np.abs(seq[0].astype(int) - jac[0].astype(int)).max() <= 1
    assert _psnr(seq, jac) >= 35.0, _psnr(seq, jac)


def test_jacobi_sharded_spans_mesh():
    """One utterance's timeline spans the 8-device mesh; full sweeps
    reproduce the sequential scan (same structural tolerances as the
    single-device Jacobi tests)."""
    from text2video.parallel.mesh import make_mesh

    r = _renderer()
    mesh = make_mesh(n_data=8, n_model=1)
    rng = np.random.RandomState(4)
    t = 10  # pads to 16 over 8 shards
    labels = rng.randint(0, 256, size=(t, 32, 32, 3), dtype=np.uint8)
    seq = r.render(labels)
    jac = r.render_jacobi_sharded(labels, mesh, sweeps=t)
    assert jac.shape == (t, 32, 32, 3)
    # Converged prefix matches the scan; the tail of a RANDOM-weight net
    # amplifies float noise exponentially (measured ~100/255 by frame 9),
    # so only a loose global bound is meaningful there.
    diff = np.abs(seq.astype(int) - jac.astype(int))
    assert diff[: t // 2].max() <= 2, diff[: t // 2].max()
    assert _psnr(seq, jac) >= 24.0, _psnr(seq, jac)
    # Sharded and single-device Jacobi run the same math.
    jac1 = r.render_jacobi(labels, sweeps=t)
    assert _psnr(jac1, jac) >= 23.0, _psnr(jac1, jac)
