"""Sharded temporal smoothing: the exact recursive (IIR) variant with
warm-up-replay carries — byte-equal to the sequential host path — plus
the FIR halo-exchange variant kept as the approximate fallback."""

import numpy as np

from text2video.ops.smooth import (
    smooth_fir_host,
    smooth_fir_sharded,
    smooth_host,
    smooth_recursive_sharded,
)
from text2video.parallel.mesh import make_mesh


def test_recursive_sharded_byte_equals_host():
    """The production mesh smoother reproduces smooth_host BIT-FOR-BIT:
    per-shard warm-up replay (error decays as the AR(4) feedback's
    spectral radius ~0.67 per frame), strict smooth_host operation
    order via lax.scan accumulation, and barrier'd weight constants so
    XLA cannot rewrite true divisions into reciprocal multiplies
    (ops/smooth.py::smooth_recursive_sharded docstring)."""
    rng = np.random.RandomState(0)
    mesh = make_mesh(n_data=8, n_model=1)
    for T in (64, 1200):  # replay-exact regime AND decay regime
        face = rng.rand(T, 210) * 500
        pose = rng.rand(T, 75) * 500
        ref_f, ref_p = smooth_host(face, pose)
        out_f, out_p = smooth_recursive_sharded(face, pose, mesh)
        np.testing.assert_array_equal(out_f, ref_f)
        np.testing.assert_array_equal(out_p, ref_p)


def test_recursive_sharded_padded_tail_byte_equal():
    rng = np.random.RandomState(3)
    t_true = 37
    face = rng.rand(t_true, 210) * 500
    pose = rng.rand(t_true, 75) * 500
    fp = np.pad(face, ((0, 3), (0, 0)))
    pp = np.pad(pose, ((0, 3), (0, 0)))
    mesh = make_mesh(n_data=8, n_model=1)
    ref_f, ref_p = smooth_host(face, pose)
    out_f, out_p = smooth_recursive_sharded(fp, pp, mesh, 4, t_valid=t_true)
    np.testing.assert_array_equal(out_f[:t_true], ref_f)
    np.testing.assert_array_equal(out_p[:t_true], ref_p)


def test_fir_sharded_matches_host():
    rng = np.random.RandomState(0)
    T = 64  # divides over 8 shards
    face = rng.rand(T, 210) * 300
    pose = rng.rand(T, 75) * 300
    ref_f, ref_p = smooth_fir_host(face, pose)

    mesh = make_mesh(n_data=8, n_model=1)
    out_f, out_p = smooth_fir_sharded(
        face.astype(np.float32), pose.astype(np.float32), mesh
    )
    np.testing.assert_allclose(np.asarray(out_f), ref_f, rtol=2e-4, atol=2e-3)
    np.testing.assert_allclose(np.asarray(out_p), ref_p, rtol=2e-4, atol=2e-3)


def test_fir_sharded_boundary_halos_masked():
    """Edge shards must not absorb wrapped-ring halo garbage: constant
    input stays constant everywhere (weights renormalize at the edges)."""
    mesh = make_mesh(n_data=8, n_model=1)
    face = np.full((32, 210), 7.0, np.float32)
    pose = np.full((32, 75), 3.0, np.float32)
    out_f, out_p = smooth_fir_sharded(face, pose, mesh)
    np.testing.assert_allclose(np.asarray(out_f), 7.0, atol=1e-4)
    np.testing.assert_allclose(np.asarray(out_p), 3.0, atol=1e-4)


def test_fir_sharded_padded_tail_masked():
    """With t_valid < T (padded tail), padding rows must not bleed into
    the last valid frames."""
    rng = np.random.RandomState(3)
    t_true = 37
    face = rng.randn(t_true, 210).astype(np.float32)
    pose = rng.randn(t_true, 75).astype(np.float32)
    t_pad = 40  # next multiple of 8
    fp = np.pad(face, ((0, t_pad - t_true), (0, 0)))
    pp = np.pad(pose, ((0, t_pad - t_true), (0, 0)))
    mesh = make_mesh(n_data=8, n_model=1)
    f_s, p_s = smooth_fir_sharded(fp, pp, mesh, 4, t_valid=t_true)
    f_ref, p_ref = smooth_fir_host(
        face.astype(np.float64), pose.astype(np.float64), 4
    )
    np.testing.assert_allclose(
        np.asarray(f_s)[:t_true], f_ref, rtol=1e-4, atol=1e-4
    )
    np.testing.assert_allclose(
        np.asarray(p_s)[:t_true], p_ref, rtol=1e-4, atol=1e-4
    )


def test_pipeline_utterance_spans_mesh(tmp_path):
    """Pipeline-level sequence parallelism: one utterance's pose smoothing
    and rasterization span the 8-device mesh (SURVEY.md §2.5); the
    sharded pose stage's tracks are BYTE-equal to the bit-exact host
    path (golden-track parity holds on-mesh, not only off-mesh)."""
    import os

    import pytest

    from tests.conftest import REFERENCE_DIR, has_reference_data

    if not has_reference_data():
        pytest.skip("reference data assets not mounted")

    from text2video.config import PipelineConfig, get_profile
    from text2video.frontend.timestamps import load_timestamp_file
    from text2video.pipeline import Text2VideoPipeline
    from text2video.pose_stage import PoseStage

    profile = get_profile("fadg0")
    ts = load_timestamp_file(
        f"{REFERENCE_DIR}/input_timestamp/fadg0/phones/Dotheymake.txt"
    )
    mesh = make_mesh(n_data=8, n_model=1)
    pipe = Text2VideoPipeline(
        PipelineConfig(person=profile, out_dir=str(tmp_path)), mesh=mesh
    )
    run = pipe.synthesize(ts, "sharded", keep_arrays=True)
    assert run.num_frames > 10
    assert run.label_maps.shape[1:] == (384, 512, 3)
    assert (run.label_maps > 0).mean() > 0.001
    for f in run.files:
        assert os.path.getsize(f) > 0

    # GOLDEN-TRACK byte equality: the sharded pose stage reproduces the
    # bit-exact float64 host stage exactly — raw tracks (host synthesis
    # on both paths) AND smoothed tracks (warm-up-replay recursion).
    stage = PoseStage(profile)
    res_sharded = stage.run(ts, mesh=mesh)
    res_host = stage.run(ts, device=False)
    np.testing.assert_array_equal(res_sharded.face, res_host.face)
    np.testing.assert_array_equal(res_sharded.pose, res_host.pose)
    np.testing.assert_array_equal(
        res_sharded.face_smooth, res_host.face_smooth
    )
    np.testing.assert_array_equal(
        res_sharded.pose_smooth, res_host.pose_smooth
    )
    # ... and therefore the emitted pose JSONs are byte-identical.
    raws_sharded = stage.emit_smooth_raws(res_sharded)
    raws_host = stage.emit_smooth_raws(res_host)
    import json

    assert [json.dumps(r) for r in raws_sharded] == [
        json.dumps(r) for r in raws_host
    ]
