"""Training data pipeline + short training-loop integration test."""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from tests.conftest import REFERENCE_DIR, requires_reference_data

IMAGES = f"{REFERENCE_DIR}/*phoneme_data/VidTIMIT/fadg0/images_fadg0"
KEYPOINTS = f"{REFERENCE_DIR}/*phoneme_data/VidTIMIT/fadg0/keypoints_fadg0"


@pytest.fixture(scope="module")
def dataset():
    from text2video.train.data import PoseClipDataset

    return PoseClipDataset(
        images_dir=IMAGES,
        keypoints_dir=KEYPOINTS,
        canvas=(128, 96),
        source_canvas=(512, 384),
        clip_len=4,
        cache_labels=False,
    )


@requires_reference_data
def test_dataset_batch_shapes(dataset):
    rng = np.random.RandomState(0)
    batch = dataset.batch(rng, 2)
    assert batch["labels"].shape == (2, 4, 96, 128, 3)
    assert batch["reals"].shape == (2, 4, 96, 128, 3)
    assert batch["face_centers"].shape == (2, 4, 2)
    # Normalized [-1, 1]; labels mostly background (-1) with drawing.
    assert batch["labels"].min() >= -1.0 and batch["labels"].max() <= 1.0
    assert (batch["labels"] > -1.0).mean() > 0.001
    assert batch["reals"].std() > 0.1
    # Mouth centres land inside the scaled canvas.
    c = batch["face_centers"]
    assert (c[..., 0] > 0).all() and (c[..., 0] < 128).all()
    assert (c[..., 1] > 0).all() and (c[..., 1] < 96).all()


@requires_reference_data
def test_dataset_clip_contiguity(dataset):
    rng = np.random.RandomState(1)
    for _ in range(5):
        labels, reals, centers = dataset.sample_clip(rng)
        assert labels.shape[0] == 4
        # Consecutive real frames of one clip are similar (no clip jumps).
        diffs = np.abs(
            reals[1:].astype(np.int32) - reals[:-1].astype(np.int32)
        ).mean(axis=(1, 2, 3))
        assert (diffs < 60).all(), diffs


@requires_reference_data
def test_short_training_run_and_checkpoint(dataset, tmp_path):
    from text2video.train.checkpoints import load_renderer
    from text2video.train.loop import train_gan
    from text2video.train.trainer import TrainConfig

    cfg = TrainConfig(
        height=96,
        width=128,
        face_crop=24,
        base_ch=8,
        n_blocks=1,
        d_base_ch=8,
        use_vgg=False,
        dtype=jnp.float32,
    )
    logs = []
    ckpt_dir = str(tmp_path / "ckpt")
    state = train_gan(
        dataset,
        cfg,
        steps=3,
        batch_size=2,
        ckpt_dir=ckpt_dir,
        save_every=100,
        log_every=1,
        log_fn=logs.append,
    )
    assert int(state.step) == 3
    assert len(logs) == 3
    assert "g_loss" in logs[-1]

    # Resume picks up the saved step.
    state2 = train_gan(
        dataset, cfg, steps=1, batch_size=2, ckpt_dir=ckpt_dir,
        log_fn=logs.append,
    )
    assert int(state2.step) == 4

    # The inference renderer loads generator params from the checkpoint.
    from text2video.config import PersonProfile

    profile = PersonProfile(
        name="tiny", language="en", canvas=(128, 96), dict_path="",
        keypoints_dir="", keypoint_layout="clip",
    )
    renderer = load_renderer(ckpt_dir, profile)
    assert renderer.generator.base_ch == 8 and renderer.generator.n_blocks == 1
    labels = np.zeros((2, 96, 128, 3), np.uint8)
    frames = renderer.render(labels)
    assert frames.shape == (2, 96, 128, 3)


@requires_reference_data
def test_device_data_mode(dataset, tmp_path):
    from text2video.train.loop import train_gan
    from text2video.train.trainer import TrainConfig

    cfg = TrainConfig(
        height=96, width=128, face_crop=24, base_ch=8, n_blocks=1,
        d_base_ch=8, use_vgg=False, dtype=jnp.float32,
    )
    logs = []
    state = train_gan(
        dataset, cfg, steps=2, batch_size=2, device_data=True,
        log_every=1, log_fn=logs.append,
    )
    assert int(state.step) == 2
    assert any("device-resident" in l for l in logs)
    assert any("g_loss" in l for l in logs)


@requires_reference_data
def test_device_data_augmented(dataset, tmp_path):
    """Augmented device-data training: labels re-rasterize on device per
    step from jittered/dropped keypoints (train/augment.py)."""
    from text2video.train.loop import train_gan
    from text2video.train.trainer import TrainConfig

    cfg = TrainConfig(
        height=96, width=128, face_crop=24, base_ch=8, n_blocks=1,
        d_base_ch=8, use_vgg=False, dtype=jnp.float32,
        aug_jitter_px=1.5, aug_drop_prob=0.05, aug_face_drop_prob=0.1,
    )
    logs = []
    state = train_gan(
        dataset, cfg, steps=2, batch_size=2, device_data=True,
        log_every=1, log_fn=logs.append,
    )
    assert int(state.step) == 2
    assert any("augmented" in l for l in logs)
    assert any("g_loss" in l for l in logs)


def test_augment_tracks_semantics():
    """Jitter moves only confident points; drops zero confidence; face
    drop blanks whole frames' face confidence."""
    import jax

    from text2video.train.augment import augment_tracks

    m = 64
    rng = np.random.RandomState(0)
    def tr(n):
        t = rng.rand(m, n * 3).astype(np.float32) * 100
        t.reshape(m, n, 3)[..., 2] = 1.0
        return jnp.asarray(t)
    face, pose, hl, hr = tr(70), tr(25), tr(21), tr(21)
    # Mark one point as unconfident; it must not move.
    face = face.at[0, 2].set(0.0)
    key = jax.random.PRNGKey(0)
    f2, p2, l2, r2 = augment_tracks(
        face, pose, hl, hr, key, drop_prob=0.0, jitter_px=2.0
    )
    assert not np.allclose(np.asarray(f2), np.asarray(face))
    np.testing.assert_allclose(
        np.asarray(f2)[0, :2], np.asarray(face)[0, :2]
    )  # unconfident point untouched
    # Confidences unchanged without drop.
    np.testing.assert_array_equal(
        np.asarray(f2).reshape(m, 70, 3)[..., 2],
        np.asarray(face).reshape(m, 70, 3)[..., 2],
    )
    # Drop-only: some confidences zero, positions unchanged.
    f3, _, _, _ = augment_tracks(
        face, pose, hl, hr, key, drop_prob=0.5, jitter_px=0.0
    )
    conf3 = np.asarray(f3).reshape(m, 70, 3)[..., 2]
    assert 0.2 < (conf3 == 0).mean() < 0.8
    # Whole-face drop blanks every face conf of some frames.
    f4, _, _, _ = augment_tracks(
        face, pose, hl, hr, key, face_drop_prob=0.5
    )
    conf4 = np.asarray(f4).reshape(m, 70, 3)[..., 2]
    frame_blank = (conf4 == 0).all(axis=1)
    assert 0.2 < frame_blank.mean() < 0.8


def test_scale_crop_registration():
    """Scale/crop augmentation keeps labels and reals registered: the
    re-rasterized transformed keypoints land where the zoomed+cropped
    image content moved (reference randomScaleHeight_and_scaledCrop —
    image and label must see the SAME affine)."""
    import jax

    from text2video.ops.rasterize import _rasterize_chunk, _round_up
    from text2video.train.augment import (
        make_scale_crop_branches,
        scale_crop_scales,
        scale_crop_transform_track,
    )

    h, w, m = 96, 128, 2
    face = np.zeros((m, 210), np.float32)
    pts = face.reshape(m, 70, 3)
    # Jaw chain (points 0-16) along a diagonal well inside the canvas.
    for i in range(17):
        pts[:, i, 0] = 40.0 + 3.0 * i  # x
        pts[:, i, 1] = 30.0 + 1.5 * i  # y
        pts[:, i, 2] = 1.0
    zeros = lambda n: jnp.zeros((m, n), jnp.float32)
    face = jnp.asarray(face)
    pose, hl, hr = zeros(75), zeros(63), zeros(63)
    ns = _round_up(max(w, h), 128)

    label1 = np.asarray(
        _rasterize_chunk(face, pose, hl, hr, width=w, height=h,
                         n_samples=ns)
    ).astype(np.float32)

    scales = scale_crop_scales(544.0 / 512.0 - 1.0)
    branches = make_scale_crop_branches(1, m, h, w, scales)
    u = jnp.asarray([[0.3, 0.7]], jnp.float32)
    for si in (1, 2):
        crop, off, s = branches[si](jnp.asarray(label1)[None], u)
        off_flat = jnp.repeat(off, m, axis=0)[:, None, :]
        f2 = scale_crop_transform_track(face, 70, s, off_flat, h, w)
        label2 = np.asarray(
            _rasterize_chunk(f2, pose, hl, hr, width=w, height=h,
                             n_samples=ns)
        ).astype(np.float32)

        def centroid(img):
            # [H, W, 3] -> (x, y) centroid of the GREEN channel: the jaw
            # draws white; the rasterizer also stamps a red disk at the
            # (0, 0) origin for all-invalid point groups, which must not
            # pollute the measurement.
            wgt = img[..., 1]
            ys, xs = np.mgrid[0:img.shape[0], 0:img.shape[1]]
            return (
                float((xs * wgt).sum() / wgt.sum()),
                float((ys * wgt).sum() / wgt.sum()),
            )

        for t in range(m):
            cx1, cy1 = centroid(np.asarray(crop)[0, t])
            cx2, cy2 = centroid(label2[t])
            assert abs(cx1 - cx2) < 1.5 and abs(cy1 - cy2) < 1.5, (
                si, t, (cx1, cy1), (cx2, cy2)
            )
        # The crop actually moved the content (non-identity branch).
        c0 = centroid(label1[0])
        c1 = centroid(np.asarray(crop)[0, 0])
        assert abs(c0[0] - c1[0]) + abs(c0[1] - c1[1]) > 1.0


@requires_reference_data
def test_device_data_scale_crop(dataset):
    """Loop-level: --aug-scale-crop trains through the jitted step."""
    from text2video.train.loop import train_gan
    from text2video.train.trainer import TrainConfig

    cfg = TrainConfig(
        height=96, width=128, face_crop=24, base_ch=8, n_blocks=1,
        d_base_ch=8, use_vgg=False, dtype=jnp.float32,
        aug_scale_crop=True,
    )
    logs = []
    state = train_gan(
        dataset, cfg, steps=2, batch_size=2, device_data=True,
        log_every=1, log_fn=logs.append,
    )
    assert int(state.step) == 2
    assert any("augmented" in l for l in logs)
    m = [l for l in logs if "g_loss" in l]
    assert m and "nan" not in m[-1]


@requires_reference_data
def test_training_snapshots(dataset, tmp_path):
    from text2video.train.loop import train_gan
    from text2video.train.trainer import TrainConfig

    cfg = TrainConfig(
        height=96, width=128, face_crop=24, base_ch=8, n_blocks=1,
        d_base_ch=8, use_vgg=False, dtype=jnp.float32,
    )
    ckpt_dir = str(tmp_path / "ck")
    train_gan(
        dataset, cfg, steps=2, batch_size=2, ckpt_dir=ckpt_dir,
        sample_every=1, log_fn=lambda s: None,
    )
    snaps = [f for f in os.listdir(ckpt_dir) if f.startswith("sample_")]
    assert len(snaps) == 2


def test_reference_flow_convention():
    """Farneback reference flow must satisfy ops/warp.flow_warp's
    convention: warp(prev, flow) ~ cur on a translating pattern."""
    import jax.numpy as jnp2

    from text2video.ops.warp import flow_warp
    from text2video.train.data import PoseClipDataset

    h, w = 64, 64
    yy, xx = np.mgrid[0:h, 0:w]
    base = (
        127 + 60 * np.sin(xx / 5.0) * np.cos(yy / 7.0)
    ).astype(np.uint8)
    prev = np.stack([base] * 3, -1)
    cur = np.roll(prev, shift=3, axis=1)  # content moves +3 px in x
    reals = np.stack([prev, cur])
    flow = PoseClipDataset.reference_flow(reals)
    assert flow.shape == (1, h, w, 2)
    # Inner region: backward flow dx ~ -3 (cur pixel came from x-3).
    inner = flow[0, 16:-16, 16:-16, 0]
    assert abs(inner.mean() + 3.0) < 0.5, inner.mean()
    warped = np.asarray(
        flow_warp(
            jnp2.asarray(prev[None].astype(np.float32)),
            jnp2.asarray(flow[:1]),
        )
    )[0]
    err = np.abs(warped[8:-8, 8:-8] - cur[8:-8, 8:-8].astype(np.float32))
    assert err.mean() < 10, err.mean()


@requires_reference_data
def test_train_step_with_reference_flow(dataset):
    """One train step consuming Farneback flow_gt stays finite."""
    import jax

    from text2video.train.trainer import TrainConfig, create_trainer_state, make_train_step

    cfg = TrainConfig(
        height=96, width=128, face_crop=24, base_ch=8, n_blocks=1,
        d_base_ch=8, use_vgg=False, dtype=jnp.float32,
        flow_supervision="reference",
    )
    state = create_trainer_state(cfg, seed=0)
    step = jax.jit(make_train_step(cfg))
    batch = dataset.batch(np.random.RandomState(0), 2, with_flow=True)
    assert batch["flow_gt"].shape == (2, 3, 96, 128, 2)
    state, metrics = step(state, batch)
    assert np.isfinite(float(metrics["g_flow"]))
    assert np.isfinite(float(metrics["g_loss"]))


@requires_reference_data
def test_max_frames_cap():
    """max_frames truncates runs in order while keeping each kept run
    contiguous and >= clip_len (HBM-budget knob for device-resident
    training on one chip)."""
    from text2video.train.data import PoseClipDataset

    ds = PoseClipDataset(
        images_dir=IMAGES,
        keypoints_dir=KEYPOINTS,
        canvas=(128, 96),
        source_canvas=(512, 384),
        clip_len=4,
        cache_labels=False,
        max_frames=10,
    )
    assert ds.num_frames <= 10
    assert all(len(c) >= 4 for c in ds.clips)
    # Sampling still works within the capped run(s).
    labels, reals, centers = ds.sample_clip(np.random.RandomState(0))
    assert labels.shape[0] == 4


def test_stall_watchdog_exits_and_pets():
    """_StallWatchdog exits the process (code 3) when not petted — run
    in a subprocess since os._exit would kill pytest — and a petted
    watchdog stays quiet."""
    import subprocess
    import sys
    import textwrap

    code = textwrap.dedent(
        """
        import time
        from text2video.train.loop import _StallWatchdog
        wd = _StallWatchdog(1.0, print)
        wd._deadline = time.time() + 1.0  # collapse the compile grace
        time.sleep(60)
        """
    )
    r = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, timeout=55,
        text=True,
    )
    assert r.returncode == _watchdog_exit_code()
    assert "presumed stalled" in r.stdout

    code_ok = textwrap.dedent(
        """
        import time
        from text2video.train.loop import _StallWatchdog
        wd = _StallWatchdog(3600.0, print)
        wd.pet()
        wd.stop()
        print("alive")
        """
    )
    r2 = subprocess.run(
        [sys.executable, "-c", code_ok], capture_output=True, timeout=120,
        text=True,
    )
    assert r2.returncode == 0 and "alive" in r2.stdout


def _watchdog_exit_code():
    from text2video.train.loop import _StallWatchdog

    return _StallWatchdog.EXIT_CODE


@requires_reference_data
def test_holdout_split_deterministic_and_disjoint():
    """train/holdout partition: deterministic, frame-disjoint, and the
    union covers the full dataset (the honest-eval contract VERDICT r2
    item 3 asked for)."""
    from text2video.train.data import PoseClipDataset

    kw = dict(
        images_dir=IMAGES,
        keypoints_dir=KEYPOINTS,
        canvas=(128, 96),
        source_canvas=(512, 384),
        clip_len=4,
        cache_labels=False,
    )
    full = PoseClipDataset(split="all", **kw)
    train = PoseClipDataset(split="train", **kw)
    hold = PoseClipDataset(split="holdout", **kw)
    train2 = PoseClipDataset(split="train", **kw)

    def stems(ds):
        return {f.stem for clip in ds.clips for f in clip}

    assert stems(train) == stems(train2)  # deterministic
    assert not (stems(train) & stems(hold))  # disjoint
    assert stems(train) | stems(hold) == stems(full)  # covering
    # Holdout reserves roughly the requested fraction (whole clips).
    assert 0.05 * full.num_frames <= hold.num_frames
    # fadg0 is multi-clip: held-out frames share no source clip with
    # training frames.
    train_clips = {s.rsplit("_", 1)[0] for s in stems(train)}
    hold_clips = {s.rsplit("_", 1)[0] for s in stems(hold)}
    assert not (train_clips & hold_clips)


def test_split_runs_single_run():
    """A single contiguous recording splits at its tail."""
    from text2video.train.data import _split_runs

    run = [object() for _ in range(100)]
    train, hold = _split_runs([run], clip_len=8, fraction=0.1)
    assert train[0] == run[:90] and hold[0] == run[90:]
    # Fraction below clip_len still reserves a renderable holdout.
    train, hold = _split_runs([run], clip_len=20, fraction=0.05)
    assert len(hold[0]) == 20
    with pytest.raises(ValueError):
        _split_runs([run[:30]], clip_len=20, fraction=0.1)
