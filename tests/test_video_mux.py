"""Muxer tests: cv2 mp4 writer and the self-contained AVI (MJPEG+PCM)."""

import struct

import cv2
import numpy as np

from text2video.io.video import mux, write_avi_with_audio, write_video


def _frames(t=10, h=64, w=96):
    # Smooth gradients (JPEG-friendly) that shift per frame.
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack(
        [(xx * 255 // w), (yy * 255 // h), ((xx + yy) * 255 // (h + w))],
        axis=-1,
    ).astype(np.uint8)
    return np.stack(
        [np.roll(base, shift=3 * i, axis=1) for i in range(t)]
    )


def test_write_video_roundtrip(tmp_path):
    frames = _frames()
    path = str(tmp_path / "v.mp4")
    write_video(frames, path, fps=25.0)
    cap = cv2.VideoCapture(path)
    assert cap.isOpened()
    n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    assert n == frames.shape[0]
    ok, img = cap.read()
    assert ok and img.shape == (64, 96, 3)
    cap.release()


def test_avi_mjpeg_pcm_roundtrip(tmp_path):
    frames = _frames()
    sr = 16000
    audio = np.sin(
        2 * np.pi * 440 * np.arange(int(10 / 25 * sr)) / sr
    ).astype(np.float32)
    path = str(tmp_path / "av.avi")
    write_avi_with_audio(frames, audio, path, fps=25.0, sample_rate=sr)

    # Video decodes via cv2.
    cap = cv2.VideoCapture(path)
    assert cap.isOpened()
    assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == frames.shape[0]
    ok, img = cap.read()
    assert ok
    # MJPEG is lossy; first frame must still be close.
    rgb = cv2.cvtColor(img, cv2.COLOR_BGR2RGB).astype(np.int32)
    assert np.abs(rgb - frames[0].astype(np.int32)).mean() < 8
    cap.release()

    # RIFF structure: audio chunks carry all PCM bytes.
    blob = open(path, "rb").read()
    assert blob[:4] == b"RIFF" and blob[8:12] == b"AVI "
    total_pcm = 0
    pos = blob.find(b"movi") + 4
    while pos + 8 <= len(blob):
        fourcc = blob[pos : pos + 4]
        (size,) = struct.unpack("<I", blob[pos + 4 : pos + 8])
        if fourcc == b"idx1":
            break
        if fourcc == b"01wb":
            total_pcm += size
        pos += 8 + size + (size % 2)
    assert total_pcm == int(round(10 / 25 * sr)) * 2


def test_mux_writes_all_containers(tmp_path):
    frames = _frames(t=5)
    audio = np.zeros(3200, np.float32)
    files = mux(frames, audio, str(tmp_path / "out"), fps=25.0)
    exts = {f.rsplit(".", 1)[-1] for f in files}
    assert "mp4" in exts and "wav" in exts
    assert "avi" in exts or any("_audio.mp4" in f for f in files)


def test_mux_no_audio(tmp_path):
    files = mux(_frames(t=3), None, str(tmp_path / "out"), fps=25.0)
    assert len(files) == 1 and files[0].endswith(".mp4")


def test_yuv420_roundtrip_matches_cv2():
    """Device RGB->YUV420 must invert through cv2's I420 conversion:
    exact-ish on flat colors, small on gradients (chroma subsampling)."""
    import jax.numpy as jnp

    from text2video.io.video import yuv420_to_bgr
    from text2video.ops.colorspace import rgb_norm_to_yuv420

    # Flat colors: error must be <= 1 gray level.
    for c in [(0, 0, 0), (255, 255, 255), (255, 0, 0), (37, 180, 99)]:
        rgb = np.tile(np.array(c, np.uint8), (1, 64, 64, 1))
        norm = jnp.asarray(rgb.astype(np.float32) / 127.5 - 1.0)
        y, u, v = rgb_norm_to_yuv420(norm)
        bgr = yuv420_to_bgr(np.asarray(y), np.asarray(u), np.asarray(v))
        err = np.abs(bgr[..., ::-1].astype(int) - rgb.astype(int)).max()
        assert err <= 1, (c, err)

    # Gradients: bounded by subsampling loss.
    frames = _frames(t=4, h=64, w=64)
    norm = jnp.asarray(frames.astype(np.float32) / 127.5 - 1.0)
    y, u, v = rgb_norm_to_yuv420(norm)
    assert y.shape == (4, 64, 64) and u.shape == (4, 32, 32)
    bgr = yuv420_to_bgr(np.asarray(y), np.asarray(u), np.asarray(v))
    err = np.abs(bgr[..., ::-1].astype(int) - frames.astype(int))
    # Hard 255->0 wrap edges bleed chroma (inherent to any 4:2:0 target,
    # including the mp4 the frames end up in) — bound the bulk, not max.
    assert err.mean() < 2 and np.percentile(err, 95) <= 6


def test_streaming_muxer_matches_batch_mux(tmp_path):
    """StreamingMuxer fed per-chunk YUV must produce the same set of
    containers as mux() with matching frame counts and close pixels."""
    import jax.numpy as jnp

    from text2video.io.video import StreamingMuxer
    from text2video.ops.colorspace import rgb_norm_to_yuv420

    frames = _frames(t=10, h=64, w=96)
    sr = 16000
    audio = np.sin(
        2 * np.pi * 220 * np.arange(int(10 / 25 * sr)) / sr
    ).astype(np.float32)

    m = StreamingMuxer(
        str(tmp_path / "s"), 96, 64, fps=25.0, sample_rate=sr, audio=audio
    )
    for lo in range(0, 10, 4):
        chunk = frames[lo : lo + 4]
        norm = jnp.asarray(chunk.astype(np.float32) / 127.5 - 1.0)
        y, u, v = rgb_norm_to_yuv420(norm)
        m.add_yuv(np.asarray(y), np.asarray(u), np.asarray(v))
    files = m.close()
    assert m.n_frames == 10
    exts = {f.rsplit(".", 1)[-1] for f in files}
    assert "mp4" in exts and "wav" in exts
    assert "avi" in exts or any("_audio.mp4" in f for f in files)

    playable = [f for f in files if f.endswith((".avi", "_audio.mp4"))][0]
    cap = cv2.VideoCapture(playable)
    assert cap.isOpened()
    assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == 10
    ok, img = cap.read()
    assert ok
    rgb = cv2.cvtColor(img, cv2.COLOR_BGR2RGB).astype(np.int32)
    assert np.abs(rgb - frames[0].astype(np.int32)).mean() < 8
    cap.release()
