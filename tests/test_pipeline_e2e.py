"""End-to-end pipeline tests on the committed fadg0 identity
(text2video/testing.py): FormantTTS audio, the packaged acoustic model,
skeleton or tiny random-weight renderers."""

import os

import numpy as np
import pytest


@pytest.fixture(scope="module")
def identity(tmp_path_factory):
    from text2video.testing import write_identity

    return write_identity(str(tmp_path_factory.mktemp("identity")))


@pytest.fixture(scope="module")
def aligner(identity):
    from text2video.testing import english_aligner

    return english_aligner(identity)


@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    """FormantTTS recordings of the test sentences, keyed by text."""
    from text2video.frontend.audio import ALIGN_SAMPLE_RATE, save_wav
    from text2video.frontend.tts import FormantTTS

    out = tmp_path_factory.mktemp("wavs")
    paths = {}
    for text in ("Do they make it", "She slipped and sprained her ankle"):
        path = str(out / (text.replace(" ", "_") + ".wav"))
        save_wav(path, FormantTTS().synthesize(text, ALIGN_SAMPLE_RATE),
                 ALIGN_SAMPLE_RATE)
        paths[text] = path
    return paths


@pytest.fixture(scope="module")
def dotheymake_ts(aligner, wavs):
    """Phone timestamps of "Do they make it" (the packaged model aligned
    against its FormantTTS recording)."""
    return aligner.align_file(wavs["Do they make it"], "Do they make it").phones


def test_run_audio_end_to_end(identity, aligner, wavs, tmp_path):
    from text2video.config import PipelineConfig, get_profile
    from text2video.pipeline import Text2VideoPipeline

    config = PipelineConfig(
        person=get_profile("fadg0", data_dir=identity),
        out_dir=str(tmp_path),
        emit_intermediates=True,
    )
    pipe = Text2VideoPipeline(config, aligner=aligner)
    run = pipe.run_audio(
        "Do they make it", wavs["Do they make it"], keep_arrays=True
    )
    assert run.num_frames > 10
    assert run.label_maps.shape[1:] == (384, 512, 3)
    # Skeleton passthrough: non-trivial drawing on the canvas.
    assert (run.label_maps > 0).mean() > 0.001
    for f in run.files:
        assert os.path.exists(f) and os.path.getsize(f) > 0
    exts = {f.rsplit(".", 1)[-1] for f in run.files}
    assert {"mp4", "wav"} <= exts

    inter = os.path.join(str(tmp_path), "fadg0", run.name + "_intermediates")
    assert os.path.isdir(os.path.join(inter, "pose_smooth"))
    assert os.path.exists(os.path.join(inter, "timestamps.txt"))
    assert os.path.exists(os.path.join(inter, "words.txt"))


def test_run_tts_formant_fallback(identity, aligner, tmp_path):
    from text2video.config import PipelineConfig, get_profile
    from text2video.pipeline import Text2VideoPipeline

    config = PipelineConfig(
        person=get_profile("fadg0", data_dir=identity), out_dir=str(tmp_path)
    )
    pipe = Text2VideoPipeline(config, aligner=aligner)
    run = pipe.run_tts("she had a suit", "f")
    assert run.num_frames > 5
    assert any(f.endswith(".mp4") for f in run.files)


def test_cli_train_and_audio(identity, wavs, tmp_path):
    from text2video.cli import main

    wav = wavs["Do they make it"]
    model_path = str(tmp_path / "aligner" / "fadg0.am")
    rc = main(
        [
            "train-aligner",
            "--out",
            model_path,
            "--data-dir",
            identity,
            wav,
            "Do they make it",
        ]
    )
    assert rc == 0 and os.path.exists(model_path)

    rc = main(
        [
            "audio",
            "Do they make it",
            "fadg0",
            "--out",
            str(tmp_path),
            "--data-dir",
            identity,
            "--aligner-model",
            model_path,
            "--wav",
            wav,
        ]
    )
    assert rc == 0
    out_dir = os.path.join(str(tmp_path), "fadg0")
    assert any(f.endswith(".mp4") for f in os.listdir(out_dir))


def test_run_audio_batch_sharded(identity, aligner, wavs, tmp_path):
    """Batched serving: two utterances rendered as one mesh-sharded batch
    must match the per-utterance path."""
    from text2video.config import PipelineConfig, get_profile
    from text2video.parallel.mesh import make_mesh
    from text2video.pipeline import Text2VideoPipeline

    config = PipelineConfig(
        person=get_profile("fadg0", data_dir=identity), out_dir=str(tmp_path)
    )
    pipe = Text2VideoPipeline(config, aligner=aligner)
    items = [
        ("Do they make it", wavs["Do they make it"]),
        ("She slipped and sprained her ankle",
         wavs["She slipped and sprained her ankle"]),
    ]
    mesh = make_mesh(n_data=2, n_model=1)
    results = pipe.run_audio_batch(items, mesh=mesh, keep_arrays=True)
    assert len(results) == 2
    assert results[0].name == "Dotheymake"
    assert results[0].num_frames != results[1].num_frames  # ragged batch
    for r in results:
        assert all(os.path.getsize(f) > 0 for f in r.files)
    # Skeleton passthrough: batch output equals the single-utterance path.
    single = pipe.run_audio(*items[0], keep_arrays=True)
    np.testing.assert_array_equal(
        results[0].label_maps, single.label_maps
    )


def test_load_size_renderer_rasterizes_at_target(
    identity, dotheymake_ts, tmp_path
):
    """With a load_size GAN (reference --loadSize 512 scaleHeight,
    text2video_audio.sh:42) the pipeline rasterizes scaled tracks at the
    GAN's working resolution — matching training labels — and the
    streamed video comes out at that resolution."""
    import cv2

    from text2video.config import (
        PipelineConfig,
        RenderConfig,
        get_profile,
    )
    from text2video.pipeline import Text2VideoPipeline
    from text2video.render import Renderer

    # fadg0 canvas 512x384, load_size 128 -> working res 192x128.
    renderer = Renderer.create(
        config=RenderConfig(load_size=128),
        height=128, width=192, base_ch=4, n_blocks=1,
    )
    pipe = Text2VideoPipeline(
        PipelineConfig(person=get_profile("fadg0", data_dir=identity),
                       out_dir=str(tmp_path)),
        renderer=renderer,
    )
    run = pipe.synthesize(
        dotheymake_ts, "t", audio=np.zeros(16000, np.float32)
    )
    mp4 = [f for f in run.files if f.endswith(".mp4")][0]
    cap = cv2.VideoCapture(mp4)
    assert int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)) == 192
    assert int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)) == 128
    assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == run.num_frames
    cap.release()


def test_jacobi_decode_pipeline(identity, dotheymake_ts, tmp_path):
    """decode_mode="jacobi" drives the full pipeline: the streaming wire
    + muxer path and the keep_arrays path both work, and the array path
    agrees with the exact scan at high sweep counts (convergence math in
    tests/test_render_jacobi.py).

    Equivalence is asserted on the pre-saturation PREFIX: the scan and
    Jacobi recurrences are algorithmically identical (manual emulations
    are bit-equal, tools/jacobi_bisect_probe.py), but two
    differently-compiled programs of the same generator differ per
    forward (~1e-6 relative in f32, up to ~0.07 in bf16 —
    tools/jacobi_bisect2.py) and a RANDOM-weight warp recurrence is
    chaotic: the difference grows ~3.5x/frame until it saturates
    (measured f32 frame maxes 0,0,1,1,1,1,1,3,13,39,91,... on this
    configuration: the committed identity's 40-frame "Do they make it").
    So the renderer runs in f32 (smallest seed noise) and the tight
    assertions cover the first 4 and 6 frames (measured 80.0 dB), with
    a loose full-clip floor that only catches gross breakage: 20.4 dB
    measured, most of the clip past saturation, so the floor is the
    random-weight worst case of test_jacobi_bf16_divergence_bounded.
    (The earlier 24 dB floor was measured on a shorter reference
    recording that is not in the repository.) Trained weights amplify
    far less (tools/jacobi_quality.py). test_jacobi_bf16_divergence_bounded
    bounds the production-dtype case."""
    import dataclasses

    import cv2

    import jax.numpy as jnp

    from text2video.config import (
        PipelineConfig,
        RenderConfig,
        get_profile,
    )
    from text2video.pipeline import Text2VideoPipeline
    from text2video.render import Renderer

    ts = dotheymake_ts

    renderer = Renderer.create(
        config=RenderConfig(
            load_size=128, decode_mode="jacobi", jacobi_sweeps=2
        ),
        height=128, width=192, base_ch=4, n_blocks=1,
        dtype=jnp.float32,
    )
    pipe = Text2VideoPipeline(
        PipelineConfig(person=get_profile("fadg0", data_dir=identity),
                       out_dir=str(tmp_path)),
        renderer=renderer,
    )
    # Streaming path (wire chunks encoded from Jacobi frames).
    run = pipe.synthesize(ts, "jac", audio=np.zeros(16000, np.float32))
    mp4 = [f for f in run.files if f.endswith(".mp4")][0]
    cap = cv2.VideoCapture(mp4)
    assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == run.num_frames
    assert int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)) == 192
    cap.release()

    # keep_arrays path; many sweeps ~= the exact sequential scan.
    pipe.renderer = dataclasses.replace(
        renderer,
        config=dataclasses.replace(
            renderer.config, jacobi_sweeps=renderer.time_bucket
        ),
    )
    run_j = pipe.synthesize(
        ts, "jac_arr", audio=np.zeros(16000, np.float32), keep_arrays=True
    )
    pipe.renderer = dataclasses.replace(
        renderer, config=dataclasses.replace(renderer.config,
                                             decode_mode="scan"),
    )
    run_s = pipe.synthesize(
        ts, "scan_arr", audio=np.zeros(16000, np.float32), keep_arrays=True
    )
    assert run_j.frames.shape == run_s.frames.shape

    def _psnr(a, b):
        mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
        return 10 * np.log10(255.0**2 / max(mse, 1e-12))

    diff = np.abs(run_j.frames.astype(int) - run_s.frames.astype(int))
    assert diff[:4].max() <= 3, diff[:4].max()  # measured 0
    p6 = _psnr(run_j.frames[:6], run_s.frames[:6])
    assert p6 >= 45.0, p6  # measured 80.0
    pfull = _psnr(run_j.frames, run_s.frames)
    assert pfull >= 18.0, pfull  # measured 20.4 (chaos-saturated tail)


def test_jacobi_bf16_divergence_bounded():
    """Production-dtype (bfloat16) scan vs Jacobi at full sweeps: the
    divergence is compile-level rounding amplified by the recurrence (see
    test_jacobi_decode_pipeline docstring). This pins the two
    structural guarantees that hold in that regime: the early prefix is
    uint8-tight (the amplification needs frames to compound), and the
    whole-clip error stays bounded even on worst-case random weights —
    trained weights amplify far less (tools/jacobi_quality.py)."""
    from text2video.config import RenderConfig
    from text2video.render import Renderer

    rng = np.random.RandomState(0)
    t = 18
    labels = rng.randint(0, 256, size=(t, 128, 192, 3), dtype=np.uint8)
    r = Renderer.create(
        config=RenderConfig(load_size=128),
        height=128, width=192, base_ch=4, n_blocks=1,
    )
    r.time_bucket = 32
    seq = r.render(labels)
    jac = r.render_jacobi(labels, sweeps=t)
    diff = np.abs(seq.astype(int) - jac.astype(int))
    # measured: frames 0-2 exact to 1 level (tools/jacobi_divergence_probe.py)
    assert diff[:3].max() <= 3, diff[:3].max()
    mse = np.mean((seq.astype(np.float64) - jac.astype(np.float64)) ** 2)
    psnr = 10 * np.log10(255.0**2 / max(mse, 1e-12))
    # measured 23.3 dB on this seed; bound loosely (random-weight worst case)
    assert psnr >= 18.0, psnr


def test_device_pose_matches_host(identity, dotheymake_ts):
    """The float32 XLA pose path (gather + blend + lax.scan smoother)
    matches the float64 host path to 1e-3 px on every track."""
    from text2video.config import get_profile
    from text2video.pose_stage import PoseStage

    stage = PoseStage(get_profile("fadg0", data_dir=identity))
    host = stage.run(dotheymake_ts, device=False)
    dev = stage.run(dotheymake_ts, device=True)
    assert dev.num_frames == host.num_frames > 10
    for a, b in [
        (dev.face, host.face),
        (dev.pose, host.pose),
        (dev.face_smooth, host.face_smooth),
        (dev.pose_smooth, host.pose_smooth),
    ]:
        assert np.max(np.abs(a - b)) <= 1e-3
