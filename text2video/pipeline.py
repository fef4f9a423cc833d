"""End-to-end pipeline: text or audio in, talking-head video out.

Replaces the reference's shell orchestration (reference:
text2video_tts.sh, text2video_audio.sh, text2video_tts_chinese.sh — bash
scripts gluing stages through the filesystem) with one in-memory typed
pipeline:

  text --(TTS | wav file)--> waveform
       --(forced alignment | pinyin timestamping)--> Timestamps
       --(PoseStage: dictionary gather + interpolation + smoothing)--> tracks
       --(rasterize_batch: batched XLA scatter-draw)--> label maps
       --(Renderer: autoregressive pose2frame GAN scan)--> frames
       --(mux)--> video files

Stages pass arrays; nothing is written to disk unless
``config.emit_intermediates`` asks for the reference-layout artifacts.
Without trained GAN weights the renderer defaults to skeleton passthrough
(the label maps become the video), which is the reference's
``--openpose_only`` debugging view and this framework's M1 slice.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional

import numpy as np

from text2video.config import PersonProfile, PipelineConfig
from text2video.frontend.align_english import EnglishAligner
from text2video.frontend.audio import (
    ALIGN_SAMPLE_RATE,
    load_wav_for_alignment,
)
from text2video.frontend.textnorm import derive_file_name
from text2video.frontend.timestamps import (
    Timestamps,
    format_timestamp_lines,
    format_word_lines,
)
from text2video.frontend.timestamp_zh import AsrBackend, timestamp_chinese
from text2video.frontend.tts import FormantTTS, TTSBackend
from text2video.io.video import StreamingMuxer, mux
from text2video.ops.rasterize import rasterize_batch
from text2video.pose_stage import PoseStage
from text2video.render import Renderer
from text2video.utils.logging import get_logger
from text2video.utils.profiling import StageTimer


@dataclasses.dataclass
class RunResult:
    name: str
    num_frames: int
    files: List[str]            # muxed outputs
    timestamps: Timestamps
    label_maps: Optional[np.ndarray] = None   # [T,H,W,3] uint8
    frames: Optional[np.ndarray] = None       # [T,H,W,3] uint8
    stage_seconds: Optional[dict] = None      # per-stage wall clock


def _scale_tracks(arr, sx: float, sy: float):
    """Scale the x/y columns of an (x, y, conf)-triple track array of
    any shape [..., 3k] (host or device array)."""
    shape = arr.shape
    flat = arr.reshape(shape[:-1] + (shape[-1] // 3, 3))
    flat = flat * np.asarray([sx, sy, 1.0], np.float32)
    return flat.reshape(shape)


def _default_mandarin_aligner(person: str = ""):
    """The packaged Mandarin acoustic model (speaker-dependent
    ``mandarin_<person>.am`` when shipped, else the joint model), or None
    if absent/unbuildable."""
    data = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
    for name in (f"mandarin_{person}.am", "mandarin.am"):
        path = os.path.join(data, name)
        if os.path.exists(path):
            try:
                from text2video.frontend.align_mandarin import (
                    MandarinAligner,
                )

                return MandarinAligner.load(path)
            except Exception:
                return None
    return None


class Text2VideoPipeline:
    def __init__(
        self,
        config: PipelineConfig,
        renderer: Optional[Renderer] = None,
        aligner: Optional[EnglishAligner] = None,
        tts: Optional[TTSBackend] = None,
        asr: Optional[AsrBackend] = None,
        mandarin_aligner=None,
        mesh=None,
    ):
        self.config = config
        self.profile: PersonProfile = config.person
        self.pose_stage = PoseStage(self.profile)
        self.renderer = renderer
        self.aligner = aligner
        self.tts = tts
        self.asr = asr
        # Optional jax Mesh: one utterance's *time* axis shards over the
        # mesh's "data" axis for pose smoothing (FIR halo exchange) and
        # rasterization (frame-parallel) — SURVEY.md §2.5 sequence
        # parallelism for utterances that span devices. The GAN stays
        # sequential over time by construction (autoregressive carry);
        # cross-utterance batching (run_audio_batch) is its scaling axis.
        self.mesh = mesh
        # frontend.align_mandarin.MandarinAligner: forced alignment for
        # the Chinese path (preferred over asr when both are given). A
        # packaged model (data/mandarin.am, trained on the reference's
        # per-person recordings) loads by default for zh profiles so the
        # real timing path is the default, not the energy fallback.
        if (
            mandarin_aligner is None
            and asr is None
            and self.profile.language == "zh"
        ):
            mandarin_aligner = _default_mandarin_aligner(self.profile.name)
        self.mandarin_aligner = mandarin_aligner

    # ---- shared tail: timestamps -> video --------------------------------

    def synthesize(
        self,
        ts: Timestamps,
        name: str,
        audio: Optional[np.ndarray] = None,
        sample_rate: int = ALIGN_SAMPLE_RATE,
        keep_arrays: bool = False,
    ) -> RunResult:
        cfg = self.config
        timer = StageTimer()
        with timer.stage("pose_synthesis"):
            result = self.pose_stage.run(
                ts,
                device=cfg.pose_device == "device",
                mesh=self.mesh,
            )

        # Tracks for rasterization: the smoothed pass when enabled
        # (reference feeds test_openpose/tmp_smooth to vid2vid,
        # text2video_tts.sh:34-45).
        face = result.face_smooth if cfg.smooth else result.face
        pose = result.pose_smooth if cfg.smooth else result.pose
        carrier = result.plan.carrier
        hands = self.pose_stage.table.hands[carrier]
        # With a GAN renderer, label chunks stay on device between the
        # rasterizer and the generator (no host round trip); the host
        # copy is only materialized when intermediates are requested.
        need_host_labels = (
            self.renderer is None or cfg.emit_intermediates or keep_arrays
        )
        t_frames = face.shape[0]
        out_dir = os.path.join(cfg.out_dir, self.profile.name)
        os.makedirs(out_dir, exist_ok=True)
        base = os.path.join(out_dir, name)

        labels = None
        frames = None
        if self.renderer is not None:
            # Rasterize directly at the GAN's working resolution: with a
            # load_size model (reference --loadSize 512 --resize_or_crop
            # scaleHeight), scaling the keypoint *tracks* and drawing at
            # target size matches how training labels are made
            # (train/data.py rasterizes scaled tracks at the training
            # canvas) — rasterizing at the person's canvas and resizing
            # the image would thin the skeleton lines, a train/test
            # label mismatch — and it shrinks the scatter-draw canvas.
            w_c, h_c = self.profile.canvas
            h2, w2 = self.renderer.target_hw(h_c, w_c)
            raster_canvas = (w2, h2)
            if raster_canvas != tuple(self.profile.canvas):
                sx, sy = w2 / w_c, h2 / h_c
                face = _scale_tracks(face, sx, sy)
                pose = _scale_tracks(pose, sx, sy)
                hands = _scale_tracks(hands, sx, sy)
            with timer.stage("rasterize"):
                chunks = rasterize_batch(
                    face,
                    pose,
                    hands[:, 0],
                    hands[:, 1],
                    raster_canvas,
                    chunk=self.renderer.time_bucket,
                    to_host=False,
                )
            if cfg.stream and not need_host_labels:
                # Streaming: frames leave the device as YUV420 chunks and
                # are muxed incrementally on a worker thread — transfer,
                # compute, and encode overlap, and link bytes halve.
                muxer = StreamingMuxer(
                    base, w2, h2, fps=self.profile.fps,
                    sample_rate=sample_rate, audio=audio,
                    wire_quality=self.renderer.config.wire_quality,
                )
                use_native = self.renderer.config.wire_format == "dct"
                with timer.stage("render"):
                    if use_native:
                        # Raw wire coefficients go straight to the
                        # muxer's native codec — the transfer loop
                        # never materializes pixel planes.
                        for coeffs, _ in self.renderer.render_stream_coeffs(
                            chunks, t_frames, timer=timer
                        ):
                            muxer.add_coeffs(*coeffs)
                    else:
                        for y, u, v in self.renderer.render_stream_yuv(
                            chunks, t_frames, timer=timer
                        ):
                            muxer.add_yuv(y, u, v)
                with timer.stage("mux"):
                    files = muxer.close()
                t_frames = muxer.n_frames
            else:
                with timer.stage("render"):
                    frames = self.renderer.render_from_device_chunks(
                        chunks, t_frames
                    )
                if need_host_labels:
                    labels = np.concatenate(
                        [np.asarray(c) for c in chunks], axis=0
                    )[:t_frames]
        else:
            with timer.stage("rasterize"):
                if self.mesh is not None:
                    from text2video.ops.rasterize import (
                        rasterize_batch_sharded,
                    )

                    labels = rasterize_batch_sharded(
                        face, pose, hands[:, 0], hands[:, 1],
                        self.profile.canvas, self.mesh,
                    )
                else:
                    labels = rasterize_batch(
                        face,
                        pose,
                        hands[:, 0],
                        hands[:, 1],
                        self.profile.canvas,
                        chunk=cfg.frame_chunk,
                    )
            frames = labels  # skeleton passthrough (no trained GAN)

        if frames is not None:
            with timer.stage("mux"):
                files = mux(
                    frames, audio, base, fps=self.profile.fps,
                    sample_rate=sample_rate,
                )
            t_frames = frames.shape[0]

        if cfg.emit_intermediates:
            self._emit_intermediates(out_dir, name, result, labels, ts)

        stage_seconds = timer.totals()
        get_logger().log(
            "pipeline_run",
            person=self.profile.name,
            name=name,
            frames=int(t_frames),
            **{f"s_{k}": round(v, 4) for k, v in stage_seconds.items()},
        )
        return RunResult(
            name=name,
            num_frames=t_frames,
            files=files,
            timestamps=ts,
            label_maps=labels if keep_arrays else None,
            frames=frames if keep_arrays else None,
            stage_seconds=stage_seconds,
        )

    def _emit_intermediates(self, out_dir, name, pose_result, labels, ts):
        import cv2  # noqa: PLC0415

        inter = os.path.join(out_dir, name + "_intermediates")
        self.pose_stage.write_jsons(
            pose_result,
            os.path.join(inter, "pose"),
            os.path.join(inter, "pose_smooth"),
        )
        img_dir = os.path.join(inter, "labels")
        os.makedirs(img_dir, exist_ok=True)
        for t in range(labels.shape[0]):
            cv2.imwrite(
                os.path.join(img_dir, "%05d.jpg" % t),
                cv2.cvtColor(labels[t], cv2.COLOR_RGB2BGR),
            )
        with open(os.path.join(inter, "timestamps.txt"), "w") as f:
            f.write(format_timestamp_lines(ts))

    # ---- entry points mirroring the three shell scripts -------------------

    def run_audio(
        self, text: str, wav_path: str, keep_arrays: bool = False
    ) -> RunResult:
        """English, real recorded audio (reference: text2video_audio.sh)."""
        if self.aligner is None:
            raise RuntimeError(
                "run_audio needs an EnglishAligner (train one with "
                "train_acoustic_model or pass model/dict paths to the CLI)"
            )
        samples = load_wav_for_alignment(wav_path)
        res = self.aligner.align(samples, text)
        name = derive_file_name(text)
        run = self.synthesize(
            res.phones, name, audio=samples, keep_arrays=keep_arrays
        )
        if self.config.emit_intermediates:
            out_dir = os.path.join(self.config.out_dir, self.profile.name)
            inter = os.path.join(out_dir, name + "_intermediates")
            os.makedirs(inter, exist_ok=True)
            with open(os.path.join(inter, "words.txt"), "w") as f:
                f.write(format_word_lines(res.words))
        return run

    def run_tts(
        self, text: str, sex: str = "f", keep_arrays: bool = False
    ) -> RunResult:
        """English, synthesized audio (reference: text2video_tts.sh)."""
        tts = self.tts or FormantTTS()
        samples = tts.synthesize(text, ALIGN_SAMPLE_RATE)
        if self.aligner is None:
            raise RuntimeError("run_tts needs an EnglishAligner")
        res = self.aligner.align(samples, text)
        return self.synthesize(
            res.phones,
            derive_file_name(text),
            audio=samples,
            keep_arrays=keep_arrays,
        )

    def run_audio_batch(
        self,
        items,
        mesh=None,
        keep_arrays: bool = False,
    ):
        """Batched serving: many (text, wav_path) pairs rendered as ONE
        sharded GAN batch (BASELINE config: "multi-utterance batch sharded
        over the mesh"). Alignment/pose/rasterization run per utterance
        (cheap, host+device); the expensive autoregressive GAN pass pads
        all utterances to a common length and scans them together, the
        batch axis sharded over the mesh's "data" axis.

        Returns a list of RunResult in input order.
        """
        import jax.numpy as jnp  # noqa: PLC0415
        import numpy as np  # noqa: PLC0415

        if self.aligner is None:
            raise RuntimeError("run_audio_batch needs an EnglishAligner")
        cfg = self.config
        timer = StageTimer()
        on_device = self.renderer is not None
        prepped = []
        for text, wav_path in items:
            with timer.stage("frontend"):
                samples = load_wav_for_alignment(wav_path)
                res = self.aligner.align(samples, text)
                pose_res = self.pose_stage.run(
                    res.phones, device=cfg.pose_device == "device"
                )
            face = pose_res.face_smooth if cfg.smooth else pose_res.face
            pose = pose_res.pose_smooth if cfg.smooth else pose_res.pose
            hands = self.pose_stage.table.hands[pose_res.plan.carrier]
            raster_canvas = tuple(self.profile.canvas)
            if on_device:
                # Rasterize at the GAN's working resolution from scaled
                # tracks (matches training labels; see synthesize()).
                w_c, h_c = self.profile.canvas
                h2, w2 = self.renderer.target_hw(h_c, w_c)
                if (w2, h2) != raster_canvas:
                    raster_canvas = (w2, h2)
                    sx, sy = w2 / w_c, h2 / h_c
                    face = _scale_tracks(face, sx, sy)
                    pose = _scale_tracks(pose, sx, sy)
                    hands = _scale_tracks(hands, sx, sy)
            with timer.stage("rasterize"):
                # With a renderer, labels stay on device: chunks concat +
                # pad + stack as device ops, so the batch path adds no
                # host round trip over the single-utterance path.
                labels = rasterize_batch(
                    face, pose, hands[:, 0], hands[:, 1],
                    raster_canvas, chunk=cfg.frame_chunk,
                    to_host=not on_device,
                )
                if on_device:
                    labels = jnp.concatenate(labels, axis=0)[: face.shape[0]]
            prepped.append((text, samples, res.phones, labels))

        t_max = max(p[3].shape[0] for p in prepped)
        with timer.stage("batch_pad"):
            if on_device:
                batch = jnp.stack(
                    [
                        jnp.pad(
                            lab,
                            ((0, t_max - lab.shape[0]), (0, 0), (0, 0), (0, 0)),
                        )
                        for *_, lab in prepped
                    ]
                )
            else:
                h, w = prepped[0][3].shape[1:3]
                batch = np.zeros((len(prepped), t_max, h, w, 3), np.uint8)
                for i, (_, _, _, labels) in enumerate(prepped):
                    batch[i, : labels.shape[0]] = labels

        with timer.stage("render"):
            if self.renderer is not None:
                frames_b = self.renderer.render_many_device(batch, mesh=mesh)
            else:
                frames_b = batch

        out_dir = os.path.join(cfg.out_dir, self.profile.name)
        os.makedirs(out_dir, exist_ok=True)
        results = []
        for i, (text, samples, ts, labels) in enumerate(prepped):
            name = derive_file_name(text)
            t = labels.shape[0]
            frames = frames_b[i, :t]
            with timer.stage("mux"):
                files = mux(
                    frames, samples, os.path.join(out_dir, name),
                    fps=self.profile.fps, sample_rate=ALIGN_SAMPLE_RATE,
                )
            results.append(
                RunResult(
                    name=name,
                    num_frames=t,
                    files=files,
                    timestamps=ts,
                    label_maps=np.asarray(labels) if keep_arrays else None,
                    frames=frames if keep_arrays else None,
                )
            )
        stage_seconds = timer.totals()
        for r in results:
            r.stage_seconds = stage_seconds
        return results

    def run_tts_chinese(
        self, text: str, sex: str = "f", keep_arrays: bool = False
    ) -> RunResult:
        """Mandarin (reference: text2video_tts_chinese.sh)."""
        tts = self.tts or FormantTTS()
        samples = tts.synthesize(text, ALIGN_SAMPLE_RATE)
        ts = timestamp_chinese(
            text,
            samples,
            ALIGN_SAMPLE_RATE,
            asr=self.asr,
            fps=self.profile.timestamp_fps,
            aligner=self.mandarin_aligner,
        )
        return self.synthesize(
            ts,
            derive_file_name(text, strip_spaces=True),
            audio=samples,
            keep_arrays=keep_arrays,
        )
