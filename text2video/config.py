"""Typed configuration for the pipeline.

The reference keys all behavior off ``sys.argv`` positional args plus
hardcoded per-person branches (reference: tts_request.py:29-41,
interp_landmarks_motion.py:55-68, align_english.py:34). Here a single
:class:`PersonProfile` captures everything that varied per person, and
:class:`PipelineConfig` everything that varied per entry point.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

# Asset root laid out like the reference repo's data folders (key-pose
# dictionaries, keypoints, pronouncing dictionary), when no data_dir is
# passed. ``text2video.testing.write_identity`` writes a runnable fadg0
# root from files committed in this repository.
DATA_DIR = os.environ.get("T2V_DATA_DIR")


def data_root(data_dir: Optional[str] = None) -> str:
    """``data_dir``, else $T2V_DATA_DIR; raises when neither is set."""
    root = data_dir or DATA_DIR
    if not root:
        raise ValueError(
            "no asset root: pass data_dir (CLI: --data-dir) or set "
            "T2V_DATA_DIR (text2video.testing.write_identity writes one)"
        )
    return root


@dataclasses.dataclass(frozen=True)
class PersonProfile:
    """Everything the pipeline needs to know about one target identity."""

    name: str
    language: str  # "en" (phoneme dictionary) | "zh" (pinyin dictionary)

    # Canvas the key poses were captured on, (width, height).
    # reference: interp_landmarks_motion_phoneme_VidTIMIT_smooth.py:78-79
    # (fadg0 512x384); interp_landmarks_motion.py:63-68 (xuesong 1280x720,
    # henan 1920x1080).
    canvas: Tuple[int, int]

    # Dictionary file. English format: "PHONEME clip frame" 3-column
    # (reference: *phoneme_data/VidTIMIT/fadg0.txt); Chinese format:
    # "pinyin frame" 2-column (reference: dict_henan.txt).
    dict_path: str
    # Directory of OpenPose keypoint JSONs for the key-pose recording.
    keypoints_dir: str
    # "clip": files are f"{clip}_{frame:03d}_keypoints.json" (English);
    # "flat": files are f"{frame:05d}_keypoints.json" (Chinese).
    keypoint_layout: str

    # Output/alignment frame rates. reference: align_english.py:34 (25 fps
    # English), pinyin_timestamping.py:24 (30 fps Chinese timestamping).
    fps: float = 25.0
    timestamp_fps: float = 30.0

    # Pose-synthesis constants (reference: ...VidTIMIT_smooth.py:70-75 and
    # interp_landmarks_motion.py:56-61).
    motion_width: int = 3
    transition_width: int = 5
    min_key_dist: int = 4
    # English path requires gap >= min_key_dist (...VidTIMIT_smooth.py:127);
    # Chinese path requires gap > min_key_dist (interp_landmarks_motion.py:154)
    # with min_key_dist=3 — the same effective threshold expressed two ways.
    key_gap_inclusive: bool = True
    smooth_width: int = 4

    # TTS voice id, mirroring the per-person/gender table at
    # tts_request.py:29-41.
    voice_female: str = "4100"
    voice_male: str = "4106"

    def voice(self, sex: str) -> str:
        return self.voice_female if sex == "f" else self.voice_male


def _profiles(data_dir: str):
    return {
        "fadg0": PersonProfile(
            name="fadg0",
            language="en",
            canvas=(512, 384),
            dict_path=os.path.join(data_dir, "*phoneme_data/VidTIMIT/fadg0.txt"),
            keypoints_dir=os.path.join(
                data_dir, "*phoneme_data/VidTIMIT/fadg0/keypoints_fadg0"
            ),
            keypoint_layout="clip",
            fps=25.0,
        ),
        "henan": PersonProfile(
            name="henan",
            language="zh",
            canvas=(1920, 1080),
            dict_path=os.path.join(data_dir, "dict_henan.txt"),
            keypoints_dir=os.path.join(data_dir, "*pinyin_data/henan/keypoints_henan"),
            keypoint_layout="flat",
            fps=25.0,
            min_key_dist=3,
            key_gap_inclusive=False,
            voice_female="100",
            voice_male="100",
        ),
        "xuesong": PersonProfile(
            name="xuesong",
            language="zh",
            canvas=(1280, 720),
            dict_path=os.path.join(data_dir, "dict_xuesong.txt"),
            keypoints_dir=os.path.join(
                data_dir, "*pinyin_data/xuesong/keypoints_xuesong"
            ),
            keypoint_layout="flat",
            fps=25.0,
            min_key_dist=3,
            key_gap_inclusive=False,
            voice_female="3",
            voice_male="3",
        ),
    }


def get_profile(name: str, data_dir: Optional[str] = None) -> PersonProfile:
    """Look up a built-in person profile (fadg0 / henan / xuesong)."""
    profiles = _profiles(data_root(data_dir))
    if name not in profiles:
        raise KeyError(
            f"unknown person {name!r}; known: {sorted(profiles)}. "
            "Construct a PersonProfile directly for a new identity."
        )
    return profiles[name]


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """pose2frame GAN inference settings.

    Mirrors the reference vid2vid test invocation
    (text2video_audio.sh:42): --loadSize 512 --how_many 1200
    --no_first_img --dataset_mode pose --input_nc 3.
    """

    # Resize label maps so height == load_size before the GAN (the
    # reference's --resize_or_crop scaleHeight --loadSize 512,
    # text2video_audio.sh:42). None = render at the canvas resolution
    # (matches a canvas-native trained model, e.g. fadg0 at 512x384).
    load_size: Optional[int] = None
    max_frames: int = 1200
    n_frames_ctx: int = 3  # generator conditions on this many label maps
    use_prev_frames: int = 2  # autoregressive context frames
    checkpoint_dir: Optional[str] = None
    dtype: str = "bfloat16"
    # Decoding strategy for the autoregressive chain (render.py):
    # "scan" runs the exact sequential lax.scan; "jacobi" runs
    # ``jacobi_sweeps`` batched whole-timeline sweeps instead — the
    # frame axis rides the generator's batch axis (wide batches,
    # shardable over a mesh), trading sweeps x FLOPs and an
    # approximation (frames converge to the scan's fixed point as
    # sweeps grow) for throughput. Quality at small k on trained
    # weights: tools/jacobi_quality.py.
    decode_mode: str = "scan"
    jacobi_sweeps: int = 3
    # Wire format for streaming frames off device (render_stream_yuv):
    # "dct" sends zigzag-truncated quantized 8x8-DCT coefficients (~4x
    # fewer bytes than "yuv420"; ops/dct.py), "yuv420" sends raw uint8
    # planes. "dct" also hands the muxer JPEG-ready coefficients (the
    # native codec entropy-codes them; io/wire_native.py); quality is
    # JPEG-style (wire roundtrip PSNR bounds in tests/test_wire_codec.py).
    # Whether it beats raw planes end to end on a local GPU is not yet
    # measured.
    wire_format: str = "dct"
    # Defaults picked by sweeping roundtrip PSNR on the committed GAN
    # clips (tools/wire_quality_probe.py): 12/6 @ quality 75 is 43-49 dB
    # on the worst (sharp synthetic-avatar) content and >46 dB photoreal
    # at 62.5% of the k=20/8 @ 80 wire bytes.
    wire_quality: int = 75
    wire_k_luma: int = 12
    wire_k_chroma: int = 6
    # Bit-pack the dct wire with a per-block 2-bit AC shift (ops/dct.py
    # ::pack_plane_shift): 67% of the int8 wire bytes at -0.5 dB on the
    # sharpest committed clip (measured in the ops/dct.py packing
    # docstring); disable to ship raw int8 coefficients.
    wire_packed: bool = True


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Run-level configuration for one text->video invocation."""

    person: PersonProfile
    out_dir: str = "./output"
    emit_intermediates: bool = False  # write pose JSONs / skeleton JPEGs
    smooth: bool = True  # temporal smoothing + mouth re-pin pass
    render: RenderConfig = dataclasses.field(default_factory=RenderConfig)
    # Device batch size for rasterization / GAN inference frame chunks.
    frame_chunk: int = 64
    # Stream frames off device as wire chunks muxed incrementally on a
    # worker thread (overlaps transfer and encode with compute).
    # Falls back to the materialized-RGB path when intermediates or
    # arrays are requested.
    stream: bool = True
    # Where the pose stage (gather/blend/smooth over ~200 KB of keypoint
    # tracks) runs: "host" is the bit-exact float64 path; "device" the
    # float32 XLA gather + lax.scan smoother. The work is small and
    # scalar-sequential, and the tracks come back to the host for
    # rasterization scaling either way. A mesh on the pipeline always
    # uses the sharded path (time-axis parallelism).
    pose_device: str = "host"
