"""Training data pipeline: (keypoints, real frames) -> clip batches.

The reference trains its GAN on vid2vid's pose dataset layout —
``datasets/{person}/train_openpose`` label images + ``train_img`` real
frames, sampled as 12-frame clips (reference: README.md:169-177,
``--n_frames_total 12 --max_t_step 4``). Here the dataset is built
directly from a person's keypoint JSONs + real frame images (e.g. the
VidTIMIT assets at *phoneme_data/VidTIMIT/{person}/): label maps are
rasterized on device by ops/rasterize.py (no label images on disk), clips
are sampled per source clip with a random temporal stride, and batches
are normalized [-1, 1] NHWC arrays ready for the sharded train step.
"""

from __future__ import annotations

import dataclasses
import glob
import os
import re
from typing import Dict, List, Optional, Tuple

import cv2
import numpy as np

from text2video.io.openpose import load_keypoint_frame
from text2video.ops.rasterize import rasterize_batch

_STEM_RE = re.compile(r"^(?P<clip>.+?)_(?P<frame>\d+)$")


def _mouth_centers(face: np.ndarray) -> np.ndarray:
    """[T, 210] face tracks -> [T, 2] mouth centres (points 48-59 mean,
    the reference's mouth_center convention,
    interp_landmarks_motion.py:91-94)."""
    pts = face.reshape(-1, 70, 3)
    return pts[:, 48:60, :2].mean(axis=1)


@dataclasses.dataclass
class _Frame:
    stem: str
    image_path: str
    keypoint_path: str


def _split_runs(clips, clip_len: int, fraction: float):
    """Deterministic (train, holdout) partition of contiguous runs.

    Multi-run datasets hold out whole runs from the end of the run order
    (never splitting a run, so held-out frames share no clip with
    training); a single-run dataset reserves its final ``fraction`` tail
    (>= clip_len frames so the holdout is renderable)."""
    total = sum(len(c) for c in clips)
    target = max(int(round(total * fraction)), clip_len)
    if len(clips) > 1:
        held, k = 0, len(clips)
        while k > 1 and held < target:
            k -= 1
            held += len(clips[k])
        return clips[:k], clips[k:]
    run = clips[0]
    n_train = len(run) - target
    if n_train < clip_len:
        raise ValueError(
            f"run of {len(run)} frames too short to hold out {target} "
            f"and keep a >= {clip_len}-frame training span"
        )
    return [run[:n_train]], [run[n_train:]]


class PoseClipDataset:
    """Clip sampler over paired (keypoint JSON, real frame) files."""

    def __init__(
        self,
        images_dir: str,
        keypoints_dir: str,
        canvas: Tuple[int, int] = (512, 384),
        source_canvas: Optional[Tuple[int, int]] = None,
        clip_len: int = 12,
        max_t_step: int = 4,
        cache_labels: bool = True,
        max_frames: Optional[int] = None,
        split: str = "all",
        holdout_fraction: float = 0.1,
    ):
        """canvas: training resolution (w, h). source_canvas: resolution
        the keypoints were annotated at (defaults to canvas); keypoint
        coordinates are scaled canvas/source so low-res training works.
        max_frames caps the total paired frames used (runs truncated in
        order, temporal contiguity preserved) — device-resident training
        needs the dataset to fit device memory (12.7k 896x512 frames
        are 17.5 GB).

        split selects a deterministic train/holdout partition for honest
        evaluation (the reference has none — its only metric is a user
        study, SURVEY.md §6): "train" drops the held-out frames, "holdout"
        keeps only them, "all" disables the split. With several source
        clips, whole clips are held out from the end of the sorted-name
        order until >= holdout_fraction of total frames are reserved;
        with a single contiguous recording (the Chinese flat layout) the
        final holdout_fraction tail of the run is reserved. Both trainers
        and evaluators constructing the dataset with the same arguments
        see the same partition."""
        self.canvas = canvas
        self.source_canvas = source_canvas or canvas
        self.clip_len = clip_len
        self.max_t_step = max_t_step

        images = {}
        for p in glob.glob(os.path.join(images_dir, "*")):
            stem = os.path.splitext(os.path.basename(p))[0]
            images[stem] = p
        frames: List[_Frame] = []
        for p in sorted(
            glob.glob(os.path.join(keypoints_dir, "*_keypoints.json"))
        ):
            stem = os.path.basename(p)[: -len("_keypoints.json")]
            if stem in images:
                frames.append(_Frame(stem, images[stem], p))
        if not frames:
            raise FileNotFoundError(
                f"no paired frames between {images_dir} and {keypoints_dir}"
            )

        # Group into contiguous runs per clip (clips are "<clip>_<frame>").
        runs: Dict[str, List[_Frame]] = {}
        for f in frames:
            m = _STEM_RE.match(f.stem)
            clip = m.group("clip") if m else "all"
            runs.setdefault(clip, []).append(f)
        # Order run members by the *integer* frame index — lexicographic
        # stem order scrambles non-zero-padded numbering (clip_2 after
        # clip_10), corrupting temporal supervision.
        def frame_key(f: _Frame):
            m = _STEM_RE.match(f.stem)
            return (int(m.group("frame")), f.stem) if m else (0, f.stem)

        self.clips = [
            sorted(v, key=frame_key)
            for v in runs.values()
            if len(v) >= clip_len
        ]
        if split not in ("all", "train", "holdout"):
            raise ValueError(f"unknown split {split!r}")
        if split != "all" and self.clips:
            train_clips, holdout_clips = _split_runs(
                self.clips, clip_len, holdout_fraction
            )
            self.clips = train_clips if split == "train" else holdout_clips
            if not self.clips:
                raise ValueError(
                    f"{split!r} split is empty (holdout_fraction="
                    f"{holdout_fraction}, clip_len={clip_len})"
                )
        if max_frames is not None:
            budget = max_frames
            capped: List[List[_Frame]] = []
            for clip in self.clips:
                if budget < clip_len:
                    break
                take = min(len(clip), budget)
                capped.append(clip[:take])
                budget -= take
            self.clips = capped
        if not self.clips:
            raise ValueError(
                f"no clip has >= {clip_len} paired frames"
            )
        self.num_frames = sum(len(c) for c in self.clips)

        # Preload keypoint tracks (tiny) per clip, scaled to `canvas`.
        sx = canvas[0] / self.source_canvas[0]
        sy = canvas[1] / self.source_canvas[1]

        def scale(track: np.ndarray) -> np.ndarray:
            t = track.reshape(track.shape[0], -1, 3)
            t[..., 0] *= sx
            t[..., 1] *= sy
            return t.reshape(track.shape)

        self._tracks = []
        for clip in self.clips:
            face = np.zeros((len(clip), 210), np.float32)
            pose = np.zeros((len(clip), 75), np.float32)
            hands = np.zeros((len(clip), 2, 63), np.float32)
            for i, f in enumerate(clip):
                kf = load_keypoint_frame(f.keypoint_path)
                face[i] = kf.face
                pose[i] = kf.pose
                hands[i, 0] = kf.hand_l
                hands[i, 1] = kf.hand_r
            self._tracks.append(
                (scale(face), scale(pose),
                 scale(hands.reshape(len(clip), -1)).reshape(hands.shape))
            )

        self._label_cache: Optional[List[np.ndarray]] = None
        if cache_labels:
            self._label_cache = [
                rasterize_batch(
                    f, p, h[:, 0], h[:, 1], self.canvas, chunk=64
                )
                for f, p, h in self._tracks
            ]
        self._image_cache: Dict[str, np.ndarray] = {}

    # ------------------------------------------------------------------

    def _load_image(self, path: str) -> np.ndarray:
        img = self._image_cache.get(path)
        if img is None:
            bgr = cv2.imread(path)
            if bgr is None:
                raise FileNotFoundError(path)
            w, h = self.canvas
            if bgr.shape[:2] != (h, w):
                bgr = cv2.resize(bgr, (w, h), interpolation=cv2.INTER_AREA)
            img = cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)
            self._image_cache[path] = img
        return img

    @staticmethod
    def reference_flow(reals: np.ndarray) -> np.ndarray:
        """[T,H,W,3] uint8 frames -> [T-1,H,W,2] float32 backward flow
        (Farneback; flow[t] maps frame t+1's pixels into frame t, the
        convention ops/warp.flow_warp samples with). Plays the role of
        vid2vid's FlowNet2 ground-truth flow."""
        t = reals.shape[0]
        grays = [
            cv2.cvtColor(reals[i], cv2.COLOR_RGB2GRAY) for i in range(t)
        ]
        flows = np.empty(
            (t - 1,) + reals.shape[1:3] + (2,), np.float32
        )
        for i in range(t - 1):
            # (cur, prev) order: the field lives on frame i+1's grid and
            # points back into frame i.
            flows[i] = cv2.calcOpticalFlowFarneback(
                grays[i + 1], grays[i], None,
                0.5, 3, 15, 3, 5, 1.2, 0,
            )
        return flows

    def sample_clip(self, rng: np.random.RandomState):
        """-> (labels [T,H,W,3] u8, reals [T,H,W,3] u8, centers [T,2])."""
        ci = rng.randint(len(self.clips))
        clip = self.clips[ci]
        face, pose, hands = self._tracks[ci]
        max_stride = min(
            self.max_t_step, max((len(clip) - 1) // (self.clip_len - 1), 1)
        )
        stride = rng.randint(1, max_stride + 1)
        span = (self.clip_len - 1) * stride + 1
        start = rng.randint(0, len(clip) - span + 1)
        idx = np.arange(start, start + span, stride)

        if self._label_cache is not None:
            labels = self._label_cache[ci][idx]
        else:
            labels = rasterize_batch(
                face[idx], pose[idx], hands[idx, 0], hands[idx, 1],
                self.canvas, chunk=len(idx),
            )
        reals = np.stack([self._load_image(clip[i].image_path) for i in idx])
        centers = _mouth_centers(face[idx])
        return labels, reals, centers

    # ---- device-resident mode helpers ---------------------------------

    def flat_reals_centers(self):
        """(reals_u8 [N,H,W,3], centers [N,2]) + clip offsets for
        index-based sampling."""
        reals = np.concatenate(
            [
                np.stack([self._load_image(f.image_path) for f in clip])
                for clip in self.clips
            ]
        )
        centers = np.concatenate(
            [_mouth_centers(face) for face, _, _ in self._tracks]
        ).astype(np.float32)
        self._clip_offsets = np.cumsum(
            [0] + [len(c) for c in self.clips]
        )
        return reals, centers

    def flat_arrays(self):
        """Whole dataset as flat arrays for device residency:
        (labels_u8 [N,H,W,3], reals_u8 [N,H,W,3], centers [N,2])."""
        if self._label_cache is None:
            self._label_cache = [
                rasterize_batch(
                    f, p, h[:, 0], h[:, 1], self.canvas, chunk=64
                )
                for f, p, h in self._tracks
            ]
        labels = np.concatenate(self._label_cache, axis=0)
        reals, centers = self.flat_reals_centers()
        return labels, reals, centers

    def flat_track_arrays(self):
        """Whole dataset as flat *keypoint* arrays for on-device per-step
        rasterization (augmented training):
        (face [N,210], pose [N,75], hand_l [N,63], hand_r [N,63])."""
        face = np.concatenate([f for f, _, _ in self._tracks])
        pose = np.concatenate([p for _, p, _ in self._tracks])
        hands = np.concatenate([h for _, _, h in self._tracks])
        return (
            face.astype(np.float32),
            pose.astype(np.float32),
            hands[:, 0].astype(np.float32),
            hands[:, 1].astype(np.float32),
        )

    def sample_clip_indices(self, rng: np.random.RandomState) -> np.ndarray:
        """[clip_len] flat frame indices of one sampled clip (contiguous
        run with random stride, same scheme as sample_clip)."""
        ci = rng.randint(len(self.clips))
        n = len(self.clips[ci])
        max_stride = min(
            self.max_t_step, max((n - 1) // (self.clip_len - 1), 1)
        )
        stride = rng.randint(1, max_stride + 1)
        span = (self.clip_len - 1) * stride + 1
        start = rng.randint(0, n - span + 1)
        return self._clip_offsets[ci] + np.arange(
            start, start + span, stride, dtype=np.int32
        )

    def batch(
        self,
        rng: np.random.RandomState,
        batch_size: int,
        with_flow: bool = False,
    ) -> Dict:
        labels, reals, centers = zip(
            *[self.sample_clip(rng) for _ in range(batch_size)]
        )
        to_f = lambda x: np.stack(x).astype(np.float32) / 127.5 - 1.0
        out = {
            "labels": to_f(labels),
            "reals": to_f(reals),
            "face_centers": np.stack(centers).astype(np.float32),
        }
        if with_flow:
            out["flow_gt"] = np.stack(
                [self.reference_flow(r) for r in reals]
            )
        return out
