"""Pose-synthesis stage: timestamps -> per-frame keypoint tracks (+ JSONs).

Replaces the reference's interp_landmarks_motion*.py scripts (reference:
interp_landmarks_motion_phoneme_VidTIMIT_smooth.py,
interp_landmarks_motion.py) with an in-memory stage: plan on host, blend and
smooth on device (or bit-exactly on host), and only materialize OpenPose
JSONs when asked to.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, List, Optional

import numpy as np

from text2video.config import PersonProfile
from text2video.frontend.timestamps import Timestamps
from text2video.io.dicts import KeypointTable, PoseDictionary
from text2video.io.openpose import dumps_keypoint_json, raw_with_tracks
from text2video.ops.interp import (
    PosePlan,
    plan_pose_track,
    synthesize_device,
    synthesize_host,
)
from text2video.ops.smooth import smooth_device_jit, smooth_host


@dataclasses.dataclass
class PoseResult:
    """Per-frame tracks for one utterance.

    face/pose: interpolated tracks [T,210]/[T,75].
    face_smooth/pose_smooth: after temporal smoothing + mouth re-pin.
    plan: gather plan (carrier/verbatim info for byte-faithful emission).
    """

    face: np.ndarray
    pose: np.ndarray
    face_smooth: np.ndarray
    pose_smooth: np.ndarray
    plan: PosePlan

    @property
    def num_frames(self) -> int:
        return self.face.shape[0]


class PoseStage:
    def __init__(
        self,
        profile: PersonProfile,
        pdict: Optional[PoseDictionary] = None,
        table: Optional[KeypointTable] = None,
    ):
        self.profile = profile
        self.pdict = pdict or PoseDictionary.load(
            profile.dict_path, profile.keypoint_layout
        )
        self.table = table or KeypointTable.load_dir(
            profile.keypoints_dir, profile.keypoint_layout
        )

    def run(
        self, ts: Timestamps, device: bool = True, mesh=None
    ) -> PoseResult:
        """device=True: float32 device path (the XLA gather +
        interpolation program, then the lax.scan recursive smoother).
        device=False: bit-exact float64 host path (matches reference JSON
        output byte-for-byte).

        mesh: shard the utterance's time axis over the mesh's "data" axis
        (SURVEY.md §2.5 sequence parallelism). Synthesis runs the
        bit-exact float64 host path (it is ~microseconds for 285 floats
        a frame), and the recursive smoother runs sharded in float64
        with a warm-up-replay carry (ops/smooth.py::
        smooth_recursive_sharded) — the mesh run's smoothed tracks, and
        therefore its pose JSONs, are BYTE-equal to the single-device
        host output (tests/test_smooth_sharded.py).
        """
        plan = plan_pose_track(ts, self.pdict, self.table, self.profile)
        if mesh is not None:
            from text2video.ops.smooth import smooth_recursive_sharded

            face, pose = synthesize_host(plan, self.table)
            n = mesh.shape["data"]
            t = face.shape[0]
            t_pad = n * ((t + n - 1) // n)
            fp = np.pad(face, ((0, t_pad - t), (0, 0)))
            pp = np.pad(pose, ((0, t_pad - t), (0, 0)))
            face_s, pose_s = smooth_recursive_sharded(
                fp, pp, mesh, self.profile.smooth_width, t_valid=t
            )
            return PoseResult(
                face=face,
                pose=pose,
                face_smooth=face_s[:t],
                pose_smooth=pose_s[:t],
                plan=plan,
            )
        if device:
            face, pose = synthesize_device(plan, self.table)
            face_s, pose_s = smooth_device_jit(
                face, pose, self.profile.smooth_width
            )
            face, pose, face_s, pose_s = (
                np.asarray(face, dtype=np.float64),
                np.asarray(pose, dtype=np.float64),
                np.asarray(face_s, dtype=np.float64),
                np.asarray(pose_s, dtype=np.float64),
            )
        else:
            face, pose = synthesize_host(plan, self.table)
            face_s, pose_s = smooth_host(face, pose, self.profile.smooth_width)
        return PoseResult(
            face=face, pose=pose, face_smooth=face_s, pose_smooth=pose_s,
            plan=plan,
        )

    # ---- JSON emission (parity with the reference's per-frame files) ----

    def emit_pose_raws(self, result: PoseResult) -> List[Dict[str, Any]]:
        """Interpolation-stage JSON dicts, frame by frame. Verbatim frames
        re-emit their carrier unchanged (ints stay ints); blended frames
        carry blended face/pose in the carrier's deep copy."""
        out = []
        plan = result.plan
        for t in range(result.num_frames):
            carrier = self.table.raws[int(plan.carrier[t])]
            if plan.verbatim[t]:
                out.append(carrier)
            else:
                out.append(
                    raw_with_tracks(
                        carrier, face=result.face[t], pose=result.pose[t]
                    )
                )
        return out

    def emit_smooth_raws(self, result: PoseResult) -> List[Dict[str, Any]]:
        """Smoothing-stage JSON dicts. The carrier is the interp-stage frame
        JSON; tracks are written as single-element nested lists, matching the
        reference's (1,N)-ndarray ``.tolist()`` output
        (...VidTIMIT_smooth.py:257-258)."""
        out = []
        for t, interp_raw in enumerate(self.emit_pose_raws(result)):
            out.append(
                raw_with_tracks(
                    interp_raw,
                    face=result.face_smooth[t],
                    pose=result.pose_smooth[t],
                    nested=True,
                )
            )
        return out

    def write_jsons(
        self, result: PoseResult, pose_dir: str, smooth_dir: Optional[str] = None
    ) -> None:
        os.makedirs(pose_dir, exist_ok=True)
        for t, raw in enumerate(self.emit_pose_raws(result)):
            with open(os.path.join(pose_dir, "%05d.json" % t), "w") as f:
                f.write(dumps_keypoint_json(raw))
        if smooth_dir is not None:
            os.makedirs(smooth_dir, exist_ok=True)
            for t, raw in enumerate(self.emit_smooth_raws(result)):
                with open(
                    os.path.join(smooth_dir, "smooth_%05d.json" % t), "w"
                ) as f:
                    f.write(dumps_keypoint_json(raw))
