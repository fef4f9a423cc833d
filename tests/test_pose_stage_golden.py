"""Golden parity tests for the pose-synthesis stage.

The goldens under tests/goldens/ were produced by executing the unmodified
reference stage (tools/make_goldens.py). The host path must match
byte-for-byte; the device (float32) path must match within sub-pixel error.
"""

import json
import os

import numpy as np
import pytest

from tests.conftest import REFERENCE_DIR, requires_reference_data
from text2video.config import get_profile
from text2video.frontend.timestamps import load_timestamp_file
from text2video.io.openpose import dumps_keypoint_json
from text2video.pose_stage import PoseStage

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "fadg0_Shehadyour")
TS_FILE = f"{REFERENCE_DIR}/input_timestamp/fadg0/phones/Shehadyour.txt"


@pytest.fixture(scope="module")
def stage():
    return PoseStage(get_profile("fadg0"))


@pytest.fixture(scope="module")
def ts():
    return load_timestamp_file(TS_FILE)


@pytest.fixture(scope="module")
def host_result(stage, ts):
    return stage.run(ts, device=False)


@requires_reference_data
def test_frame_count_matches_golden(host_result):
    n_golden = len(os.listdir(os.path.join(GOLDEN, "pose")))
    assert host_result.num_frames == n_golden == 87


@requires_reference_data
def test_interp_jsons_bit_exact(stage, host_result):
    raws = stage.emit_pose_raws(host_result)
    for t, raw in enumerate(raws):
        path = os.path.join(GOLDEN, "pose", "%05d.json" % t)
        with open(path) as f:
            golden_text = f.read()
        assert dumps_keypoint_json(raw) == golden_text, f"frame {t} differs"


@requires_reference_data
def test_smooth_jsons_bit_exact(stage, host_result):
    raws = stage.emit_smooth_raws(host_result)
    for t, raw in enumerate(raws):
        path = os.path.join(GOLDEN, "pose_smooth", "smooth_%05d.json" % t)
        with open(path) as f:
            golden_text = f.read()
        assert dumps_keypoint_json(raw) == golden_text, f"frame {t} differs"


@requires_reference_data
def test_device_path_subpixel(stage, ts, host_result):
    dev = stage.run(ts, device=True)
    for a, b in [
        (dev.face, host_result.face),
        (dev.pose, host_result.pose),
        (dev.face_smooth, host_result.face_smooth),
        (dev.pose_smooth, host_result.pose_smooth),
    ]:
        err = np.max(np.abs(a - b))
        assert err < 1e-2, f"device/host divergence {err}"


def test_golden_smooth_roundtrip_parse():
    # Smooth goldens use the reference's nested-list quirk; our codec must
    # read them transparently.
    from text2video.io.openpose import frame_from_raw

    path = os.path.join(GOLDEN, "pose_smooth", "smooth_00010.json")
    with open(path) as f:
        raw = json.load(f)
    kf = frame_from_raw(raw)
    assert kf.face.shape == (210,)
    assert np.isfinite(kf.face).all()
