"""Chinese-path (pinyin dictionary) pose stage vs reference goldens.

Goldens generated by tools/make_goldens.py:main_chinese — the reference
interp_landmarks_motion.py run unmodified on the henan ``111`` vosk
timestamp fixture. Exercises the Chinese flavor's quirks: 2-col dict,
flat keypoint index, min_key_dist=3 with the strict ``>`` gap rule
(vs the English path's ``>=`` at 4).
"""

import json
import os

import pytest

from tests.conftest import REFERENCE_DIR, requires_reference_data

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "henan_111")


@pytest.fixture(scope="module")
def result_and_stage():
    from text2video.config import get_profile
    from text2video.frontend.timestamps import load_timestamp_file
    from text2video.pose_stage import PoseStage

    stage = PoseStage(get_profile("henan"))
    ts = load_timestamp_file(
        f"{REFERENCE_DIR}/input_timestamp/henan/111.txt"
    )
    return stage.run(ts, device=False), stage


@requires_reference_data
@pytest.mark.skipif(
    not os.path.isdir(GOLDEN), reason="run tools/make_goldens.py first"
)
def test_chinese_pose_jsons_bit_exact(result_and_stage):
    result, stage = result_and_stage
    golden_names = sorted(os.listdir(os.path.join(GOLDEN, "pose")))
    assert result.num_frames == len(golden_names)
    from text2video.io.openpose import dumps_keypoint_json

    raws = stage.emit_pose_raws(result)
    for t, name in enumerate(golden_names):
        with open(os.path.join(GOLDEN, "pose", name)) as f:
            golden = f.read()
        assert dumps_keypoint_json(raws[t]) == golden, f"frame {name}"


@requires_reference_data
@pytest.mark.skipif(
    not os.path.isdir(GOLDEN), reason="run tools/make_goldens.py first"
)
def test_chinese_smooth_jsons_bit_exact(result_and_stage):
    result, stage = result_and_stage
    golden_names = sorted(os.listdir(os.path.join(GOLDEN, "pose_smooth")))
    from text2video.io.openpose import dumps_keypoint_json

    raws = stage.emit_smooth_raws(result)
    assert len(raws) == len(golden_names)
    for t, name in enumerate(golden_names):
        with open(os.path.join(GOLDEN, "pose_smooth", name)) as f:
            golden = f.read()
        assert dumps_keypoint_json(raws[t]) == golden, f"frame {name}"


@requires_reference_data
def test_unknown_symbols_dropped_with_warning():
    """OOV syllables are dropped (reference KeyErrors); all-unknown input
    raises."""
    import warnings

    from text2video.config import get_profile
    from text2video.frontend.timestamps import Timestamps
    from text2video.io.dicts import KeypointTable, PoseDictionary
    from text2video.ops.interp import plan_pose_track

    profile = get_profile("fadg0")
    pdict = PoseDictionary.load(profile.dict_path, "clip")
    table = KeypointTable.load_dir(profile.keypoints_dir, "clip")
    ts = Timestamps(entries=((0, "sp"), (3, "ZZZ"), (9, "AA1"), (15, "T")))
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        plan = plan_pose_track(ts, pdict, table, profile)
    assert any("ZZZ" in str(x.message) for x in w)
    assert plan.num_frames == 16

    with pytest.raises(KeyError):
        plan_pose_track(
            Timestamps(entries=((0, "QQQ"),)), pdict, table, profile
        )
