"""Dictionary-building tests: recordings -> reference-format dictionaries
usable by the pose stage."""

import os

import numpy as np
import pytest

from tests.conftest import REFERENCE_DIR, requires_reference_data
from text2video.dictbuild import (
    build_phoneme_dict,
    build_pinyin_dict,
    collect_instances,
    write_phoneme_dict,
    write_pinyin_dict,
)
from text2video.frontend.timestamps import Timestamps


@requires_reference_data
def test_build_phoneme_dict_from_fadg0(tmp_path):
    from text2video.frontend.align_english import (
        EnglishAligner,
        PronouncingDict,
        train_acoustic_model,
    )
    from text2video.frontend.audio import load_wav_for_alignment
    from text2video.io.dicts import KeypointTable, PoseDictionary

    ref = REFERENCE_DIR
    sa1 = "She had your dark suit in greasy wash water all year"
    sa2 = "Don't ask me to carry an oily rag like that"
    wav1 = load_wav_for_alignment(
        f"{ref}/*phoneme_data/VidTIMIT/fadg0/audio/sa1.wav"
    )
    wav2 = load_wav_for_alignment(
        f"{ref}/*phoneme_data/VidTIMIT/fadg0/audio/sa2.wav"
    )
    pdict = PronouncingDict.load(f"{ref}/aligner/english/dict")
    model = train_acoustic_model([(wav1, sa1), (wav2, sa2)], pdict)
    aligner = EnglishAligner(model, pdict)

    table = KeypointTable.load_dir(
        f"{ref}/*phoneme_data/VidTIMIT/fadg0/keypoints_fadg0", "clip"
    )
    max_frame = {"sa1": 400, "sa2": 400}
    for clip, frame in table._index:
        max_frame[clip] = max(max_frame.get(clip, 0), frame)

    instances = collect_instances(
        [("sa1", wav1, sa1), ("sa2", wav2, sa2)], aligner
    )
    assert len(instances) > 40
    entries = build_phoneme_dict(instances, max_frame=max_frame)
    path = str(tmp_path / "fadg0_built.txt")
    write_phoneme_dict(entries, path)

    # Parses as a reference-format dictionary and every entry's keypoint
    # frame exists.
    built = PoseDictionary.load(path, "clip")
    symbols = {sym for sym, _, _ in entries}
    # Stress variants of observed vowels are all covered.
    assert {"IY0", "IY1", "IY2"} <= symbols
    for sym, clip, frame in entries:
        assert table.has_key((clip, frame)), (sym, clip, frame)

    # The built dictionary drives the pose stage on a real timestamp file
    # (restricted to covered symbols).
    from text2video.config import get_profile
    from text2video.pose_stage import PoseStage

    profile = get_profile("fadg0")
    profile = type(profile)(
        **{**profile.__dict__, "dict_path": path}
    )
    stage = PoseStage(profile)
    ts = Timestamps(
        entries=tuple(
            (f, s)
            for f, s in [(0, "sp"), (2, "SH"), (5, "IY1"), (8, "HH"),
                         (10, "AE1"), (11, "D")]
            if s == "sp" or s in symbols
        )
    )
    res = stage.run(ts, device=False)
    assert res.num_frames > 5


def test_build_pinyin_dict():
    ts = Timestamps(entries=((6, "mu"), (10, "qian"), (16, "mu"), (23, "zhi")))
    entries = build_pinyin_dict(ts, max_frame=20)
    assert entries == [("mu", 6), ("qian", 10), ("zhi", 20)]


def test_write_pinyin_dict_roundtrip(tmp_path):
    from text2video.io.dicts import PoseDictionary

    path = str(tmp_path / "dict_x.txt")
    write_pinyin_dict([("ni", 3), ("hao", 9)], path)
    d = PoseDictionary.load(path, "flat")
    assert "ni" in d and "hao" in d


def test_row_nearest_sparse_table():
    """Sparse keypoint folders (xuesong: gaps in the frame index) clamp
    to the nearest captured frame instead of crashing like the
    reference's FileNotFoundError."""
    import numpy as np

    from text2video.io.dicts import KeypointTable

    face = np.zeros((3, 210))
    pose = np.zeros((3, 75))
    hands = np.zeros((3, 2, 63))
    has = np.zeros(3, bool)
    index = {("", 10): 0, ("", 14): 1, ("", 30): 2}
    t = KeypointTable(face, pose, hands, has, [{}, {}, {}], index)
    assert t.row_nearest(("", 10)) == 0      # exact
    assert t.row_nearest(("", 11)) == 0      # closer to 10
    assert t.row_nearest(("", 13)) == 1      # closer to 14
    assert t.row_nearest(("", 12)) == 0      # tie -> lower
    assert t.row_nearest(("", 5)) == 0       # below range
    assert t.row_nearest(("", 99)) == 2      # above range


@requires_reference_data
def test_load_prompts_and_coverage():
    from text2video.dictbuild import load_prompts, prompt_coverage

    prompts = load_prompts(f"{REFERENCE_DIR}/prompts/all_pinyin.txt")
    assert len(prompts) >= 400
    assert "zhong" in prompts
    missing = prompt_coverage(prompts, [("zhong", 5)])
    assert "zhong" not in missing and len(missing) == len(prompts) - 1
