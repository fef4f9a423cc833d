"""A runnable fadg0 identity built from files committed in this repository.

``get_profile("fadg0", data_dir=...)`` reads a key-pose dictionary and a
directory of OpenPose keypoint frames laid out like the reference repo's
``*phoneme_data`` folders. :func:`write_identity` writes that layout from
the 87 committed OpenPose frames of the fadg0 "She had your ..." golden
(``tests/goldens/fadg0_Shehadyour/pose/``), so the whole text->video path
runs without the reference's assets:

  * keypoints: ``*phoneme_data/VidTIMIT/fadg0/keypoints_fadg0/
    sa1_<frame:03d>_keypoints.json``;
  * key-pose dictionary ``*phoneme_data/VidTIMIT/fadg0.txt``: every phone
    the packaged ``data/english_fadg0.am`` can emit (vowels with each
    stress mark) mapped deterministically onto one of those frames;
  * an empty pronouncing dictionary ``aligner/english/dict``: the native
    G2P covers every word (frontend/align_english.py).

Audio comes from ``FormantTTS`` and alignment from the packaged acoustic
model. The frames are real; the phone->frame map is not a trained
dictionary, so mouth shapes do not follow the phones.
"""

from __future__ import annotations

import glob
import os
import shutil
from typing import List

_PACKAGE = os.path.dirname(os.path.abspath(__file__))
GOLDEN_POSE_DIR = os.path.join(
    os.path.dirname(_PACKAGE), "tests", "goldens", "fadg0_Shehadyour", "pose"
)
ENGLISH_AM = os.path.join(_PACKAGE, "data", "english_fadg0.am")
CLIP = "sa1"
# The golden clip's sentence (VidTIMIT sa1).
SA1_TEXT = "She had your dark suit in greasy wash water all year"


def identity_symbols(am_path: str = ENGLISH_AM) -> List[str]:
    """Every phone symbol the aligner can emit with this model, sorted."""
    from text2video.frontend.align_english import _VOWEL_RE
    from text2video.frontend.native import AcousticModel

    symbols = set()
    for p in AcousticModel.load(am_path).phones:
        if _VOWEL_RE.match(p):
            symbols.update(p + s for s in ("0", "1", "2"))
        symbols.add(p)
    return sorted(symbols)


def write_identity(root: str) -> str:
    """Write the fadg0 identity under ``root`` (idempotent); returns it."""
    frames = sorted(glob.glob(os.path.join(GOLDEN_POSE_DIR, "*.json")))
    if not frames:
        raise FileNotFoundError(f"no golden pose frames in {GOLDEN_POSE_DIR}")
    base = os.path.join(root, "*phoneme_data", "VidTIMIT")
    kp_dir = os.path.join(base, "fadg0", "keypoints_fadg0")
    os.makedirs(kp_dir, exist_ok=True)
    for i, src in enumerate(frames):
        shutil.copyfile(
            src, os.path.join(kp_dir, f"{CLIP}_{i:03d}_keypoints.json")
        )
    # Spread the symbols evenly over the clip, clear of its ends so the
    # planner's motion windows stay inside the recording.
    symbols = identity_symbols()
    margin = 4
    span = len(frames) - 1 - 2 * margin
    with open(os.path.join(base, "fadg0.txt"), "w") as f:
        for i, sym in enumerate(symbols):
            frame = margin + (i * span) // max(len(symbols) - 1, 1)
            f.write(f"{sym} {CLIP} {frame:03d}\n")
    dict_dir = os.path.join(root, "aligner", "english")
    os.makedirs(dict_dir, exist_ok=True)
    open(os.path.join(dict_dir, "dict"), "w").close()
    return root


def english_aligner(root: str):
    """The packaged fadg0 acoustic model with the identity's dictionary."""
    from text2video.frontend.align_english import EnglishAligner

    return EnglishAligner.load(
        ENGLISH_AM, os.path.join(root, "aligner", "english", "dict")
    )
