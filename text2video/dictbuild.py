"""Dictionary building: recordings -> phoneme/pinyin-pose dictionaries.

The reference's per-person setup is manual (reference: README.md:107-165):
record the prompt script, run forced alignment / vosk, then *handcraft*
``dict_{person}.txt`` / ``{person}.txt`` mapping each phoneme or pinyin to
a good video frame, and run OpenPose for the keypoints. This module
automates the mapping step: align each recorded clip against its
transcript, collect every phoneme instance's midpoint video frame, and
pick a representative instance per symbol (the one with median duration —
long instances are usually the cleanest articulations, extreme ones are
outliers).

Output formats match the reference exactly so either system can consume
them:
  * English: ``PHONEME clip frame`` 3-column with stress variants
    (reference: *phoneme_data/VidTIMIT/fadg0.txt, e.g. ``AA0 sa1 038``).
  * Chinese: ``pinyin frame`` 2-column flat index
    (reference: dict_henan.txt).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from text2video.frontend.align_english import (
    EnglishAligner,
    strip_stress,
)
from text2video.frontend.timestamps import Timestamps

_STRESS_VARIANTS = ("0", "1", "2")
_VOWELS = {
    "AA", "AE", "AH", "AO", "AW", "AY", "EH", "ER", "EY", "IH", "IY",
    "OW", "OY", "UH", "UW",
}


@dataclasses.dataclass
class PhoneInstance:
    symbol: str        # stressed symbol as aligned (e.g. "AA1")
    clip: str
    frame: int         # video frame (fps-converted midpoint)
    duration_s: float


def collect_instances(
    clips: Sequence[Tuple[str, np.ndarray, str]],
    aligner: EnglishAligner,
    video_fps: float = 25.0,
) -> List[PhoneInstance]:
    """clips: (clip_name, mono 16 kHz PCM, transcript) triples."""
    out: List[PhoneInstance] = []
    for clip_name, samples, text in clips:
        res = aligner.align(samples, text)
        for sym, st, en in res.phone_times:
            # 'sp' instances are kept: the synthesis dictionary needs a
            # neutral closed-mouth pose (reference fadg0.txt has one).
            out.append(
                PhoneInstance(
                    symbol=sym,
                    clip=clip_name,
                    frame=int(0.5 * (st + en) * video_fps),
                    duration_s=en - st,
                )
            )
    return out


def _representative(instances: List[PhoneInstance]) -> PhoneInstance:
    by_dur = sorted(instances, key=lambda i: i.duration_s)
    return by_dur[len(by_dur) // 2]


def build_phoneme_dict(
    instances: Sequence[PhoneInstance],
    max_frame: Optional[Dict[str, int]] = None,
) -> List[Tuple[str, str, int]]:
    """-> sorted (SYMBOL, clip, frame) entries with full stress coverage.

    Every stressed vowel variant (AA0/AA1/AA2) gets a line — from its own
    instances when observed, else from the base phone's pool — because
    synthesis looks up the aligner's stressed symbols directly (reference
    dict covers variants the same way, fadg0.txt).
    ``max_frame``: optional per-clip frame count to clamp into (keypoint
    folders may be shorter than the audio).
    """
    by_symbol: Dict[str, List[PhoneInstance]] = {}
    by_base: Dict[str, List[PhoneInstance]] = {}
    for inst in instances:
        by_symbol.setdefault(inst.symbol, []).append(inst)
        by_base.setdefault(strip_stress(inst.symbol), []).append(inst)

    entries: Dict[str, Tuple[str, int]] = {}
    for base, pool in by_base.items():
        symbols = (
            [base + s for s in _STRESS_VARIANTS] if base in _VOWELS else [base]
        )
        for sym in symbols:
            pick = _representative(by_symbol.get(sym) or pool)
            frame = pick.frame
            if max_frame and pick.clip in max_frame:
                frame = min(frame, max_frame[pick.clip])
            entries[sym] = (pick.clip, frame)
    return sorted(
        (sym, clip, frame) for sym, (clip, frame) in entries.items()
    )


def write_phoneme_dict(
    entries: Sequence[Tuple[str, str, int]], path: str
) -> None:
    with open(path, "w") as f:
        for sym, clip, frame in entries:
            f.write(f"{sym} {clip} {frame:03d}\n")


# ---- Chinese (pinyin -> flat frame index) --------------------------------


def build_pinyin_dict(
    ts: Timestamps, max_frame: Optional[int] = None
) -> List[Tuple[str, int]]:
    """Pinyin timestamps of one long dictionary recording -> 2-col
    entries (first occurrence of each syllable wins, like a recording of
    the prompt list read once; reference: prompts/all_pinyin.txt)."""
    entries: Dict[str, int] = {}
    for frame, sym in ts:
        if sym not in entries:
            entries[sym] = (
                min(frame, max_frame) if max_frame is not None else frame
            )
    return sorted(entries.items())


def write_pinyin_dict(entries: Sequence[Tuple[str, int]], path: str) -> None:
    with open(path, "w") as f:
        for sym, frame in entries:
            f.write(f"{sym} {frame}\n")


def load_prompts(path: str) -> List[str]:
    """Recording-prompt list for capturing a new person's dictionary
    (reference: prompts/all_pinyin.txt — 408 syllables the subject reads
    on camera, README.md:113-115). One prompt token per line."""
    with open(path, encoding="utf-8", errors="replace") as f:
        return [line.strip() for line in f if line.strip()]


def prompt_coverage(
    prompts: Sequence[str], entries: Sequence[Tuple[str, int]]
) -> List[str]:
    """Prompts not yet covered by a built dictionary — what still needs
    recording."""
    have = {sym for sym, _ in entries}
    return [p for p in prompts if p not in have]
