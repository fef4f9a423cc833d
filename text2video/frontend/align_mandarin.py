"""Mandarin forced alignment: audio + known pinyin stream -> per-syllable
frame timestamps.

The reference gets Chinese word timings from open vosk/Kaldi ASR
(reference: pinyin_timestamping.py:68-91) and splits each recognized
word's interval uniformly across its syllables. But in this pipeline the
text is *known* — timing is a forced-alignment problem, not open ASR —
so this module aligns the text's own pinyin stream to the audio with the
same native GMM-HMM toolchain (native/align/) that powers the English
P2FA-equivalent path, using Mandarin initial/final (shengmu/yunmu)
monophone units. Per-syllable intervals then feed the reference's exact
emission walk (timestamp_zh.pinyin_timestamps), where a one-syllable
interval degenerates to its midpoint: ``st + (et-st)/2``.

Acoustic models train flat-start from any (wav, transcript) pairs —
e.g. the per-person TTS recordings shipped with the reference
(input_audio/{henan,xuesong}/*.wav with pinyin streams at
input_timestamp/...) — via :func:`train_mandarin_model`.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from text2video.frontend import native
from text2video.frontend.audio import ALIGN_SAMPLE_RATE
from text2video.frontend.pinyin import to_pinyin
from text2video.frontend.textnorm import strip_punct

FRAME_SHIFT_S = 0.010
TIME_OFFSET_S = 0.0125  # half the 25 ms analysis window

# Pinyin initials (shengmu), two-char first for greedy matching.
INITIALS = [
    "zh", "ch", "sh",
    "b", "p", "m", "f", "d", "t", "n", "l",
    "g", "k", "h", "j", "q", "x", "r", "z", "c", "s",
]

# Zero-initial syllables: the y-/w- orthography maps onto i/u/v finals.
_ZERO_INITIAL = {
    "yi": "i", "ya": "ia", "yan": "ian", "yang": "iang", "yao": "iao",
    "ye": "ie", "yin": "in", "ying": "ing", "yo": "o", "yong": "iong",
    "you": "iou", "yu": "v", "yuan": "van", "yue": "ve", "yun": "vn",
    "wu": "u", "wa": "ua", "wai": "uai", "wan": "uan", "wang": "uang",
    "wei": "uei", "wen": "uen", "weng": "ueng", "wo": "uo",
}

# Standalone finals (no initial, no y/w onset).
_BARE_FINALS = {
    "a", "o", "e", "ai", "ei", "ao", "ou", "an", "en", "ang", "eng", "er",
}

# Apical-vowel initials: their written "i" is the buzzing [ɿ]/[ʅ], a
# different unit from the [i] of "ji".
_APICAL = {"zh", "ch", "sh", "r", "z", "c", "s"}

FINALS = sorted(
    _BARE_FINALS
    | set(_ZERO_INITIAL.values())
    | {
        "ih", "ong",
        "ia", "ie", "iao", "iou", "ian", "in", "iang", "ing", "iong",
        "ua", "uo", "uai", "uei", "uan", "uen", "uang",
        "v", "ve", "van", "vn",
    }
)

MANDARIN_PHONES = ["sil", "sp"] + INITIALS + FINALS


def pinyin_to_phones(syl: str) -> Optional[List[str]]:
    """Toneless pinyin syllable -> [initial?, final] units, or None when
    the token is not a decomposable pinyin syllable (ASCII words, digit
    runs, unknown hanzi passed through by to_pinyin)."""
    syl = syl.strip().lower()
    if not syl.isascii() or not syl.isalpha():
        return None
    # Rare interjection readings (呒 m, 嗯 n, 嗡 wong) map onto the
    # nearest standard unit rather than spending a monophone on them.
    special = {"m": "en", "hm": "en", "n": "en", "ng": "en", "hng": "en",
               "wong": "ueng"}
    if syl in special:
        return [special[syl]]
    if syl in _ZERO_INITIAL:
        return [_ZERO_INITIAL[syl]]
    if syl in _BARE_FINALS:
        return [syl]
    for ini in INITIALS:
        if syl.startswith(ini) and len(syl) > len(ini):
            fin = syl[len(ini):]
            # Abbreviated-final expansions.
            if fin == "iu":
                fin = "iou"
            elif fin == "ui":
                fin = "uei"
            elif fin == "un":
                fin = "vn" if ini in ("j", "q", "x") else "uen"
            elif ini in ("j", "q", "x"):
                # After j/q/x the written u is ü.
                if fin == "u":
                    fin = "v"
                elif fin == "ue":
                    fin = "ve"
                elif fin == "uan":
                    fin = "van"
            elif fin == "ue" and ini in ("l", "n"):
                fin = "ve"  # lue/nue == lve/nve
            if fin == "i" and ini in _APICAL:
                fin = "ih"
            if fin in FINALS:
                return [ini, fin]
            return None
    return None


def expand_walk_stream(text: str) -> List[str]:
    """The emission-walk token stream for ``text``: punctuation stripped
    (reference: pinyin_timestamping.py:20-35 strips zhon CJK + ASCII
    punctuation before lazy_pinyin), hanzi to toneless pinyin, numeric
    tokens expanded one digit-pinyin per slot (:112-133). One entry per
    output line of the reference's walk."""
    from text2video.frontend.timestamp_zh import digits_to_pinyin

    out: List[str] = []
    for tok in to_pinyin(strip_punct(text, strip_spaces=True, ascii_too=True)):
        if tok.isnumeric():
            out.extend(digits_to_pinyin(d) for d in tok)
        else:
            out.append(tok)
    return out


@dataclasses.dataclass(frozen=True)
class SyllableSpan:
    syllable: str
    start: float
    end: float


class MandarinAligner:
    """Forced alignment of a pinyin syllable stream against audio."""

    def __init__(self, model: native.AcousticModel):
        self.model = model

    @classmethod
    def load(cls, model_path: str) -> "MandarinAligner":
        return cls(native.AcousticModel.load(model_path))

    def align_stream(
        self,
        samples: np.ndarray,
        stream: Sequence[str],
        sample_rate: int = ALIGN_SAMPLE_RATE,
    ) -> List[SyllableSpan]:
        """Align ``stream`` (one token per output line) to the audio.

        Returns one SyllableSpan per token. Non-decomposable tokens join
        the lattice as skippable pauses; when skipped they inherit the
        previous token's end time (zero-length span), which the emission
        walk turns into that boundary's frame.
        """
        model = self.model
        feats = native.extract_features(
            samples, sample_rate, model.feat_kind
        )

        def pid(sym: str) -> int:
            i = model.phone_id(sym)
            if i < 0:
                raise KeyError(f"model has no phone {sym!r}")
            return i

        segments: List[Tuple[List[List[int]], bool]] = []
        seg_token: List[int] = []  # stream index, -1 for sil/sp glue

        segments.append(([[pid("sil")]], False))
        seg_token.append(-1)
        for i, tok in enumerate(stream):
            phones = pinyin_to_phones(tok)
            if phones is None:
                segments.append(([[pid("sp")]], True))
                seg_token.append(i)
            else:
                segments.append(([[pid(p) for p in phones]], False))
                seg_token.append(i)
            if i + 1 < len(stream):
                segments.append(([[pid("sp")]], True))
                seg_token.append(-1)
        segments.append(([[pid("sil")]], False))
        seg_token.append(-1)

        records, _ = native.align_variants(model, feats, segments)

        def t_of(frame: int) -> float:
            return FRAME_SHIFT_S * frame + TIME_OFFSET_S

        # Collapse phone records to per-segment spans.
        seg_span = {}
        for seg, _var, _pos, _pid, start, end in records:
            if start == end:
                continue
            lo, hi = seg_span.get(seg, (start, end))
            seg_span[seg] = (min(lo, start), max(hi, end))

        spans: List[SyllableSpan] = []
        prev_end = 0.0
        for seg, tok_i in enumerate(seg_token):
            if tok_i < 0:
                if seg in seg_span:
                    prev_end = t_of(seg_span[seg][1])
                continue
            if seg in seg_span:
                lo, hi = seg_span[seg]
                spans.append(SyllableSpan(stream[tok_i], t_of(lo), t_of(hi)))
                prev_end = t_of(hi)
            else:
                spans.append(SyllableSpan(stream[tok_i], prev_end, prev_end))
        return spans

    def align_text(
        self,
        samples: np.ndarray,
        text: str,
        sample_rate: int = ALIGN_SAMPLE_RATE,
    ) -> List[SyllableSpan]:
        return self.align_stream(
            samples, expand_walk_stream(text), sample_rate
        )


def train_mandarin_model(
    utterances: Sequence[Tuple[np.ndarray, Sequence[str]]],
    sample_rate: int = ALIGN_SAMPLE_RATE,
    iterations: int = 8,
    target_mixes: int = 4,
    save_path: Optional[str] = None,
    feat_kind: int = native.FEAT_MFCC,
) -> native.AcousticModel:
    """Flat-start Viterbi training of Mandarin initial/final monophones.

    utterances: (mono float PCM, pinyin token stream) pairs — e.g. the
    golden streams at input_timestamp/{person}/*.txt against their
    input_audio wavs. Non-decomposable tokens train as ``sp``.
    """
    model = native.AcousticModel.create(MANDARIN_PHONES, feat_kind=feat_kind)
    trainer = native.Trainer(model)

    prepped = []
    for samples, stream in utterances:
        feats = native.extract_features(samples, sample_rate, feat_kind)
        ids: List[int] = [model.phone_id("sil")]
        skip: List[bool] = [False]
        for i, tok in enumerate(stream):
            phones = pinyin_to_phones(tok)
            if phones is None:
                ids.append(model.phone_id("sp"))
                skip.append(True)
            else:
                for p in phones:
                    ids.append(model.phone_id(p))
                    skip.append(False)
            if i + 1 < len(stream):
                ids.append(model.phone_id("sp"))
                skip.append(True)
        ids.append(model.phone_id("sil"))
        skip.append(False)
        prepped.append((feats, ids, skip))
        trainer.accumulate_global(feats)
    trainer.finalize_flat_start()

    for it in range(iterations):
        for feats, ids, skip in prepped:
            trainer.accumulate(feats, ids, skip, uniform=(it == 0))
        trainer.update()
        if it == iterations // 2 and target_mixes > 1:
            trainer.mixup(target_mixes)

    if save_path is not None:
        model.save(save_path)
    return model
