"""Unit-selection concatenative TTS from a recorded voice.

The reference's voices come from Baidu's TTS service (reference:
tts_request.py:29-44 — per-person voice ids, network egress). Offline,
the previous best was rule-based formant synthesis (frontend/tts.py
FormantTTS) — intelligible timing, robotic sound. This backend instead
speaks with a *real recorded voice*: the same wav+transcript pool that
trains the person's acoustic model is force-aligned, cut into phone
units (English) or syllable units (Mandarin), and synthesis concatenates
context-matched units with short crossfades. Natural speaker timbre, no
network, no external models — the voice pool is the reference's own
recordings (e.g. VidTIMIT fadg0 audio, input_audio/henan).

Unit selection is greedy with a context score (match the previous /next
symbol of the unit's source context — the classic diphone-continuity
heuristic); per-unit energy is normalized to the pool median so units
from different recordings splice smoothly. Phones missing from the pool
fall back to the formant synthesizer's segment renderer, so synthesis
always succeeds.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from text2video.frontend.align_english import (
    EnglishAligner,
    strip_stress,
    transcript_words,
)
from text2video.frontend.audio import ALIGN_SAMPLE_RATE, resample
from text2video.frontend import tts as _tts

UNIT_PAD_S = 0.008   # source context kept each side, consumed by fades
XFADE_S = 0.008      # crossfade between consecutive units
WORD_GAP_S = 0.08    # silence between English words
SYL_GAP_S = 0.03     # gap between Mandarin syllables
MIN_UNIT_S = 0.02


@dataclasses.dataclass
class _Unit:
    wave: np.ndarray          # float32 @ ALIGN_SAMPLE_RATE, padded
    left: str                 # symbol preceding the unit in its source
    right: str                # symbol following it
    rms: float


def _rms(x: np.ndarray) -> float:
    return float(np.sqrt(np.mean(np.square(x)) + 1e-12))


@dataclasses.dataclass
class ConcatTTS:
    """Concatenative TTS over a phone/syllable unit inventory."""

    units: Dict[str, List[_Unit]]
    mode: str                              # "en" | "zh"
    pdict: Optional[object] = None         # PronouncingDict for "en"
    target_rms: float = 0.0
    fallback_f0: float = 120.0

    # ---- building ----------------------------------------------------

    @classmethod
    def build_english(
        cls,
        utterances: Sequence[Tuple[np.ndarray, str]],
        aligner: EnglishAligner,
    ) -> "ConcatTTS":
        """Cut phone units from (samples, transcript) pairs using forced
        alignment (the same pool that trains the acoustic model)."""
        sr = ALIGN_SAMPLE_RATE
        units: Dict[str, List[_Unit]] = {}
        for samples, text in utterances:
            res = aligner.align(samples, text)
            pts = res.phone_times
            for i, (sym, st, en) in enumerate(pts):
                base = strip_stress(sym)
                if base in ("sil", "sp") or en - st < MIN_UNIT_S:
                    continue
                lo = max(0, int(round((st - UNIT_PAD_S) * sr)))
                hi = min(len(samples), int(round((en + UNIT_PAD_S) * sr)))
                wave = np.asarray(samples[lo:hi], np.float32)
                left = strip_stress(pts[i - 1][0]) if i > 0 else "sil"
                right = (
                    strip_stress(pts[i + 1][0]) if i + 1 < len(pts)
                    else "sil"
                )
                units.setdefault(base, []).append(
                    _Unit(wave, left, right, _rms(wave))
                )
        return cls(
            units=units,
            mode="en",
            pdict=aligner.pdict,
            target_rms=cls._median_rms(units),
        )

    @classmethod
    def build_mandarin(
        cls,
        utterances: Sequence[Tuple[np.ndarray, str]],
        aligner,
    ) -> "ConcatTTS":
        """Cut whole-syllable units from (samples, hanzi-or-pinyin text)
        pairs with the Mandarin forced aligner
        (frontend/align_mandarin.MandarinAligner)."""
        sr = ALIGN_SAMPLE_RATE
        units: Dict[str, List[_Unit]] = {}
        for samples, text in utterances:
            spans = aligner.align_text(samples, text)
            for i, span in enumerate(spans):
                st, en = span.start, span.end
                if en - st < MIN_UNIT_S:
                    continue
                lo = max(0, int(round((st - UNIT_PAD_S) * sr)))
                hi = min(len(samples), int(round((en + UNIT_PAD_S) * sr)))
                wave = np.asarray(samples[lo:hi], np.float32)
                left = spans[i - 1].syllable if i > 0 else "sil"
                right = (
                    spans[i + 1].syllable if i + 1 < len(spans) else "sil"
                )
                units.setdefault(span.syllable, []).append(
                    _Unit(wave, left, right, _rms(wave))
                )
        return cls(
            units=units, mode="zh", target_rms=cls._median_rms(units)
        )

    @staticmethod
    def _median_rms(units: Dict[str, List[_Unit]]) -> float:
        all_rms = [u.rms for us in units.values() for u in us]
        return float(np.median(all_rms)) if all_rms else 0.1

    # ---- synthesis ---------------------------------------------------

    def _token_stream(self, text: str) -> List[Optional[str]]:
        """Symbols to speak; None marks a word/phrase gap."""
        if self.mode == "en":
            seq: List[Optional[str]] = []
            for w in transcript_words(text):
                seq.extend(strip_stress(p) for p in self.pdict.lookup(w))
                seq.append(None)
            return seq
        from text2video.frontend.align_mandarin import (  # noqa: PLC0415
            expand_walk_stream,
        )

        seq = []
        for tok in expand_walk_stream(text):
            seq.append(tok)
            seq.append(None)
        return seq

    def _pick(self, sym: str, prev: str, nxt: str, pos: int):
        cands = self.units.get(sym)
        if not cands:
            return None
        scores = [
            2 * (u.left == prev) + (u.right == nxt) for u in cands
        ]
        best = max(scores)
        # Deterministic variety among ties: rotate by stream position so
        # repeated symbols don't reuse one unit monotonously.
        ties = [i for i, s in enumerate(scores) if s == best]
        return cands[ties[pos % len(ties)]]

    def _fallback_wave(self, sym: str, sr: int) -> np.ndarray:
        """Formant-render one missing symbol (frontend/tts.py segments)."""
        rng = np.random.RandomState(0)
        segs = _tts._phone_segments(sym)
        return _tts._render(segs, sr, self.fallback_f0, rng)

    def synthesize(self, text: str, sample_rate: int) -> np.ndarray:
        sr = ALIGN_SAMPLE_RATE
        seq = self._token_stream(text)
        syms = [s for s in seq if s is not None]
        gap = WORD_GAP_S if self.mode == "en" else SYL_GAP_S
        xf = int(XFADE_S * sr)
        pieces: List[np.ndarray] = [np.zeros(int(0.1 * sr), np.float32)]
        si = 0
        for tok in seq:
            if tok is None:
                pieces.append(np.zeros(int(gap * sr), np.float32))
                continue
            prev = syms[si - 1] if si > 0 else "sil"
            nxt = syms[si + 1] if si + 1 < len(syms) else "sil"
            unit = self._pick(tok, prev, nxt, si)
            si += 1
            if unit is None:
                if self.mode == "zh":
                    # Missing syllable: formant-render its phones.
                    from text2video.frontend.align_mandarin import (  # noqa: PLC0415
                        pinyin_to_phones,
                    )

                    parts = pinyin_to_phones(tok) or []
                    phones: List[str] = []
                    for p in parts:
                        phones.extend(
                            _tts._ZH_INITIAL_PHONES.get(p)
                            or _tts._ZH_FINAL_PHONES.get(p, ["AH"])
                        )
                    wave = np.concatenate(
                        [self._fallback_wave(p, sr) for p in phones]
                        or [np.zeros(int(0.05 * sr), np.float32)]
                    )
                else:
                    wave = self._fallback_wave(tok, sr)
                wave = wave * 0.8
            else:
                scale = (
                    self.target_rms / unit.rms if unit.rms > 1e-6 else 1.0
                )
                wave = unit.wave * min(scale, 4.0)
            pieces.append(np.asarray(wave, np.float32))
        pieces.append(np.zeros(int(0.1 * sr), np.float32))

        # Overlap-add with linear crossfades between consecutive pieces.
        out = pieces[0]
        for w in pieces[1:]:
            n = min(xf, len(out), len(w))
            if n > 0:
                ramp = np.linspace(0.0, 1.0, n, dtype=np.float32)
                head = out[-n:] * (1.0 - ramp) + w[:n] * ramp
                out = np.concatenate([out[:-n], head, w[n:]])
            else:
                out = np.concatenate([out, w])
        peak = np.abs(out).max()
        if peak > 0.99:
            out = out * (0.99 / peak)
        if sample_rate != sr:
            out = resample(out, sr, sample_rate)
        return out.astype(np.float32)

    def coverage(self) -> Dict[str, int]:
        """Unit counts per symbol (diagnostics/tests)."""
        return {k: len(v) for k, v in sorted(self.units.items())}
