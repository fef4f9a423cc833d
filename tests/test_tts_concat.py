"""Concatenative unit-selection TTS (frontend/tts_concat.py).

The voice pool is the reference's own recordings; synthesis must produce
clean audio that the SAME aligner can force-align back to the input text
— the round trip that the downstream video pipeline actually depends on.
"""

import numpy as np
import pytest

from tests.conftest import REFERENCE_DIR, requires_reference_data
from text2video.frontend.audio import ALIGN_SAMPLE_RATE


@pytest.fixture(scope="module")
def english_pool():
    from text2video.frontend.align_english import (
        EnglishAligner,
        PronouncingDict,
        train_acoustic_model,
    )
    from text2video.frontend.audio import load_wav_for_alignment

    ref = REFERENCE_DIR
    pdict = PronouncingDict.load(f"{ref}/aligner/english/dict")
    utts = [
        (
            load_wav_for_alignment(f"{ref}/input_audio/fadg0/Dotheymake.wav"),
            "Do they make it",
        ),
        (
            load_wav_for_alignment(
                f"{ref}/*phoneme_data/VidTIMIT/fadg0/audio/sa1.wav"
            ),
            "She had your dark suit in greasy wash water all year",
        ),
        (
            load_wav_for_alignment(
                f"{ref}/*phoneme_data/VidTIMIT/fadg0/audio/sa2.wav"
            ),
            "Don't ask me to carry an oily rag like that",
        ),
    ]
    model = train_acoustic_model(utts, pdict)
    return EnglishAligner(model, pdict), utts


@requires_reference_data
def test_build_and_coverage(english_pool):
    from text2video.frontend.tts_concat import ConcatTTS

    aligner, utts = english_pool
    tts = ConcatTTS.build_english(utts, aligner)
    cov = tts.coverage()
    # The 3-utterance pool covers the phones of its own transcripts.
    for ph in ("D", "UW", "EY", "M", "K", "SH", "AA", "S"):
        assert cov.get(ph, 0) >= 1, (ph, cov)
    assert sum(cov.values()) > 40


@requires_reference_data
def test_synthesize_is_alignable_round_trip(english_pool):
    from text2video.frontend.align_english import strip_stress
    from text2video.frontend.tts_concat import ConcatTTS

    aligner, utts = english_pool
    tts = ConcatTTS.build_english(utts, aligner)
    text = "Do they make it"
    audio = tts.synthesize(text, ALIGN_SAMPLE_RATE)
    assert audio.dtype == np.float32
    assert np.isfinite(audio).all()
    assert np.abs(audio).max() <= 1.0
    # Real-voice units: substantially longer than pure silence, bounded.
    dur = len(audio) / ALIGN_SAMPLE_RATE
    assert 0.5 < dur < 6.0
    # The same aligner force-aligns the synthetic audio to the text and
    # recovers the dictionary phone sequence.
    res = aligner.align(audio, text)
    got = [
        strip_stress(p)
        for _, p in res.phones
        if p not in ("sp", "sil")
    ]
    want = []
    for w in ("do", "they", "make", "it"):
        want.extend(strip_stress(p) for p in aligner.pdict.lookup(w))
    assert got == want


@requires_reference_data
def test_fallback_for_missing_phone(english_pool):
    from text2video.frontend.tts_concat import ConcatTTS

    aligner, utts = english_pool
    tts = ConcatTTS.build_english(utts[:1], aligner)  # tiny pool
    # "vision" needs ZH which one utterance can't supply -> formant
    # fallback keeps synthesis alive.
    audio = tts.synthesize("vision", ALIGN_SAMPLE_RATE)
    assert np.isfinite(audio).all() and len(audio) > 0


@requires_reference_data
def test_mandarin_syllable_units():
    import os

    from text2video.frontend.align_mandarin import MandarinAligner
    from text2video.frontend.audio import load_wav_for_alignment
    from text2video.frontend.tts_concat import ConcatTTS

    data = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "text2video", "data",
    )
    model = None
    for name in ("mandarin_henan.am", "mandarin.am"):
        p = os.path.join(data, name)
        if os.path.exists(p):
            model = p
            break
    if model is None:
        pytest.skip("no packaged mandarin model")
    wav = f"{REFERENCE_DIR}/input_audio/henan/lai4zi4he2nan2.wav"
    if not os.path.exists(wav):
        import glob

        cands = glob.glob(f"{REFERENCE_DIR}/input_audio/henan/*.wav")
        if not cands:
            pytest.skip("no henan audio")
        wav = cands[0]
    txt = None
    ts_dir = f"{REFERENCE_DIR}/input_timestamp/henan"
    stem = os.path.splitext(os.path.basename(wav))[0]
    ts_file = os.path.join(ts_dir, stem + ".txt")
    if not os.path.exists(ts_file):
        pytest.skip("no golden pinyin stream for the henan wav")
    stream = [l.split()[1] for l in open(ts_file) if len(l.split()) == 2]
    aligner = MandarinAligner.load(model)
    samples = load_wav_for_alignment(wav)

    class _TextShim:
        """align_text over a known pinyin stream."""

        def align_text(self, s, text):
            return aligner.align_stream(s, stream)

    tts = ConcatTTS.build_mandarin([(samples, "ignored")], _TextShim())
    cov = tts.coverage()
    assert len(cov) >= 3, cov
    # Unit selection returns real-audio units for covered syllables.
    syl = max(cov, key=cov.get)
    unit = tts._pick(syl, "sil", "sil", 0)
    assert unit is not None and np.isfinite(unit.wave).all()
    assert len(unit.wave) >= int(0.02 * ALIGN_SAMPLE_RATE)
    # And synthesis (hanzi input; uncovered syllables take the formant
    # fallback) always produces clean audio.
    audio = tts.synthesize("你好", ALIGN_SAMPLE_RATE)
    assert np.isfinite(audio).all() and len(audio) > ALIGN_SAMPLE_RATE // 8


@requires_reference_data
def test_pipeline_run_tts_with_concat_voice(english_pool, tmp_path):
    """run_tts with the real-voice backend produces a muxed video whose
    timing comes from aligning the concatenative audio."""
    from text2video.config import PipelineConfig, get_profile
    from text2video.frontend.tts_concat import ConcatTTS
    from text2video.pipeline import Text2VideoPipeline

    aligner, utts = english_pool
    pipe = Text2VideoPipeline(
        PipelineConfig(person=get_profile("fadg0"), out_dir=str(tmp_path)),
        aligner=aligner,
        tts=ConcatTTS.build_english(utts, aligner),
    )
    run = pipe.run_tts("Do they make it")
    assert run.num_frames > 10
    assert any(f.endswith(".mp4") for f in run.files)
    assert any(f.endswith(".avi") or f.endswith("_audio.mp4")
               for f in run.files)
