"""Chinese timestamping frontend tests (formula parity with the reference
pinyin_timestamping.py / phoneme_timestamping.py)."""

import numpy as np

from text2video.frontend.pinyin import to_pinyin
from text2video.frontend.timestamp_zh import (
    EnergySegmenter,
    WordInterval,
    digits_to_pinyin,
    pinyin_timestamps,
    timestamp_chinese,
    word_timestamps,
)


def test_digit_map():
    # reference: pinyin_timestamping.py:50-60
    assert digits_to_pinyin("2") == "er"
    assert digits_to_pinyin("105") == "yilingwu"


def test_to_pinyin_grouping():
    # Hanzi -> one syllable each; non-hanzi runs group into one token.
    assert to_pinyin("你好") == ["ni", "hao"]
    assert to_pinyin("今年2024好") == ["jin", "nian", "2024", "hao"]
    # Full Unihan coverage: even rare hanzi convert now.
    assert to_pinyin("好犇") == ["hao", "ben"]
    # A character absent from the table still passes through.
    assert to_pinyin("好㐂") == ["hao", "㐂"]


def test_pinyin_timestamps_uniform_split():
    """frame = int((st + step*(idx+1)) * 30 + 0.5), step=(et-st)/(nc+1)
    (reference: pinyin_timestamping.py:98-106)."""
    ts = pinyin_timestamps(
        "你好", [WordInterval(word="你好", start=0.0, end=0.9)]
    )
    # step = 0.3; slots at 0.3, 0.6 -> frames 9, 18.
    assert list(ts) == [(9, "ni"), (18, "hao")]


def test_pinyin_timestamps_digits_spelled_out():
    # Text "25" is one numeric token -> one digit-pinyin per slot.
    intervals = [
        WordInterval(word="你好", start=0.0, end=0.9),  # 2 slots
    ]
    ts = pinyin_timestamps("25", intervals)
    assert [sym for _, sym in ts] == ["er", "wu"]


def test_word_timestamps_midpoint():
    # reference: phoneme_timestamping.py:92-107 — midpoint at fps 30.
    ts = word_timestamps(
        ["hello", "world"],
        [WordInterval("hello", 0.0, 1.0), WordInterval("world", 1.0, 2.0)],
    )
    assert list(ts) == [(15, "hello"), (45, "world")]


def test_energy_segmenter_and_full_path():
    sr = 16000
    sil = np.zeros(sr // 2, np.float32)
    tone = np.sin(2 * np.pi * 300 * np.arange(sr) / sr).astype(np.float32)
    samples = np.concatenate([sil, tone, sil])
    seg = EnergySegmenter(n_words=2)
    ivs = seg.recognize(samples, sr)
    assert len(ivs) == 2
    # Speech region is [0.5, 1.5]; intervals tile it.
    assert abs(ivs[0].start - 0.5) < 0.1
    assert abs(ivs[1].end - 1.5) < 0.1

    ts = timestamp_chinese("你好", samples, sr)
    assert [sym for _, sym in ts] == ["ni", "hao"]
    assert all(f >= 0 for f, _ in ts)
    assert list(ts) == sorted(ts, key=lambda e: e[0])


def test_timestamp_chinese_aligner_path_digits_one_to_one():
    """Forced-aligner path: every expanded symbol (digits included) gets
    exactly its own span midpoint — no symbol is dropped and none
    inherits a later span's timing. Regression: pinyin_timestamps burns
    one extra interval to step past an exhausted numeric token
    (reference quirk, pinyin_timestamping.py:112-133), which is wrong
    when the aligner provides exactly one span per emitted symbol."""
    from text2video.frontend.align_mandarin import (
        SyllableSpan,
        expand_walk_stream,
    )

    text = "我有2024个朋友"
    stream = expand_walk_stream(text)
    assert stream == [
        "wo", "you", "er", "ling", "er", "si", "ge", "peng", "you",
    ]

    class StubAligner:
        def align_text(self, samples, txt, sample_rate):
            syms = expand_walk_stream(txt)
            return [
                SyllableSpan(s, float(k), float(k + 1))
                for k, s in enumerate(syms)
            ]

    ts = timestamp_chinese(
        text, np.zeros(16000, np.float32), 16000,
        aligner=StubAligner(), fps=30.0,
    )
    assert [s for _, s in ts] == stream
    # Midpoint of span [k, k+1) at 30 fps.
    assert [f for f, _ in ts] == [int((k + 0.5) * 30 + 0.5)
                                  for k in range(len(stream))]
