#!/usr/bin/env python3
"""Build the packaged English fadg0 acoustic model
(text2video/data/english_fadg0.am — the CLI's no-flag default).

Recipe: flat-start monophone training on every available fadg0
recording, with word-boundary + pronunciation-variant supervision from
the reference's shipped timestamp outputs
(frontend/align_english.py::load_word_spans — the reference's
corpus-trained P2FA models are stripped from its mirror, but their
word/phone outputs for five utterances ARE shipped, and supervised
segments recover their segmentation convention). Measured on the golden
utterances (tools/align_ratchet_probe.py; tests/test_align.py ratchets
these): mean frame error 0.286 (Dotheymake) / 0.618 (Shehadyour) /
0.371 (sheslipped) vs 3.76 unsupervised. The residual is symmetric
+-1-frame boundary disagreement that no capacity knob moves (sweep over
iterations x mixes x feature kind is flat at this floor) plus two
off-by-3 nasal-closure boundaries in Shehadyour — supervision
convention, not model capacity.

  python tools/make_english_model.py [--out text2video/data/english_fadg0.am]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument(
        "--out",
        default=os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            "text2video", "data", "english_fadg0.am",
        ),
    )
    ap.add_argument("--iterations", type=int, default=32)
    ap.add_argument("--mixes", type=int, default=4)
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")

    from text2video.config import data_root
    from text2video.frontend.align_english import (
        PronouncingDict,
        load_word_spans,
        train_acoustic_model,
    )
    from text2video.frontend.audio import load_wav_for_alignment

    ref = data_root()
    pdict = PronouncingDict.load(f"{ref}/aligner/english/dict")

    def words_of(path):
        return " ".join(
            p[2]
            for p in (l.split() for l in open(path))
            if len(p) == 3 and p[2] != "SIL"
        )

    utts, spans = [], []
    # Supervised: the goldens track the input_audio recordings for
    # these four; itsuffersf's golden tracks the real-audio recording.
    for n in ["Shehadyour", "Dotheymake", "Don'taskme", "sheslipped"]:
        utts.append((
            load_wav_for_alignment(f"{ref}/input_audio/fadg0/{n}.wav"),
            words_of(f"{ref}/input_timestamp/fadg0/words/{n}.txt"),
        ))
        spans.append(load_word_spans(
            f"{ref}/input_timestamp/fadg0/words/{n}.txt",
            f"{ref}/input_timestamp/fadg0/phones/{n}.txt",
        ))
    utts.append((
        load_wav_for_alignment(f"{ref}/input_audio_real/fadg0/itsuffersf.wav"),
        words_of(f"{ref}/input_timestamp/fadg0/words/itsuffersf.txt"),
    ))
    spans.append(load_word_spans(
        f"{ref}/input_timestamp/fadg0/words/itsuffersf.txt",
        f"{ref}/input_timestamp/fadg0/phones/itsuffersf.txt",
    ))
    # Unsupervised extra recordings of the same voice.
    sa1 = "She had your dark suit in greasy wash water all year"
    sa2 = "Don't ask me to carry an oily rag like that"
    extra = [
        (f"{ref}/input_audio_real/fadg0/Shehadyour.wav",
         words_of(f"{ref}/input_timestamp/fadg0/words/Shehadyour.txt")),
        (f"{ref}/input_audio/fadg0/itsuffersf.wav",
         words_of(f"{ref}/input_timestamp/fadg0/words/itsuffersf.txt")),
        (f"{ref}/*phoneme_data/VidTIMIT/fadg0/audio/sa1.wav", sa1),
        (f"{ref}/*phoneme_data/VidTIMIT/fadg0/audio/sa2.wav", sa2),
        (f"{ref}/input_audio/fadg0/Shehadyour (Sibo-Zhangs-MacBook-Pro."
         "local's conflicted copy 2021-04-07).wav", sa1),
    ]
    for wav, text in extra:
        utts.append((load_wav_for_alignment(wav), text))
        spans.append(None)

    train_acoustic_model(
        utts, pdict,
        iterations=args.iterations,
        target_mixes=args.mixes,
        word_spans=spans,
        save_path=args.out,
    )
    print(f"wrote {args.out} ({len(utts)} utterances, "
          f"{sum(s is not None for s in spans)} supervised)")


if __name__ == "__main__":
    main()
