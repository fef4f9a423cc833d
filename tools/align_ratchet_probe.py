#!/usr/bin/env python3
"""Probe the residual golden frame error of the English aligner.

VERDICT r3 item 7: mean frame error vs the reference's shipped golden
timestamps is 0.29 (Dotheymake) / 0.62 (Shehadyour); investigate whether
the residual is the supervised word-span convention or model capacity,
then ratchet tests/test_align.py. This script trains the packaged-model
recipe (tools/make_english_model.py) under swept knobs and prints the
per-golden mean/max frame error as JSON lines.

  python tools/align_ratchet_probe.py --iterations 16 --mixes 4
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# Goldens with BOTH a phones file and a scoreable recording (Thewaytoge
# ships no audio; Don'taskme ships no phones file — it still trains,
# words-only supervised).
GOLDENS = ["Dotheymake", "Shehadyour", "sheslipped", "itsuffersf"]
TRAIN_ONLY = ["Don'taskme"]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iterations", type=int, default=16)
    ap.add_argument("--mixes", type=int, default=4)
    ap.add_argument("--feat", choices=["mfcc", "plp"], default="mfcc")
    ap.add_argument("--save", default="")
    ap.add_argument("--load", default="",
                    help="score an existing .am instead of training")
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")

    import numpy as np

    from text2video.config import data_root
    from text2video.frontend import native
    from text2video.frontend.align_english import (
        EnglishAligner,
        PronouncingDict,
        load_word_spans,
        train_acoustic_model,
    )
    from text2video.frontend.audio import load_wav_for_alignment

    ref = data_root()
    pdict = PronouncingDict.load(f"{ref}/aligner/english/dict")

    def words_of(path):
        return " ".join(
            p[2] for p in (l.split() for l in open(path))
            if len(p) == 3 and p[2] != "SIL"
        )

    # Which recording each golden timestamp file tracks (established in
    # round 2: itsuffersf's golden tracks input_audio_real).
    golden_wav = {
        "Dotheymake": f"{ref}/input_audio/fadg0/Dotheymake.wav",
        "Shehadyour": f"{ref}/input_audio/fadg0/Shehadyour.wav",
        "Don'taskme": f"{ref}/input_audio/fadg0/Don'taskme.wav",
        "sheslipped": f"{ref}/input_audio/fadg0/sheslipped.wav",
        "itsuffersf": f"{ref}/input_audio_real/fadg0/itsuffersf.wav",
        "Don'taskme": f"{ref}/input_audio/fadg0/Don'taskme.wav",
    }

    utts, spans = [], []
    for n in GOLDENS + TRAIN_ONLY:
        utts.append((
            load_wav_for_alignment(golden_wav[n]),
            words_of(f"{ref}/input_timestamp/fadg0/words/{n}.txt"),
        ))
        spans.append(load_word_spans(
            f"{ref}/input_timestamp/fadg0/words/{n}.txt",
            f"{ref}/input_timestamp/fadg0/phones/{n}.txt",
        ))
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

    if args.load:
        model = native.AcousticModel.load(args.load)
        report = {"load": args.load}
    else:
        feat_kind = (native.FEAT_MFCC if args.feat == "mfcc"
                     else native.FEAT_PLP)
        model = train_acoustic_model(
            utts, pdict, iterations=args.iterations,
            target_mixes=args.mixes, word_spans=spans,
            feat_kind=feat_kind, save_path=args.save or None,
        )
        report = {"iterations": args.iterations, "mixes": args.mixes,
                  "feat": args.feat}
    aligner = EnglishAligner(model, pdict)
    worst_mean, worst_max = 0.0, 0
    for n in GOLDENS:
        path = f"{ref}/input_timestamp/fadg0/phones/{n}.txt"
        golden = [(int(a), b) for a, b in (l.split() for l in open(path))
                  if b != "sp"]
        samples = load_wav_for_alignment(golden_wav[n])
        text = words_of(f"{ref}/input_timestamp/fadg0/words/{n}.txt")
        ours = [(f, p) for f, p in aligner.align(samples, text).phones
                if p != "sp"]
        if [p for _, p in golden] != [p for _, p in ours]:
            report[n] = {"phones": "MISMATCH",
                         "golden": [p for _, p in golden],
                         "ours": [p for _, p in ours]}
            worst_mean, worst_max = 99.0, 99
            continue
        err = [abs(f1 - f2) for (f1, _), (f2, _) in zip(golden, ours)]
        report[n] = {
            "mean": round(float(np.mean(err)), 3),
            "max": int(max(err)),
            "n_off": int(sum(e > 1 for e in err)),
            "n": len(err),
        }
        worst_mean = max(worst_mean, float(np.mean(err)))
        worst_max = max(worst_max, max(err))
    report["worst_mean"] = round(worst_mean, 3)
    report["worst_max"] = int(worst_max)
    print(json.dumps(report))


if __name__ == "__main__":
    main()
