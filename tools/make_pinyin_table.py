"""Generate the full hanzi -> toneless-pinyin data table.

The reference converts arbitrary Mandarin text with pypinyin's
``lazy_pinyin`` (reference: pinyin_timestamping.py:42), whose readings
derive from the Unihan kMandarin database. pypinyin is not in this
environment; its Unihan-derived *data* tables ship inside the reference's
vendored venv as auto-generated files (pinyin_dict.py: codepoint ->
comma-separated tonal readings; phrases_dict.py: phrase -> per-char
readings). This tool distills them into two compact data files committed
under text2video/data/:

  * pinyin_table.tsv  — ``<char>\t<toneless pinyin>`` (first reading),
    loaded by frontend/pinyin.load_table.
  * pinyin_phrases.tsv — ``<phrase>\t<syl1 syl2 ...>`` for only those
    phrases whose toneless reading differs from the per-char table
    (polyphone disambiguation, e.g. 了/地/得), loaded by
    frontend/pinyin.load_phrases.

Tone marks strip by Unicode NFD decomposition; ``ü`` becomes ``v``
(pypinyin NORMAL-style convention, matching dict_henan.txt's lv/lve).
"""

from __future__ import annotations

import argparse
import ast
import os
import re
import unicodedata

DEFAULT_SRC = (
    "/root/reference/venv_vid2vid/lib/python3.7/site-packages/pypinyin"
)
OUT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "text2video",
    "data",
)


def strip_tone(syllable: str) -> str:
    """'zhōng' -> 'zhong', 'lǜ' -> 'lv', 'ê̄' -> 'e'."""
    out = []
    for ch in unicodedata.normalize("NFD", syllable):
        if unicodedata.category(ch) == "Mn":  # combining tone mark
            continue
        out.append("v" if ch == "ü" else ch)
    s = "".join(out)
    # pypinyin writes ü as u-with-diaeresis pre-composed in some entries;
    # NFD already split it. Also normalize the rare 'ê' -> 'e' (done by
    # NFD) and m̀/ń interjections keep their base letter.
    return s


def _literal_dict(path: str, name: str) -> dict:
    """Parse ``name = {...}`` out of an auto-generated data module
    without importing it (the venv targets python 3.7)."""
    text = open(path, encoding="utf-8").read()
    m = re.search(rf"{name}\s*=\s*\{{", text)
    if not m:
        raise ValueError(f"no dict literal {name!r} in {path}")
    return ast.literal_eval(text[m.end() - 1 :].rsplit("}", 1)[0] + "}")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=DEFAULT_SRC)
    ap.add_argument("--out", default=OUT_DIR)
    args = ap.parse_args()

    char_dict = _literal_dict(
        os.path.join(args.src, "pinyin_dict.py"), "pinyin_dict"
    )
    table = {}
    for cp, readings in sorted(char_dict.items()):
        first = readings.split(",")[0].strip()
        if first:
            table[chr(cp)] = strip_tone(first)

    os.makedirs(args.out, exist_ok=True)
    table_path = os.path.join(args.out, "pinyin_table.tsv")
    with open(table_path, "w", encoding="utf-8") as f:
        for ch, py in table.items():
            f.write(f"{ch}\t{py}\n")
    print(f"wrote {len(table)} chars -> {table_path}")

    phrase_dict = _literal_dict(
        os.path.join(args.src, "phrases_dict.py"), "phrases_dict"
    )
    kept = {}
    for phrase, readings in phrase_dict.items():
        syls = [strip_tone(r[0]) for r in readings]
        default = [table.get(c, c) for c in phrase]
        if syls != default:
            kept[phrase] = syls
    phrase_path = os.path.join(args.out, "pinyin_phrases.tsv")
    with open(phrase_path, "w", encoding="utf-8") as f:
        for phrase in sorted(kept):
            f.write(f"{phrase}\t{' '.join(kept[phrase])}\n")
    print(
        f"wrote {len(kept)} disambiguating phrases "
        f"(of {len(phrase_dict)}) -> {phrase_path}"
    )


if __name__ == "__main__":
    main()
