// Rule-based English letter-to-sound (grapheme -> ARPABET phonemes).
//
// Native replacement for the role the vendored english2phoneme C tool
// played in the reference pipeline: pronouncing out-of-dictionary words
// during forced-alignment text prep (reference: aligner/align_english.py:70,
// tools/english2phoneme/). Fresh implementation of the classic
// context-sensitive rewrite-rule formalism (patterns over left context /
// target / right context) with an original, compact rule table — the
// 127k-entry CMU-style dictionary asset covers common words; these rules
// only handle the OOV tail.
#pragma once

#include <string>
#include <vector>

namespace t2v {

// word: ASCII letters (case-insensitive; non-letters are treated as
// boundaries). Returns ARPABET symbols without stress digits, e.g.
// "hello" -> {"HH", "EH", "L", "OW"}.
std::vector<std::string> GraphemeToPhoneme(const std::string& word);

}  // namespace t2v
