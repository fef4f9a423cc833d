// Acoustic feature extraction (MFCC_0_D_A_Z / PLP_0_D_A_Z class, 39-dim).
//
// Native replacement for the role HTK's HCopy played in the reference
// pipeline (reference: aligner/align_english.py:243 — 39-dim PLP_0_D_A_Z,
// 10 ms step, 25 ms Hamming window, NUMCHANS 20, LPCORDER 12, USEPOWER
// per aligner/english/16000/config). Fresh implementation: framing +
// Hamming + radix-2 FFT + mel filterbank, then either DCT cepstra (MFCC)
// or the PLP chain (equal-loudness weighting + cube-root compression +
// inverse cosine transform to autocorrelation + Levinson-Durbin LPC +
// LPC-to-cepstra + liftering), plus delta/delta-delta and cepstral mean
// normalisation.
#pragma once

#include <cstdint>
#include <vector>

namespace t2v {

enum class FeatKind { kMFCC = 0, kPLP = 1 };

struct FeatConfig {
  int sample_rate = 16000;
  float frame_shift_s = 0.010f;   // TARGETRATE 100000 (100ns units)
  float frame_len_s = 0.025f;     // WINDOWSIZE 250000
  int num_mel = 26;               // PLP uses 20 (NUMCHANS = 20)
  int num_ceps = 13;              // c0..c12 ("_0")
  float preemph = 0.97f;
  bool cmn = true;                // "_Z"
  FeatKind kind = FeatKind::kMFCC;
  int lpc_order = 12;             // LPCORDER (PLP only)
  float compress = 0.33f;         // PLP intensity-loudness power law
  int ceplifter = 22;             // HTK CEPLIFTER (PLP only)
};

// samples: mono PCM in [-1, 1]. Returns [num_frames][39] features
// (statics + deltas + delta-deltas).
std::vector<std::vector<float>> ExtractFeatures(const float* samples,
                                                int64_t num_samples,
                                                const FeatConfig& cfg);

int FeatureDim(const FeatConfig& cfg);  // 3 * num_ceps

}  // namespace t2v
