// Monophone diagonal-GMM HMMs + Viterbi forced alignment + flat-start
// Viterbi training.
//
// Native replacement for the role HTK's HVite (-a -m forced alignment;
// reference: aligner/align_english.py:251, HTKLib/HRec.c token passing)
// and HERest played. The reference's acoustic models (hmmdefs) are
// stripped from its mirror, so this library also trains its own models
// from a recording + transcript (flat start -> Viterbi re-estimation ->
// mixture splitting), replacing the P2FA model dependency.
//
// Fresh design, not a port: a phone is a fixed 3-emitting-state
// left-to-right HMM (1 state for short-pause "sp", which is also
// skippable); alignment expands the phone sequence into a linear state
// lattice and runs log-domain Viterbi with backtracking.
#pragma once

#include <string>
#include <vector>

namespace t2v {

struct Gaussian {
  std::vector<float> mean;
  std::vector<float> inv_var;   // 1 / sigma^2
  float log_weight = 0.0f;
  float gconst = 0.0f;          // -0.5 * (D*log(2pi) + sum(log var))

  void Finalize();              // recompute gconst from inv_var
  float LogLik(const float* x, int dim) const;
};

struct State {
  std::vector<Gaussian> mix;
  float self_loop_logp = 0.0f;  // log P(stay)
  float forward_logp = 0.0f;    // log P(advance)

  float LogLik(const float* x, int dim) const;
};

struct Phone {
  std::string name;
  std::vector<State> states;    // 3 emitting states (1 for "sp")
};

struct PhoneSpan {
  int phone_index;              // index into the alignment's phone sequence
  int start_frame;              // inclusive
  int end_frame;                // exclusive
};

// Pronunciation-variant alignment: the utterance is a chain of segments
// (sil / word / optional sp); a word segment may carry several
// pronunciation variants (parallel paths in the decoding lattice, like
// HVite's dictionary alternatives — the best-scoring variant wins).
struct Variant {
  std::vector<int> phone_ids;
};

struct Segment {
  std::vector<Variant> variants;
  bool skippable = false;
};

struct AlignedPhone {
  int segment = 0;
  int variant = 0;     // chosen pronunciation
  int phone_pos = 0;   // position within the variant
  int phone_id = 0;    // model phone
  int start_frame = 0; // inclusive
  int end_frame = 0;   // exclusive
};

// frame -> position on the best path, for training and state-level
// timing output.
struct FrameState {
  int phone_id = 0;
  int state = 0;      // emitting-state index within the phone
  int segment = 0;    // segment index in the alignment request
  int phone_pos = 0;  // phone position within the chosen variant
};

class AcousticModel {
 public:
  int dim = 0;
  // Feature kind the model was trained on (FeatKind: 0 = MFCC, 1 = PLP);
  // stored in the model file so alignment always extracts matching
  // features (format v2; v1 files load as MFCC).
  int feat_kind = 0;
  std::vector<Phone> phones;

  int PhoneId(const std::string& name) const;  // -1 if absent

  bool Save(const std::string& path) const;
  bool Load(const std::string& path);
};

bool ViterbiAlignSegments(const AcousticModel& model,
                          const std::vector<std::vector<float>>& feats,
                          const std::vector<Segment>& segments,
                          std::vector<AlignedPhone>* phones,
                          std::vector<FrameState>* frame_states,
                          double* loglik);

// Forced alignment of feats [T][dim] against a phone-id sequence.
// skippable[i] != 0 lets phone i be deleted entirely (tee model, used for
// the optional "sp" between words). Returns true on success; spans gets
// one entry per *emitted* phone (skipped phones are omitted), in order.
bool ViterbiAlign(const AcousticModel& model,
                  const std::vector<std::vector<float>>& feats,
                  const std::vector<int>& phone_ids,
                  const std::vector<unsigned char>& skippable,
                  std::vector<PhoneSpan>* spans, double* loglik);

// ---- Training ----------------------------------------------------------

class Trainer {
 public:
  explicit Trainer(AcousticModel* model);

  // Flat start: set every state of every phone to the global mean/var of
  // the supplied features (call once with each utterance, then
  // FinalizeFlatStart).
  void AccumulateGlobal(const std::vector<std::vector<float>>& feats);
  void FinalizeFlatStart();

  // One Viterbi-training pass: align (uniform segmentation on the first
  // pass, Viterbi afterwards), hard-assign frames to states, accumulate.
  void AccumulateUtterance(const std::vector<std::vector<float>>& feats,
                           const std::vector<int>& phone_ids,
                           const std::vector<unsigned char>& skippable,
                           bool uniform_first_pass);
  // Update model params from accumulators and reset them.
  void Update();

  // Double the mixture count of every state (split each component,
  // perturbing means by +-0.2 sigma), up to target_mixes.
  void MixUp(int target_mixes);

 private:
  AcousticModel* model_;
  // Per phone, per state: [count, sum[dim], sumsq[dim]] per mixture.
  struct Acc {
    double count = 0.0;
    std::vector<double> sum, sumsq;
    double self_loops = 0.0, forwards = 0.0;
  };
  std::vector<std::vector<std::vector<Acc>>> acc_;  // [phone][state][mix]
  std::vector<double> global_sum_, global_sumsq_;
  double global_count_ = 0.0;
  void EnsureAcc();
  int BestMix(const State& st, const float* x) const;
};

}  // namespace t2v
