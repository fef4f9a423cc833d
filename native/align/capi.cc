// C API for ctypes bindings (text2video/frontend/native.py).
//
// Memory model: feature matrices are returned as a single malloc'd
// float buffer the caller frees with t2v_free. Model handles are opaque
// pointers freed with t2v_model_free.

#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#include "feats.h"
#include "g2p.h"
#include "hmm.h"

using t2v::AcousticModel;
using t2v::FeatConfig;
using t2v::PhoneSpan;
using t2v::Trainer;

namespace {

std::vector<std::vector<float>> WrapFeats(const float* feats, int t, int d) {
  std::vector<std::vector<float>> out(t, std::vector<float>(d));
  for (int i = 0; i < t; ++i) {
    std::memcpy(out[i].data(), feats + static_cast<int64_t>(i) * d,
                d * sizeof(float));
  }
  return out;
}

struct TrainerHandle {
  AcousticModel* model;
  Trainer trainer;
  explicit TrainerHandle(AcousticModel* m) : model(m), trainer(m) {}
};

}  // namespace

extern "C" {

void t2v_free(void* p) { std::free(p); }

// ---- features ----------------------------------------------------------

// Returns 0 on success. *out is [*out_t x *out_d], caller frees.
// kind: 0 = MFCC_0_D_A_Z, 1 = PLP_0_D_A_Z (the reference aligner's
// TARGETKIND, aligner/english/16000/config:4).
int t2v_extract_features(const float* samples, int64_t num_samples,
                         int sample_rate, int kind, float** out, int* out_t,
                         int* out_d) {
  FeatConfig cfg;
  cfg.sample_rate = sample_rate;
  cfg.kind = kind == 1 ? t2v::FeatKind::kPLP : t2v::FeatKind::kMFCC;
  const auto feats = t2v::ExtractFeatures(samples, num_samples, cfg);
  const int t = static_cast<int>(feats.size());
  const int d = t2v::FeatureDim(cfg);
  *out_t = t;
  *out_d = d;
  if (t == 0) {
    *out = nullptr;
    return 0;
  }
  *out = static_cast<float*>(std::malloc(sizeof(float) * t * d));
  for (int i = 0; i < t; ++i) {
    std::memcpy(*out + static_cast<int64_t>(i) * d, feats[i].data(),
                d * sizeof(float));
  }
  return 0;
}

// ---- model lifecycle ---------------------------------------------------

void* t2v_model_load(const char* path) {
  auto* m = new AcousticModel();
  if (!m->Load(path)) {
    delete m;
    return nullptr;
  }
  return m;
}

// phone_names: newline-separated list. states_per_phone applies to all
// phones except "sp", which gets 1 state. feat_kind as in
// t2v_extract_features.
void* t2v_model_create(const char* phone_names, int dim,
                       int states_per_phone, int feat_kind) {
  auto* m = new AcousticModel();
  m->dim = dim;
  m->feat_kind = feat_kind;
  std::string names(phone_names), cur;
  for (size_t i = 0; i <= names.size(); ++i) {
    if (i == names.size() || names[i] == '\n') {
      if (!cur.empty()) {
        t2v::Phone p;
        p.name = cur;
        p.states.resize(cur == "sp" ? 1 : states_per_phone);
        m->phones.push_back(std::move(p));
      }
      cur.clear();
    } else {
      cur.push_back(names[i]);
    }
  }
  return m;
}

int t2v_model_save(void* handle, const char* path) {
  return static_cast<AcousticModel*>(handle)->Save(path) ? 0 : 1;
}

int t2v_model_feat_kind(void* handle) {
  return static_cast<AcousticModel*>(handle)->feat_kind;
}

void t2v_model_free(void* handle) {
  delete static_cast<AcousticModel*>(handle);
}

int t2v_model_dim(void* handle) {
  return static_cast<AcousticModel*>(handle)->dim;
}

int t2v_model_num_phones(void* handle) {
  return static_cast<int>(static_cast<AcousticModel*>(handle)->phones.size());
}

const char* t2v_model_phone_name(void* handle, int i) {
  return static_cast<AcousticModel*>(handle)->phones[i].name.c_str();
}

int t2v_model_phone_id(void* handle, const char* name) {
  return static_cast<AcousticModel*>(handle)->PhoneId(name);
}

// ---- alignment ---------------------------------------------------------

// feats: [t x d]. phone_ids/skippable: length n. On success writes
// starts/ends (frame indices, caller-allocated length n; skipped phones
// get start == end == -1) and returns 0.
int t2v_align(void* handle, const float* feats, int t, int d,
              const int* phone_ids, const unsigned char* skippable, int n,
              int* starts, int* ends, double* loglik) {
  auto* m = static_cast<AcousticModel*>(handle);
  if (d != m->dim) return 2;
  const auto fv = WrapFeats(feats, t, d);
  std::vector<int> ids(phone_ids, phone_ids + n);
  std::vector<unsigned char> skip(skippable, skippable + n);
  std::vector<PhoneSpan> spans;
  double ll = 0.0;
  if (!t2v::ViterbiAlign(*m, fv, ids, skip, &spans, &ll)) return 1;
  for (int i = 0; i < n; ++i) starts[i] = ends[i] = -1;
  for (const auto& sp : spans) {
    starts[sp.phone_index] = sp.start_frame;
    ends[sp.phone_index] = sp.end_frame;
  }
  if (loglik != nullptr) *loglik = ll;
  return 0;
}

// Pronunciation-variant alignment. Segments are flattened:
//   seg_n_variants[n_segments], seg_skippable[n_segments],
//   variant_lengths[sum(seg_n_variants)], phone_ids[sum(variant_lengths)].
// Outputs one record per emitted phone (skipped segments emit nothing),
// up to `cap` records; *n_out gets the count. Returns 0 on success,
// 3 if cap is too small.
int t2v_align_variants(void* handle, const float* feats, int t, int d,
                       int n_segments, const int* seg_n_variants,
                       const unsigned char* seg_skippable,
                       const int* variant_lengths, const int* phone_ids,
                       int cap, int* out_segment, int* out_variant,
                       int* out_phone_pos, int* out_phone_id, int* out_start,
                       int* out_end, int* n_out, double* loglik) {
  auto* m = static_cast<AcousticModel*>(handle);
  if (d != m->dim) return 2;
  const auto fv = WrapFeats(feats, t, d);
  std::vector<t2v::Segment> segments(n_segments);
  int vi = 0, pi = 0;
  for (int i = 0; i < n_segments; ++i) {
    segments[i].skippable = seg_skippable[i] != 0;
    for (int v = 0; v < seg_n_variants[i]; ++v, ++vi) {
      t2v::Variant var;
      var.phone_ids.assign(phone_ids + pi, phone_ids + pi + variant_lengths[vi]);
      pi += variant_lengths[vi];
      segments[i].variants.push_back(std::move(var));
    }
  }
  std::vector<t2v::AlignedPhone> phones;
  double ll = 0.0;
  if (!t2v::ViterbiAlignSegments(*m, fv, segments, &phones, nullptr, &ll)) {
    return 1;
  }
  if (static_cast<int>(phones.size()) > cap) return 3;
  *n_out = static_cast<int>(phones.size());
  for (size_t k = 0; k < phones.size(); ++k) {
    out_segment[k] = phones[k].segment;
    out_variant[k] = phones[k].variant;
    out_phone_pos[k] = phones[k].phone_pos;
    out_phone_id[k] = phones[k].phone_id;
    out_start[k] = phones[k].start_frame;
    out_end[k] = phones[k].end_frame;
  }
  if (loglik != nullptr) *loglik = ll;
  return 0;
}

// Per-frame best-path positions (for state-level timing output, the
// reference's align_english_states.py role). Same segment encoding as
// t2v_align_variants; caller allocates 4 arrays of length t.
int t2v_align_frame_states(void* handle, const float* feats, int t, int d,
                           int n_segments, const int* seg_n_variants,
                           const unsigned char* seg_skippable,
                           const int* variant_lengths, const int* phone_ids,
                           int* out_phone_id, int* out_state,
                           int* out_segment, int* out_phone_pos,
                           double* loglik) {
  auto* m = static_cast<AcousticModel*>(handle);
  if (d != m->dim) return 2;
  const auto fv = WrapFeats(feats, t, d);
  std::vector<t2v::Segment> segments(n_segments);
  int vi = 0, pi = 0;
  for (int i = 0; i < n_segments; ++i) {
    segments[i].skippable = seg_skippable[i] != 0;
    for (int v = 0; v < seg_n_variants[i]; ++v, ++vi) {
      t2v::Variant var;
      var.phone_ids.assign(phone_ids + pi, phone_ids + pi + variant_lengths[vi]);
      pi += variant_lengths[vi];
      segments[i].variants.push_back(std::move(var));
    }
  }
  std::vector<t2v::FrameState> fs;
  double ll = 0.0;
  if (!t2v::ViterbiAlignSegments(*m, fv, segments, nullptr, &fs, &ll)) {
    return 1;
  }
  for (int k = 0; k < t; ++k) {
    out_phone_id[k] = fs[k].phone_id;
    out_state[k] = fs[k].state;
    out_segment[k] = fs[k].segment;
    out_phone_pos[k] = fs[k].phone_pos;
  }
  if (loglik != nullptr) *loglik = ll;
  return 0;
}

// ---- training ----------------------------------------------------------

void* t2v_trainer_create(void* model_handle) {
  return new TrainerHandle(static_cast<AcousticModel*>(model_handle));
}

void t2v_trainer_free(void* h) { delete static_cast<TrainerHandle*>(h); }

void t2v_trainer_accumulate_global(void* h, const float* feats, int t,
                                   int d) {
  static_cast<TrainerHandle*>(h)->trainer.AccumulateGlobal(
      WrapFeats(feats, t, d));
}

void t2v_trainer_finalize_flat_start(void* h) {
  static_cast<TrainerHandle*>(h)->trainer.FinalizeFlatStart();
}

void t2v_trainer_accumulate(void* h, const float* feats, int t, int d,
                            const int* phone_ids,
                            const unsigned char* skippable, int n,
                            int uniform) {
  static_cast<TrainerHandle*>(h)->trainer.AccumulateUtterance(
      WrapFeats(feats, t, d), std::vector<int>(phone_ids, phone_ids + n),
      std::vector<unsigned char>(skippable, skippable + n), uniform != 0);
}

void t2v_trainer_update(void* h) {
  static_cast<TrainerHandle*>(h)->trainer.Update();
}

void t2v_trainer_mixup(void* h, int target_mixes) {
  static_cast<TrainerHandle*>(h)->trainer.MixUp(target_mixes);
}

// ---- G2P ---------------------------------------------------------------

// Returns a malloc'd space-separated ARPABET string; caller frees.
char* t2v_g2p(const char* word) {
  const auto phones = t2v::GraphemeToPhoneme(word);
  std::string joined;
  for (size_t i = 0; i < phones.size(); ++i) {
    if (i > 0) joined += " ";
    joined += phones[i];
  }
  char* out = static_cast<char*>(std::malloc(joined.size() + 1));
  std::memcpy(out, joined.c_str(), joined.size() + 1);
  return out;
}

}  // extern "C"
