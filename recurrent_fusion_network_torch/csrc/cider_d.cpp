// Native CIDEr-D reward scorer of the SCST step (host code, not a GPU
// kernel).
//
// The port's copy of recurrent_fusion_network_tpu/rewards/native/cider_d.cpp:
// hashed-ngram tf-idf vectors, clipped cosine similarity, Gaussian length
// penalty, the same math as the NumPy engine in ../rewards/cider_d.py (which
// matches the reference's cider/pyciderevalcap/ciderD/ciderD_scorer.py).
//
// Exposed through a C ABI loaded with ctypes. Token sequences arrive as flat
// int32 arrays + offsets; n-grams are hashed into int64 keys exactly like the
// Python side (base 2^15, order tag in the high bits) so both engines share
// the same document-frequency table.
//
// Built at first use by ../rewards/native.py into build/native/libciderd.so
// under the checkout root:
//   g++ -O3 -ffp-contract=off -shared -fPIC -std=c++17 -pthread \
//       cider_d.cpp -o libciderd.so

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

constexpr int64_t kKeyBase = int64_t(1) << 15;
constexpr int64_t kNTag = int64_t(1) << 60;

struct Ctx {
  std::unordered_map<int64_t, double> log_df;  // log(max(1, df))
  double ref_len = 0.0;
  int n_max = 4;
  double sigma = 6.0;
};

// sorted sparse vector for one n-gram order
struct NVec {
  std::vector<int64_t> keys;
  std::vector<double> w;
  double norm = 0.0;
};

struct SentVec {
  std::vector<NVec> per_n;
  int64_t length = 0;  // bigram count (the reference's 'length' quirk)
};

// tokens up to and including the first 0 (array_to_str semantics)
static size_t trim_with_eos(const int32_t* tok, size_t len) {
  for (size_t i = 0; i < len; ++i)
    if (tok[i] == 0) return i + 1;
  return len;
}

static SentVec make_vec(const Ctx& ctx, const int32_t* tok, size_t len_raw) {
  SentVec sv;
  sv.per_n.resize(ctx.n_max);
  size_t len = trim_with_eos(tok, len_raw);
  // count n-grams
  std::unordered_map<int64_t, int> counts;
  for (int n = 1; n <= ctx.n_max; ++n) {
    counts.clear();
    if (len + 1 > size_t(n)) {
      for (size_t i = 0; i + n <= len; ++i) {
        int64_t key = 0;
        for (int j = 0; j < n; ++j) key = key * kKeyBase + tok[i + j];
        key += kNTag * n;
        ++counts[key];
      }
    }
    if (n == 2) sv.length = int64_t(len >= 2 ? len - 1 : 0);
    NVec& v = sv.per_n[n - 1];
    v.keys.reserve(counts.size());
    v.w.reserve(counts.size());
    std::vector<std::pair<int64_t, int>> items(counts.begin(), counts.end());
    std::sort(items.begin(), items.end());
    double norm2 = 0.0;
    for (auto& kv : items) {
      auto it = ctx.log_df.find(kv.first);
      double ldf = it == ctx.log_df.end() ? 0.0 : it->second;
      double w = double(kv.second) * (ctx.ref_len - ldf);
      v.keys.push_back(kv.first);
      v.w.push_back(w);
      norm2 += w * w;
    }
    v.norm = std::sqrt(norm2);
  }
  return sv;
}

static double sim(const Ctx& ctx, const SentVec& h, const SentVec& r) {
  double val = 0.0;
  for (int n = 0; n < ctx.n_max; ++n) {
    const NVec& hv = h.per_n[n];
    const NVec& rv = r.per_n[n];
    if (hv.norm == 0.0 || rv.norm == 0.0) continue;
    double acc = 0.0;
    size_t i = 0, j = 0;  // sorted-merge intersection
    while (i < hv.keys.size() && j < rv.keys.size()) {
      if (hv.keys[i] < rv.keys[j]) {
        ++i;
      } else if (rv.keys[j] < hv.keys[i]) {
        ++j;
      } else {
        acc += std::min(hv.w[i], rv.w[j]) * rv.w[j];  // CIDEr-D clipping
        ++i;
        ++j;
      }
    }
    val += acc / (hv.norm * rv.norm);
  }
  double delta = double(h.length - r.length);
  return val * std::exp(-(delta * delta) / (2.0 * ctx.sigma * ctx.sigma));
}

}  // namespace

extern "C" {

void* cider_init(const int64_t* keys, const double* log_df, int64_t n,
                 double ref_len, int n_max, double sigma) {
  Ctx* ctx = new Ctx;
  ctx->log_df.reserve(size_t(n) * 2);
  for (int64_t i = 0; i < n; ++i) ctx->log_df.emplace(keys[i], log_df[i]);
  ctx->ref_len = ref_len;
  ctx->n_max = n_max;
  ctx->sigma = sigma;
  return ctx;
}

void cider_free(void* p) { delete static_cast<Ctx*>(p); }

// hyp_tok/hyp_off: n_hyp sentences, sentence i = hyp_tok[hyp_off[i]..hyp_off[i+1])
// ref_tok/ref_off: n_ref reference sentences, flat
// group_off: n_group+1 offsets into the reference list (refs of group g =
//            ref indices [group_off[g], group_off[g+1]))
// hyp_group: group index per hypothesis
void cider_score(void* p, const int32_t* hyp_tok, const int64_t* hyp_off,
                 int64_t n_hyp, const int32_t* ref_tok, const int64_t* ref_off,
                 int64_t n_ref, const int64_t* group_off, int64_t n_group,
                 const int64_t* hyp_group, double* out, int n_threads) {
  const Ctx& ctx = *static_cast<Ctx*>(p);

  // reference vectors once per distinct sentence
  std::vector<SentVec> ref_vecs{};
  ref_vecs.resize(size_t(n_ref));
  auto build_refs = [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i)
      ref_vecs[size_t(i)] = make_vec(ctx, ref_tok + ref_off[i],
                                     size_t(ref_off[i + 1] - ref_off[i]));
  };
  auto score_hyps = [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      SentVec hv = make_vec(ctx, hyp_tok + hyp_off[i],
                            size_t(hyp_off[i + 1] - hyp_off[i]));
      int64_t g = hyp_group[i];
      int64_t r0 = group_off[g], r1 = group_off[g + 1];
      double total = 0.0;
      for (int64_t r = r0; r < r1; ++r) total += sim(ctx, hv, ref_vecs[size_t(r)]);
      out[i] = total / double(ctx.n_max) / double(r1 - r0) * 10.0;
    }
  };

  if (n_threads <= 1) {
    build_refs(0, n_ref);
    score_hyps(0, n_hyp);
    return;
  }
  auto run_parallel = [&](auto fn, int64_t n) {
    std::vector<std::thread> ts;
    int64_t chunk = (n + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; ++t) {
      int64_t lo = t * chunk, hi = std::min(n, lo + chunk);
      if (lo >= hi) break;
      ts.emplace_back(fn, lo, hi);
    }
    for (auto& t : ts) t.join();
  };
  run_parallel(build_refs, n_ref);
  run_parallel(score_hyps, n_hyp);
}

}  // extern "C"
