// Native host runtime for rawalign-tpu.
//
// The device (GPU) owns the mapping compute path; this library owns the
// host-side sequential hot loops that feed it:
//   * plain-mode sketching for the index build (the adjacent-similar
//     suppression + rolling pack are sequential over a whole genome's
//     expected signal, reference: src/rsketch.c:223-274);
//   * minimizer-mode sketching (reference: src/rsketch.c:146-221);
//   * event-detector peak finding for the host/golden path
//     (reference: src/revent.c:77-138).
//
// All functions are re-implementations matching the semantics of this
// repo's Python golden model (rawalign_tpu/golden/), which is itself
// oracle-tested; they are exposed via ctypes (see rawalign_tpu/native.py).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

constexpr float kLastSigDiff = 0.3f;
constexpr float kMaskSignal = 3.402823466e+32F;

inline uint64_t hash_masked(uint64_t key, uint64_t mask) {
  key = (~key + (key << 21)) & mask;
  key = key ^ (key >> 24);
  key = (key + (key << 3) + (key << 8)) & mask;
  key = key ^ (key >> 14);
  key = (key + (key << 2) + (key << 4)) & mask;
  key = key ^ (key >> 28);
  key = (key + (key << 31)) & mask;
  return key;
}

inline uint32_t quantize(float v, int q, int lq) {
  uint32_t bits;
  std::memcpy(&bits, &v, sizeof(bits));
  const uint32_t mask_lq = (1u << lq) - 1u;
  return ((bits >> 30) << lq) | ((bits >> (32 - q)) & mask_lq);
}

}  // namespace

extern "C" {

// Sequential double left-fold of sum(v) and sum(v*v) over float values —
// the reference's per-sequence z-norm accumulation (rsig.cpp:12,28-35:
// `sum += curval; sum2 += curval*curval;` with double accumulators).
// NumPy's pairwise summation rounds differently in the low bits, which
// shifts mean/stddev by ~1 ulp and flips a handful of normalized float32
// signal values per megabase — invisible in mapping decisions but visible
// in the --dtw-output-cigar per-element difference column.
void ra_znorm_sums(const float* v, int64_t n, double* out_sum,
                   double* out_sum2) {
  double s = 0.0, s2 = 0.0;
  for (int64_t i = 0; i < n; ++i) {
    const double c = (double)v[i];
    s += c;
    s2 += c * c;
  }
  *out_sum = s;
  *out_sum2 = s2;
}

// Gather pore-model values for a k-mer code array (the 50Mb
// reference-signal fill: numpy fancy indexing + astype paid two full
// passes and an extra copy — measured 2.9s per strand there).
void ra_pore_gather(const int32_t* kmers, int64_t n, const float* pore,
                    float* out) {
  for (int64_t i = 0; i < n; ++i) out[i] = pore[kmers[i]];
}

// In-place z-normalize with the reference's exact arithmetic
// (rsig.cpp:37-38: double (v - mean) / std, one rounding to float at
// the store). NumPy promotes the whole array to float64 for this
// (three full 400MB passes at 50Mb); this is one pass.
void ra_znorm_apply(float* v, int64_t n, double mean, double std_dev) {
  for (int64_t i = 0; i < n; ++i)
    v[i] = (float)(((double)v[i] - mean) / std_dev);
}

// Pack (hash << 32 | ps) seed keys in one pass (the numpy widen+shift+or
// chain makes three full u64 passes — ~4s per strand at 50Mb).
void ra_pack_seeds(const uint32_t* h, const uint32_t* ps, int64_t n,
                   uint64_t* out) {
  for (int64_t i = 0; i < n; ++i)
    out[i] = ((uint64_t)h[i] << 32) | (uint64_t)ps[i];
}

// Plain-mode sketch: emits one seed per kept event once e events are
// packed. Outputs hash (32-bit) and event index arrays; returns the seed
// count. Output buffers must hold at least n entries.
int64_t ra_sketch_reg(const float* values, int64_t n, int e, int q, int lq,
                      uint32_t* out_hash, int64_t* out_pos) {
  const int quant_bit = lq + 2;
  const int nbits = quant_bit * e;
  const uint64_t mask_events =
      nbits >= 64 ? ~0ULL : ((1ULL << nbits) - 1ULL);
  const uint64_t mask32 = 0xFFFFFFFFULL;
  uint64_t acc = 0;
  int64_t last = 0;
  int kept = 0;
  int64_t out = 0;
  for (int64_t i = 0; i < n; ++i) {
    const float v = values[i];
    if ((i > 0 && std::fabs(v - values[last]) < kLastSigDiff) ||
        v == kMaskSignal)
      continue;
    last = i;
    acc = ((acc << quant_bit) | quantize(v, q, lq)) & mask_events;
    if (++kept < e) continue;
    out_hash[out] = (uint32_t)hash_masked(acc, mask32);
    out_pos[out] = i;
    ++out;
  }
  return out;
}

// Minimizer-mode sketch (w-window minimum over packed-hash seeds, with
// duplicate-minimum emission), matching golden sketch_min. Position
// reported is the OLDEST event of the e-window. Output buffers must hold
// at least n entries.
int64_t ra_sketch_min(const float* values, int64_t n, int w, int e, int q,
                      int lq, uint32_t* out_hash, int64_t* out_pos) {
  const int quant_bit = lq + 2;
  const int nbits = quant_bit * e;
  const uint64_t mask_events =
      nbits >= 64 ? ~0ULL : ((1ULL << nbits) - 1ULL);
  const uint64_t mask32 = 0xFFFFFFFFULL;
  const uint64_t kInvalid = ~0ULL;

  // buf entries: (hash, pos); sig_buf mirrors the reference's e-slot ring
  uint64_t* buf_h = new uint64_t[w];
  int64_t* buf_p = new int64_t[w];
  for (int j = 0; j < w; ++j) {
    buf_h[j] = kInvalid;
    buf_p[j] = -1;
  }
  uint64_t* sig_h = new uint64_t[e]();
  int64_t* sig_p = new int64_t[e]();

  uint64_t acc = 0;
  int64_t last = 0;
  int64_t l = 0;
  int buf_pos = 0, min_pos = 0, sig_pos = 0;
  bool sig_full = false;
  uint64_t min_h = kInvalid;
  int64_t min_p = -1;
  int64_t out = 0;

  auto emit = [&](uint64_t h, int64_t p) {
    out_hash[out] = (uint32_t)(h);
    out_pos[out] = p;
    ++out;
  };

  for (int64_t i = 0; i < n; ++i) {
    const float v = values[i];
    if (i > 0 && std::fabs(v - values[last]) < kLastSigDiff) continue;
    ++l;
    last = i;
    acc = ((acc << quant_bit) | quantize(v, q, lq)) & mask_events;

    sig_p[sig_pos] = i;
    if (++sig_pos == e) {
      sig_full = true;
      sig_pos = 0;
    }
    sig_h[sig_pos] = hash_masked(acc, mask32);

    if (!sig_full) continue;

    const uint64_t info_h = sig_h[sig_pos];
    const int64_t info_p = sig_p[sig_pos];
    buf_h[buf_pos] = info_h;
    buf_p[buf_pos] = info_p;
    if (l == w + e - 1 && min_h != kInvalid) {
      for (int j = buf_pos + 1; j < w; ++j)
        if (min_h == buf_h[j] && buf_p[j] != min_p) emit(buf_h[j], buf_p[j]);
      for (int j = 0; j < buf_pos; ++j)
        if (min_h == buf_h[j] && buf_p[j] != min_p) emit(buf_h[j], buf_p[j]);
    }
    if (info_h <= min_h) {
      if (l >= w + e && min_h != kInvalid) emit(min_h, min_p);
      min_h = info_h;
      min_p = info_p;
      min_pos = buf_pos;
    } else if (buf_pos == min_pos) {
      if (l >= w + e - 1 && min_h != kInvalid) emit(min_h, min_p);
      min_h = kInvalid;
      for (int j = buf_pos + 1; j < w; ++j)
        if (min_h >= buf_h[j]) { min_h = buf_h[j]; min_p = buf_p[j]; min_pos = j; }
      for (int j = 0; j <= buf_pos; ++j)
        if (min_h >= buf_h[j]) { min_h = buf_h[j]; min_p = buf_p[j]; min_pos = j; }
      if (l >= w + e - 1 && min_h != kInvalid) {
        for (int j = buf_pos + 1; j < w; ++j)
          if (min_h == buf_h[j] && min_p != buf_p[j]) emit(buf_h[j], buf_p[j]);
        for (int j = 0; j <= buf_pos; ++j)
          if (min_h == buf_h[j] && min_p != buf_p[j]) emit(buf_h[j], buf_p[j]);
      }
    }
    if (++buf_pos == w) buf_pos = 0;
  }
  if (min_h != kInvalid) emit(min_h, min_p);

  delete[] buf_h;
  delete[] buf_p;
  delete[] sig_h;
  delete[] sig_p;
  return out;
}

// Dual-detector peak finding over precomputed t-statistics. Returns the
// number of peaks written to out_peaks (buffer size >= n).
int64_t ra_gen_peaks(const float* t1, const float* t2, int64_t n,
                     float threshold1, float threshold2, int w1, int w2,
                     float peak_height, uint32_t* out_peaks) {
  const float kFltMax = std::numeric_limits<float>::max();
  const float* sig[2] = {t1, t2};
  const float thr[2] = {threshold1, threshold2};
  const int win[2] = {w1, w2};
  int64_t masked_to[2] = {0, 0};
  int64_t peak_pos[2] = {-1, -1};
  float peak_value[2] = {kFltMax, kFltMax};
  bool valid_peak[2] = {false, false};
  int64_t out = 0;

  for (int64_t i = 0; i < n; ++i) {
    for (int k = 0; k < 2; ++k) {
      if (masked_to[k] >= i) continue;
      const float cv = sig[k][i];
      if (peak_pos[k] == -1) {
        if (cv < peak_value[k]) {
          peak_value[k] = cv;
        } else if (cv - peak_value[k] > peak_height) {
          peak_value[k] = cv;
          peak_pos[k] = i;
        }
      } else {
        if (cv > peak_value[k]) {
          peak_value[k] = cv;
          peak_pos[k] = i;
        }
        if (k == 0 && peak_value[0] > thr[0]) {
          masked_to[1] = peak_pos[0] + win[0];
          peak_pos[1] = -1;
          peak_value[1] = kFltMax;
          valid_peak[1] = false;
        }
        if (peak_value[k] - cv > peak_height && peak_value[k] > thr[k])
          valid_peak[k] = true;
        if (valid_peak[k] && (i - peak_pos[k]) > win[k] / 2) {
          out_peaks[out++] = (uint32_t)peak_pos[k];
          peak_pos[k] = -1;
          peak_value[k] = cv;
          valid_peak[k] = false;
        }
      }
    }
  }
  return out;
}

// Banded DTW with the production anti-diagonal slanted-band geometry
// (dtw.cpp:273-520 semantics; same cell set and operand triples as the
// device kernel and the oracle-validated golden model). Evaluated
// row-major over per-row band bounds derived from the anti-diagonal
// sweep — identical float results, simpler traversal. Used as the host
// fallback for tiles too large for the device kernel's memory budget.
// a/b may be passed in either order; swaps internally so a is longer.
float ra_dtw_banded(const float* a, int64_t n0, const float* b, int64_t m0,
                    int radius, int exclude_last) {
  if (n0 < m0) {
    const float* t = a;
    a = b;
    b = t;
    int64_t tl = n0;
    n0 = m0;
    m0 = tl;
  }
  const int64_t n = n0, m = m0;
  int64_t r = radius;
  r += ((n - m) * r + n - 1) / n;  // slope widening
  const int64_t lp = r + ((r % 2 == 0) ? 1 : 0);
  const int64_t ls = r + ((r % 2 == 1) ? 1 : 0);
  const float kInf = 1e10f;

  // per-row visited-column bounds from the anti-diagonal sweep
  int64_t* jmin = new int64_t[n];
  int64_t* jmax = new int64_t[n];
  for (int64_t i = 0; i < n; ++i) {
    jmin[i] = m;  // empty
    jmax[i] = -1;
  }
  auto mark = [&](int64_t start_i, int64_t start_j, int64_t length) {
    int64_t o0 = 0;
    if (start_i - n + 1 > o0) o0 = start_i - n + 1;
    if (-start_j > o0) o0 = -start_j;
    int64_t o1 = length;
    if (start_i + 1 < o1) o1 = start_i + 1;
    if (m - start_j < o1) o1 = m - start_j;
    for (int64_t o = o0; o < o1; ++o) {
      const int64_t i = start_i - o;
      const int64_t j = start_j + o;
      if (j < jmin[i]) jmin[i] = j;
      if (j > jmax[i]) jmax[i] = j;
    }
  };
  jmin[0] = 0;
  jmax[0] = 0;  // iteration 0 initializes only (0,0)
  int64_t cr = 0;
  for (int64_t it = 1; it < n; ++it) {
    if ((cr + 1) * n <= m * it) {
      ++cr;
      mark(it + ls / 2 - 1, cr - ls / 2, ls);
    }
    mark(it + lp / 2, cr - lp / 2, lp);
  }

  // row-major masked DP with two rolling rows
  float* prev = new float[m];
  float* curr = new float[m];
  for (int64_t j = 0; j < m; ++j) prev[j] = kInf;
  float res = kInf;
  for (int64_t i = 0; i < n; ++i) {
    for (int64_t j = 0; j < m; ++j) curr[j] = kInf;
    const int64_t lo = jmin[i], hi = jmax[i];
    for (int64_t j = lo; j <= hi; ++j) {
      if (i == 0 && j == 0) {
        curr[0] = std::fabs(a[0] - b[0]);
        continue;
      }
      const float top = (j > 0) ? curr[j - 1] : kInf;
      const float left = (i > 0) ? prev[j] : kInf;
      const float topleft = (i > 0 && j > 0) ? prev[j - 1] : kInf;
      float best = top < left ? top : left;
      if (topleft < best) best = topleft;
      curr[j] = best + std::fabs(a[i] - b[j]);
    }
    float* t = prev;
    prev = curr;
    curr = t;
  }
  res = prev[m - 1];
  delete[] prev;
  delete[] curr;
  delete[] jmin;
  delete[] jmax;
  if (exclude_last) res -= std::fabs(a[n - 1] - b[m - 1]);
  return res;
}

// Full-matrix global DTW with traceback (reference semantics:
// dtw.cpp:595-667 DTW_global_tb; a is the read axis, b the reference
// axis — NOT swapped). Writes the alignment path (i, j) ascending into
// out_ij (interleaved pairs, caller allocates n+m entries -> 2*(n+m)
// int32) and per-element |a[i]-b[j]| into out_diff; returns the path
// length and stores the total cost in *out_cost. Bit-identical to the
// Python golden model (rawalign_tpu/golden/dtw.py:dtw_global_tb): both
// evaluate float32 min(top, left, topleft) + |a-b| over the cumulative
// global borders and trace back with the same strict-inequality tie
// rules (diagonal preferred on ties).
int64_t ra_dtw_global_tb(const float* a, int64_t n, const float* b,
                         int64_t m, int32_t* out_ij, float* out_diff,
                         float* out_cost) {
  if (n <= 0 || m <= 0) {
    *out_cost = 0.0f;
    return 0;
  }
  float* dp = new float[n * m];
  dp[0] = std::fabs(a[0] - b[0]);
  for (int64_t i = 1; i < n; ++i)
    dp[i * m] = dp[(i - 1) * m] + std::fabs(a[i] - b[0]);
  for (int64_t j = 1; j < m; ++j)
    dp[j] = dp[j - 1] + std::fabs(a[0] - b[j]);
  for (int64_t i = 1; i < n; ++i) {
    const float ai = a[i];
    const float* pr = dp + (i - 1) * m;
    float* cu = dp + i * m;
    for (int64_t j = 1; j < m; ++j) {
      float best = pr[j] < cu[j - 1] ? pr[j] : cu[j - 1];
      if (pr[j - 1] < best) best = pr[j - 1];
      cu[j] = best + std::fabs(ai - b[j]);
    }
  }
  *out_cost = dp[n * m - 1];
  // traceback from (n-1, m-1), reversed in place at the end
  int64_t i = n - 1, j = m - 1, len = 0;
  out_ij[2 * len] = (int32_t)i;
  out_ij[2 * len + 1] = (int32_t)j;
  out_diff[len++] = std::fabs(a[i] - b[j]);
  while (i > 0 || j > 0) {
    if (i == 0) {
      --j;
    } else if (j == 0) {
      --i;
    } else {
      const float left = dp[(i - 1) * m + j];
      const float top = dp[i * m + (j - 1)];
      const float topleft = dp[(i - 1) * m + (j - 1)];
      if (left < (top < topleft ? top : topleft)) {
        --i;
      } else if (top < (left < topleft ? left : topleft)) {
        --j;
      } else {
        --i;
        --j;
      }
    }
    out_ij[2 * len] = (int32_t)i;
    out_ij[2 * len + 1] = (int32_t)j;
    out_diff[len++] = std::fabs(a[i] - b[j]);
  }
  delete[] dp;
  for (int64_t k = 0; k < len / 2; ++k) {  // reverse to ascending order
    int32_t ti = out_ij[2 * k], tj = out_ij[2 * k + 1];
    out_ij[2 * k] = out_ij[2 * (len - 1 - k)];
    out_ij[2 * k + 1] = out_ij[2 * (len - 1 - k) + 1];
    out_ij[2 * (len - 1 - k)] = ti;
    out_ij[2 * (len - 1 - k) + 1] = tj;
    float td = out_diff[k];
    out_diff[k] = out_diff[len - 1 - k];
    out_diff[len - 1 - k] = td;
  }
  return len;
}

// Batched variant over flattened tile arrays (offsets into a/b pools).
void ra_dtw_banded_batch(const float* a_pool, const int64_t* a_off,
                         const int64_t* a_len, const float* b_pool,
                         const int64_t* b_off, const int64_t* b_len,
                         const int32_t* radius, const uint8_t* exclude_last,
                         int64_t n_tiles, float* out) {
  for (int64_t t = 0; t < n_tiles; ++t) {
    out[t] = ra_dtw_banded(a_pool + a_off[t], a_len[t], b_pool + b_off[t],
                           b_len[t], radius[t], exclude_last[t]);
  }
}

// Batched bounded-window chaining DP over flattened per-read anchor
// arrays (reference semantics: rmap.cpp:427-484; window-bounded exactly
// like the device kernel rawalign_tpu/map/chain.py — same scores and
// predecessor choices bit-for-bit: every arithmetic step is int32 or a
// single f32 add/divide, no contraction opportunities). Anchors of one
// read are sorted by (segment = target*2 + strand, target_pos,
// query_pos); cross-segment window slots are inert (no score, no skip
// count, no break), matching the reference's per-(target,strand)-list
// iteration. The real per-round anchor data is tiny (a few MB of cell
// updates), so running the DP host-side removes a device round trip;
// results are identical to the device path by construction.
// Full event detector for one chunk (reference: revent.c:190-210):
// float32 sequential prefix sums (revent.c:22-32), two-window t-stats
// (revent.c:34-75; float ops with the double abs/sqrt step, multiplies
// kept in separate statements so -ffp-contract cannot change the
// rounding), dual-detector peak finding (ra_gen_peaks) and normalized
// event means (ra_gen_events) — output bit-identical to the Python
// golden chain prefix_sums+tstat+gen_peaks+gen_events
// (rawalign_tpu/golden/events.py; pinned in tests/test_native.py).
// out_events must hold s_len + 2 entries. Scratch is allocated per call.
int64_t ra_gen_peaks(const float* t1, const float* t2, int64_t n,
                     float threshold1, float threshold2, int w1, int w2,
                     float peak_height, uint32_t* out_peaks);
int64_t ra_gen_events(const uint32_t* peaks, int64_t n_peaks, const float* ps,
                      int64_t s_len, float* out_events);

static void tstat_fill(const float* ps, const float* pss, int64_t s_len,
                       int w, float* t) {
  for (int64_t i = 0; i <= s_len; ++i) t[i] = 0.0f;
  if (s_len < 2 * (int64_t)w || w < 2) return;
  const float w32 = (float)w;
  for (int64_t i = w; i <= s_len - w; ++i) {
    float sum1 = ps[i];
    float sumsq1 = pss[i];
    if (i > w) {
      sum1 -= ps[i - w];
      sumsq1 -= pss[i - w];
    }
    const float sum2 = ps[i + w] - ps[i];
    const float sumsq2 = pss[i + w] - pss[i];
    const float mean1 = sum1 / w32;
    const float mean2 = sum2 / w32;
    const float m1s = mean1 * mean1;
    const float m2s = mean2 * mean2;
    const float cv0 = sumsq1 / w32 - m1s + sumsq2 / w32 - m2s;
    const float cv = cv0 > 1.17549435e-38F ? cv0 : 1.17549435e-38F;
    const float dm = mean2 - mean1;
    const float q = cv / w32;
    t[i] = (float)(std::fabs((double)dm) / std::sqrt((double)q));
  }
  for (int64_t i = s_len - w + 1; i <= s_len; ++i) t[i] = 0.0f;
}

int64_t ra_detect_events(const float* sig, int64_t s_len, int w1, int w2,
                         float threshold1, float threshold2,
                         float peak_height, float* out_events) {
  if (s_len == 0) return 0;
  float* ps = new float[4 * (s_len + 1)];
  float* pss = ps + (s_len + 1);
  float* t1 = pss + (s_len + 1);
  float* t2 = t1 + (s_len + 1);
  uint32_t* peaks = new uint32_t[s_len];
  ps[0] = 0.0f;
  pss[0] = 0.0f;
  float a = 0.0f, b = 0.0f;
  for (int64_t i = 0; i < s_len; ++i) {
    a += sig[i];
    const float sq = sig[i] * sig[i];
    b += sq;
    ps[i + 1] = a;
    pss[i + 1] = b;
  }
  tstat_fill(ps, pss, s_len, w1, t1);
  tstat_fill(ps, pss, s_len, w2, t2);
  const int64_t n_peaks = ra_gen_peaks(t1, t2, s_len, threshold1, threshold2,
                                       w1, w2, peak_height, peaks);
  int64_t n_ev = 0;
  if (n_peaks > 0)
    n_ev = ra_gen_events(peaks, n_peaks, ps, s_len, out_events);
  delete[] peaks;
  delete[] ps;
  return n_ev;
}

// Event means between consecutive peaks + final segment, z-normalized
// over the chunk (reference: revent.c:140-188), bit-identical to the
// Python golden model (rawalign_tpu/golden/events.py::gen_events):
// float32 mean divisions, SEQUENTIAL double accumulation with the
// squares rounded in float first, double z-normalization stored to
// float. Returns the event count written to out_events (caller
// allocates >= n_peaks + 1). mean*mean is computed in a separate
// statement so -ffp-contract cannot fuse it into the subtraction.
int64_t ra_gen_events(const uint32_t* peaks, int64_t n_peaks, const float* ps,
                      int64_t s_len, float* out_events) {
  if (n_peaks == 0) return 0;
  int64_t n_ev = 1;
  for (int64_t i = 1; i < n_peaks; ++i)
    if (peaks[i] > 0 && (int64_t)peaks[i] < s_len) ++n_ev;
  float l_prefixsum = 0.0f;
  float l_peak = 0.0f;
  for (int64_t pi = 0; pi < n_ev - 1; ++pi) {
    const int64_t p = (int64_t)peaks[pi];
    out_events[pi] = (ps[p] - l_prefixsum) / ((float)p - l_peak);
    l_prefixsum = ps[p];
    l_peak = (float)p;
  }
  out_events[n_ev - 1] =
      (ps[s_len] - l_prefixsum) / ((float)s_len - l_peak);
  double s = 0.0, s2 = 0.0;
  for (int64_t i = 0; i < n_ev; ++i) {
    s += (double)out_events[i];
    const float sq = out_events[i] * out_events[i];
    s2 += (double)sq;
  }
  const double mean = s / (double)n_ev;
  const double mm = mean * mean;
  const double std = std::sqrt(s2 / (double)n_ev - mm);
  for (int64_t i = 0; i < n_ev; ++i)
    out_events[i] = (float)(((double)out_events[i] - mean) / std);
  return n_ev;
}

// End-candidate selection + chain traceback from DP results (reference
// semantics: rmap.cpp:486-505 candidate filter + rmap.cpp:130-173
// traceback with used-anchor marking), replicating the Python
// implementation in rawalign_tpu/map/postprocess.py::chains_from_dp
// exactly (same candidate order, same used-mark sequence, same
// double-precision score adjustment). Outputs: concatenated anchor
// indices in traceback order (end -> start), per-chain offsets
// (n_chains+1 entries), per-chain end-anchor index and adjusted score.
// Buffers sized n are always enough (every anchor joins at most one
// chain). Returns the chain count.
int64_t ra_chains_from_dp(const int32_t* seg, const int32_t* tgt,
                          const int32_t* qry, const float* scores,
                          const int32_t* preds, int64_t n,
                          double min_chaining_score, int num_best_chains,
                          int min_num_anchors, int disable_filter,
                          int32_t* out_anchor_idx, int64_t* out_chain_off,
                          int32_t* out_end_idx, double* out_score) {
  (void)tgt;
  (void)qry;
  if (n <= 0) return 0;
  // running max (inclusive) of scores, shared across segments
  float* running = new float[n];
  float rm = scores[0];
  for (int64_t i = 0; i < n; ++i) {
    if (scores[i] > rm) rm = scores[i];
    running[i] = rm;
  }
  bool* used = new bool[n]();
  int64_t n_chains = 0;
  int64_t a_cursor = 0;
  out_chain_off[0] = 0;
  // candidate scratch (per segment)
  int64_t* cand = new int64_t[n];
  for (int64_t s0 = 0; s0 < n;) {
    int64_t s1 = s0 + 1;
    while (s1 < n && seg[s1] == seg[s0]) ++s1;
    int64_t nc = 0;
    for (int64_t i = s0; i < s1; ++i) {
      const bool ok =
          disable_filter ||
          ((double)scores[i] >= min_chaining_score &&
           scores[i] > running[i] / 2.0f);
      if (ok) cand[nc++] = i;
    }
    if (nc) {
      // sort by (score desc, index desc) — insertion sort is fine, the
      // candidate lists are short (score-filtered)
      for (int64_t a = 1; a < nc; ++a) {
        const int64_t v = cand[a];
        int64_t b = a - 1;
        while (b >= 0 && (scores[cand[b]] < scores[v] ||
                          (scores[cand[b]] == scores[v] && cand[b] < v))) {
          cand[b + 1] = cand[b];
          --b;
        }
        cand[b + 1] = v;
      }
      const float seg_max = running[s1 - 1];
      for (int64_t rank = 0; rank < nc && rank < num_best_chains; ++rank) {
        const int64_t end_idx = cand[rank];
        if (!used[end_idx]) {
          // traceback with used marking (rmap.cpp:130-173)
          const int64_t chain_start = a_cursor;
          int64_t start = end_idx;
          bool stop_at_used = false;
          out_anchor_idx[a_cursor++] = (int32_t)end_idx;
          if (preds[start] != start && used[preds[start]])
            stop_at_used = true;
          used[start] = true;
          while (preds[start] != start && !used[preds[start]]) {
            start = preds[start];
            out_anchor_idx[a_cursor++] = (int32_t)start;
            if (preds[start] != start && used[preds[start]])
              stop_at_used = true;
            used[start] = true;
          }
          const int64_t len = a_cursor - chain_start;
          if (len >= min_num_anchors) {
            double score = (double)scores[end_idx];
            if (stop_at_used) score -= (double)scores[preds[start]];
            out_end_idx[n_chains] = (int32_t)end_idx;
            out_score[n_chains] = score;
            out_chain_off[++n_chains] = a_cursor;
          } else {
            a_cursor = chain_start;  // discard (anchors stay marked)
          }
        }
        if (!disable_filter && scores[end_idx] < seg_max / 2.0f) break;
      }
    }
    s0 = s1;
  }
  delete[] cand;
  delete[] used;
  delete[] running;
  return n_chains;
}

void ra_chain_dp(const int32_t* seg, const int32_t* tgt, const int32_t* qry,
                 const int32_t* n_anchors, int64_t B, int64_t A, int window,
                 int e, int max_gap, int max_target_gap, int max_skips,
                 float* out_scores, int32_t* out_preds) {
  const float init_score = (float)e;
  for (int64_t b = 0; b < B; ++b) {
    const int32_t* s = seg + b * A;
    const int32_t* t = tgt + b * A;
    const int32_t* q = qry + b * A;
    float* f = out_scores + b * A;
    int32_t* p = out_preds + b * A;
    const int64_t n = n_anchors[b] < A ? n_anchors[b] : A;
    for (int64_t i = 0; i < n; ++i) {
      float best = init_score;
      int32_t pred = (int32_t)i;
      const int32_t cs = s[i], ct = t[i], cq = q[i];
      const int64_t lo = i - window > 0 ? i - window : 0;
      int num_skips = 0;
      for (int64_t j = i - 1; j >= lo; --j) {
        if (s[j] != cs) continue;  // inert cross-segment slot
        if (q[j] == cq || t[j] == ct) continue;  // rmap.cpp:456-457
        if (t[j] + max_target_gap < ct) break;   // rmap.cpp:458
        const int32_t qdiff = cq - q[j];
        if (qdiff < 0) continue;  // rmap.cpp:465
        const int32_t tdiff = ct - t[j];
        float current = 0.0f;
        const int32_t m32 = tdiff < qdiff ? tdiff : qdiff;
        const float matching = (float)(m32 < e ? m32 : e);
        const int32_t gap_length = tdiff > qdiff ? tdiff - qdiff : qdiff - tdiff;
        const float gap_scale =
            tdiff > 0 ? (float)qdiff / (float)tdiff : 1.0f;
        if (gap_length < max_gap && gap_scale < 5.0f && gap_scale > 0.75f)
          current = f[j] + matching;  // rmap.cpp:472-474
        if (current > best) {
          best = current;
          pred = (int32_t)j;
          --num_skips;  // rmap.cpp:476-478
        } else {
          if (++num_skips > max_skips) break;  // rmap.cpp:479-483
        }
      }
      f[i] = best;
      p[i] = pred;
    }
    for (int64_t i = n; i < A; ++i) {
      f[i] = 0.0f;
      p[i] = (int32_t)i;
    }
  }
}

// Anchor expansion for one engine round (map/anchors.py expand_round's
// C twin, bit-identical ordering contract): per live row, expand each
// seed's (lo, count) hit range against the index value tables
// (rmap.cpp:371-391's gather), append carried anchors (rmap.cpp:343-362
// re-injection, occ rank 0), stable-sort by (seg, tpos, qpos), and
// apply the occ-ranked budget drop for rows over A. Outputs land in the
// engine's pre-sentinel-filled (B, A) blocks. out_stats = {max_used,
// max_true, dropped}.
void ra_expand_round(
    const int32_t* h_lo, const int32_t* h_qpos, const int32_t* h_count,
    const uint8_t* live, const int64_t* offsets, const int64_t* car_seg,
    const int64_t* car_tpos, const int64_t* car_qpos, const int32_t* car_cnt,
    const uint32_t* val_id, const uint32_t* val_ps, int64_t B, int64_t NS,
    int64_t A, int32_t* seg_b, int32_t* tgt_b, int32_t* qry_b,
    int32_t* n_anch, int64_t* out_stats) {
  // Sort keys are packed into one __uint128_t per anchor so the
  // (seg, tpos, qpos, idx) lexicographic order is a single integer
  // compare: 50Mb-scale rounds carry ~4M anchors and the struct
  // comparator sort was the measured host wall there (2.0-2.8s/round;
  // [tail] profile, round 5). Layout (high to low):
  //   seg:41 | tpos:31 | qpos:32 | idx:24
  // idx (the input-position stable tie-break) caps rows at 2^24
  // anchors — far above the 2^17..2^19 anchor ceilings.
  typedef unsigned __int128 u128;
  int64_t max_used = 0, max_true = 0, dropped = 0;
  std::vector<u128> keys;
  std::vector<int32_t> occs;  // indexed by input position (idx)
  int64_t car_base = 0;
  for (int64_t b = 0; b < B; ++b) {
    const int64_t car_n = car_cnt ? (int64_t)car_cnt[b] : 0;
    const int64_t car_off = car_base;
    car_base += car_n;
    n_anch[b] = 0;
    if (!live[b]) continue;
    keys.clear();
    occs.clear();
    const int32_t* lo = h_lo + b * NS;
    const int32_t* qp = h_qpos + b * NS;
    const int32_t* cnt = h_count + b * NS;
    const int64_t off = offsets[b];
    for (int64_t s = 0; s < NS; ++s) {
      const int64_t c = cnt[s];
      for (int64_t j = 0; j < c; ++j) {
        const int64_t hidx = (int64_t)lo[s] + j;
        const uint32_t ps = val_ps[hidx];
        const uint64_t seg =
            (uint64_t)val_id[hidx] * 2 + (uint64_t)(ps & 1u);
        const uint64_t tpos = (uint64_t)((ps >> 1) & 0x7FFFFFFFu);
        const uint64_t qpos = (uint64_t)((int64_t)qp[s] + off);
        const uint64_t idx = (uint64_t)keys.size();
        keys.push_back(((u128)seg << 87) | ((u128)tpos << 56) |
                       ((u128)qpos << 24) | (u128)idx);
        occs.push_back((int32_t)c);
      }
    }
    for (int64_t j = 0; j < car_n; ++j) {
      const uint64_t idx = (uint64_t)keys.size();
      keys.push_back(((u128)(uint64_t)car_seg[car_off + j] << 87) |
                     ((u128)(uint64_t)car_tpos[car_off + j] << 56) |
                     ((u128)(uint64_t)car_qpos[car_off + j] << 24) |
                     (u128)idx);
      occs.push_back(0);  // carried anchors always survive the budget
    }
    int64_t m = (int64_t)keys.size();
    if (!m) continue;
    std::sort(keys.begin(), keys.end());
    if (m > max_true) max_true = m;
    if (m > A) {
      // keep the A anchors with the smallest parent-seed occurrence,
      // stable in sorted position (occ-ranked adaptive drop).
      // Equivalent to stable-sort-by-occ + take-A + restore-position,
      // but O(m) via an occurrence histogram: keep every anchor with
      // occ < T, plus the first (A - count_below_T) anchors with
      // occ == T in sorted-position order — exactly the prefix a
      // stable sort by occ would select. occ values are bounded by
      // the engine's per-seed cap (max_occ), so the histogram is small.
      dropped += m - A;
      int32_t occ_max = 0;
      for (int64_t i = 0; i < m; ++i)
        if (occs[i] > occ_max) occ_max = occs[i];
      std::vector<int64_t> hist((size_t)occ_max + 1, 0);
      for (int64_t i = 0; i < m; ++i) ++hist[occs[i]];
      int64_t cum = 0;
      int32_t T = 0;
      for (; T <= occ_max; ++T) {
        if (cum + hist[T] >= A) break;
        cum += hist[T];
      }
      int64_t quota = A - cum;  // occ==T anchors to keep
      int64_t w = 0;
      for (int64_t i = 0; i < m && w < A; ++i) {
        const int32_t o = occs[(uint32_t)(keys[i] & 0xFFFFFF)];
        if (o < T) {
          keys[w++] = keys[i];
        } else if (o == T && quota > 0) {
          keys[w++] = keys[i];
          --quota;
        }
      }
      m = A;
    }
    int32_t* sb = seg_b + b * A;
    int32_t* tb = tgt_b + b * A;
    int32_t* qb = qry_b + b * A;
    for (int64_t i = 0; i < m; ++i) {
      const u128 k = keys[i];
      sb[i] = (int32_t)(uint64_t)(k >> 87);
      tb[i] = (int32_t)((uint64_t)(k >> 56) & 0x7FFFFFFFu);
      qb[i] = (int32_t)((uint64_t)(k >> 24) & 0xFFFFFFFFu);
    }
    n_anch[b] = (int32_t)m;
    if (m > max_used) max_used = m;
  }
  out_stats[0] = max_used;
  out_stats[1] = max_true;
  out_stats[2] = dropped;
}

// ---------------------------------------------------------------------------
// Batched round tail (round-4): traceback + chain records + DTW tile
// descriptors for a whole engine round in ONE call, replacing the
// per-read Python loop (Chain-object construction was the dominant
// remaining host cost; VERDICT r3 item 1). Per gated row: run the
// ra_chains_from_dp candidate selection/traceback, optionally
// stable-sort the row's chains by chaining score descending (the DTW
// evaluation order, rmap.cpp:509-512), then emit flat chain records,
// anchors (end->start order, rmap.cpp:130-173) and per-chain tile
// descriptor runs (align_chain's sparse parts, rmap.cpp:238-300, or the
// single global region, rmap.cpp:192-237; identical row layout to
// postprocess.build_chain_tile_descs_vec).
// Returns the chain count; out_counts = {n_chains, n_anchors, n_descs}.
int64_t ra_round_chains(
    const int32_t* seg_b, const int32_t* tgt_b, const int32_t* qry_b,
    const float* scores_b, const int32_t* preds_b, const int32_t* n_anch,
    const uint8_t* gate, int64_t B, int64_t A, double min_chaining_score,
    int num_best_chains, int min_num_anchors, int disable_filter,
    int sort_for_dtw, int use_dtw, int border_global, int fill_full,
    double band_frac, const int64_t* segbase, const int64_t* ev_base,
    int32_t* ch_read, double* ch_score, int32_t* ch_seg,
    int32_t* ch_start_t, int32_t* ch_end_t, int32_t* ch_nanch,
    int64_t* ch_aoff, uint32_t* ch_at, uint32_t* ch_aq, int64_t* ch_doff,
    int64_t* descs, int64_t* out_counts) {
  std::vector<int32_t> aidx(A);
  std::vector<int64_t> coff(A + 1);
  std::vector<int32_t> eidx(A);
  std::vector<double> csc(A);
  std::vector<int64_t> order;
  int64_t nc_total = 0, na_total = 0, nd_total = 0;
  ch_aoff[0] = 0;
  ch_doff[0] = 0;
  for (int64_t b = 0; b < B; ++b) {
    if (!gate[b]) continue;
    const int64_t n = n_anch[b] < A ? n_anch[b] : A;
    if (n <= 0) continue;
    const int32_t* seg = seg_b + b * A;
    const int32_t* tgt = tgt_b + b * A;
    const int32_t* qry = qry_b + b * A;
    const int64_t nc = ra_chains_from_dp(
        seg, tgt, qry, scores_b + b * A, preds_b + b * A, n,
        min_chaining_score, num_best_chains, min_num_anchors,
        disable_filter, aidx.data(), coff.data(), eidx.data(), csc.data());
    if (!nc) continue;
    order.resize(nc);
    for (int64_t k = 0; k < nc; ++k) order[k] = k;
    if (sort_for_dtw) {
      // the engine's chains.sort(key=chaining_score, reverse=True):
      // stable descending by score only
      std::stable_sort(order.begin(), order.end(),
                       [&](int64_t x, int64_t y) { return csc[x] > csc[y]; });
    }
    for (int64_t r = 0; r < nc; ++r) {
      const int64_t k = order[r];
      const int64_t a0 = coff[k], a1 = coff[k + 1];
      const int64_t len = a1 - a0;
      const int64_t e = aidx[a0];           // end anchor index
      const int64_t s = aidx[a1 - 1];       // start anchor index
      ch_read[nc_total] = (int32_t)b;
      ch_score[nc_total] = csc[k];
      ch_seg[nc_total] = seg[e];
      ch_start_t[nc_total] = tgt[s];
      ch_end_t[nc_total] = tgt[e];
      ch_nanch[nc_total] = (int32_t)len;
      for (int64_t j = a0; j < a1; ++j) {
        ch_at[na_total] = (uint32_t)tgt[aidx[j]];
        ch_aq[na_total] = (uint32_t)qry[aidx[j]];
        ++na_total;
      }
      ch_aoff[nc_total + 1] = na_total;
      // DTW tile descriptors for this chain
      if (use_dtw) {
        const uint32_t* at = ch_at + ch_aoff[nc_total];
        const uint32_t* aq = ch_aq + ch_aoff[nc_total];
        const int64_t rb = segbase[seg[e]];
        const int64_t eb = ev_base[b];
        const int64_t parts = border_global ? 1 : len - 1;
        for (int64_t p = 0; p < parts; ++p) {
          // sparse part p: sa = anchors[parts-p], ea = anchors[parts-p-1]
          // (anchors are end->start); global: sa=anchors[len-1], ea=anchors[0]
          int64_t sa = border_global ? len - 1 : parts - p;
          int64_t ea = border_global ? 0 : parts - p - 1;
          const int64_t t0 = at[sa], q0 = aq[sa];
          const int64_t t1 = at[ea], q1 = aq[ea];
          const int64_t ql = q1 - q0 + 1;
          const int64_t tl = t1 - t0 + 1;
          int64_t radius =
              fill_full ? (ql > 1 ? ql : 1)
                        : (int64_t)((double)ql * band_frac);
          if (radius < 1) radius = 1;
          const int64_t excl = border_global ? 0 : (p != parts - 1);
          const bool swap = tl > ql;
          int64_t* row = descs + nd_total * 6;
          row[0] = swap ? rb + t0 : eb + q0;
          row[1] = swap ? tl : ql;
          row[2] = swap ? eb + q0 : rb + t0;
          row[3] = swap ? ql : tl;
          row[4] = radius;
          row[5] = excl;
          ++nd_total;
        }
      }
      ch_doff[nc_total + 1] = nd_total;
      ++nc_total;
    }
  }
  out_counts[0] = nc_total;
  out_counts[1] = na_total;
  out_counts[2] = nd_total;
  return nc_total;
}

// Round finalize: B&B replay over the DTW part costs
// (rmap.cpp:243-280,509-530), primary-chain selection (rmap.cpp:90-128),
// MAPQ (rmap.cpp:65-88), the early-termination decision
// (rmap.cpp:594-665) and the PAF emit fields incl. the float32 tag
// accumulations (rmap.cpp:698-729) — per read, matching
// postprocess.bnb_replay + golden chain.gen_primary_chains/comp_mapq +
// golden engine.is_mapped_with_high_confidence + MappingEngine._emit
// bit-for-bit. Carried-anchor outputs feed ra_expand_round next round.
void ra_round_finalize(
    const int32_t* ch_read, const double* ch_score, const int32_t* ch_seg,
    const int32_t* ch_start_t, const int32_t* ch_end_t,
    const int32_t* ch_nanch, const int64_t* ch_aoff, const uint32_t* ch_at,
    const uint32_t* ch_aq, const int64_t* ch_doff, int64_t n_chains,
    int64_t B, const float* costs, int64_t n_costs, int use_dtw,
    int border_global, double match_bonus, double dtw_min_score,
    double min_bestmap_ratio, double min_meanmap_ratio, int min_chain_anchor,
    uint8_t* out_decision, int32_t* out_nc, int32_t* out_seg,
    int32_t* out_start_t, int32_t* out_end_t, int32_t* out_nanch0,
    uint32_t* out_q_start, uint32_t* out_q_end, int32_t* out_mapq,
    double* out_s1, double* out_s2, float* out_sm, float* out_at,
    float* out_aq, int64_t* car_off, int64_t* car_seg, int64_t* car_t,
    int64_t* car_q, int64_t* out_total_carried) {
  (void)n_costs;
  struct Rec {
    double cscore;
    float ascore;
    int32_t seg, start_t, end_t, nanch;
    int64_t a0;  // into ch_at/ch_aq
  };
  std::vector<Rec> survivors;
  std::vector<int64_t> primary;
  int64_t car_total = 0;
  car_off[0] = 0;
  int64_t c0 = 0;  // chain cursor
  for (int64_t b = 0; b < B; ++b) {
    // rows are contiguous by read (ra_round_chains emits in read order)
    int64_t c1 = c0;
    while (c1 < n_chains && ch_read[c1] == (int32_t)b) ++c1;
    survivors.clear();
    if (use_dtw) {
      // B&B replay in chain order (score-desc from ra_round_chains)
      double best_found = 0.0;
      for (int64_t c = c0; c < c1; ++c) {
        const int64_t a0 = ch_aoff[c];
        const int64_t n_a = ch_nanch[c];
        const int64_t q_start = ch_aq[a0 + n_a - 1];
        const int64_t q_end = ch_aq[a0];
        const int64_t read_size = q_end - q_start + 1;
        float current_max = (float)((float)read_size * (float)match_bonus);
        bool abandoned = false;
        float dtw_cost = 0.0f;
        int64_t num_aligned = 0;
        const int64_t d0 = ch_doff[c];
        const int64_t parts = ch_doff[c + 1] - d0;
        if (border_global) {
          if ((double)current_max < best_found) {
            abandoned = true;
          } else {
            dtw_cost = costs[d0];
            num_aligned = read_size;
          }
        } else {
          // scalar replay of rmap.cpp:243-280: check-before-each-part
          for (int64_t p = 0; p < parts; ++p) {
            if ((double)current_max < best_found) {
              abandoned = true;
              break;
            }
            const float sub = costs[d0 + p];
            current_max = current_max - sub;
            dtw_cost = dtw_cost + sub;
          }
          if (!abandoned) num_aligned = parts ? read_size - 1 + parts : 0;
        }
        if (abandoned) continue;
        const float ascore =
            (float)((float)num_aligned * (float)match_bonus) - dtw_cost;
        if ((double)ascore >= dtw_min_score) {
          if ((double)ascore > best_found) best_found = (double)ascore;
          Rec r;
          r.cscore = ch_score[c];
          r.ascore = ascore;
          r.seg = ch_seg[c];
          r.start_t = ch_start_t[c];
          r.end_t = ch_end_t[c];
          r.nanch = ch_nanch[c];
          r.a0 = ch_aoff[c];
          survivors.push_back(r);
        }
      }
    } else {
      for (int64_t c = c0; c < c1; ++c) {
        Rec r;
        r.cscore = ch_score[c];
        r.ascore = 0.0f;
        r.seg = ch_seg[c];
        r.start_t = ch_start_t[c];
        r.end_t = ch_end_t[c];
        r.nanch = ch_nanch[c];
        r.a0 = ch_aoff[c];
        survivors.push_back(r);
      }
    }
    c0 = c1;
    const int64_t ns = (int64_t)survivors.size();
    if (!ns) {
      out_decision[b] = 0;
      out_nc[b] = 0;
      car_off[b + 1] = car_total;
      continue;
    }
    // gen_primary_chains: stable sort by the rmap.h:41-45 key tuple,
    // descending, then greedy overlap filter
    std::vector<int64_t> ord(ns);
    for (int64_t i = 0; i < ns; ++i) ord[i] = i;
    std::stable_sort(ord.begin(), ord.end(), [&](int64_t x, int64_t y) {
      const Rec &a = survivors[x], &bb = survivors[y];
      if (a.ascore != bb.ascore) return a.ascore > bb.ascore;
      if (a.cscore != bb.cscore) return a.cscore > bb.cscore;
      if (a.nanch != bb.nanch) return a.nanch > bb.nanch;
      const int as = a.seg & 1, bs = bb.seg & 1;
      if (as != bs) return as > bs;
      const int ar = a.seg >> 1, br = bb.seg >> 1;
      if (ar != br) return ar > br;
      if (a.start_t != bb.start_t) return a.start_t > bb.start_t;
      return a.end_t > bb.end_t;
    });
    primary.clear();
    primary.push_back(ord[0]);
    for (int64_t ci = 1; ci < ns; ++ci) {
      const Rec& c = survivors[ord[ci]];
      const Rec& last = survivors[primary.back()];
      const double ref_score = use_dtw ? (double)last.ascore : last.cscore;
      const double c_score = use_dtw ? (double)c.ascore : c.cscore;
      if (c_score < ref_score / 3.0) break;
      bool is_primary = true;
      for (int64_t pi : primary) {
        const Rec& p = survivors[pi];
        if ((c.seg >> 1) == (p.seg >> 1)) {
          const int32_t lo =
              c.start_t > p.start_t ? c.start_t : p.start_t;
          const int32_t hi = c.end_t < p.end_t ? c.end_t : p.end_t;
          if (lo <= hi) {
            is_primary = false;
            break;
          }
        }
      }
      if (is_primary) primary.push_back(ord[ci]);
    }
    const int64_t np = (int64_t)primary.size();
    const Rec& b0 = survivors[primary[0]];
    // comp_mapq (rmap.cpp:65-88)
    int mapq = 60;
    if (np > 1) {
      const Rec& b1 = survivors[primary[1]];
      const double ratio = use_dtw ? (double)b1.ascore / (double)b0.ascore
                                   : b1.cscore / b0.cscore;
      const double v = 40.0 * (1.0 - ratio);
      mapq = (v != v || v < 0.0) ? 0 : (v > 60.0 ? 60 : (int)v);
    }
    // is_mapped_with_high_confidence (rmap.cpp:594-665)
    bool decided = false;
    if (b0.nanch > 0) {
      if (use_dtw) {
        if (np >= 2) {
          const Rec& b1 = survivors[primary[1]];
          if ((double)b0.ascore / (double)b1.ascore >= min_bestmap_ratio) {
            decided = true;
          } else {
            double mean = 0.0;
            for (int64_t pi : primary) mean += (double)survivors[pi].ascore;
            mean /= (double)np;
            if ((double)b0.ascore >= min_meanmap_ratio * mean) decided = true;
          }
        } else if (np == 1 && b0.nanch >= min_chain_anchor) {
          decided = true;
        }
      } else {
        if (np >= 2) {
          const Rec& b1 = survivors[primary[1]];
          if (b0.cscore / b1.cscore >= min_bestmap_ratio) {
            decided = true;
          } else {
            double mean = 0.0;
            for (int64_t pi : primary) mean += survivors[pi].cscore;
            mean /= (double)np;
            if (b0.cscore >= min_meanmap_ratio * mean) decided = true;
          }
        } else if (np == 1 && b0.nanch >= min_chain_anchor) {
          decided = true;
        }
      }
    }
    // emit fields + f32 tag folds (rmap.cpp:707-729)
    out_decision[b] = decided ? 1 : 0;
    out_nc[b] = (int32_t)np;
    out_seg[b] = b0.seg;
    out_start_t[b] = b0.start_t;
    out_end_t[b] = b0.end_t;
    out_nanch0[b] = b0.nanch;
    out_q_start[b] = ch_aq[b0.a0 + b0.nanch - 1];
    out_q_end[b] = ch_aq[b0.a0];
    out_mapq[b] = mapq;
    out_s1[b] = b0.cscore;
    out_s2[b] = np > 1 ? survivors[primary[1]].cscore : 0.0;
    float sm = 0.0f;
    for (int64_t pi : primary) sm += (float)survivors[pi].cscore;
    out_sm[b] = sm / (float)np;
    float at_sum = 0.0f, aq_sum = 0.0f;
    const uint32_t* at = ch_at + b0.a0;
    const uint32_t* aq = ch_aq + b0.a0;
    for (int64_t ai = 0; ai + 1 < b0.nanch; ++ai) {
      at_sum += (float)(uint32_t)(at[ai] - at[ai + 1]);
      aq_sum += (float)(uint32_t)(aq[ai] - aq[ai + 1]);
    }
    out_at[b] = at_sum / (float)b0.nanch;
    out_aq[b] = aq_sum / (float)b0.nanch;
    // carried anchors: every primary chain's anchors, chain order
    for (int64_t pi : primary) {
      const Rec& p = survivors[pi];
      for (int64_t ai = 0; ai < p.nanch; ++ai) {
        car_seg[car_total] = p.seg;
        car_t[car_total] = ch_at[p.a0 + ai];
        car_q[car_total] = ch_aq[p.a0 + ai];
        ++car_total;
      }
    }
    car_off[b + 1] = car_total;
  }
  out_total_carried[0] = car_total;
}

}  // extern "C"
