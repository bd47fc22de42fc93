// Batched banded DTW for NVIDIA Hopper (sm_90a), called from JAX through
// the XLA foreign function interface (rawalign_tpu/map/dtw_cuda.py).
//
// Computes the reference's production alignment kernel
// DTW_global_slantedbanded_antidiagonalwise (dtw.cpp:273-520) for a batch
// of tiles. Tile t is described by six int32 rows of `desc` (row-major,
// shape (6, T)): a_base, n, b_base, m, R, excl. a = src[a_base : a_base+n]
// is the longer sequence, b = src[b_base : b_base+m], R the slope-widened
// band radius and excl the exclude-last flag. The arithmetic is the one
// of the plain JAX version (rawalign_tpu/map/dtw.py, dtw_plain): float32
// abs, sub, min and add in the same order, so results are bit-identical.
//
// Layout: the two rotating anti-diagonal buffers of a tile live in the
// registers of LPT lanes of one warp, K consecutive band slots per lane
// (dpw = LPT * K). The neighbour shifts of the recurrence are register
// moves inside a lane and one warp shuffle across the lane boundary. The
// whole wavefront loop runs inside the kernel: one launch per size class,
// no state in device memory between steps.
//
// Build: make -C native cuda

#include <cuda_runtime.h>

#include <cstdint>
#include <string>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr float kInf = 1e10f;
constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFull = 0xffffffffu;

template <int LPT, int K>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    dtw_banded_kernel(const float* __restrict__ src,
                      const int32_t* __restrict__ desc, int64_t T,
                      float* __restrict__ out) {
  constexpr int kTilesPerWarp = 32 / LPT;
  const int lane = threadIdx.x & 31;
  const int s = lane % LPT;  // lane within the tile's segment
  const int64_t warp =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int64_t t = warp * kTilesPerWarp + lane / LPT;

  const int64_t a_base = desc[t];
  const int n = desc[T + t];
  const int64_t b_base = desc[2 * T + t];
  const int m = desc[3 * T + t];
  const int R = desc[4 * T + t];
  const bool excl = desc[5 * T + t] != 0;

  const bool plm = (R % 2) == 0;  // primary anti-diagonal is the longer
  const int lp = plm ? R + 1 : R;
  const int ls = plm ? R : R + 1;
  const int hlp = lp >> 1;
  const int hls = ls >> 1;
  const int slot0 = plm ? hlp : hlp + 1;
  const bool ok = n > 0 && m > 0;

  const float* a = src + a_base;
  const float* b = src + b_base;
  auto A = [&](int x) { return (x >= 0 && x < n) ? a[x] : 0.0f; };
  auto B = [&](int y) { return (y >= 0 && y < m) ? b[y] : 0.0f; };

  const float d00 = ok ? fabsf(a[0] - b[0]) : 0.0f;
  const float corr = (excl && ok) ? fabsf(a[n - 1] - b[m - 1]) : 0.0f;

  float dp0[K], dp1[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int o = s * K + k;
    dp0[k] = kInf;
    dp1[k] = (o == slot0 && ok) ? d00 : kInf;
  }
  float res = ok ? d00 : kInf;

  int acc = 0;  // Bresenham accumulator: cr(it) = floor(it * m / n)
  int cr = 0;
  bool pinc = false;
  const int n_max = __reduce_max_sync(kFull, n);
  for (int it = 1; it < n_max; ++it) {
    const bool active = it < n;
    const bool previnc = pinc;
    const int acc2 = acc + m;
    const bool incraw = acc2 >= n;
    acc = incraw ? acc2 - n : acc2;
    const bool incb = incraw && active;
    cr += incb ? 1 : 0;

    // closed-form in-band slot ranges (dtw.cpp:320-345)
    const int s_i = it + hls - 1;
    const int s_j = cr - hls;
    const int o0s = max(max(0, s_i - n + 1), -s_j);
    const int o1s = min(min(ls, s_i + 1), m - s_j);
    const int p_i = it + hlp;
    const int p_j = cr - hlp;
    const int o0p = max(max(0, p_i - n + 1), -p_j);
    const int o1p = min(min(lp, p_i + 1), m - p_j);
    // primary slot o holds cell (x0 - o, y0 + o)
    const int x0 = it + hlp;
    const int y0 = cr - hlp;

    // ---- secondary anti-diagonal (dtw.cpp:361-414)
    float dp1_next = __shfl_down_sync(kFull, dp1[0], 1, LPT);
    if (s == LPT - 1) dp1_next = kInf;
    float sec[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int o = s * K + k;
      const float left_raw = (k < K - 1) ? dp1[k + 1] : dp1_next;
      const float top = (!plm && o == 0) ? kInf : dp1[k];
      const float topleft = (!plm && o == 0 && !previnc) ? kInf : dp0[k];
      const float left = (!plm && o == ls - 1) ? kInf : left_raw;
      const float cost = plm ? fabsf(A(x0 - o - 1) - B(y0 + o))
                             : fabsf(A(x0 - o) - B(y0 + o - 1));
      const float v = fminf(fminf(top, left), topleft) + cost;
      sec[k] = (o >= o0s && o < o1s) ? v : kInf;
    }

    float e0[K], e1[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      e0[k] = incb ? dp1[k] : dp0[k];
      e1[k] = incb ? sec[k] : dp1[k];
    }
    float e1_prev = __shfl_up_sync(kFull, e1[K - 1], 1, LPT);
    float e0_prev = __shfl_up_sync(kFull, e0[K - 1], 1, LPT);
    if (s == 0) {
      e1_prev = kInf;
      e0_prev = kInf;
    }

    // ---- primary anti-diagonal (dtw.cpp:416-491); with R odd slot o
    // holds primary cell o - 1 (the reference's "+1 simplification")
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int o = s * K + k;
      const float e1r = (k > 0) ? e1[k - 1] : e1_prev;
      const float e0r = (k > 0) ? e0[k - 1] : e0_prev;
      float top, topleft, left, cost;
      int op;
      if (plm) {
        top = (o == 0) ? kInf : e1r;
        topleft = incb ? e0[k] : ((o == 0) ? kInf : e0r);
        left = (incb && o == lp - 1) ? kInf : e1[k];
        cost = fabsf(A(x0 - o) - B(y0 + o));
        op = o;
      } else {
        top = incb ? e1r : ((o == 1) ? kInf : e1r);
        topleft = incb ? e0[k] : ((o == 1 && !previnc) ? kInf : e0r);
        left = e1[k];
        cost = fabsf(A(x0 - o + 1) - B(y0 + o - 1));
        op = o - 1;
      }
      const float v = fminf(fminf(top, left), topleft) + cost;
      const float pri = (op >= o0p && op < o1p) ? v : kInf;
      if (active) {
        dp0[k] = e1[k];
        dp1[k] = pri;
      }
      if (it == n - 1 && o == slot0) res = dp1[k];
    }
    if (active) pinc = incraw;
  }
  if (s == slot0 / K) out[t] = res - corr;
}

template <int LPT, int K>
ffi::Error Launch(cudaStream_t stream, const float* src, const int32_t* desc,
                  int64_t T, float* out) {
  constexpr int kTilesPerBlock = kWarpsPerBlock * (32 / LPT);
  if (T % kTilesPerBlock != 0) {
    return ffi::Error::InvalidArgument(
        "tile count " + std::to_string(T) + " is not a multiple of " +
        std::to_string(kTilesPerBlock));
  }
  const int64_t blocks = T / kTilesPerBlock;
  dtw_banded_kernel<LPT, K>
      <<<static_cast<unsigned>(blocks), kWarpsPerBlock * 32, 0, stream>>>(
          src, desc, T, out);
  return ffi::Error::Success();
}

ffi::Error DtwBandedImpl(cudaStream_t stream, ffi::Buffer<ffi::F32> src,
                         ffi::Buffer<ffi::S32> desc,
                         ffi::ResultBuffer<ffi::F32> out, int32_t dpw) {
  const int64_t T = out->element_count();
  if (static_cast<int64_t>(desc.element_count()) != 6 * T) {
    return ffi::Error::InvalidArgument("desc must have shape (6, T)");
  }
  if (T == 0) return ffi::Error::Success();
  const float* s = src.typed_data();
  const int32_t* d = desc.typed_data();
  float* o = out->typed_data();
  ffi::Error err = ffi::Error::Success();
  switch (dpw) {
    case 16: err = Launch<16, 1>(stream, s, d, T, o); break;
    case 32: err = Launch<32, 1>(stream, s, d, T, o); break;
    case 64: err = Launch<32, 2>(stream, s, d, T, o); break;
    case 128: err = Launch<32, 4>(stream, s, d, T, o); break;
    case 256: err = Launch<32, 8>(stream, s, d, T, o); break;
    case 512: err = Launch<32, 16>(stream, s, d, T, o); break;
    case 1024: err = Launch<32, 32>(stream, s, d, T, o); break;
    default:
      return ffi::Error::InvalidArgument("unsupported band width dpw=" +
                                         std::to_string(dpw));
  }
  if (!err.success()) return err;
  const cudaError_t last = cudaGetLastError();
  if (last != cudaSuccess) {
    return ffi::Error::Internal(std::string("dtw_banded launch: ") +
                                cudaGetErrorString(last));
  }
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(RawalignDtwBanded, DtwBandedImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::F32>>()
                                  .Attr<int32_t>("dpw"));
