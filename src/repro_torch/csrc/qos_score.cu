// QoS scoring kernel: the paper's Eq. 7 network score N in [-1, 1] per
// latency-window row, lat[n, T] (f32 or bf16, ms, newest sample last) -> N[n] f32.
//
// Replaces: src/repro/kernels/qos_score.py : _qos_kernel (qos_score_pallas).
//
// Bound on the H100: a pure row reduction, memory-bound.  The main path's
// per-query step reads a [64 * 10,005, 64] f32 window, 164 MB, about 49 us
// at 3.35 TB/s; the shared [10,005, 64] window is 2.6 MB, under 1 us.
// The arithmetic (a pow, a few multiply-adds per sample) is far below the
// memory line.
//
// Design (simple and right first):
//   * One thread per server row, 64 rows per block.  The block stages
//     32-column chunks of its 64 rows through shared memory with coalesced
//     loads (a warp reads 32 consecutive samples of one row), then each
//     thread walks its own row.  No padding of T: the last chunk is masked.
//   * Two passes over the window, as the reference computes the variance
//     around the window mean: pass 1 accumulates the EWMA, the trend
//     numerator, the outage count, the window sum and the last sample over
//     all T columns; pass 2 re-reads only the trailing min(window, T)
//     columns for the squared deviations.  The second pass costs at most
//     half a row more traffic, mostly from L2.
//   * EWMA weights are alpha * (1 - alpha)^age with the age in f32 through
//     powf, as repro.core.qos.ewma does, never a running product (that
//     drifts); the (1 - alpha)^T carry of the initial state is computed on
//     the host in double and added to the oldest real sample's weight.
//   * The offline clamp reads the last real sample; bf16 windows are
//     widened to f32 on load and every sum runs in f32.
//   Sums run in another order than the plain PyTorch version
//   (repro_torch.core.qos.network_score), so the two agree to a few ulp.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int ROWS = 64;  // rows (threads) per block
constexpr int CH = 32;    // columns per shared-memory chunk

struct QosConsts {
  float ideal_low, ideal_high, base_scale;
  float alpha, one_minus_alpha, carry;
  float trend_scale, cv_low, cv_scale;
  float w_high, w_trend, w_outage, w_instab;
  float offline, outage_risk;
  float n_w, sum_x2;
  int T, window;  // window = min(p.window, T) real trailing samples
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float clip01(float x) { return fminf(fmaxf(x, 0.0f), 1.0f); }

// Stage columns [c0, c0 + CH) of this block's rows into tile (zeros past the edge).
template <typename TL>
__device__ __forceinline__ void load_chunk(float (*tile)[CH + 1], const TL* __restrict__ lat,
                                           long long n, int T, long long row0, int c0) {
  for (int e = threadIdx.x; e < ROWS * CH; e += ROWS) {
    const int rr = e / CH;
    const int cc = e % CH;
    const long long gr = row0 + rr;
    const int t = c0 + cc;
    tile[rr][cc] = (gr < n && t < T) ? to_f32(lat[gr * T + t]) : 0.0f;
  }
}

template <typename TL>
__global__ void __launch_bounds__(ROWS) qos_kernel(const TL* __restrict__ lat,
                                                   float* __restrict__ out, long long n,
                                                   QosConsts p) {
  __shared__ float tile[ROWS][CH + 1];
  const int tid = threadIdx.x;
  const long long row0 = static_cast<long long>(blockIdx.x) * ROWS;
  const int T = p.T;
  const int wstart = T - p.window;
  const float centre = (p.n_w - 1.0f) / 2.0f;

  // --- pass 1: EWMA, trend numerator, outage count, window sum, last sample
  float ew = 0.0f, sxl = 0.0f, risky = 0.0f, swin = 0.0f, last = 0.0f;
  for (int c0 = 0; c0 < T; c0 += CH) {
    load_chunk(tile, lat, n, T, row0, c0);
    __syncthreads();
    const int cols = min(CH, T - c0);
    for (int cc = 0; cc < cols; ++cc) {
      const int t = c0 + cc;
      const float x = tile[tid][cc];
      float wgt = __fmul_rn(p.alpha, powf(p.one_minus_alpha, static_cast<float>(T - 1 - t)));
      if (t == 0) wgt = __fadd_rn(wgt, p.carry);
      ew += x * wgt;
      if (t >= wstart) {
        const float xc = (static_cast<float>(t) - static_cast<float>(T - 1)) + centre;
        sxl += x * xc;
        risky += (x > p.outage_risk) ? 1.0f : 0.0f;
        swin += x;
      }
      if (t == T - 1) last = x;
    }
    __syncthreads();
  }
  const float nw1 = fmaxf(p.n_w, 1.0f);
  const float mean = swin / nw1;

  // --- pass 2: squared deviations over the trailing window
  float ssd = 0.0f;
  for (int c0 = wstart; c0 < T; c0 += CH) {
    load_chunk(tile, lat, n, T, row0, c0);
    __syncthreads();
    const int cols = min(CH, T - c0);
    for (int cc = 0; cc < cols; ++cc) {
      const float d = tile[tid][cc] - mean;
      ssd += d * d;
    }
    __syncthreads();
  }

  const long long r = row0 + tid;
  if (r >= n) return;

  const float p_high = clip01((ew - p.ideal_high) / (4.0f * p.ideal_high));
  const float slope = sxl / fmaxf(p.sum_x2, 1e-6f);
  const float p_trend = clip01(slope * p.n_w / p.trend_scale);
  const float p_outage = clip01(2.0f * risky / nw1);
  const float var = ssd / nw1;
  const float cv = sqrtf(fmaxf(var, 0.0f)) / fmaxf(mean, 1e-6f);
  const float p_instab = clip01((cv - p.cv_low) / p.cv_scale);

  const float over = fmaxf(ew - p.ideal_high, 0.0f);
  const float under = fmaxf(p.ideal_low - ew, 0.0f);
  const float base = 1.0f / (1.0f + (over + under) / p.base_scale);
  const float score = base * (1.0f - p.w_high * p_high) * (1.0f - p.w_trend * p_trend) *
                      (1.0f - p.w_outage * p_outage) * (1.0f - p.w_instab * p_instab);
  out[r] = (last >= p.offline) ? -1.0f : score;
}

}  // namespace

// params: the 15 floats of QosConsts from ideal_low to outage_risk, then
// n_w and sum_x2 (host-computed); window = min(p.window, T).
extern "C" int qos_scores(const void* lat, int lat_bf16, float* out, long long n, int T,
                          int window, const float* params, void* stream) {
  QosConsts p;
  p.ideal_low = params[0];
  p.ideal_high = params[1];
  p.base_scale = params[2];
  p.alpha = params[3];
  p.one_minus_alpha = params[4];
  p.carry = params[5];
  p.trend_scale = params[6];
  p.cv_low = params[7];
  p.cv_scale = params[8];
  p.w_high = params[9];
  p.w_trend = params[10];
  p.w_outage = params[11];
  p.w_instab = params[12];
  p.offline = params[13];
  p.outage_risk = params[14];
  p.n_w = params[15];
  p.sum_x2 = params[16];
  p.T = T;
  p.window = window;
  const unsigned blocks = static_cast<unsigned>((n + ROWS - 1) / ROWS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (lat_bf16) {
    qos_kernel<__nv_bfloat16><<<blocks, ROWS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(lat), out, n, p);
  } else {
    qos_kernel<float><<<blocks, ROWS, 0, s>>>(static_cast<const float*>(lat), out, n, p);
  }
  return static_cast<int>(cudaGetLastError());
}
