// QoS scoring kernel: the paper's Eq. 7 network score N in [-1, 1] per
// latency-window row, lat[n, T] (f32 or bf16, ms, newest sample last) -> N[n] f32.
//
// Replaces: src/repro/kernels/qos_score.py : _qos_kernel (qos_score_pallas).
//
// Bound on the H100: a pure row reduction, bound by the bytes it reads.
// The main path's per-query step reads a [64 * 10,005, 64] f32 window,
// 164 MB (more than the 50 MB L2), about 49.7 us at 3.35 TB/s; the shared
// [10,005, 64] window is 2.6 MB, under 1 us, so there a launch and one
// round trip to memory are the floor.  To stream at the memory's rate an
// SM needs some 20 KB or more of loads in flight at all times, each byte
// read once; and the per-row arithmetic (nine IEEE divisions and a square
// root after the sums) must not cost more issue slots than the bytes take.
//
// Design (`kernels/qos_score.py: launch_plan` picks the mode, the vector
// width V and the lanes per row G):
//   * A group of G lanes owns a row: lane g of the group reads the row's
//     chunks g, g + G, ... of V samples each.  V is 4 (f32) or 8 (bf16), a
//     16-byte load, where the row stride and the base address are multiples
//     of 16 bytes (an offset view may not be), else 1.  G is the fewest
//     lanes (a power of two up to 32) that read at most 16 samples each, so
//     a warp covers 32 / G rows at a time: 8 at T = 64.
//   * Ring mode (16-byte chunks, T <= RESIDENT_MAX, a large window such as
//     the per-query step's): persistent 4-warp blocks, each warp walking
//     tiles of 32 rows in G batches.  Every lane copies its own chunks of
//     the batches ahead with cp.async into a private 4-stage ring in shared
//     memory, so three batches of loads stay in flight per warp without
//     holding registers, and the lane reads back only what it copied
//     itself (no barrier); its EWMA weights, the same in every batch, stay
//     in registers.  After a batch's sums are reduced, lane gl == batch keeps
//     its row's sums; after G batches every lane holds one row of the tile
//     and the 32 lanes compute the per-row finale at once, so its divisions
//     are paid once per 32 rows, not once per row by one lane of G.
//   * Register mode (T <= RESIDENT_MAX: a small window such as the shared
//     [10,005, 64] one, which finishes sooner spread over more blocks, or
//     scalar loads): the lane's samples are loaded into registers once;
//     stream mode (T > RESIDENT_MAX) reads chunks as it goes and re-reads
//     the trailing window in pass 2.  Both take one row per group and let
//     lane 0 of the group finish it.
//   * Two passes, as the reference computes the variance around the window
//     mean: pass 1 accumulates the EWMA, the trend numerator, the outage
//     count, the window sum and the last sample; pass 2 the squared
//     deviations over the trailing min(window, T) samples, from the ring or
//     registers where the row was read once.  Only chunks that reach into
//     the window pay for the window terms.
//   * EWMA weights are computed once per block into shared memory (while
//     the first loads are in flight) by the plain version's expression,
//     alpha * (1 - alpha)^age through powf (never a running product, which
//     drifts), plus the (1 - alpha)^T carry of the initial state (a double
//     rounded once to f32 on the host) on the oldest sample, so each weight
//     has the plain version's bits; a T above TABLE_MAX computes each weight
//     where it is used, by the same expression.
//   * The five sums are reduced by __shfl_xor_sync inside the group, so
//     every lane of it holds the same bits; the last sample (the offline
//     clamp) comes from the lane that read column T - 1.
//   Sums run in another order than the plain PyTorch version
//   (repro_torch.core.qos.network_score), so the two agree to a few ulp.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;       // threads per block (register and stream modes)
constexpr int RING_WARPS = 4;      // warps per block (ring mode)
constexpr int RING_STAGES = 4;     // batches a lane has in its ring (3 in flight)
constexpr int TABLE_MAX = 1024;    // longest T whose weights sit in shared memory
constexpr int RESIDENT_MAX = 256;  // longest T read once (ring or registers)
constexpr int LANE_SAMPLES = 16;   // samples a lane reads of such a row
enum Mode { STREAM = 0, REGISTERS = 1, RING = 2 };
static_assert((RING_STAGES & (RING_STAGES - 1)) == 0, "a power of two");

struct QosConsts {
  float ideal_low, ideal_high, base_scale;
  float alpha, one_minus_alpha, carry;
  float trend_scale, cv_low, cv_scale;
  float w_high, w_trend, w_outage, w_instab;
  float offline, outage_risk;
  float n_w, sum_x2;
  int T, window;  // window = min(p.window, T) real trailing samples
};

__device__ __forceinline__ float clip01(float x) { return fminf(fmaxf(x, 0.0f), 1.0f); }

// EWMA weight of sample t, bit for bit the plain version's
__device__ __forceinline__ float ewma_weight(const QosConsts& p, int t) {
  float w = __fmul_rn(p.alpha, powf(p.one_minus_alpha, static_cast<float>(p.T - 1 - t)));
  if (t == 0) w = __fadd_rn(w, p.carry);
  return w;
}

// 16 bytes of samples -> V f32 values.
__device__ __forceinline__ void unpack(const uint4& q, float (&x)[4]) {
  x[0] = __uint_as_float(q.x);
  x[1] = __uint_as_float(q.y);
  x[2] = __uint_as_float(q.z);
  x[3] = __uint_as_float(q.w);
}
__device__ __forceinline__ void unpack(const uint4& q, float (&x)[8]) {
  const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(w[i] << 16);           // bf16 -> f32 is exact
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// Chunk c (V samples) of a row, widened to f32.
template <typename TL, int V>
__device__ __forceinline__ void load_chunk(const TL* __restrict__ row, int c, float (&x)[V]);

template <>
__device__ __forceinline__ void load_chunk<float, 1>(const float* __restrict__ row, int c,
                                                     float (&x)[1]) {
  x[0] = row[c];
}
template <>
__device__ __forceinline__ void load_chunk<__nv_bfloat16, 1>(
    const __nv_bfloat16* __restrict__ row, int c, float (&x)[1]) {
  x[0] = __bfloat162float(row[c]);
}
template <>
__device__ __forceinline__ void load_chunk<float, 4>(const float* __restrict__ row, int c,
                                                     float (&x)[4]) {
  unpack(reinterpret_cast<const uint4*>(row)[c], x);
}
template <>
__device__ __forceinline__ void load_chunk<__nv_bfloat16, 8>(
    const __nv_bfloat16* __restrict__ row, int c, float (&x)[8]) {
  unpack(reinterpret_cast<const uint4*>(row)[c], x);
}

// Pass-1 sums of one lane.
struct Sums {
  float ew = 0.0f, sxl = 0.0f, risky = 0.0f, swin = 0.0f, last = 0.0f;
};

// Weights of chunk c: from the table (one 16-byte load for V = 4), or
// computed where used for a T above TABLE_MAX.
template <int V>
__device__ __forceinline__ void chunk_weights(const QosConsts& p, const float* wtab, bool table,
                                              int c, float (&w)[V]) {
  if constexpr (V % 4 == 0) {
    if (table) {
#pragma unroll
      for (int q = 0; q < V / 4; ++q) {
        const float4 f = reinterpret_cast<const float4*>(wtab)[c * (V / 4) + q];
        w[4 * q] = f.x;
        w[4 * q + 1] = f.y;
        w[4 * q + 2] = f.z;
        w[4 * q + 3] = f.w;
      }
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < V; ++j) w[j] = table ? wtab[c * V + j] : ewma_weight(p, c * V + j);
}

// Pass 1 over chunk c.  Only a chunk that reaches into the trailing window
// pays for the trend, outage and window-sum terms (with the chunk order
// gl + G * i the test is the same for every lane of a group wherever the
// window starts on a multiple of G * V samples).
template <int V>
__device__ __forceinline__ void accumulate(Sums& s, const QosConsts& p, const float (&w)[V],
                                           int c, const float (&x)[V], int wstart,
                                           float centre) {
#pragma unroll
  for (int j = 0; j < V; ++j) s.ew += x[j] * w[j];
  const int t0 = c * V;
  // centred position of sample t: (t - (T - 1)) + centre, exact in f32
  const float xc0 = static_cast<float>(t0 - (p.T - 1)) + centre;
  if (t0 >= wstart) {  // the whole chunk is in the window
#pragma unroll
    for (int j = 0; j < V; ++j) {
      s.sxl += x[j] * (xc0 + static_cast<float>(j));
      s.risky += x[j] > p.outage_risk ? 1.0f : 0.0f;
      s.swin += x[j];
    }
  } else if (t0 + V > wstart) {  // the chunk the window starts in
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const bool in = t0 + j >= wstart;
      const float xj = in ? x[j] : 0.0f;
      s.sxl += xj * (xc0 + static_cast<float>(j));
      s.risky += (in && x[j] > p.outage_risk) ? 1.0f : 0.0f;
      s.swin += xj;
    }
  }
  if (t0 + V == p.T) s.last = x[V - 1];
}

template <int V>
__device__ __forceinline__ float sq_dev(int c, const float (&x)[V], int wstart, float mean) {
  float ssd = 0.0f;
  if (c * V >= wstart) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float d = x[j] - mean;
      ssd += d * d;
    }
  } else if (c * V + V > wstart) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float d = x[j] - mean;
      if (c * V + j >= wstart) ssd += d * d;
    }
  }
  return ssd;
}

// Sum over the G lanes of the group (every lane gets the same bits).
__device__ __forceinline__ float group_sum(float v, int G) {
  for (int off = G >> 1; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// N of row r from its pass-1 sums and squared deviations (one lane writes).
__device__ __forceinline__ float qos_score(const QosConsts& p, float ew, float sxl, float risky,
                                           float mean, float ssd, float last) {
  const float nw1 = fmaxf(p.n_w, 1.0f);
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
  return (last >= p.offline) ? -1.0f : score;
}

// The chunks a lane reads of row r into registers (zeros past the fleet's end).
template <typename TL, int V, int NH>
__device__ __forceinline__ void load_row(const TL* __restrict__ lat, long long r, long long n,
                                         int T, int C, int gl, int G, float (&x)[NH][V]) {
  const bool live = r < n;
  const TL* row = lat + (live ? r : 0) * T;
#pragma unroll
  for (int i = 0; i < NH; ++i) {
    const int c = gl + G * i;
    if (live && c < C) {
      load_chunk<TL, V>(row, c, x[i]);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) x[i][j] = 0.0f;
    }
  }
}

__device__ __forceinline__ void fill_table(float* wtab, const QosConsts& p) {
  for (int t = threadIdx.x; t < p.T; t += blockDim.x) wtab[t] = ewma_weight(p, t);
}

// Register (NH > 0 chunks a lane) and stream (NH = 0) modes: one row per
// group of G lanes, THREADS / G rows a block.
template <typename TL, int V, int NH>
__global__ void __launch_bounds__(THREADS) qos_kernel(const TL* __restrict__ lat,
                                                      float* __restrict__ out, long long n,
                                                      QosConsts p, int G) {
  __shared__ __align__(16) float wtab[TABLE_MAX];
  const int T = p.T;
  const int C = T / V;                           // chunks per row (V divides T)
  const int lane = threadIdx.x & 31;
  const int gl = lane & (G - 1);
  const long long r = static_cast<long long>(blockIdx.x) * (THREADS / G) + threadIdx.x / G;
  const bool live = r < n;
  const TL* row = lat + (live ? r : 0) * T;
  const int wstart = T - p.window;
  const float centre = (p.n_w - 1.0f) / 2.0f;
  const bool table = T <= TABLE_MAX;

  float x[NH > 0 ? NH : 1][V];
  if constexpr (NH > 0) load_row<TL, V, NH>(lat, r, n, T, C, gl, G, x);
  if (table) {  // while the loads are in flight
    fill_table(wtab, p);
    __syncthreads();
  }

  // --- pass 1: EWMA, trend numerator, outage count, window sum, last sample
  Sums s;
  if constexpr (NH > 0) {
#pragma unroll
    for (int i = 0; i < NH; ++i) {
      const int c = gl + G * i;
      if (c < C) {
        float w[V];
        chunk_weights<V>(p, wtab, table, c, w);
        accumulate<V>(s, p, w, c, x[i], wstart, centre);
      }
    }
  } else {
    for (int c = gl; c < C; c += G) {
      float z[V];
      if (live) {
        load_chunk<TL, V>(row, c, z);
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) z[j] = 0.0f;
      }
      float w[V];
      chunk_weights<V>(p, wtab, table, c, w);
      accumulate<V>(s, p, w, c, z, wstart, centre);
    }
  }
  const float ew = group_sum(s.ew, G);
  const float sxl = group_sum(s.sxl, G);
  const float risky = group_sum(s.risky, G);
  const float mean = group_sum(s.swin, G) / fmaxf(p.n_w, 1.0f);
  const float last = __shfl_sync(0xffffffffu, s.last, (lane & ~(G - 1)) | ((C - 1) & (G - 1)));

  // --- pass 2: squared deviations over the trailing window
  float ssd = 0.0f;
  if constexpr (NH > 0) {
#pragma unroll
    for (int i = 0; i < NH; ++i) {
      const int c = gl + G * i;
      if (c < C) ssd += sq_dev<V>(c, x[i], wstart, mean);
    }
  } else {
    for (int c = wstart / V + gl; c < C; c += G) {
      float z[V];
      if (live) {
        load_chunk<TL, V>(row, c, z);
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) z[j] = 0.0f;
      }
      ssd += sq_dev<V>(c, z, wstart, mean);
    }
  }
  ssd = group_sum(ssd, G);
  if (live && gl == 0) out[r] = qos_score(p, ew, sxl, risky, mean, ssd, last);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem) : "memory");
}

// Ring mode: 16-byte chunks, T <= RESIDENT_MAX, NH = LANE_SAMPLES / V.
template <typename TL>
__global__ void __launch_bounds__(RING_WARPS * 32) qos_ring_kernel(const TL* __restrict__ lat,
                                                                   float* __restrict__ out,
                                                                   long long n, QosConsts p,
                                                                   int G) {
  constexpr int V = 16 / sizeof(TL);
  constexpr int NH = LANE_SAMPLES / V;
  __shared__ __align__(16) float wtab[RESIDENT_MAX];
  __shared__ uint4 ring[RING_WARPS][RING_STAGES][NH][32];  // each lane its own column
  const int T = p.T;
  const int C = T / V;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gl = lane & (G - 1);
  const int lg = __ffs(G) - 1;                     // G = 1 << lg
  const int per_batch = 32 >> lg;                  // rows of a batch: one per group
  const int g = lane >> lg;                        // this lane's group
  const int wstart = T - p.window;
  const float centre = (p.n_w - 1.0f) / 2.0f;
  const long long n_tiles = (n + 31) / 32;
  const long long gw = static_cast<long long>(blockIdx.x) * RING_WARPS + warp;
  const long long tw = static_cast<long long>(gridDim.x) * RING_WARPS;
  const long long steps = gw < n_tiles ? ((n_tiles - gw + tw - 1) / tw) << lg : 0;
  // step s: batch (s mod G) of this warp's tile gw + (s / G) * tw
  auto tile_of = [&](long long s) { return gw + (s >> lg) * tw; };
  auto issue = [&](long long s) {
    const long long r = tile_of(s) * 32 + (s & (G - 1)) * per_batch + g;
    if (r >= n) return;
    const TL* row = lat + r * T;
#pragma unroll
    for (int i = 0; i < NH; ++i) {
      const int c = gl + G * i;
      if (c < C) cp_async16(&ring[warp][s & (RING_STAGES - 1)][i][lane], row + c * V);
    }
  };
#pragma unroll
  for (int s = 0; s < RING_STAGES - 1; ++s) {
    if (s < steps) issue(s);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  fill_table(wtab, p);  // while the first batches are in flight
  __syncthreads();
  float w[NH][V];  // the lane's chunks are the same in every batch: so are their weights
#pragma unroll
  for (int i = 0; i < NH; ++i) {
    const int c = gl + G * i;
    if (c < C) {
      chunk_weights<V>(p, wtab, true, c, w[i]);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) w[i][j] = 0.0f;
    }
  }

  float f_ew = 0.0f, f_sxl = 0.0f, f_risky = 0.0f, f_mean = 0.0f, f_ssd = 0.0f, f_last = 0.0f;
  for (long long s = 0; s < steps; ++s) {
    if (s + RING_STAGES - 1 < steps) issue(s + RING_STAGES - 1);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group %0;\n" ::"n"(RING_STAGES - 1) : "memory");
    const int b = static_cast<int>(s & (G - 1));
    const long long tile = tile_of(s);
    const bool live = tile * 32 + b * per_batch + g < n;
    float x[NH][V];
#pragma unroll
    for (int i = 0; i < NH; ++i) {
      const int c = gl + G * i;
      if (live && c < C) {
        unpack(ring[warp][s & (RING_STAGES - 1)][i][lane], x[i]);
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) x[i][j] = 0.0f;
      }
    }
    Sums sm;
#pragma unroll
    for (int i = 0; i < NH; ++i) {
      const int c = gl + G * i;
      if (c < C) accumulate<V>(sm, p, w[i], c, x[i], wstart, centre);
    }
    const float ew = group_sum(sm.ew, G);
    const float sxl = group_sum(sm.sxl, G);
    const float risky = group_sum(sm.risky, G);
    const float mean = group_sum(sm.swin, G) / fmaxf(p.n_w, 1.0f);
    const float last = __shfl_sync(0xffffffffu, sm.last, (lane & ~(G - 1)) | ((C - 1) & (G - 1)));
    float ssd = 0.0f;
#pragma unroll
    for (int i = 0; i < NH; ++i) {
      const int c = gl + G * i;
      if (c < C) ssd += sq_dev<V>(c, x[i], wstart, mean);
    }
    ssd = group_sum(ssd, G);
    if (gl == b) {  // this lane finishes row b * per_batch + g of the tile
      f_ew = ew;
      f_sxl = sxl;
      f_risky = risky;
      f_mean = mean;
      f_ssd = ssd;
      f_last = last;
    }
    if (b == G - 1) {
      const long long r = tile * 32 + gl * per_batch + g;
      if (r < n) out[r] = qos_score(p, f_ew, f_sxl, f_risky, f_mean, f_ssd, f_last);
    }
  }
}

// SMs x blocks of `kernel` an SM holds, once per kernel.
template <typename K>
long long resident_blocks(K kernel, int threads, long long& cache) {
  if (cache == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
    cache = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  }
  return cache;
}

template <typename TL, int V>
int launch(const void* lat, float* out, long long n, const QosConsts& p, int G, int mode,
           cudaStream_t s) {
  const TL* l = static_cast<const TL*>(lat);
  if constexpr (V > 1) {
    if (mode == RING) {
      static long long cache = 0;
      const long long warps = (n + 31) / 32;
      const long long want = (warps + RING_WARPS - 1) / RING_WARPS;
      const long long most = resident_blocks(qos_ring_kernel<TL>, RING_WARPS * 32, cache);
      const unsigned blocks = static_cast<unsigned>(want < most ? want : most);
      qos_ring_kernel<TL><<<blocks, RING_WARPS * 32, 0, s>>>(l, out, n, p, G);
      return static_cast<int>(cudaGetLastError());
    }
  }
  const long long rows = THREADS / G;
  const unsigned blocks = static_cast<unsigned>((n + rows - 1) / rows);
  if (mode == REGISTERS)
    qos_kernel<TL, V, LANE_SAMPLES / V><<<blocks, THREADS, 0, s>>>(l, out, n, p, G);
  else
    qos_kernel<TL, V, 0><<<blocks, THREADS, 0, s>>>(l, out, n, p, G);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// params: the 15 floats of QosConsts from ideal_low to outage_risk, then
// n_w and sum_x2 (host-computed); window = min(p.window, T).  vec (1, or 4
// for f32 / 8 for bf16), group (lanes per row) and mode (0 stream, 1
// registers, 2 ring) come from kernels/qos_score.py: launch_plan; a plan
// the kernel cannot run is refused.
extern "C" int qos_scores(const void* lat, int lat_bf16, float* out, long long n, int T,
                          int window, const float* params, int vec, int group, int mode,
                          void* stream) {
  const int wide = lat_bf16 ? 8 : 4;
  const bool read_once = mode == REGISTERS || mode == RING;
  if (n < 1 || T < 1 || window < 1 || window > T || (vec != 1 && vec != wide) ||
      T % vec != 0 || group < 1 || group > 32 || (group & (group - 1)) != 0 ||
      mode < STREAM || mode > RING || (mode == RING && vec == 1) ||
      (read_once && (T > RESIDENT_MAX || (T + group - 1) / group > LANE_SAMPLES)))
    return static_cast<int>(cudaErrorInvalidValue);
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (lat_bf16) {
    return vec == 1 ? launch<__nv_bfloat16, 1>(lat, out, n, p, group, mode, s)
                    : launch<__nv_bfloat16, 8>(lat, out, n, p, group, mode, s);
  }
  return vec == 1 ? launch<float, 1>(lat, out, n, p, group, mode, s)
                  : launch<float, 4>(lat, out, n, p, group, mode, s);
}
