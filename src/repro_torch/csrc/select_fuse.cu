// Fused selection tail over materialised stage-2 scores: top-k of `sel`
// (ties -> lower index), Eq. 5 softmax of `val` over the valid candidates,
// Eq. 8 fusion alpha*C + beta*N - gamma*U - delta*R (+ eps*W), dead/invalid
// exclusion and the Eq. 9 argmax, per query.
//
// Replaces: src/repro/kernels/select_fuse.py : _select_kernel
//           (fused_select_pallas), the merged tail of the mega-fleet sharded
//           engine (core/mesh_routing.py) and of the unfused single engine.
//
// Bound on the H100: the data needs `sel` read once, `val` and the per-tool
// rows (N, U, R, dead, W) read at the k winners only, and 16 bytes written
// per query (tool id, C, N, S).  At the mega tail's [256, 16] k 16 that is
// about 0.03 us at 3.35 TB/s: a launch and a few dependent round trips to
// memory are the floor.  At the full tool axis [256, 20010] k 128 it is
// 20.5 MB of `sel`, about 6 us.  The arithmetic is a few operations per
// entry.  What stands between a selection and that floor is reading the
// row more than once (k rounds over it), block barriers per pick, and a
// finale that walks the k winners one after another.
//
// Design (`kernels/select_fuse.py: launch_plan` picks the regime):
//   * One total order, one key: (score desc, index asc), as topk/lax.top_k
//     rank.  A score is clamped (fmaxf(x, NEG)), canonicalised (+0.0f, so
//     -0 and +0 tie and the index decides, as `beats` and the stable sort
//     have it; inputs hold no NaN) and mapped to an order-preserving u32;
//     the rank key is that u32 above the complement of the index, so the k
//     largest rank keys are the top k in rank order and no two are equal.
//   * Narrow rows (n_t <= NARROW_MAX, the sharded merge's [256, 16] and
//     [256, 64]): one warp per query, two queries a block.  Each lane holds
//     E = pow2(n_t / 32) rank keys in registers (padding keys 0 lose to
//     everything), a warp bitonic sort orders them, and the first k go to
//     the finale.  No block barrier, no rounds; the row is read once.
//   * Wide rows (the full tool axis): one 256-thread block per query, each
//     warp owning a contiguous segment.  One read of the row (eight loads in
//     flight a lane) turns scores into keys, stages them in dynamic shared
//     memory where they fit (20,010 keys are 80 KB; rows above WIDE_DYN_MAX
//     bytes are read again from global memory where needed), and counts and
//     collects the entries above NEG (a full-axis row is nearly all NEG:
//     only the candidate servers' tools are scored).  With at most CAND_MAX
//     of them, one warp finishes: it sorts the collected entries and, when
//     there are fewer than k, appends the lowest-index NEG entries, which
//     rank after them in index order.  Only a row with more valid entries
//     runs a radix select over them, 8 bits a pass from the top, with
//     per-warp 256-bin histograms (one add per distinct digit in a warp:
//     a uniform warp adds once, else __match_any_sync groups the lanes),
//     stopping early when the chosen bin is taken whole; then an ordered
//     compaction (ballots, a prefix over the warps' segments) takes every
//     entry above the threshold and the lowest-index entries equal to it.
//   * Finale (select_tail::finale_warp, one warp): a candidate slot per
//     lane (up to four a lane), every lane gathering `val` and the five
//     rows at its winners at once; the max is a shuffle reduce, the softmax
//     denominator is summed by one lane in slot order, C and S use the same
//     rounded operations as the one-lane finale, and the argmax is a shuffle
//     reduce under (S desc, slot asc): bit-equal to the plain version
//     (kernels/ref.py: fused_select_ref) at temperature 1.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "select_tail.cuh"

namespace {

using select_tail::NEG;
using select_tail::Rows;
using select_tail::Weights;

constexpr int K_MAX = 128;
constexpr int NARROW_MAX = 256;    // widest row one warp sorts in registers (8 keys a lane)
constexpr int NARROW_WARPS = 2;    // queries (warps) per block on narrow rows
constexpr int WIDE_THREADS = 256;  // one block per query on wide rows
constexpr int WIDE_WARPS = WIDE_THREADS / 32;
constexpr int BINS = 256;          // radix digit of 8 bits
constexpr int CAND_MAX = 256;      // valid entries a wide row collects (more: the radix path)
constexpr int READ_AHEAD = 8;      // loads in flight a lane while a wide row is read
constexpr int WIDE_DYN_MAX = 232448 - 16384;  // staged row bytes (static shared memory aside)
constexpr unsigned FULL = 0xffffffffu;

static_assert(WIDE_THREADS == BINS, "one thread per histogram bin");
static_assert(NARROW_MAX == 32 * 8, "a narrow row: at most 8 keys a lane");

// Order-preserving key of a clamped, canonicalised score: a > b <=> key(a) > key(b).
__device__ __forceinline__ unsigned score_key(float x) {
  const unsigned u = __float_as_uint(__fadd_rn(fmaxf(x, NEG), 0.0f));
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float key_score(unsigned key) {
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
}
// Higher ranks first under (score desc, index asc); 0 names no entry.
__device__ __forceinline__ unsigned long long rank_key(unsigned key, int idx) {
  return (static_cast<unsigned long long>(key) << 32) | (0xffffffffu - static_cast<unsigned>(idx));
}
__device__ __forceinline__ int rank_index(unsigned long long rk) {
  return static_cast<int>(0xffffffffu - static_cast<unsigned>(rk));
}

// Bitonic sort of the warp's 32 E keys into descending order; position
// p = lane * E + r holds key[r].
template <int E>
__device__ __forceinline__ void warp_sort_desc(unsigned long long (&key)[E], int lane) {
  constexpr int N = 32 * E;
#pragma unroll
  for (int size = 2; size <= N; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride >= E) {  // partner: lane ^ (stride / E), same register
#pragma unroll
        for (int r = 0; r < E; ++r) {
          const int p = lane * E + r;
          const unsigned long long o = __shfl_xor_sync(FULL, key[r], stride / E);
          const bool keep_max = ((p & size) == 0) == ((p & stride) == 0);
          key[r] = keep_max ? (key[r] > o ? key[r] : o) : (key[r] < o ? key[r] : o);
        }
      } else {  // partner: register r ^ stride of this lane
#pragma unroll
        for (int r = 0; r < E; ++r) {
          const int rp = r ^ stride;
          if (rp > r) {
            const bool desc = ((lane * E + r) & size) == 0;
            const unsigned long long a = key[r], b = key[rp];
            if (desc ? a < b : a > b) {
              key[r] = b;
              key[rp] = a;
            }
          }
        }
      }
    }
  }
}

// The warp's sorted keys -> the first k candidates in rank order.
template <int E>
__device__ __forceinline__ void write_ranked(const unsigned long long (&key)[E], int lane, int k,
                                             float* cand_sel, int* cand_gid) {
#pragma unroll
  for (int r = 0; r < E; ++r) {
    const int j = lane * E + r;
    if (j < k) {
      cand_sel[j] = key_score(static_cast<unsigned>(key[r] >> 32));
      cand_gid[j] = rank_index(key[r]);
    }
  }
}

struct Out {
  int* idx;
  float *c, *n, *s;
};

template <typename TV, int E>
__global__ void __launch_bounds__(NARROW_WARPS * 32) select_narrow_kernel(
    const float* __restrict__ sel, const TV* __restrict__ val, Rows rows, Weights wt, int n_q,
    int n_t, int k, Out out) {
  __shared__ float cand_sel[NARROW_WARPS][K_MAX], scratch[NARROW_WARPS][K_MAX];
  __shared__ int cand_gid[NARROW_WARPS][K_MAX];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long qi = static_cast<long long>(blockIdx.x) * NARROW_WARPS + warp;
  if (qi >= n_q) return;  // the whole warp
  const float* src = sel + qi * n_t;
  unsigned long long key[E];
#pragma unroll
  for (int r = 0; r < E; ++r) {  // coalesced: entry r * 32 + lane
    const int e = r * 32 + lane;
    key[r] = e < n_t ? rank_key(score_key(src[e]), e) : 0ull;
  }
  warp_sort_desc<E>(key, lane);
  write_ranked<E>(key, lane, k, cand_sel[warp], cand_gid[warp]);
  __syncwarp();
  select_tail::finale_warp(k, cand_sel[warp], cand_gid[warp], scratch[warp], val + qi * n_t,
                           rows, qi, wt, out.idx, out.c, out.n, out.s);
}

// One warp: sort the rank keys cand[0, m_sort) (m_sort <= 32 E) and
// write the first k ranks; ranks m_sort .. k - 1 are cand[m_sort, k) as
// they stand (the caller put them in rank order).
template <int E>
__device__ __forceinline__ void rank_candidates(const unsigned long long* cand, int m_sort,
                                                int k, int lane, float* cand_sel,
                                                int* cand_gid) {
  unsigned long long key[E];
#pragma unroll
  for (int r = 0; r < E; ++r) {
    const int j = lane * E + r;
    key[r] = j < m_sort ? cand[j] : 0ull;
  }
  warp_sort_desc<E>(key, lane);
  write_ranked<E>(key, lane, min(k, m_sort), cand_sel, cand_gid);
  for (int j = m_sort + lane; j < k; j += 32) {
    cand_sel[j] = key_score(static_cast<unsigned>(cand[j] >> 32));
    cand_gid[j] = rank_index(cand[j]);
  }
}

template <typename TV>
__device__ __forceinline__ void rank_and_finish(const unsigned long long* cand, int m_sort,
                                                int k, int lane, float* cand_sel,
                                                int* cand_gid, float* scratch,
                                                const TV* val_row, const Rows& rows,
                                                long long qi, const Weights& wt,
                                                const Out& out) {
  if (m_sort <= 32)
    rank_candidates<1>(cand, m_sort, k, lane, cand_sel, cand_gid);
  else if (m_sort <= 64)
    rank_candidates<2>(cand, m_sort, k, lane, cand_sel, cand_gid);
  else if (m_sort <= 128)
    rank_candidates<4>(cand, m_sort, k, lane, cand_sel, cand_gid);
  else
    rank_candidates<8>(cand, m_sort, k, lane, cand_sel, cand_gid);
  __syncwarp();
  select_tail::finale_warp(k, cand_sel, cand_gid, scratch, val_row, rows, qi, wt, out.idx,
                           out.c, out.n, out.s);
}

template <typename TV, bool STAGED>
__global__ void __launch_bounds__(WIDE_THREADS) select_wide_kernel(
    const float* __restrict__ sel, const TV* __restrict__ val, Rows rows, Weights wt, int n_t,
    int k, Out out) {
  extern __shared__ unsigned row_keys[];  // STAGED: the row's score keys
  __shared__ unsigned hist[WIDE_WARPS][BINS];
  __shared__ unsigned long long cand[CAND_MAX];  // rank keys of the candidates
  __shared__ float cand_sel[K_MAX], scratch[K_MAX];
  __shared__ int cand_gid[K_MAX];
  __shared__ unsigned warp_sum[WIDE_WARPS], warp_valid[WIDE_WARPS];
  __shared__ unsigned pick_digit, pick_need, pick_count, n_cand;

  const long long qi = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const unsigned lanes_below = (1u << lane) - 1u;
  const unsigned neg_key = score_key(NEG);  // the least key: a clamped score
  const float* src = sel + qi * n_t;
  const TV* val_row = val + qi * n_t;
  auto key_at = [&](int e) -> unsigned {
    if constexpr (STAGED) return row_keys[e];
    else return score_key(src[e]);
  };
  // warp w owns the contiguous segment [lo, hi) in the passes that need
  // the index order: (warp, position) is the index order
  const int seg = (n_t + WIDE_WARPS - 1) / WIDE_WARPS;
  const int lo = min(n_t, warp * seg), hi = min(n_t, lo + seg);
  if (tid == 0) n_cand = 0;
  __syncthreads();

  // --- one read of the row: its keys staged, its valid entries (above NEG)
  // counted and, while they fit, collected (in any order: a rank key
  // carries its index)
  unsigned my_valid = 0;
  for (int b0 = lo; b0 < hi; b0 += 32 * READ_AHEAD) {
    float x[READ_AHEAD];
#pragma unroll
    for (int u = 0; u < READ_AHEAD; ++u) {  // READ_AHEAD loads in flight a lane
      const int e = b0 + 32 * u + lane;
      x[u] = e < hi ? src[e] : NEG;
    }
#pragma unroll
    for (int u = 0; u < READ_AHEAD; ++u) {
      const int e = b0 + 32 * u + lane;
      const unsigned key = score_key(x[u]);
      if constexpr (STAGED) {
        if (e < hi) row_keys[e] = key;
      }
      const bool valid = e < hi && key != neg_key;
      const unsigned bal = __ballot_sync(FULL, valid);
      if (bal) {
        unsigned slot = 0;
        if (lane == 0) slot = atomicAdd(&n_cand, static_cast<unsigned>(__popc(bal)));
        slot = __shfl_sync(FULL, slot, 0) + __popc(bal & lanes_below);
        if (valid && slot < CAND_MAX) cand[slot] = rank_key(key, e);
        my_valid += __popc(bal);
      }
    }
  }
  if (lane == 0) warp_valid[warp] = my_valid;
  __syncthreads();
  unsigned n_valid = 0;
#pragma unroll
  for (int w = 0; w < WIDE_WARPS; ++w) n_valid += warp_valid[w];

  if (n_valid <= CAND_MAX) {  // block-uniform: one warp finishes
    if (warp != 0) return;
    const int m = static_cast<int>(n_valid);
    if (m < k) {
      // fewer valid entries than k: the lowest-index NEG entries fill ranks
      // m .. k - 1 in index order; they lie among the first k + m entries
      unsigned found = 0;
      const unsigned need = static_cast<unsigned>(k - m);
      for (int b0 = 0; found < need; b0 += 32) {
        const int e = b0 + lane;
        unsigned key = 0;
        if (e < n_t) key = key_at(e);
        const bool is_neg = e < n_t && key == neg_key;
        const unsigned bal = __ballot_sync(FULL, is_neg);
        const unsigned pos = found + __popc(bal & lanes_below);
        if (is_neg && pos < need) cand[m + pos] = rank_key(key, e);
        found += __popc(bal);
      }
    }
    __syncwarp();
    rank_and_finish(cand, m, k, lane, cand_sel, cand_gid, scratch, val_row, rows, qi, wt, out);
    return;
  }

  // --- more than CAND_MAX valid entries: a radix select over them, 8 bits
  // a pass from the top, finds the decided top bits `prefix` (under
  // `dmask`) of the k-th largest key; every valid entry above them is
  // taken, and the `need` lowest-index ones equal to them
  unsigned prefix = 0, dmask = 0, need = static_cast<unsigned>(k);
  for (int shift = 24;; shift -= 8) {
    for (int i = tid; i < WIDE_WARPS * BINS; i += WIDE_THREADS) (&hist[0][0])[i] = 0;
    __syncthreads();
    for (int base = 0; base < n_t; base += WIDE_THREADS) {
      const int e = base + tid;
      unsigned digit = BINS;  // no bin
      if (e < n_t) {
        const unsigned key = key_at(e);
        if (key != neg_key && (key & dmask) == prefix) digit = (key >> shift) & (BINS - 1);
      }
      // warp-aggregated adds: one add per distinct digit in the warp
      const unsigned d0 = __shfl_sync(FULL, digit, 0);
      if (__all_sync(FULL, digit == d0)) {
        if (lane == 0 && d0 < BINS) atomicAdd(&hist[warp][d0], 32u);
      } else {
        const unsigned peers = __match_any_sync(FULL, digit);
        if (digit < BINS && lane == __ffs(peers) - 1)
          atomicAdd(&hist[warp][digit], static_cast<unsigned>(__popc(peers)));
      }
    }
    __syncthreads();
    const int b = BINS - 1 - tid;  // bins from the top
    unsigned cnt = 0;
#pragma unroll
    for (int w = 0; w < WIDE_WARPS; ++w) cnt += hist[w][b];
    unsigned incl = cnt;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const unsigned y = __shfl_up_sync(FULL, incl, off);
      if (lane >= off) incl += y;
    }
    if (lane == 31) warp_sum[warp] = incl;
    __syncthreads();
    for (int w = 0; w < warp; ++w) incl += warp_sum[w];
    const unsigned excl = incl - cnt;
    if (excl < need && need <= incl) {  // exactly one bin
      pick_digit = static_cast<unsigned>(b);
      pick_need = need - excl;
      pick_count = cnt;
    }
    __syncthreads();
    prefix |= pick_digit << shift;
    dmask |= static_cast<unsigned>(BINS - 1) << shift;
    need = pick_need;
    if (pick_count == need || shift == 0) break;  // block-uniform
  }

  // --- ordered compaction into cand[0, k): the entries above the
  // threshold, then the `need` lowest-index ones equal to it
  unsigned my_eq = 0;
  for (int b0 = lo; b0 < hi; b0 += 32) {
    const int e = b0 + lane;
    bool eq = false;
    if (e < hi) {
      const unsigned key = key_at(e);
      eq = key != neg_key && (key & dmask) == prefix;
    }
    my_eq += __popc(__ballot_sync(FULL, eq));
  }
  if (lane == 0) warp_sum[warp] = my_eq;
  if (tid == 0) n_cand = 0;
  __syncthreads();
  unsigned eq_pos = 0;
  for (int w = 0; w < warp; ++w) eq_pos += warp_sum[w];
  const unsigned n_above = static_cast<unsigned>(k) - need;
  for (int b0 = lo; b0 < hi; b0 += 32) {
    const int e = b0 + lane;
    const unsigned key = e < hi ? key_at(e) : neg_key;
    const unsigned dk = key & dmask;
    const bool ok = key != neg_key;
    const bool eq = ok && dk == prefix;
    const bool gt = ok && dk > prefix;
    const unsigned bal_eq = __ballot_sync(FULL, eq);
    const unsigned pos = eq_pos + __popc(bal_eq & lanes_below);
    if (eq && pos < need) cand[n_above + pos] = rank_key(key, e);
    eq_pos += __popc(bal_eq);
    const unsigned bal_gt = __ballot_sync(FULL, gt);
    if (bal_gt) {
      unsigned slot = 0;
      if (lane == 0) slot = atomicAdd(&n_cand, static_cast<unsigned>(__popc(bal_gt)));
      slot = __shfl_sync(FULL, slot, 0) + __popc(bal_gt & lanes_below);
      if (gt) cand[slot] = rank_key(key, e);
    }
  }
  __syncthreads();
  if (warp != 0) return;
  rank_and_finish(cand, k, k, lane, cand_sel, cand_gid, scratch, val_row, rows, qi, wt, out);
}

template <typename TV, int E>
int launch_narrow(const float* sel, const void* val, const Rows& rows, const Weights& wt,
                  int n_q, int n_t, int k, const Out& out, cudaStream_t st) {
  const unsigned blocks = static_cast<unsigned>((n_q + NARROW_WARPS - 1) / NARROW_WARPS);
  select_narrow_kernel<TV, E><<<blocks, NARROW_WARPS * 32, 0, st>>>(
      sel, static_cast<const TV*>(val), rows, wt, n_q, n_t, k, out);
  return static_cast<int>(cudaGetLastError());
}

template <typename TV>
int launch(const float* sel, const void* val, const Rows& rows, const Weights& wt, int n_q,
           int n_t, int k, int per_lane, int staged, const Out& out, cudaStream_t st) {
  switch (per_lane) {
    case 1: return launch_narrow<TV, 1>(sel, val, rows, wt, n_q, n_t, k, out, st);
    case 2: return launch_narrow<TV, 2>(sel, val, rows, wt, n_q, n_t, k, out, st);
    case 4: return launch_narrow<TV, 4>(sel, val, rows, wt, n_q, n_t, k, out, st);
    case 8: return launch_narrow<TV, 8>(sel, val, rows, wt, n_q, n_t, k, out, st);
    default: break;
  }
  const TV* v = static_cast<const TV*>(val);
  if (staged) {
    static bool opted_in = false;  // once per instantiation: allow WIDE_DYN_MAX bytes
    if (!opted_in) {
      const cudaError_t err = cudaFuncSetAttribute(select_wide_kernel<TV, true>,
                                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                   WIDE_DYN_MAX);
      if (err != cudaSuccess) return static_cast<int>(err);
      opted_in = true;
    }
    const size_t bytes = static_cast<size_t>(n_t) * sizeof(unsigned);
    select_wide_kernel<TV, true><<<n_q, WIDE_THREADS, bytes, st>>>(sel, v, rows, wt, n_t, k, out);
  } else {
    select_wide_kernel<TV, false><<<n_q, WIDE_THREADS, 0, st>>>(sel, v, rows, wt, n_t, k, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// sel: [n_q, n_t] f32 (clamped to NEG here); val: [n_q, n_t] f32 or bf16
// (val_bf16).  The five per-tool rows (qos, load, rtt, dead, aff) come as
// pointers (nullptr = absent) and strides (0 = one row broadcast, n_t = per
// query).  wlive: nullptr for the static alpha..delta, else a device [4]
// f32 vector read by the kernel.  per_lane (1, 2, 4 or 8: a narrow row of
// at most 32 * per_lane entries; 0: a wide row) and staged come from
// kernels/select_fuse.py: launch_plan; a plan the kernel cannot run is
// refused.
extern "C" int fused_select(const float* sel, const void* val, int val_bf16, const float* qos,
                            const float* load, const float* rtt, const float* dead,
                            const float* aff, long long s_qos, long long s_load,
                            long long s_rtt, long long s_dead, long long s_aff,
                            const float* wlive, float alpha, float beta, float gamma,
                            float delta, float eps, int use_aff, float temp, int n_q, int n_t,
                            int k, int per_lane, int staged, int* idx, float* c, float* n,
                            float* s, void* stream) {
  const bool narrow = per_lane == 1 || per_lane == 2 || per_lane == 4 || per_lane == 8;
  if (k < 1 || k > K_MAX || k > n_t || n_q < 1 || (per_lane != 0 && !narrow) ||
      (narrow && (n_t > 32 * per_lane || staged)) ||
      (staged && static_cast<long long>(n_t) * 4 > WIDE_DYN_MAX))
    return static_cast<int>(cudaErrorInvalidValue);
  const Rows rows{{qos, load, rtt, dead, aff}, {s_qos, s_load, s_rtt, s_dead, s_aff}};
  const Weights wt{wlive, alpha, beta, gamma, delta, eps, use_aff, temp};
  const Out out{idx, c, n, s};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (val_bf16)
    return launch<__nv_bfloat16>(sel, val, rows, wt, n_q, n_t, k, per_lane, staged, out, st);
  return launch<float>(sel, val, rows, wt, n_q, n_t, k, per_lane, staged, out, st);
}
