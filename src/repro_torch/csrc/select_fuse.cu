// Fused selection tail over materialised stage-2 scores: top-k of `sel`
// (ties -> lower index), Eq. 5 softmax of `val` over the valid candidates,
// Eq. 8 fusion alpha*C + beta*N - gamma*U - delta*R (+ eps*W), dead/invalid
// exclusion and the Eq. 9 argmax, one query per block.
//
// Replaces: src/repro/kernels/select_fuse.py : _select_kernel
//           (fused_select_pallas), the merged tail of the mega-fleet sharded
//           engine (core/mesh_routing.py) and of the unfused single engine.
//
// Bound on the H100: the data needs `sel` and `val` [n_q, n_tools] read once,
// the per-tool rows (N, U, R, dead, W: [n_tools] broadcast or [n_q, n_tools])
// read once, and 16 bytes written per query (tool id, C, N, S).  At the mega
// path's shape [256, 16] that is about 0.1 MB, some 0.03 us at 3.35 TB/s, and
// the arithmetic is negligible: the kernel is bound by launch latency and by
// its k rounds of block barriers, not by bytes or operations.  At the full
// tool axis [256, 20010] the bytes are some 41 MB (12 us).
//
// Design (simple and right first):
//   * One block per query (no query tiles, no 128-lane padding: any width
//     n_tools >= 1, any n_q).  The block is as wide as the row up to 256
//     threads.  Blocks run in any order and share nothing.
//   * The `sel` row is read from global memory in every round and clamped
//     to NEG as it is read.  On the paths that call the kernel the row is at
//     most [20010] f32 (80 KB) and stays in L2 across the rounds; at the
//     mega tail's [16] the kernel is bound by its barriers and its serial
//     finale, not by reads, so a shared-memory copy of the row would buy
//     nothing there.
//   * k rounds of a block-wide argmax under (score desc, index asc): a round
//     considers only the entries that rank after the previous round's pick
//     in that total order, so nothing is marked or written back and the
//     picks come out in exactly the stable sort's order (lax.top_k's tie
//     rule).  Each thread keeps its best of a strided slice, a warp shuffle
//     reduces 32 of them, and one warp reduces the warps' results.  Indices
//     are int32, not the TPU kernel's float lane iota, so there is no 2^24
//     cap on the row width.
//   * Finale (thread 0): `val` and the per-tool rows are read at the k
//     winners' ids only, then select_tail.cuh (shared with score_fuse.cu)
//     computes softmax, fusion and argmax bit-equal to the plain version
//     (kernels/ref.py: fused_select_ref) at temperature 1.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>

#include "select_tail.cuh"

namespace {

using select_tail::beats;
using select_tail::NEG;
using select_tail::N_ROWS;
using select_tail::Rows;
using select_tail::Weights;

constexpr int K_MAX = 128;
constexpr int MAX_THREADS = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float neg_inf() {
  return __int_as_float(static_cast<int>(0xff800000u));
}

// (bs, bg) <- the better of the lane's pair and its partner's, under beats
__device__ __forceinline__ void warp_best(float& bs, int& bg) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float os = __shfl_down_sync(0xffffffffu, bs, off);
    const int og = __shfl_down_sync(0xffffffffu, bg, off);
    if (beats(os, og, bs, bg)) {
      bs = os;
      bg = og;
    }
  }
}

template <typename TV>
__global__ void __launch_bounds__(MAX_THREADS) select_fuse_kernel(
    const float* __restrict__ sel, const TV* __restrict__ val, Rows rows, Weights wt, int n_t,
    int k, int* __restrict__ out_idx, float* __restrict__ out_c,
    float* __restrict__ out_n, float* __restrict__ out_s) {
  __shared__ float cand_sel[K_MAX], cand_val[K_MAX];
  __shared__ int cand_gid[K_MAX];
  __shared__ float red_s[MAX_THREADS / 32];
  __shared__ int red_g[MAX_THREADS / 32];

  const long long qi = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const float* src = sel + qi * n_t;

  float prev_s = 0.0f;
  int prev_g = -1;  // no pick yet
  for (int j = 0; j < k; ++j) {
    float bs = neg_inf();
    int bg = INT_MAX;
    for (int e = tid; e < n_t; e += nthr) {
      const float s = fmaxf(src[e], NEG);
      if (prev_g >= 0 && !beats(prev_s, prev_g, s, e)) continue;  // already picked
      if (beats(s, e, bs, bg)) {
        bs = s;
        bg = e;
      }
    }
    warp_best(bs, bg);
    if ((tid & 31) == 0) {
      red_s[tid >> 5] = bs;
      red_g[tid >> 5] = bg;
    }
    __syncthreads();
    if (tid < 32) {
      const bool has = tid < (nthr >> 5);
      bs = has ? red_s[tid] : neg_inf();
      bg = has ? red_g[tid] : INT_MAX;
      warp_best(bs, bg);
      if (tid == 0) {
        cand_sel[j] = bs;
        cand_gid[j] = bg;
      }
    }
    __syncthreads();
    prev_s = cand_sel[j];
    prev_g = cand_gid[j];
  }

  if (tid != 0) return;
  for (int j = 0; j < k; ++j) cand_val[j] = to_f32(val[qi * n_t + cand_gid[j]]);
  select_tail::finale(k, cand_sel, cand_val, cand_gid, rows, qi, wt, out_idx, out_c, out_n,
                      out_s);
}

template <typename TV>
int launch(const float* sel, const void* val, const Rows& rows, const Weights& wt, int n_q,
           int n_t, int k, int* idx, float* c, float* n, float* s, cudaStream_t stream) {
  const int threads = n_t >= MAX_THREADS ? MAX_THREADS : ((n_t + 31) / 32) * 32;
  select_fuse_kernel<TV><<<n_q, threads, 0, stream>>>(sel, static_cast<const TV*>(val), rows,
                                                       wt, n_t, k, idx, c, n, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// sel: [n_q, n_t] f32; val: [n_q, n_t] f32 or bf16 (val_bf16).  rows_ptr /
// rows_stride: qos, load, rtt, dead, aff (nullptr = absent, stride 0 =
// broadcast row, n_t = per query).  wlive: nullptr for the static
// alpha..delta, else a device [4] f32 vector read by the kernel.
extern "C" int fused_select(const float* sel, const void* val, int val_bf16,
                            const float* const* rows_ptr, const long long* rows_stride,
                            const float* wlive, float alpha, float beta, float gamma,
                            float delta, float eps, int use_aff, float temp, int n_q, int n_t,
                            int k, int* idx, float* c, float* n, float* s, void* stream) {
  if (k < 1 || k > K_MAX || k > n_t || n_q < 1) return static_cast<int>(cudaErrorInvalidValue);
  Rows rows;
  for (int i = 0; i < N_ROWS; ++i) {
    rows.ptr[i] = rows_ptr[i];
    rows.stride[i] = rows_stride[i];
  }
  const Weights wt{wlive, alpha, beta, gamma, delta, eps, use_aff, temp};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (val_bf16)
    return launch<__nv_bfloat16>(sel, val, rows, wt, n_q, n_t, k, idx, c, n, s, st);
  return launch<float>(sel, val, rows, wt, n_q, n_t, k, idx, c, n, s, st);
}
