// Fused stage-2 kernel: tool scoring + candidate mask + streaming top-k +
// softmax expertise + QoS/load/RTT/affinity fusion + argmax, one pass per
// query, never materialising the [n_q, n_tools] score matrix.
//
// Replaces: src/repro/kernels/score_fuse.py : _score_kernel
//           (fused_score_select_pallas), all of stage 2 of the routing pipeline.
//
// Bound on the H100: at the main path's shape (256 queries, 20,010 tools,
// V_t 123, top_s 8) only the tools of each query's 8 candidate servers are
// scored, so the work that the data needs is small: the host-server array
// (80 KB, scanned per query, L2-resident), the candidate tools' weight rows
// and a few per-tool operands.  Reading every input once (9.8 MB of tool
// weights dominate) takes about 3 us at 3.35 TB/s; the arithmetic is
// negligible.  The kernel is bound by latency: stripe loops and block
// barriers, not bytes or FLOPs.
//
// Design (simple and right first):
//   * One block of 256 threads per query (a query tile of one row).  It loops
//     over 512-tool stripes; the running top-k (k <= K_MAX = 128) lives in
//     shared memory.  Blocks run in any order, so nothing is carried across
//     blocks: the stripe loop inside the block replaces the TPU's sequential
//     grid axis.
//   * Stripe skipping: each thread tests its two tools' host servers against
//     the query's candidate servers; a block-wide OR skips a stripe with no
//     candidate tool (almost every stripe at fleet scale).
//   * Scores: one f32 dot product per candidate (query, tool), summed over
//     the vocabulary in index order with one rounding per multiply and per
//     add (no FMA), so identical tool rows score bit-identically and equal
//     the plain version's sequential sums.  bf16 q/w are widened on load.
//     The rerank dot product (RerankRAG) runs only for candidate tools too.
//   * Merge: the running list and the stripe's candidates form one pool;
//     each entry's rank is the number of pool entries that beat it under
//     (score desc, global tool id asc), exactly lax.top_k's order over the
//     full tool axis.  Ranks below k are written to their slot.  Tool ids
//     are int32, so there is no 2^24 cap.
//   * Finale (thread 0, select_tail.cuh, shared with select_fuse.cu):
//     softmax over the valid candidates, fusion
//     alpha*C + beta*N - gamma*U - delta*R (+ eps*W) in the reference's
//     operation order without contraction, dead candidates excluded from
//     the argmax only, strict '>' so the first maximum wins.  Per-tool rows
//     are read at the winners' ids, broadcast (stride 0) or per query.  The
//     fusion weights are static floats or a live [4] f32 device vector.
//     A query whose candidate servers host no tool returns tool 0 with
//     C = 1/k and S = NEG, as the plain version's argmax over all-NEG
//     scores does.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "select_tail.cuh"

namespace {

using select_tail::beats;
using select_tail::NEG;
using select_tail::Rows;
using select_tail::ROW_QOS;
using select_tail::N_ROWS;

constexpr int STRIPE = 512;
constexpr int THREADS = 256;
constexpr int PER_THREAD = STRIPE / THREADS;
constexpr int K_MAX = 128;
constexpr int S_MAX = 128;  // largest top_s

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename TW>
__device__ __forceinline__ float dot(const float* __restrict__ qv, const TW* __restrict__ wrow,
                                     int V) {
  float acc = 0.0f;
  for (int v = 0; v < V; ++v) acc = __fadd_rn(acc, __fmul_rn(qv[v], to_f32(wrow[v])));
  return acc;
}

template <typename TQ, typename TW>
__global__ void __launch_bounds__(THREADS) score_fuse_kernel(
    const TQ* __restrict__ q, const TQ* __restrict__ qr, const TW* __restrict__ w,
    const int* __restrict__ host, const int* __restrict__ cand, Rows rows,
    const float* __restrict__ wlive, float alpha, float beta, float gamma, float delta,
    float eps, int use_aff, float temp, int n_t, int V, int top_s, int k,
    int* __restrict__ out_idx, float* __restrict__ out_c, float* __restrict__ out_n,
    float* __restrict__ out_s) {
  extern __shared__ float qsh[];  // [V] query counts, then [V] rerank counts
  float* qrsh = qsh + V;
  __shared__ int cs[S_MAX];
  __shared__ float run_sel[K_MAX], run_val[K_MAX];
  __shared__ int run_gid[K_MAX];
  __shared__ float new_sel[K_MAX], new_val[K_MAX];
  __shared__ int new_gid[K_MAX];
  __shared__ float mem_sel[STRIPE], mem_val[STRIPE];
  __shared__ int mem_gid[STRIPE];
  __shared__ int mcnt;

  const long long qi = blockIdx.x;
  const int tid = threadIdx.x;
  const bool rerank = qr != nullptr;

  for (int v = tid; v < V; v += THREADS) {
    qsh[v] = to_f32(q[qi * V + v]);
    if (rerank) qrsh[v] = to_f32(qr[qi * V + v]);
  }
  for (int i = tid; i < top_s; i += THREADS) cs[i] = cand[qi * top_s + i];
  if (tid == 0) mcnt = 0;
  __syncthreads();

  int filled = 0;  // valid entries in the running list (same in every thread)
  for (int s0 = 0; s0 < n_t; s0 += STRIPE) {
    bool member[PER_THREAD];
    bool any = false;
#pragma unroll
    for (int h = 0; h < PER_THREAD; ++h) {
      const int g = s0 + tid + h * THREADS;
      member[h] = false;
      if (g < n_t) {
        const int hg = host[g];
        for (int i = 0; i < top_s; ++i) member[h] |= (cs[i] == hg);
      }
      any |= member[h];
    }
    if (!__syncthreads_or(any)) continue;  // stripe hosts no candidate tool

#pragma unroll
    for (int h = 0; h < PER_THREAD; ++h) {
      if (!member[h]) continue;
      const int g = s0 + tid + h * THREADS;
      const TW* wrow = w + static_cast<long long>(g) * V;
      const float sc = dot(qsh, wrow, V);
      const float vv = rerank ? dot(qrsh, wrow, V) : sc;
      const int pos = atomicAdd(&mcnt, 1);
      mem_sel[pos] = sc;
      mem_val[pos] = vv;
      mem_gid[pos] = g;
    }
    __syncthreads();

    // rank merge of (running list U stripe candidates); ranks are distinct
    // because tool ids are, so the slots < k receive exactly one entry each
    const int m = mcnt;
    const int pool = filled + m;
    for (int e = tid; e < pool; e += THREADS) {
      float se, ve;
      int ge;
      if (e < filled) {
        se = run_sel[e]; ve = run_val[e]; ge = run_gid[e];
      } else {
        se = mem_sel[e - filled]; ve = mem_val[e - filled]; ge = mem_gid[e - filled];
      }
      int rank = 0;
      for (int p = 0; p < filled; ++p) rank += beats(run_sel[p], run_gid[p], se, ge);
      for (int p = 0; p < m && rank < k; ++p) rank += beats(mem_sel[p], mem_gid[p], se, ge);
      if (rank < k) {
        new_sel[rank] = se;
        new_val[rank] = ve;
        new_gid[rank] = ge;
      }
    }
    __syncthreads();
    filled = min(k, pool);
    for (int e = tid; e < filled; e += THREADS) {
      run_sel[e] = new_sel[e];
      run_val[e] = new_val[e];
      run_gid[e] = new_gid[e];
    }
    if (tid == 0) mcnt = 0;
    __syncthreads();
  }

  if (tid != 0) return;

  if (filled == 0) {
    out_idx[qi] = 0;
    out_c[qi] = 1.0f / static_cast<float>(k);
    out_n[qi] = select_tail::row_at(rows, ROW_QOS, qi, 0);
    out_s[qi] = NEG;
    return;
  }
  const select_tail::Weights wt{wlive, alpha, beta, gamma, delta, eps, use_aff, temp};
  select_tail::finale(filled, run_sel, run_val, run_gid, rows, qi, wt, out_idx, out_c, out_n,
                      out_s);
}

template <typename TQ, typename TW>
int launch(const void* q, const void* qr, const void* w, const int* host, const int* cand,
           const Rows& rows, const float* wlive, float alpha, float beta, float gamma,
           float delta, float eps, int use_aff, float temp, int n_q, int n_t, int V, int top_s,
           int k, int* idx, float* c, float* n, float* s, cudaStream_t stream) {
  auto kern = score_fuse_kernel<TQ, TW>;
  const size_t smem = 2 * static_cast<size_t>(V) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kern<<<n_q, THREADS, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TQ*>(qr), static_cast<const TW*>(w), host,
      cand, rows, wlive, alpha, beta, gamma, delta, eps, use_aff, temp, n_t, V, top_s, k, idx,
      c, n, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// rows_ptr / rows_stride: qos, load, rtt, dead, aff (nullptr = absent,
// stride 0 = broadcast row, n_t = per query).  wlive: nullptr for the
// static alpha..delta, else a device [4] f32 vector read by the kernel.
extern "C" int fused_score_select(const void* q, const void* qr, int q_bf16, const void* w,
                                  int w_bf16, const int* host, const int* cand,
                                  const float* const* rows_ptr, const long long* rows_stride,
                                  const float* wlive, float alpha, float beta, float gamma,
                                  float delta, float eps, int use_aff, float temp, int n_q,
                                  int n_t, int V, int top_s, int k, int* idx, float* c,
                                  float* n, float* s, void* stream) {
  if (top_s > S_MAX || k > K_MAX || k < 1) return static_cast<int>(cudaErrorInvalidValue);
  Rows rows;
  for (int i = 0; i < N_ROWS; ++i) {
    rows.ptr[i] = rows_ptr[i];
    rows.stride[i] = rows_stride[i];
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_bf16 && w_bf16)
    return launch<__nv_bfloat16, __nv_bfloat16>(q, qr, w, host, cand, rows, wlive, alpha, beta,
                                                gamma, delta, eps, use_aff, temp, n_q, n_t, V,
                                                top_s, k, idx, c, n, s, st);
  if (q_bf16)
    return launch<__nv_bfloat16, float>(q, qr, w, host, cand, rows, wlive, alpha, beta, gamma,
                                        delta, eps, use_aff, temp, n_q, n_t, V, top_s, k, idx,
                                        c, n, s, st);
  if (w_bf16)
    return launch<float, __nv_bfloat16>(q, qr, w, host, cand, rows, wlive, alpha, beta, gamma,
                                        delta, eps, use_aff, temp, n_q, n_t, V, top_s, k, idx,
                                        c, n, s, st);
  return launch<float, float>(q, qr, w, host, cand, rows, wlive, alpha, beta, gamma, delta, eps,
                              use_aff, temp, n_q, n_t, V, top_s, k, idx, c, n, s, st);
}
