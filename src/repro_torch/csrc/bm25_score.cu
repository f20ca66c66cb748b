// BM25 scoring kernel, a sparse-query product:
//   scores[n_q, n_docs] = qcounts[n_q, V] @ weights[n_docs, V]^T, f32,
// with the weights given transposed, wt[V, n_docs] (f32, or bf16 widened
// exactly on load).
//
// Replaces: src/repro/kernels/bm25_score.py : _bm25_kernel (bm25_scores_pallas),
//           the stage-1 server scores of the routing pipeline.
//
// Bound on the H100: a query holds a handful of terms (about 18 of V_s 793
// at the main path's stage-1 shape, 256 queries x 10,005 servers, and the
// whole batch uses about 35 columns), so the work the data needs is the
// used weight columns (1.4 MB) and the [256, 10005] f32 output (10.2 MB):
// about 3.7 us at 3.35 TB/s.  The dense product would be 4.1 GFLOP; the
// non-zeros need about 91 MFLOP.  Bound by the output write.
//
// Design:
//   * A block takes a tile of BQ = 16 queries x BN = 512 docs, 256 threads,
//     each holding 16 x 2 accumulators (docs tid and tid + 256 of the tile).
//   * The vocabulary is walked in chunks of 256 columns.  For each chunk the
//     block finds, on the card, the columns that some query of the tile
//     uses (one column per thread, a warp ballot and a prefix over the
//     warps), in increasing index order, and stages those columns' 16
//     query values in shared memory.  No host round trip, no pre-pass.
//   * For each used column, in order, every thread reads its docs' weights
//     from the row wt[c, :] (neighbouring threads, neighbouring docs: whole
//     sectors) and adds q * w to the 16 x 2 sums.  The weights of the next
//     UB = 4 columns are in flight while a batch of 4 is summed.  The
//     registers are held to 80 a thread so that 3 blocks fit an SM and the
//     320 blocks of the main path's shape run in one wave.
//   * What bounds it now: the f32 multiplies and adds over the tile's union
//     of used columns (the zero terms of the union included) on the CUDA
//     cores, then the prologue's scan of the query tile, then the store.
//   * Exactness: every output is summed over the vocabulary in increasing
//     index order with one rounding per multiply and per add (__fmul_rn /
//     __fadd_rn, no FMA), as the plain version (core/bm25.py: bm25_scores)
//     does over all V.  A column that this query does not use adds
//     0 * w = +-0 for finite w, which leaves a sum that is never -0 (it
//     starts at +0) unchanged bit for bit; so skipping the unused columns,
//     or summing over the tile's union of used columns, gives the same bits
//     as the dense ordered sum, for any finite weights and any density.
//     Identical corpus rows (replica fleets) score bit-identically, so
//     stage-1 ties break as in the reference.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int BQ = 16;               // queries per block
constexpr int DPT = 2;               // docs per thread
constexpr int BN = THREADS * DPT;    // docs per block
constexpr int CH = THREADS;          // vocabulary columns per chunk, one per thread
constexpr int UB = 4;                // used columns whose weights are loaded together
constexpr int MIN_BLOCKS = 3;        // blocks per SM the registers must allow

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename TW>
__device__ __forceinline__ void load_column(float (&w)[DPT], const TW* __restrict__ wt, int c,
                                            int d, int n_d) {
  const TW* row = wt + static_cast<long long>(c) * n_d;
#pragma unroll
  for (int j = 0; j < DPT; ++j) {
    const int dj = d + j * THREADS;
    w[j] = dj < n_d ? to_f32(row[dj]) : 0.0f;
  }
}

template <typename TW>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) bm25_sparse_kernel(
    const float* __restrict__ q, const TW* __restrict__ wt, float* __restrict__ out, int n_q,
    int n_d, int V) {
  __shared__ __align__(16) float qsh[CH][BQ];   // the tile's values of the chunk's used columns
  __shared__ int ucol[CH];                      // the used columns, increasing
  __shared__ int wcnt[WARPS];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q0 = blockIdx.y * BQ;
  const int nq = min(BQ, n_q - q0);
  const int d = blockIdx.x * BN + tid;

  float acc[BQ][DPT];
#pragma unroll
  for (int i = 0; i < BQ; ++i)
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.0f;

  for (int c0 = 0; c0 < V; c0 += CH) {
    // which columns of the chunk does some query of the tile use?
    const int c = c0 + tid;
    float qv[BQ];
    bool used = false;
#pragma unroll
    for (int i = 0; i < BQ; ++i) {
      qv[i] = (c < V && i < nq) ? q[static_cast<long long>(q0 + i) * V + c] : 0.0f;
      used |= qv[i] != 0.0f;
    }
    const unsigned ball = __ballot_sync(0xffffffffu, used);
    if (lane == 0) wcnt[warp] = __popc(ball);
    __syncthreads();
    int base = 0, n_used = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const int n = wcnt[w];
      base += w < warp ? n : 0;
      n_used += n;
    }
    if (used) {
      const int pos = base + __popc(ball & ((1u << lane) - 1u));
      ucol[pos] = c;
#pragma unroll
      for (int i = 0; i < BQ; i += 4)
        *reinterpret_cast<float4*>(&qsh[pos][i]) =
            make_float4(qv[i], qv[i + 1], qv[i + 2], qv[i + 3]);
    }
    __syncthreads();

    // sum the used columns in increasing order, UB columns' weights in
    // flight while the previous UB are summed
    float wc[UB][DPT], wn[UB][DPT];
#pragma unroll
    for (int b = 0; b < UB; ++b)
      if (b < n_used) load_column(wn[b], wt, ucol[b], d, n_d);
    for (int u0 = 0; u0 < n_used; u0 += UB) {
#pragma unroll
      for (int b = 0; b < UB; ++b)
#pragma unroll
        for (int j = 0; j < DPT; ++j) wc[b][j] = wn[b][j];
#pragma unroll
      for (int b = 0; b < UB; ++b)
        if (u0 + UB + b < n_used) load_column(wn[b], wt, ucol[u0 + UB + b], d, n_d);
#pragma unroll
      for (int b = 0; b < UB; ++b) {
        if (u0 + b >= n_used) break;
#pragma unroll
        for (int i = 0; i < BQ; i += 4) {
          const float4 a4 = *reinterpret_cast<const float4*>(&qsh[u0 + b][i]);
          const float a[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
          for (int ii = 0; ii < 4; ++ii)
#pragma unroll
            for (int j = 0; j < DPT; ++j)
              acc[i + ii][j] = __fadd_rn(acc[i + ii][j], __fmul_rn(a[ii], wc[b][j]));
        }
      }
    }
    __syncthreads();   // the next chunk overwrites ucol and qsh
  }

#pragma unroll
  for (int i = 0; i < BQ; ++i) {
    if (i >= nq) break;
    float* orow = out + static_cast<long long>(q0 + i) * n_d;
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      const int dj = d + j * THREADS;
      if (dj < n_d) orow[dj] = acc[i][j];
    }
  }
}

}  // namespace

// q [n_q, V] f32, wt [V, n_d] f32 (w_bf16 = 0) or bf16 (w_bf16 = 1), out [n_q, n_d] f32.
extern "C" int bm25_scores_sparse(const float* q, const void* wt, int w_bf16, float* out,
                                  int n_q, int n_d, int V, void* stream) {
  const dim3 grid((n_d + BN - 1) / BN, (n_q + BQ - 1) / BQ);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (w_bf16)
    bm25_sparse_kernel<__nv_bfloat16><<<grid, THREADS, 0, st>>>(
        q, static_cast<const __nv_bfloat16*>(wt), out, n_q, n_d, V);
  else
    bm25_sparse_kernel<float><<<grid, THREADS, 0, st>>>(q, static_cast<const float*>(wt), out,
                                                         n_q, n_d, V);
  return static_cast<int>(cudaGetLastError());
}
