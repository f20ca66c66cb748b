// BM25 scoring kernel: scores[n_q, n_docs] = qcounts[n_q, V] @ weights[n_docs, V]^T, f32.
//
// Replaces: src/repro/kernels/bm25_score.py : _bm25_kernel (bm25_scores_pallas),
//           the stage-1 server scores of the routing pipeline.
//
// Bound on the H100: at the main path's stage-1 shape (256 queries x 10,005
// servers x V 793) the product is 2*256*10005*793 = 4.1 GFLOP over 32 MB of
// weights, so the f32 CUDA-core rate (about 67 TFLOP/s counting a fused
// multiply-add as two operations) bounds it near 61 us; reading the
// operands once takes about 10 us at 3.35 TB/s.  Compute-bound as a dense
// product; the queries are sparse (a handful of terms each), so the work
// the data needs is far less, and the 10 MB output write then bounds it.
//
// Design (simple and right first):
//   * 64x64 output tile per 256-thread block, 4x4 outputs per thread,
//     16-wide vocabulary slices staged through shared memory.
//   * No TF32 and no tensor cores: the operands are unrounded counts and
//     IDF weights.
//   * Every output element is summed over the vocabulary in index order,
//     one rounding per multiply and per add (__fmul_rn / __fadd_rn: no
//     contraction into FMA), with no split-K and no special code for the
//     ragged edge beyond masked zero loads, and the last slice stops at V.
//     So identical corpus rows (replica fleets) score bit-identically
//     wherever they sit in a tile, and the result equals the plain PyTorch
//     version (repro_torch.core.bm25.bm25_scores) bit for bit.  Stage-1
//     ties then break exactly as in the reference.
//   * Avoiding FMA halves the arithmetic rate; wgmma, TMA and pipelining
//     are later work.
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;       // query rows per block
constexpr int BN = 64;       // doc rows per block
constexpr int BK = 16;       // vocabulary slice per shared-memory stage
constexpr int TM = 4;        // query rows per thread
constexpr int TN = 4;        // doc rows per thread
constexpr int THREADS = 256; // (BM / TM) * (BN / TN)
constexpr int PAD = 4;       // keeps float4 alignment, spreads banks

__global__ void __launch_bounds__(THREADS) bm25_kernel(
    const float* __restrict__ q, const float* __restrict__ w,
    float* __restrict__ out, int n_q, int n_d, int V) {
  __shared__ __align__(16) float qs[BK][BM + PAD];
  __shared__ __align__(16) float ws[BK][BN + PAD];

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);   // doc-column group
  const int ty = tid / (BN / TN);   // query-row group
  const int q0 = blockIdx.y * BM;
  const int d0 = blockIdx.x * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < V; k0 += BK) {
    // cooperative loads: BM*BK = 1024 elements, 4 per thread; a row's 16
    // consecutive vocabulary entries come from 16 neighbouring threads
#pragma unroll
    for (int r = 0; r < (BM * BK) / THREADS; ++r) {
      const int e = tid + r * THREADS;
      const int row = e / BK;
      const int col = e % BK;
      const int kk = k0 + col;
      const int gq = q0 + row;
      const int gd = d0 + row;
      qs[col][row] = (gq < n_q && kk < V) ? q[(long long)gq * V + kk] : 0.0f;
      ws[col][row] = (gd < n_d && kk < V) ? w[(long long)gd * V + kk] : 0.0f;
    }
    __syncthreads();

    const int kend = min(BK, V - k0);
    for (int kk = 0; kk < kend; ++kk) {
      const float4 a4 = *reinterpret_cast<const float4*>(&qs[kk][ty * TM]);
      const float4 b4 = *reinterpret_cast<const float4*>(&ws[kk][tx * TN]);
      const float a[TM] = {a4.x, a4.y, a4.z, a4.w};
      const float b[TN] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          acc[i][j] = __fadd_rn(acc[i][j], __fmul_rn(a[i], b[j]));
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gq = q0 + ty * TM + i;
    if (gq >= n_q) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gd = d0 + tx * TN + j;
      if (gd < n_d) out[(long long)gq * n_d + gd] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" int bm25_scores_f32(const float* q, const float* w, float* out,
                               int n_q, int n_d, int V, void* stream) {
  const dim3 grid((n_d + BN - 1) / BN, (n_q + BM - 1) / BM);
  bm25_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      q, w, out, n_q, n_d, V);
  return static_cast<int>(cudaGetLastError());
}
