// Shared stage-2 finale of the fused kernels (score_fuse.cu, select_fuse.cu):
// Eq. 5 softmax over the valid candidates, Eq. 8 fusion
// alpha*C + beta*N - gamma*U - delta*R (+ eps*W), dead/invalid exclusion and
// the Eq. 9 argmax, for one query whose top-k candidates are already chosen.
//
// Bit-equal to the plain version (kernels/ref.py: fused_select_ref) at
// softmax temperature 1: (v - vmax) / temp with a true division, the softmax
// denominator summed over the candidate slots in order, every fusion product
// rounded and summed on its own in the reference's order (no FMA), and a
// strict '>' in the argmax so the earliest candidate wins ties.  A slot is
// valid when its selection score is above NEG / 2; invalid slots keep zero
// softmax mass (unless every slot is invalid) and score NEG.  A row whose
// candidates are all excluded returns slot 0, the top-selection candidate,
// as np.argmax over an all -inf vector does.
#pragma once

#include <cuda_runtime.h>

namespace select_tail {

constexpr float NEG = -1e30f;

enum { ROW_QOS = 0, ROW_LOAD, ROW_RTT, ROW_DEAD, ROW_AFF, N_ROWS };

// Per-tool operand rows: N (qos), U (load), R (rtt), dead mask, W (affinity).
struct Rows {
  const float* ptr[N_ROWS];   // nullptr: operand absent (reads as 0)
  long long stride[N_ROWS];   // 0: one row broadcast to every query; else per query
};

// Fusion weights: static floats, or a live [4] f32 device vector
// [alpha, beta, gamma, delta] read by the kernel (no rebuild, no host sync).
struct Weights {
  const float* live;
  float alpha, beta, gamma, delta, eps;
  int use_aff;
  float temp;
};

__device__ __forceinline__ float row_at(const Rows& r, int which, long long qi, long long g) {
  const float* p = r.ptr[which];
  return p ? p[qi * r.stride[which] + g] : 0.0f;
}

// a ranks before b: higher score, or the same score and a lower index
__device__ __forceinline__ bool beats(float sa, int ga, float sb, int gb) {
  return sa > sb || (sa == sb && ga < gb);
}

// One thread runs it per query.  cand_sel/cand_val/cand_gid hold the m
// (>= 1) candidates in rank order; writes the winner's (tool id, C, N, S).
__device__ inline void finale(int m, const float* cand_sel, const float* cand_val,
                              const int* cand_gid, const Rows& rows, long long qi,
                              const Weights& w, int* out_idx, float* out_c, float* out_n,
                              float* out_s) {
  const float a = w.live ? w.live[0] : w.alpha;
  const float b = w.live ? w.live[1] : w.beta;
  const float gm = w.live ? w.live[2] : w.gamma;
  const float dl = w.live ? w.live[3] : w.delta;

  float vmax = NEG;
  for (int j = 0; j < m; ++j) {
    const float v = cand_sel[j] > 0.5f * NEG ? cand_val[j] : NEG;
    vmax = j == 0 ? v : fmaxf(vmax, v);
  }
  float denom = 0.0f;
  for (int j = 0; j < m; ++j) {
    const float v = cand_sel[j] > 0.5f * NEG ? cand_val[j] : NEG;
    denom = __fadd_rn(denom, expf(__fdiv_rn(__fsub_rn(v, vmax), w.temp)));
  }
  denom = fmaxf(denom, 1e-30f);

  int best_i = 0;
  float best_s = NEG, best_c = 0.0f, best_n = 0.0f;
  for (int j = 0; j < m; ++j) {
    const bool valid = cand_sel[j] > 0.5f * NEG;
    const float v = valid ? cand_val[j] : NEG;
    const int g = cand_gid[j];
    const float c = __fdiv_rn(expf(__fdiv_rn(__fsub_rn(v, vmax), w.temp)), denom);
    const float nq = row_at(rows, ROW_QOS, qi, g);
    const float u = row_at(rows, ROW_LOAD, qi, g);
    const float r = row_at(rows, ROW_RTT, qi, g);
    float s = __fsub_rn(__fsub_rn(__fadd_rn(__fmul_rn(a, c), __fmul_rn(b, nq)), __fmul_rn(gm, u)),
                        __fmul_rn(dl, r));
    if (w.use_aff) s = __fadd_rn(s, __fmul_rn(w.eps, row_at(rows, ROW_AFF, qi, g)));
    if (!valid) s = NEG;
    if (row_at(rows, ROW_DEAD, qi, g) > 0.0f) s = NEG;
    if (j == 0 || s > best_s) {
      best_i = g;
      best_s = s;
      best_c = c;
      best_n = nq;
    }
  }
  out_idx[qi] = best_i;
  out_c[qi] = best_c;
  out_n[qi] = best_n;
  out_s[qi] = best_s;
}

}  // namespace select_tail
