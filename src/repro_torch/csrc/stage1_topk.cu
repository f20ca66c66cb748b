// Stage 1 of the sharded routing engine: per (shard, query) row, the top k
// servers under (score desc, local index asc), with the dead and pad masks
// applied as the scores are read.  Tiled fleets read the template scores
// s_tpl [n_q, M] through the doc map [J, S] in place; dense fleets read
// scores [J, n_q, S].  Nothing [J, n_q, S]-sized is written.
//
// Replaces no TPU kernel: the reference selects with lax.top_k
// (src/repro/core/mesh_routing.py : _stage1_stacked), which the port first
// ran as a full stable torch.sort of every row (kernels/ref.py:
// stage1_topk_ref, the plain version).
//
// Bound on the H100: bytes.  At the mega route's shape (4 shards of
// 250,000 servers, 256 queries, k 8, 15 templates) the data needs the doc
// map (4 MB), the dead vector (4 MB), the valid mask (1 MB) and the
// template scores (15 KB) read once and 64 KB written: about 2.7 us at
// 3.35 TB/s, all of it resident in the 50 MB L2.  The sort it replaces
// wrote and sorted 1 GB of gathered scores.  What stands between a
// selection and that floor is the per-entry work: 256 M (row, server)
// entries each need a mask, a score and a compare.
//
// Design:
//   * One key, one order: the score, canonicalised (-0 and +0 tie; every
//     NaN is one key above +inf, where the CPU's stable sort puts NaN), maps
//     to an order-preserving u32; the rank key is that u32 above the
//     complement of the local index, so the k largest rank keys are the top
//     k in rank order.  NEG (dead) and PAD_NEG (pad) keep their own keys,
//     PAD_NEG strictly below NEG, as the module's merge relies on.
//   * Scan (stage1_scan_kernel): a block owns one shard's CHUNK servers and
//     a group of queries.  It stages the chunk's masks and template ids once
//     in shared memory as one code a server (no entry / pad / dead /
//     template id).  Each warp then takes its queries one by one: it turns
//     the query's M template scores into keys in shared memory (after the
//     three codes' keys), so an entry's key is one shared-memory lookup.
//     Lanes read 4 codes at a time (one 16-byte load), and the warp keeps
//     its sorted top k in registers (position r * 32 + lane in register r).
//     Entries are visited in index order, so an entry that does not beat
//     the k-th key's score cannot enter: one u32 compare and one ballot per
//     128 entries is the common case on a tied fleet.  The rare entries
//     that pass are inserted one by one in index order (a ballot for the
//     position, a shuffle to shift the tail).
//   * Merge (stage1_merge_kernel): a warp per (shard, query) merges the
//     chunks' partial lists by the same insertion under the full 64-bit
//     key, then writes each winner's value, read again from the inputs with
//     the masks (bit-equal to the plain version's, -0 and NaN payloads
//     included), and its global server id.
//   * Launches on the caller's stream; the partial lists live in a
//     workspace the wrapper allocates; no synchronisation.
#include <cuda_runtime.h>

namespace {

constexpr float NEG = -1e30f;
constexpr float PAD_NEG = -2e30f;
constexpr int K_MAX = 128;        // largest k: 4 rank keys a lane
constexpr int TPL_MAX = 256;      // template scores a warp keeps as keys
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CHUNK = 8192;       // servers a scan block stages
constexpr int STEP = 128;         // entries a warp reads per step, 4 a lane
constexpr int MERGE_WARPS = 4;
constexpr int CODE_NONE = -3, CODE_PAD = -2, CODE_DEAD = -1;  // below: template ids
constexpr unsigned FULL = 0xffffffffu;

static_assert(CHUNK % STEP == 0, "a chunk is whole steps");

// Order-preserving key: a > b <=> key(a) > key(b); -0 == +0; NaN above +inf.
// No score maps to 0, which names no entry.
__device__ __forceinline__ unsigned score_key(float x) {
  if (x != x) return 0xffffffffu;
  const unsigned u = __float_as_uint(x == 0.0f ? 0.0f : x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ unsigned long long rank_key(unsigned key, int idx) {
  return (static_cast<unsigned long long>(key) << 32) | (0xffffffffu - static_cast<unsigned>(idx));
}
__device__ __forceinline__ int rank_index(unsigned long long rk) {
  return static_cast<int>(0xffffffffu - static_cast<unsigned>(rk));
}

// The warp's list: position p = r * 32 + lane holds lst[r]; rank keys in
// descending order, 0 past the entries held.  Inserts c, which ranks above
// position k - 1, drops what falls to position k, and returns the rank key
// now at position k - 1 (0 while fewer than k are held).
template <int E>
__device__ __forceinline__ unsigned long long insert(unsigned long long (&lst)[E],
                                                     unsigned long long c, int k, int lane) {
  int pos = 0;
#pragma unroll
  for (int r = 0; r < E; ++r) pos += __popc(__ballot_sync(FULL, lst[r] > c));
  unsigned long long up[E], wrap[E];
#pragma unroll
  for (int r = 0; r < E; ++r) {
    up[r] = __shfl_up_sync(FULL, lst[r], 1);
    wrap[r] = __shfl_sync(FULL, lst[r], 31);
  }
#pragma unroll
  for (int r = 0; r < E; ++r) {
    const int p = r * 32 + lane;
    const unsigned long long prev = lane ? up[r] : (r ? wrap[r - 1] : 0ull);
    const unsigned long long v = p < pos ? lst[r] : (p == pos ? c : prev);
    lst[r] = p < k ? v : 0ull;
  }
  unsigned long long last = 0;
#pragma unroll
  for (int r = 0; r < E; ++r) {
    const unsigned long long t = __shfl_sync(FULL, lst[r], (k - 1) & 31);
    if (r == ((k - 1) >> 5)) last = t;
  }
  return last;
}

struct Args {
  const float* scores;          // tiled: s_tpl [n_q, M]; dense: [J, n_q, S]
  const int* doc;               // tiled: [J, S] template of each server
  const float* dead;            // nullptr, [J, 1, S] or [J, n_q, S]: > 0 scores NEG
  const unsigned char* valid;   // [J, S]: 0 scores PAD_NEG
  const int* gid;               // [J, S] global server id
  int J, n_q, S, M, k, n_chunks, q_per_block;
  unsigned long long* part;     // [J, n_q, n_chunks, k] the chunks' lists
  float* v_out;                 // [J, n_q, k]
  int* gid_out;                 // [J, n_q, k]
};

// An entry's key from its staged code (see the note) and, for dense scores
// or per-query dead rows, the query's own row.
template <bool TILED, bool DEAD_Q>
__device__ __forceinline__ unsigned entry_key(int code, const unsigned* kr, const float* srow,
                                              const float* drow, int i) {
  if (TILED && !DEAD_Q) return kr[code + 3];
  if (code < 0) return kr[code + 3];
  if (DEAD_Q && drow[i] > 0.0f) return kr[CODE_DEAD + 3];
  if (TILED) return kr[code + 3];
  return score_key(srow[i]);
}

template <bool TILED, bool DEAD_Q, int E>
__global__ void __launch_bounds__(THREADS) stage1_scan_kernel(Args a) {
  __shared__ __align__(16) int codes[CHUNK];
  __shared__ unsigned keys[WARPS][TPL_MAX + 3];  // per warp: the codes' keys, then the templates'
  const int chunk = blockIdx.x, j = blockIdx.y;
  const int q0 = blockIdx.z * a.q_per_block;
  const int q1 = min(a.n_q, q0 + a.q_per_block);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int e0 = chunk * CHUNK;
  const int len = min(CHUNK, a.S - e0);
  const long long row = static_cast<long long>(j) * a.S + e0;

  for (int i = threadIdx.x; i < CHUNK; i += THREADS) {
    int code = CODE_NONE;
    if (i < len) {
      if (!a.valid[row + i]) code = CODE_PAD;
      else if (!DEAD_Q && a.dead != nullptr && a.dead[row + i] > 0.0f) code = CODE_DEAD;
      else code = TILED ? a.doc[row + i] : 0;
    }
    codes[i] = code;
  }
  unsigned* kr = keys[warp];
  if (lane == 0) {
    kr[CODE_NONE + 3] = 0u;
    kr[CODE_PAD + 3] = score_key(PAD_NEG);
    kr[CODE_DEAD + 3] = score_key(NEG);
  }
  __syncthreads();

  for (int q = q0 + warp; q < q1; q += WARPS) {
    const long long jq = static_cast<long long>(j) * a.n_q + q;
    if (TILED) {
      __syncwarp();  // the previous query's keys are read
      for (int m = lane; m < a.M; m += 32)
        kr[3 + m] = score_key(a.scores[static_cast<long long>(q) * a.M + m]);
      __syncwarp();
    }
    const float* srow = TILED ? nullptr : a.scores + jq * a.S + e0;
    const float* drow = DEAD_Q ? a.dead + jq * a.S + e0 : nullptr;
    unsigned long long lst[E];
#pragma unroll
    for (int r = 0; r < E; ++r) lst[r] = 0ull;
    unsigned thr = 0;  // the score key at position k - 1 (0 until k are held)
    for (int b = 0; b < len; b += STEP) {
      const int4 c4 = reinterpret_cast<const int4*>(codes + b)[lane];
      const int c[4] = {c4.x, c4.y, c4.z, c4.w};
      unsigned key[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        key[u] = entry_key<TILED, DEAD_Q>(c[u], kr, srow, drow, b + 4 * lane + u);
      const unsigned mx = max(max(key[0], key[1]), max(key[2], key[3]));
      unsigned bal = __ballot_sync(FULL, mx > thr);
      while (bal) {  // warp-uniform: the passing lanes in index order
        const int src = __ffs(bal) - 1;
        bal &= bal - 1;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const unsigned kk = __shfl_sync(FULL, key[u], src);
          if (kk > thr)
            thr = static_cast<unsigned>(
                insert<E>(lst, rank_key(kk, e0 + b + 4 * src + u), a.k, lane) >> 32);
        }
      }
    }
    unsigned long long* out = a.part + (jq * a.n_chunks + chunk) * a.k;
#pragma unroll
    for (int r = 0; r < E; ++r) {
      const int p = r * 32 + lane;
      if (p < a.k) out[p] = lst[r];
    }
  }
}

template <bool TILED, bool DEAD_Q, int E>
__global__ void __launch_bounds__(MERGE_WARPS * 32) stage1_merge_kernel(Args a) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long jq = static_cast<long long>(blockIdx.x) * MERGE_WARPS + warp;
  if (jq >= static_cast<long long>(a.J) * a.n_q) return;  // the whole warp
  const int j = static_cast<int>(jq / a.n_q), q = static_cast<int>(jq % a.n_q);
  const unsigned long long* src = a.part + jq * a.n_chunks * a.k;
  const int n = a.n_chunks * a.k;
  unsigned long long lst[E];
#pragma unroll
  for (int r = 0; r < E; ++r) lst[r] = 0ull;
  unsigned long long thr = 0;
  for (int b = 0; b < n; b += 32) {
    const unsigned long long x = b + lane < n ? src[b + lane] : 0ull;
    unsigned bal = __ballot_sync(FULL, x > thr);
    while (bal) {
      const int s = __ffs(bal) - 1;
      bal &= bal - 1;
      const unsigned long long c = __shfl_sync(FULL, x, s);
      if (c > thr) thr = insert<E>(lst, c, a.k, lane);
    }
  }
#pragma unroll
  for (int r = 0; r < E; ++r) {
    const int p = r * 32 + lane;
    if (p >= a.k || lst[r] == 0ull) continue;  // k <= S: every position holds an entry
    const int e = rank_index(lst[r]);
    const long long g = static_cast<long long>(j) * a.S + e;
    float v;
    if (!a.valid[g]) v = PAD_NEG;
    else if (a.dead != nullptr && a.dead[DEAD_Q ? jq * a.S + e : g] > 0.0f) v = NEG;
    else if (TILED) v = a.scores[static_cast<long long>(q) * a.M + a.doc[g]];
    else v = a.scores[jq * a.S + e];
    a.v_out[jq * a.k + p] = v;
    a.gid_out[jq * a.k + p] = a.gid[g];
  }
}

template <bool TILED, bool DEAD_Q, int E>
int launch(const Args& a, cudaStream_t st) {
  const dim3 grid(static_cast<unsigned>(a.n_chunks), static_cast<unsigned>(a.J),
                  static_cast<unsigned>((a.n_q + a.q_per_block - 1) / a.q_per_block));
  stage1_scan_kernel<TILED, DEAD_Q, E><<<grid, THREADS, 0, st>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long rows = static_cast<long long>(a.J) * a.n_q;
  const unsigned blocks = static_cast<unsigned>((rows + MERGE_WARPS - 1) / MERGE_WARPS);
  stage1_merge_kernel<TILED, DEAD_Q, E><<<blocks, MERGE_WARPS * 32, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <bool TILED, bool DEAD_Q>
int launch_e(const Args& a, cudaStream_t st) {
  if (a.k <= 32) return launch<TILED, DEAD_Q, 1>(a, st);
  if (a.k <= 64) return launch<TILED, DEAD_Q, 2>(a, st);
  return launch<TILED, DEAD_Q, 4>(a, st);
}

}  // namespace

// scores: tiled (doc != nullptr) s_tpl [n_q, M] f32, else [J, n_q, S] f32;
// doc [J, S] i32 with ids in [0, M); dead nullptr or [J, 1, S]
// (dead_per_query 0) / [J, n_q, S] (1) f32; valid [J, S] bool; gid [J, S]
// i32; part [J, n_q, ceil(S / 8192), k] u64 workspace; v [J, n_q, k] f32
// and g [J, n_q, k] i32 out.  q_per_block queries share a scan block.  A
// shape the kernel cannot run is refused.
extern "C" int stage1_topk(const float* scores, const int* doc, const float* dead,
                           int dead_per_query, const unsigned char* valid, const int* gid, int J,
                           int n_q, int S, int M, int k, int q_per_block,
                           unsigned long long* part, float* v, int* g, void* stream) {
  const bool tiled = doc != nullptr;
  const int n_chunks = (S + CHUNK - 1) / CHUNK;
  if (J < 1 || J > 65535 || n_q < 1 || S < 1 || k < 1 || k > K_MAX || k > S ||
      q_per_block < 1 || (n_q + q_per_block - 1) / q_per_block > 65535 ||
      (tiled && (M < 1 || M > TPL_MAX)) || (dead_per_query && dead == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{scores, doc, dead, valid, gid, J, n_q, S, M, k, n_chunks, q_per_block, part, v, g};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tiled) return dead_per_query ? launch_e<true, true>(a, st) : launch_e<true, false>(a, st);
  return dead_per_query ? launch_e<false, true>(a, st) : launch_e<false, false>(a, st);
}
