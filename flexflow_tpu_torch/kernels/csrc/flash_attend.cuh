// KV-cache serving attention for Hopper (sm_90a), K1 and K2 of the port:
// what csrc/flash_attend.cu (bf16 / fp16 caches) and
// csrc/flash_attend_f32.cu (fp32 caches) share. The arguments, a block's
// S range and append, the stores, cp.async, the split-S combine, the
// launch and the two C entries; each source defines dispatch<APPEND>
// for its cache types and is built into a library of its own, so the
// two compile in parallel (kernels/build.py).

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BS = 64;     // cache positions per S-tile (never depends on Q)
constexpr int QM = 64;     // query rows per 16-bit block (fp32: by plan)
constexpr int NT_MMA = 128;   // 16-bit kernel: four warps of 16 query rows
constexpr int DC = 256;       // head-dim columns a wide block owns
using bf16 = __nv_bfloat16;
using f16 = __half;

constexpr int NSTAGE = 3;     // 16-bit kernel: K/V ring depth

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(f16 x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ f16 from_f<f16>(float x) { return __float2half_rn(x); }

// x rounded to the cache type T and widened back to fp32
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

struct Args {
  const void* q;       // [R, Q, H, D] cache type
  void* k;             // [R, KH, S, D] (one layer of the stacked cache)
  void* v;
  const int* lengths;  // [R]
  const int* qpos;     // [R, Q]
  const float* bias;   // [R, Q, S] or null
  const float* alibi;  // [H] or null
  const void* k_new;   // [R, 1, KH, D] (K2)
  const void* v_new;
  const int* appos;    // [R] (K2)
  void* out;           // [R, Q, H*D]
  float* part_o;       // [n_split, R, Q, H, D] when partial
  float* part_ml;      // [n_split, R, Q, H, 2]
  int partial;         // write part_o/part_ml: n_split > 1 or out == null
  int R, Q, H, KH, S;
  int D;               // the cache's head dim (the wide kernels read it)
  int n_split, tps;    // S-splits of tps tiles each
  float scale;
  int causal;
  int out_dt;          // out's dtype code: 0 fp32, 1 bf16, 2 fp16
};

// What one block streams: (row r, kv head kh, query tile qt, split),
// S-tiles [t0, t1), and the cache position whose K/V come from k_new.
struct Block {
  int r, kh, qt, split, G, GQ, q0, len, t0, t1, app;
};

// Every thread of the block calls this (it synchronises).
// bx is the block's (query tile x split) index: blockIdx.x, or blockIdx.x
// over the column slices of the wide kernels; qm its query tile's rows
// (at most blockDim.x).
template <bool APPEND>
__device__ Block block_setup(const Args& a, int bx, int qm) {
  __shared__ int qmax;
  Block b;
  b.r = blockIdx.z;
  b.kh = blockIdx.y;
  b.qt = bx / a.n_split;
  b.split = bx % a.n_split;
  b.G = a.H / a.KH;
  b.GQ = b.G * a.Q;
  b.q0 = b.qt * qm;
  // every scalar load issued before the first use of any of them: the
  // block's first tile waits on one memory latency, not a chain of them
  const int gq = b.q0 + threadIdx.x;
  const bool has_q = a.causal && threadIdx.x < qm && gq < b.GQ;
  const int my_qp = has_q ? a.qpos[b.r * a.Q + gq % a.Q] : -1;
  const int len = a.lengths[b.r];
  const int p = APPEND ? a.appos[b.r] : -1;
  b.len = min(max(len, 0), a.S);
  b.app = (p >= 0 && p < a.S) ? p : -1;
  int lim = b.len;
  if (a.causal) {
    // causal tile cut: no row of this query tile sees past max qpos
    if (threadIdx.x == 0) qmax = -1;
    __syncthreads();
    if (has_q) atomicMax(&qmax, my_qp);
    __syncthreads();
    lim = min(lim, max(qmax + 1, 0));
  }
  const int nb = (lim + BS - 1) / BS;
  b.t0 = b.split * a.tps;
  b.t1 = min(b.t0 + a.tps, nb);
  return b;
}

// K2: the block of query tile 0 in the split that owns appos[r] (and, in
// the wide kernels, of column slice 0) writes the whole row of k_new/v_new
// into the cache (16-byte stores), once. No block reads that row of the
// cache: the streams take it from k_new/v_new.
template <typename T>
__device__ void append_store(const Args& a, const Block& b, int D) {
  if (b.app < 0 || b.qt != 0 || b.split != (b.app / BS) / a.tps) return;
  const int CH = D * (int)sizeof(T) / 16;
  const size_t src = ((size_t)b.r * a.KH + b.kh) * D;
  const size_t dst = (((size_t)b.r * a.KH + b.kh) * a.S + b.app) * D;
  const uint4* kn = reinterpret_cast<const uint4*>(reinterpret_cast<const T*>(a.k_new) + src);
  const uint4* vn = reinterpret_cast<const uint4*>(reinterpret_cast<const T*>(a.v_new) + src);
  uint4* kc = reinterpret_cast<uint4*>(reinterpret_cast<T*>(a.k) + dst);
  uint4* vc = reinterpret_cast<uint4*>(reinterpret_cast<T*>(a.v) + dst);
  for (int c = threadIdx.x; c < CH; c += blockDim.x) {
    kc[c] = kn[c];
    vc[c] = vn[c];
  }
}

// (r, qi, h) of query row gq of the block, flattened as in out [R, Q, H*D]
__device__ __forceinline__ size_t out_row(const Args& a, const Block& b, int gq) {
  const int g = gq / a.Q, qi = gq % a.Q;
  return ((size_t)b.r * a.Q + qi) * a.H + b.kh * b.G + g;
}

// Element i of an output of dtype code dt. The output type is read at
// run time (one branch a store, the same for the whole grid): a template
// parameter would triple the instantiations for an epilogue alone.
__device__ __forceinline__ void put_out(void* out, size_t i, int dt, float x) {
  if (dt == 0) reinterpret_cast<float*>(out)[i] = x;
  else if (dt == 1) reinterpret_cast<bf16*>(out)[i] = from_f<bf16>(x);
  else reinterpret_cast<f16*>(out)[i] = from_f<f16>(x);
}

// The split's running max and sum of a finished row (partials only).
__device__ __forceinline__ void store_ml(const Args& a, const Block& b, size_t row, float m,
                                         float l) {
  if (!a.partial) return;
  float* p = a.part_ml + ((size_t)b.split * a.R * a.Q * a.H + row) * 2;
  p[0] = m;
  p[1] = l;
}

// The score of query row (gq, qpos qp, ALiBi slope, bias row) against
// cache position pos: masked to NEG_INF, else scaled, ALiBi, bias.
__device__ __forceinline__ float score(const Args& a, const Block& b, float dot, bool row_ok,
                                       int qp, float slope, const float* brow, int pos) {
  if (!row_ok || pos >= b.len || (a.causal && pos > qp)) return NEG_INF;
  float s = dot * a.scale;
  if (a.alibi) s = s - slope * (float)(qp - pos);
  if (brow) s = s + brow[pos];
  return s;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16-byte async copy global -> shared; src_bytes 0 fills zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// two fp32 values rounded to T (bf16 or fp16), packed lo | hi << 16
template <typename T> __device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (std::is_same<T, bf16>::value) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  } else {
    const __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
}

// ---------------------------------------------------------------------
// split-S combine: out = sum_s w_s O_s / sum_s w_s l_s, w_s = e^(m_s - m)
// over the splits in order (deterministic). One block per (r, qi, h).
// ---------------------------------------------------------------------

template <typename T>
__global__ void combine_kernel(const float* part_o, const float* part_ml, void* out,
                               int out_dt, int rows, int D, int n_split) {
  extern __shared__ float ml_s[];  // [n_split][2]: (m, l), then (weight, l)
  __shared__ float l_tot;
  const size_t row = blockIdx.x;
  // all splits' (m, l) at once: one memory latency, not n_split of them
  for (int e = threadIdx.x; e < 2 * n_split; e += blockDim.x)
    ml_s[e] = part_ml[((size_t)(e >> 1) * rows + row) * 2 + (e & 1)];
  __syncthreads();
  if (threadIdx.x == 0) {
    float mx = NEG_INF, l = 0.f;
    for (int s = 0; s < n_split; ++s) mx = fmaxf(mx, ml_s[2 * s]);
    for (int s = 0; s < n_split; ++s) {
      const float w = expf(ml_s[2 * s] - mx);
      l += w * ml_s[2 * s + 1];
      ml_s[2 * s] = w;
    }
    l_tot = fmaxf(l, 1e-30f);
  }
  __syncthreads();
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float o = 0.f;
#pragma unroll 8
    for (int s = 0; s < n_split; ++s)
      o += ml_s[2 * s] * part_o[((size_t)s * rows + row) * D + d];
    put_out(out, row * D + d, out_dt, round_to<T>(o / l_tot));
  }
}

// ---------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------

// One attention launch (grid x = query tiles of qm rows x splits x nx
// column slices, in clusters of `cluster` consecutive blocks), its dynamic
// shared-memory limit raised to the largest smem this kernel has launched
// with, then the split-S combine when there are splits.
template <typename T, typename Kern>
int launch_with(Kern kern, size_t smem, size_t& smem_set, int qm, int nx, int threads, int D,
                const Args& a, cudaStream_t stream, int cluster = 1) {
  cudaError_t err = cudaSuccess;
  if (smem > smem_set) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem;
  }
  const dim3 grid((unsigned)(((a.H / a.KH) * a.Q + qm - 1) / qm * a.n_split * nx),
                  (unsigned)a.KH, (unsigned)a.R);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kern, a);
  if (err == cudaSuccess) err = cudaGetLastError();
  // partials out (no output): the caller combines
  if (err != cudaSuccess || !a.partial || !a.out) return (int)err;
  const int rows = a.R * a.Q * a.H;
  combine_kernel<T><<<rows, D < DC ? D : DC, 2 * a.n_split * sizeof(float), stream>>>(
      a.part_o, a.part_ml, a.out, a.out_dt, rows, D, a.n_split);
  return (int)cudaGetLastError();
}

Args make_args(const void* q, void* k, void* v, const int* lengths, const int* qpos,
               const float* bias, const float* alibi, const void* k_new,
               const void* v_new, const int* appos, void* out, float* part_o,
               float* part_ml, int R, int Q, int H, int KH, int S, int D, int n_split,
               int tps, float scale, int causal, int out_dt) {
  Args a;
  a.q = q; a.k = k; a.v = v; a.lengths = lengths; a.qpos = qpos;
  a.bias = bias; a.alibi = alibi; a.k_new = k_new; a.v_new = v_new;
  a.appos = appos; a.out = out; a.part_o = part_o; a.part_ml = part_ml;
  a.R = R; a.Q = Q; a.H = H; a.KH = KH; a.S = S; a.D = D;
  a.n_split = n_split; a.tps = tps;
  a.partial = n_split > 1 || !out;
  a.scale = scale; a.causal = causal; a.out_dt = out_dt;
  return a;
}

bool plan_ok(int S, int n_split, int tps, const void* out, const float* part_o,
             const float* part_ml) {
  if (n_split < 1 || tps < 1 || (long long)n_split * tps * BS < S) return false;
  return (n_split == 1 && out) || (part_o && part_ml);
}

// the source's kernels for cache dtype code cache_dt at head dim D
template <bool APPEND>
int dispatch(const Args& a, int D, int cache_dt, int qm, cudaStream_t st);

}  // namespace

// Both entries take the same arguments (K1 ignores k_new/v_new/appos) and
// return cudaGetLastError() after the launch(es): 0 on success. The S
// range is cut into n_split splits of tps 64-position tiles; with
// n_split > 1, part_o [n_split, R, Q, H, D] and part_ml [n_split, R, Q,
// H, 2] (fp32) hold the partials and a combine kernel follows. With out
// null they hold the partials of every split (n_split = 1 too), the
// caller combines them and no combine kernel runs. D is 64,
// 128 or a multiple of 256; cache_dt and out_dt are dtype codes (0
// fp32, 1 bf16, 2 fp16). qm is an fp32 cache's query tile (8, 16, 32 or
// 64 rows; 8 or 16 at D >= 256: kernels/attention.py f32_tile_plan); the
// 16-bit caches take 64.
extern "C" int ff_flash_attend(const void* q, void* k, void* v, const int* lengths,
                               const int* qpos, const float* bias, const float* alibi,
                               const void* k_new, const void* v_new, const int* appos,
                               void* out, float* part_o, float* part_ml, int R, int Q,
                               int H, int KH, int S, int D, int n_split, int tps,
                               float scale, int causal, int cache_dt, int out_dt, int qm,
                               void* stream) {
  if (!plan_ok(S, n_split, tps, out, part_o, part_ml)) return (int)cudaErrorInvalidValue;
  const Args a = make_args(q, k, v, lengths, qpos, bias, alibi, nullptr, nullptr, nullptr,
                           out, part_o, part_ml, R, Q, H, KH, S, D, n_split, tps, scale,
                           causal, out_dt);
  return dispatch<false>(a, D, cache_dt, qm, (cudaStream_t)stream);
}

extern "C" int ff_flash_attend_append(const void* q, void* k, void* v,
                                      const int* lengths, const int* qpos,
                                      const float* bias, const float* alibi,
                                      const void* k_new, const void* v_new,
                                      const int* appos, void* out, float* part_o,
                                      float* part_ml, int R, int Q, int H, int KH, int S,
                                      int D, int n_split, int tps, float scale, int causal,
                                      int cache_dt, int out_dt, int qm, void* stream) {
  if (!k_new || !v_new || !appos || !plan_ok(S, n_split, tps, out, part_o, part_ml))
    return (int)cudaErrorInvalidValue;
  const Args a = make_args(q, k, v, lengths, qpos, bias, alibi, k_new, v_new, appos, out,
                           part_o, part_ml, R, Q, H, KH, S, D, n_split, tps, scale, causal,
                           out_dt);
  return dispatch<true>(a, D, cache_dt, qm, (cudaStream_t)stream);
}
