// KV-cache serving attention for Hopper (sm_90a): K1 and K2 of the port.
//
// Replaces the two Pallas TPU kernels reached through
// flexflow_tpu/kernels/attention.py:flash_attend —
//   K1  ff_flash_attend         <- _kernel / _stream_attend (attention.py:103, :144)
//   K2  ff_flash_attend_append  <- _append_kernel           (attention.py:116)
// with the semantics of its jnp oracle reference_attend: fp32 online
// softmax over the valid cache prefix, causal masking on absolute query
// positions or an additive tree bias, optional ALiBi, GQA (h = kh*G + g),
// finite NEG_INF masking, q and p rounded to the cache type before their
// products, fp32 accumulation.
//
// What bounds it on this card: decode (K2, one real token per row) and
// prefill chunks of short prompts read each valid K/V row once and do
// about 4*G*Q flops per cache element, far below the ~295 flop/byte an
// H100 needs before bf16 tensor cores are the limit — the bound is the
// HBM bytes of the valid cache prefix, 2*R*KH*len*D*itemsize.
//
// What the design does about it:
//  * one block per (row r, kv head kh) — no cross-block ordering: the
//    TPU's sequential grid over r and its cross-program DMA hand-off
//    (attention.py:182-231) are replaced by a loop over S-tiles inside
//    the block, and the block stops after ceil(min(len, S) / BS) tiles,
//    so inactive rows (len 0) read nothing and write zeros;
//  * every query row of a kv head (all G*Q of them) is served by the
//    block that streams that head, so each K/V tile is read from HBM once
//    per QT query rows (a pass), straight from the stacked [L,R,KH,S,D]
//    cache at the layer's base pointer — no layer is ever copied out;
//  * BS is a constant (64 positions): the softmax partition over S does
//    not depend on the query width, so a width-1 and a width-8 decode of
//    the same positions round identically;
//  * K2 writes k_new/v_new into its own (r, kh) cache row at appos[r],
//    then __syncthreads(), then streams: no other block reads that slice,
//    so the fused append needs no cross-block ordering. The cache is read
//    with plain (coherent) loads, never the read-only path, so the block
//    sees its own write;
//  * no PACK=2 lane packing and no 128-lane padding: D = 64 and D = 128
//    rows are read as they are stored.
// This first version is simple scalar FMA over shared-memory tiles;
// wgmma/TMA and split-S for long caches are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int NT = 256;  // threads per block
constexpr int BS = 64;   // cache positions per S-tile (never depends on Q)
constexpr int QT = 32;   // query rows per pass
constexpr int NWARPS = NT / 32;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

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
  int R, Q, H, KH, S;
  float scale;
  int causal;
};

template <int D>
constexpr size_t smem_bytes() {
  // q tile, K tile (padded rows), V tile, scores/probabilities,
  // m / l / correction per query row, qpos per query row
  return sizeof(float) * (QT * D + BS * (D + 1) + BS * D + QT * BS + 3 * QT) +
         sizeof(int) * QT;
}

template <typename T, typename OutT, int D, bool APPEND>
__global__ void __launch_bounds__(NT)
flash_attend_kernel(const Args a) {
  extern __shared__ float smem[];
  constexpr int KS = D + 1;  // padded K row stride: conflict-free column reads
  float* q_s = smem;               // [QT][D]
  float* k_s = q_s + QT * D;       // [BS][KS]
  float* v_s = k_s + BS * KS;      // [BS][D]
  float* p_s = v_s + BS * D;       // [QT][BS]
  float* m_s = p_s + QT * BS;      // [QT]
  float* l_s = m_s + QT;           // [QT]
  float* c_s = l_s + QT;           // [QT]
  int* qp_s = reinterpret_cast<int*>(c_s + QT);  // [QT]

  const int r = blockIdx.x, kh = blockIdx.y, tid = threadIdx.x;
  const int G = a.H / a.KH, GQ = G * a.Q;
  const size_t head = ((size_t)r * a.KH + kh) * (size_t)a.S * D;
  T* kc = reinterpret_cast<T*>(a.k) + head;
  T* vc = reinterpret_cast<T*>(a.v) + head;

  if (APPEND) {
    const int p = a.appos[r];
    if (p >= 0 && p < a.S) {
      const size_t src = ((size_t)r * a.KH + kh) * D;
      const T* kn = reinterpret_cast<const T*>(a.k_new) + src;
      const T* vn = reinterpret_cast<const T*>(a.v_new) + src;
      for (int d = tid; d < D; d += NT) {
        kc[(size_t)p * D + d] = kn[d];
        vc[(size_t)p * D + d] = vn[d];
      }
    }
    __syncthreads();  // the block's own write is visible to its stream
  }

  const int len = min(max(a.lengths[r], 0), a.S);
  const int nb = (len + BS - 1) / BS;
  const T* qg = reinterpret_cast<const T*>(a.q);
  OutT* og = reinterpret_cast<OutT*>(a.out);

  // accumulator ownership: thread tid owns dim my_d of query rows
  // row0, row0 + RSTEP, ... of the current pass
  constexpr int NACC = QT * D / NT;
  constexpr int RSTEP = NT / D;
  const int my_d = tid % D, row0 = tid / D;
  // score ownership: thread tid owns key column sc of rows srow0 + i*SSTEP
  constexpr int SSTEP = NT / BS;
  constexpr int NSC = QT / SSTEP;
  const int sc = tid % BS, srow0 = tid / BS;

  for (int base = 0; base < GQ; base += QT) {
    for (int e = tid; e < QT * D; e += NT) {
      const int row = e / D, d = e % D, gq = base + row;
      float val = 0.f;
      if (gq < GQ) {
        const int g = gq / a.Q, qi = gq % a.Q, h = kh * G + g;
        val = to_f(qg[(((size_t)r * a.Q + qi) * a.H + h) * D + d]);
      }
      q_s[e] = val;
    }
    for (int row = tid; row < QT; row += NT) {
      const int gq = base + row;
      qp_s[row] = gq < GQ ? a.qpos[r * a.Q + gq % a.Q] : 0;
      m_s[row] = NEG_INF;
      l_s[row] = 0.f;
    }
    float acc[NACC];
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc[i] = 0.f;
    __syncthreads();

    for (int j = 0; j < nb; ++j) {
      const int s0 = j * BS;
      for (int e = tid; e < BS * D; e += NT) {
        const int s = e / D, d = e % D, pos = s0 + s;
        float kv = 0.f, vv = 0.f;
        if (pos < a.S) {
          kv = to_f(kc[(size_t)pos * D + d]);
          vv = to_f(vc[(size_t)pos * D + d]);
        }
        k_s[s * KS + d] = kv;
        v_s[s * D + d] = vv;
      }
      __syncthreads();

      // scores s[row][col] = q[row] . k[col], fp32 accumulate
      {
        float dots[NSC];
#pragma unroll
        for (int i = 0; i < NSC; ++i) dots[i] = 0.f;
        for (int d = 0; d < D; ++d) {
          const float kd = k_s[sc * KS + d];
#pragma unroll
          for (int i = 0; i < NSC; ++i) dots[i] += q_s[(srow0 + i * SSTEP) * D + d] * kd;
        }
        const int pos = s0 + sc;
#pragma unroll
        for (int i = 0; i < NSC; ++i) {
          const int row = srow0 + i * SSTEP, gq = base + row;
          float s = NEG_INF;
          if (gq < GQ && pos < len) {
            const int qp = qp_s[row];
            if (!a.causal || pos <= qp) {
              const int g = gq / a.Q, qi = gq % a.Q;
              s = dots[i] * a.scale;
              if (a.alibi) s = s - a.alibi[kh * G + g] * (float)(qp - pos);
              if (a.bias) s = s + a.bias[((size_t)r * a.Q + qi) * a.S + pos];
            }
          }
          p_s[row * BS + sc] = s;
        }
      }
      __syncthreads();

      // online softmax, one warp per query row (BS == 64: two keys a lane)
      const int warp = tid / 32, lane = tid % 32;
      for (int row = warp; row < QT; row += NWARPS) {
        const float x0 = p_s[row * BS + lane], x1 = p_s[row * BS + lane + 32];
        float mx = fmaxf(x0, x1);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float m_old = m_s[row];
        const float m_new = fmaxf(m_old, mx);
        const float p0 = expf(x0 - m_new), p1 = expf(x1 - m_new);
        float sum = p0 + p1;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
        p_s[row * BS + lane] = round_to<T>(p0);
        p_s[row * BS + lane + 32] = round_to<T>(p1);
        if (lane == 0) {
          const float corr = expf(m_old - m_new);
          l_s[row] = l_s[row] * corr + sum;
          m_s[row] = m_new;
          c_s[row] = corr;
        }
      }
      __syncthreads();

      // acc = acc * corr + p . v
      {
        float pv[NACC];
#pragma unroll
        for (int i = 0; i < NACC; ++i) pv[i] = 0.f;
        for (int s = 0; s < BS; ++s) {
          const float vv = v_s[s * D + my_d];
#pragma unroll
          for (int i = 0; i < NACC; ++i) pv[i] += p_s[(row0 + i * RSTEP) * BS + s] * vv;
        }
#pragma unroll
        for (int i = 0; i < NACC; ++i) acc[i] = acc[i] * c_s[row0 + i * RSTEP] + pv[i];
      }
      __syncthreads();  // the next tile overwrites k_s / v_s / p_s
    }

#pragma unroll
    for (int i = 0; i < NACC; ++i) {
      const int row = row0 + i * RSTEP, gq = base + row;
      if (gq < GQ) {
        const int g = gq / a.Q, qi = gq % a.Q, h = kh * G + g;
        og[((size_t)r * a.Q + qi) * a.H * D + (size_t)h * D + my_d] =
            from_f<OutT>(acc[i] / fmaxf(l_s[row], 1e-30f));
      }
    }
    __syncthreads();  // the next pass rewrites q_s / m_s / l_s
  }
}

template <typename T, typename OutT, int D, bool APPEND>
int launch(const Args& a, cudaStream_t stream) {
  auto kern = flash_attend_kernel<T, OutT, D, APPEND>;
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(a.R, a.KH), NT, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <bool APPEND>
int dispatch(const Args& a, int D, int cache_bf16, int out_bf16, cudaStream_t st) {
  using bf = __nv_bfloat16;
  if (D == 128) {
    if (cache_bf16 && out_bf16) return launch<bf, bf, 128, APPEND>(a, st);
    if (cache_bf16) return launch<bf, float, 128, APPEND>(a, st);
    if (out_bf16) return launch<float, bf, 128, APPEND>(a, st);
    return launch<float, float, 128, APPEND>(a, st);
  }
  if (D == 64) {
    if (cache_bf16 && out_bf16) return launch<bf, bf, 64, APPEND>(a, st);
    if (cache_bf16) return launch<bf, float, 64, APPEND>(a, st);
    if (out_bf16) return launch<float, bf, 64, APPEND>(a, st);
    return launch<float, float, 64, APPEND>(a, st);
  }
  return (int)cudaErrorInvalidValue;
}

Args make_args(const void* q, void* k, void* v, const int* lengths, const int* qpos,
               const float* bias, const float* alibi, const void* k_new,
               const void* v_new, const int* appos, void* out, int R, int Q, int H,
               int KH, int S, float scale, int causal) {
  Args a;
  a.q = q; a.k = k; a.v = v; a.lengths = lengths; a.qpos = qpos;
  a.bias = bias; a.alibi = alibi; a.k_new = k_new; a.v_new = v_new;
  a.appos = appos; a.out = out;
  a.R = R; a.Q = Q; a.H = H; a.KH = KH; a.S = S;
  a.scale = scale; a.causal = causal;
  return a;
}

}  // namespace

// Both entries take the same arguments (K1 ignores k_new/v_new/appos) and
// return cudaGetLastError() after the launch: 0 on success.
extern "C" int ff_flash_attend(const void* q, void* k, void* v, const int* lengths,
                               const int* qpos, const float* bias, const float* alibi,
                               const void* k_new, const void* v_new, const int* appos,
                               void* out, int R, int Q, int H, int KH, int S, int D,
                               float scale, int causal, int cache_bf16, int out_bf16,
                               void* stream) {
  const Args a = make_args(q, k, v, lengths, qpos, bias, alibi, nullptr, nullptr,
                           nullptr, out, R, Q, H, KH, S, scale, causal);
  return dispatch<false>(a, D, cache_bf16, out_bf16, (cudaStream_t)stream);
}

extern "C" int ff_flash_attend_append(const void* q, void* k, void* v,
                                      const int* lengths, const int* qpos,
                                      const float* bias, const float* alibi,
                                      const void* k_new, const void* v_new,
                                      const int* appos, void* out, int R, int Q, int H,
                                      int KH, int S, int D, float scale, int causal,
                                      int cache_bf16, int out_bf16, void* stream) {
  if (!k_new || !v_new || !appos) return (int)cudaErrorInvalidValue;
  const Args a = make_args(q, k, v, lengths, qpos, bias, alibi, k_new, v_new, appos,
                           out, R, Q, H, KH, S, scale, causal);
  return dispatch<true>(a, D, cache_bf16, out_bf16, (cudaStream_t)stream);
}
