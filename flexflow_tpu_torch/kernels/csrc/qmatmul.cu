// Weight-only dequant-GEMM for Hopper (sm_90a): kernel K3 of the port.
//
//   y[m, n] = (sum_k x[m, k] * q[k, n]) * scale[n]   -> out dtype
//
// q is an int8 payload [K, N] or an int4 payload packed two rows a byte
// [ceil(K/2), N] (row 2p in the low nibble of packed row p, row 2p+1 in
// the high one), scale fp32 [N]. It replaces flexflow_tpu/quant.py:138
// qmatmul on a QuantizedWeight, where XLA fuses the int8 -> bf16 convert
// into the dot's operand read; there is no pallas_call behind it. What it
// must not do is what a dequantize-then-matmul does: write and re-read a
// bf16 copy of every weight (3x the weight bytes of the int8 read).
//
// What bounds it on this card: at decode (M = 8..64 rows) each weight byte
// is used for 2*M flops, below the ~295 flop/byte where bf16 tensor cores
// become the limit, so it is bound by the HBM bytes of the payload; at a
// prefill chunk (M = 256) it is near that line.
//
// What the design does about it (bf16 activations):
//  * grid (N tile of 256 columns, M tile of 64 rows, K split). Each block
//    streams its columns' payload once through a 4-stage cp.async ring of
//    int8 tiles in shared memory, beside the matching x tile (bf16, XOR-
//    swizzled 16-byte chunks for conflict-free ldmatrix), which its eight
//    warps share (a warp owns 32 columns);
//  * the payload is converted to bf16 in registers, straight into the
//    mma.sync.m16n8k16 B fragments: a thread reads one 32-bit word of 4
//    neighbouring columns at each of the k rows its fragment needs, and
//    the 4 bytes feed 4 n-tiles (n-tile j, fragment column l <-> weight
//    column 4*l + j). The convert is exact (|q| <= 127) and costs a byte
//    permute and an fp32 subtract per value; int4 pairs rows exactly as
//    the fragment pairs k, so one word feeds both halves of a k pair;
//  * fp32 accumulation; the scale is applied once, after the sum;
//  * decode launches too few N tiles to fill 132 SMs, so K is split
//    (split_plan in qmatmul.py, about two blocks an SM: a function of K, N
//    and the SM count only, never of M) and a second small kernel adds the
//    fp32 partials in a fixed order and applies the scale. Every row's arithmetic depends
//    on that row alone, so a row gives the same bits at any M and at any
//    place in the batch (the tree verify at M = 8 against decode at 64).
// fp32 activations take a plain fp32-FMA kernel with the same grid, split
// plan and combine (no TF32: it would change the numbers).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int BM = 64;       // rows of x per block (four m16 tiles)
constexpr int BN = 256;      // weight columns per block: eight warps of 32
constexpr int BK = 64;       // k per pipeline stage (the split plan's unit)
constexpr int NSTAGE = 4;    // cp.async ring depth (100 KiB: two blocks an SM)
constexpr int NT = BN;       // a thread per column
constexpr int XTILE = BM * BK * 2;  // bytes of one bf16 x tile

// payload tile rows are padded so that the fragment reads of one warp hit
// 32 distinct banks: int8 reads rows 2c (c = 0..3), int4 rows c
template <bool INT4> struct WTile {
  static constexpr int ROWS = INT4 ? BK / 2 : BK;
  static constexpr int STRIDE = INT4 ? BN + 32 : BN + 16;
  static constexpr int BYTES = ROWS * STRIDE;
  static constexpr int STAGE = BYTES + XTILE;
};

struct QArgs {
  const void* x;       // [M, Kp] bf16 or fp32 (Kp % 8 == 0, zeros past K)
  const int8_t* q;     // [K, N] int8 or [ceil(K/2), N] packed int4
  const float* scale;  // [N]
  void* out;           // [M, N]
  float* part;         // [splits, M, N] fp32 when splits > 1
  int M, N, K, Kp;
  int splits, cps;     // K splits of cps BK-chunks each
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// async copy global -> shared of VEC bytes; src_bytes 0 writes zeros
template <int VEC> __device__ __forceinline__ void cp_async(void* dst, const void* src, int n);
template <> __device__ __forceinline__ void cp_async<16>(void* dst, const void* src, int n) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(n));
}
template <> __device__ __forceinline__ void cp_async<4>(void* dst, const void* src, int n) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c[16x8] += a[16x16] . b[16x8], bf16 operands, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// byte i of w, which holds a value v biased to v + bias (0..255), as the
// fp32 v: the byte becomes the low mantissa of 2^23 + (v + bias), exact
__device__ __forceinline__ float unbias(uint32_t w, int i, float two23_bias) {
  return __int_as_float(__byte_perm(w, 0x4B000000u, 0x7540 + i)) - two23_bias;
}

// element offset of 16-byte chunk `ch` of row `row` in a [rows][64] bf16
// tile, chunks XOR-swizzled by row (8 rows of one chunk hit 8 banks)
__device__ __forceinline__ int swz(int row, int ch) { return row * BK + ((ch ^ (row & 7)) << 3); }

// this thread's 8 results of one row, columns col..col+7: 4 scaled and
// stored (or 4 raw partials) a group, each group whole inside or past N
template <typename OutT>
__device__ __forceinline__ void store8(const QArgs& a, int row, int col, const float* v) {
  if (row >= a.M) return;
  const size_t base = (size_t)row * a.N + col;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c = col + 4 * h;
    if (c >= a.N) return;
    const float* s = v + 4 * h;
    if (a.splits > 1) {
      float* p = a.part + (size_t)blockIdx.z * a.M * a.N + base + 4 * h;
      *reinterpret_cast<float4*>(p) = make_float4(s[0], s[1], s[2], s[3]);
      continue;
    }
    const float4 sc = *reinterpret_cast<const float4*>(a.scale + c);
    const float y0 = s[0] * sc.x, y1 = s[1] * sc.y, y2 = s[2] * sc.z, y3 = s[3] * sc.w;
    if constexpr (sizeof(OutT) == 4) {
      *reinterpret_cast<float4*>(reinterpret_cast<float*>(a.out) + base + 4 * h) =
          make_float4(y0, y1, y2, y3);
    } else {
      uint2 u;
      u.x = pack_bf16(y0, y1);
      u.y = pack_bf16(y2, y3);
      *reinterpret_cast<uint2*>(reinterpret_cast<bf16*>(a.out) + base + 4 * h) = u;
    }
  }
}

// ---------------------------------------------------------------------
// bf16 activations: tensor cores (mma.sync.m16n8k16), cp.async ring
// ---------------------------------------------------------------------
template <bool INT4, int VEC, typename OutT>
__global__ void __launch_bounds__(NT, 2) qmm_mma_kernel(const QArgs a) {
  using W = WTile<INT4>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int nk = (a.K + BK - 1) / BK;
  const int c0 = blockIdx.z * a.cps, nchunks = max(min(nk, c0 + a.cps) - c0, 0);
  const int mrows = min(BM, a.M - m0);
  const int mtiles = (mrows + 15) >> 4;
  const int prows = INT4 ? (a.K + 1) / 2 : a.K;
  const bf16* x = reinterpret_cast<const bf16*>(a.x);

  auto load = [&](int chunk, int st) {
    unsigned char* ws = smem + st * W::STAGE;
    bf16* xs = reinterpret_cast<bf16*>(ws + W::BYTES);
    constexpr int CPR = BN / VEC;
    for (int i = tid; i < W::ROWS * CPR; i += NT) {
      const int r = i / CPR, cc = i % CPR;
      const int prow = chunk * W::ROWS + r, col = n0 + cc * VEC;
      const bool ok = prow < prows && col < a.N;
      cp_async<VEC>(ws + r * W::STRIDE + cc * VEC, ok ? a.q + (size_t)prow * a.N + col : a.q,
                    ok ? VEC : 0);
    }
    const int k0 = chunk * BK;
    for (int i = tid; i < mtiles * 16 * 8; i += NT) {
      const int r = i >> 3, ch = i & 7, k = k0 + ch * 8;
      const bool ok = r < mrows && k < a.Kp;
      cp_async<16>(xs + swz(r, ch), ok ? x + (size_t)(m0 + r) * a.Kp + k : x, ok ? 16 : 0);
    }
  };
#pragma unroll
  for (int i = 0; i < NSTAGE - 1; ++i) {
    if (i < nchunks) load(c0 + i, i);
    cp_async_commit();
  }

  float acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;

  const int wcol = warp * 32 + 4 * g;  // this thread's word of 4 columns
  for (int j = 0; j < nchunks; ++j) {
    if (j + NSTAGE - 1 < nchunks) load(c0 + j + NSTAGE - 1, (j + NSTAGE - 1) % NSTAGE);
    cp_async_commit();
    cp_async_wait<NSTAGE - 1>();  // chunk j has landed (this thread's part)
    __syncthreads();              // ... and every thread's
    const unsigned char* ws = smem + (j % NSTAGE) * W::STAGE;
    const bf16* xs = reinterpret_cast<const bf16*>(ws + W::BYTES);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      // B fragments of 4 n-tiles: b[n][0] holds k rows 2c, 2c+1 of the
      // step, b[n][1] rows 2c+8, 2c+9, at weight column wcol + n
      uint32_t b[4][2];
      if constexpr (INT4) {
        // packed row p holds k rows 2p (low nibble) and 2p+1 (high)
        const uint32_t w0 =
            *reinterpret_cast<const uint32_t*>(ws + (kk * 8 + c) * W::STRIDE + wcol) ^ 0x88888888u;
        const uint32_t w1 =
            *reinterpret_cast<const uint32_t*>(ws + (kk * 8 + c + 4) * W::STRIDE + wcol) ^
            0x88888888u;
        const uint32_t lo0 = w0 & 0x0F0F0F0Fu, hi0 = (w0 >> 4) & 0x0F0F0F0Fu;
        const uint32_t lo1 = w1 & 0x0F0F0F0Fu, hi1 = (w1 >> 4) & 0x0F0F0F0Fu;
        constexpr float B4 = 8388616.f;  // 2^23 + 8
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          b[n][0] = pack_bf16(unbias(lo0, n, B4), unbias(hi0, n, B4));
          b[n][1] = pack_bf16(unbias(lo1, n, B4), unbias(hi1, n, B4));
        }
      } else {
        const unsigned char* base = ws + (kk * 16 + 2 * c) * W::STRIDE + wcol;
        const uint32_t w0 = *reinterpret_cast<const uint32_t*>(base) ^ 0x80808080u;
        const uint32_t w1 = *reinterpret_cast<const uint32_t*>(base + W::STRIDE) ^ 0x80808080u;
        const uint32_t w8 = *reinterpret_cast<const uint32_t*>(base + 8 * W::STRIDE) ^ 0x80808080u;
        const uint32_t w9 = *reinterpret_cast<const uint32_t*>(base + 9 * W::STRIDE) ^ 0x80808080u;
        constexpr float B8 = 8388736.f;  // 2^23 + 128
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          b[n][0] = pack_bf16(unbias(w0, n, B8), unbias(w1, n, B8));
          b[n][1] = pack_bf16(unbias(w8, n, B8), unbias(w9, n, B8));
        }
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        if (mt < mtiles) {
          uint32_t af[4];
          ldmatrix_x4(af, xs + swz(mt * 16 + (lane & 15), kk * 2 + (lane >> 4)));
#pragma unroll
          for (int n = 0; n < 4; ++n) mma_bf16(acc[mt][n], af, b[n][0], b[n][1]);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before it refills
  }
  cp_async_wait<0>();

  // accumulator (n-tile n, fragment column l) is weight column 4*l + n of
  // the warp's 32: this thread's c0/c1 of the 4 n-tiles are columns
  // 8c..8c+3 and 8c+4..8c+7, rows g and g + 8 of each m-tile
  const int col = n0 + warp * 32 + 8 * c;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
    if (mt >= mtiles) break;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v[8];
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        v[n] = acc[mt][n][2 * h];
        v[4 + n] = acc[mt][n][2 * h + 1];
      }
      store8<OutT>(a, m0 + mt * 16 + g + 8 * h, col, v);
    }
  }
}

// ---------------------------------------------------------------------
// fp32 activations: plain fp32 FMA (exact operands, no TF32)
// ---------------------------------------------------------------------
constexpr int FM = 16;   // rows of x per block
constexpr int FN = 64;   // weight columns per block
constexpr int FNT = 256;

template <bool INT4, typename OutT>
__global__ void __launch_bounds__(FNT) qmm_fp32_kernel(const QArgs a) {
  __shared__ float xs[FM][BK];
  __shared__ float wsm[BK][FN + 1];
  const int tid = threadIdx.x, colt = tid % FN, rg = tid / FN;  // 4 rows each
  const int n0 = blockIdx.x * FN, m0 = blockIdx.y * FM;
  const int nk = (a.K + BK - 1) / BK;
  const int c0 = blockIdx.z * a.cps, c1 = min(nk, c0 + a.cps);
  const float* x = reinterpret_cast<const float*>(a.x);
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int chunk = c0; chunk < c1; ++chunk) {
    const int k0 = chunk * BK;
    for (int i = tid; i < FM * BK; i += FNT) {
      const int r = i / BK, k = k0 + i % BK;
      xs[r][i % BK] = (m0 + r < a.M && k < a.K) ? x[(size_t)(m0 + r) * a.Kp + k] : 0.f;
    }
    for (int i = tid; i < BK * FN; i += FNT) {
      const int kr = i / FN, n = n0 + i % FN, k = k0 + kr;
      float w = 0.f;
      if (k < a.K && n < a.N) {
        if constexpr (INT4) {
          const int8_t p = a.q[(size_t)(k >> 1) * a.N + n];
          w = (float)((k & 1) ? (p >> 4) : ((int8_t)(p << 4) >> 4));
        } else {
          w = (float)a.q[(size_t)k * a.N + n];
        }
      }
      wsm[kr][i % FN] = w;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < BK; ++k) {
      const float w = wsm[k][colt];
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[r] = fmaf(xs[rg * 4 + r][k], w, acc[r]);
    }
    __syncthreads();
  }
  const int n = n0 + colt;
  if (n >= a.N) return;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int m = m0 + rg * 4 + r;
    if (m >= a.M) continue;
    const size_t o = (size_t)m * a.N + n;
    if (a.splits > 1) {
      a.part[(size_t)blockIdx.z * a.M * a.N + o] = acc[r];
    } else if constexpr (sizeof(OutT) == 4) {
      reinterpret_cast<float*>(a.out)[o] = acc[r] * a.scale[n];
    } else {
      reinterpret_cast<bf16*>(a.out)[o] = __float2bfloat16(acc[r] * a.scale[n]);
    }
  }
}

// out[m, n] = (sum over splits s = 0, 1, ... of part[s, m, n]) * scale[n]
template <typename OutT>
__global__ void combine_kernel(const QArgs a) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)a.M * a.N) return;
  const size_t mn = (size_t)a.M * a.N;
  float s = a.part[i];
  for (int z = 1; z < a.splits; ++z) s += a.part[z * mn + i];
  s *= a.scale[i % a.N];
  if constexpr (sizeof(OutT) == 4) {
    reinterpret_cast<float*>(a.out)[i] = s;
  } else {
    reinterpret_cast<bf16*>(a.out)[i] = __float2bfloat16(s);
  }
}

template <bool INT4, int VEC, typename OutT>
cudaError_t launch_mma(const QArgs& a, cudaStream_t st) {
  static bool attr_set = false;
  auto kern = qmm_mma_kernel<INT4, VEC, OutT>;
  const int smem = NSTAGE * WTile<INT4>::STAGE;
  if (!attr_set) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const dim3 grid((a.N + BN - 1) / BN, (a.M + BM - 1) / BM, a.splits);
  kern<<<grid, NT, smem, st>>>(a);
  return cudaGetLastError();
}

template <bool INT4, typename OutT>
cudaError_t launch_fp32(const QArgs& a, cudaStream_t st) {
  const dim3 grid((a.N + FN - 1) / FN, (a.M + FM - 1) / FM, a.splits);
  qmm_fp32_kernel<INT4, OutT><<<grid, FNT, 0, st>>>(a);
  return cudaGetLastError();
}

template <typename OutT>
cudaError_t dispatch(const QArgs& a, int int4, int act_bf16, int vec16, cudaStream_t st) {
  if (!act_bf16) return int4 ? launch_fp32<true, OutT>(a, st) : launch_fp32<false, OutT>(a, st);
  if (int4)
    return vec16 ? launch_mma<true, 16, OutT>(a, st) : launch_mma<true, 4, OutT>(a, st);
  return vec16 ? launch_mma<false, 16, OutT>(a, st) : launch_mma<false, 4, OutT>(a, st);
}

}  // namespace

// x [M, Kp] (bf16 when act_bf16, else fp32; zeros in columns K..Kp-1),
// q the int8 [K, N] or packed int4 [ceil(K/2), N] payload, scale fp32 [N],
// out [M, N] (bf16 when out_bf16, else fp32). With splits > 1, part is an
// fp32 [splits, M, N] scratch and a combine kernel follows. vec16 says
// that N % 16 == 0 and q is 16-byte aligned (else N % 4 == 0 and 4-byte
// copies). Returns cudaGetLastError() after the launch(es): 0 on success.
extern "C" int ff_qmatmul(const void* x, const void* q, const float* scale, void* out,
                          float* part, int M, int N, int K, int Kp, int splits, int cps,
                          int int4, int act_bf16, int out_bf16, int vec16, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || N % 4 || Kp % 8 || Kp < K || splits < 1 || cps < 1 ||
      (long long)splits * cps * BK < K || (splits > 1 && !part))
    return (int)cudaErrorInvalidValue;
  QArgs a;
  a.x = x; a.q = reinterpret_cast<const int8_t*>(q); a.scale = scale; a.out = out;
  a.part = part; a.M = M; a.N = N; a.K = K; a.Kp = Kp; a.splits = splits; a.cps = cps;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = out_bf16 ? dispatch<bf16>(a, int4, act_bf16, vec16, st)
                           : dispatch<float>(a, int4, act_bf16, vec16, st);
  if (e != cudaSuccess || splits == 1) return (int)e;
  const size_t n = (size_t)M * N;
  const int threads = 256;
  if (out_bf16)
    combine_kernel<bf16><<<(unsigned)((n + threads - 1) / threads), threads, 0, st>>>(a);
  else
    combine_kernel<float><<<(unsigned)((n + threads - 1) / threads), threads, 0, st>>>(a);
  return (int)cudaGetLastError();
}
