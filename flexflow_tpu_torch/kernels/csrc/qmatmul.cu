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
// 16-bit copy of every weight.
//
// What bounds it on this card: at decode (M = 8..64 rows) each weight byte
// is used for 2*M flops, below the ~295 flop/byte where the 16-bit tensor
// cores become the limit, so it is bound by the HBM bytes of the payload;
// at a prefill chunk (M = 256) it is near that line.
//
// Design (16-bit activations, bf16 or fp16: one template):
//  * a block owns 128 weight columns and one K split; two consumer
//    warpgroups of 64 columns each and one producer warp. The producer's
//    lane 0 keeps a ring of stages full with TMA (cp.async.bulk.tensor):
//    a [64 k][128 col] int8 (or [32][128] packed int4) payload tile and
//    one [64 rows][64 k] tile of x for each of the block's MT 64-row M
//    tiles, all 128-byte swizzled, each stage guarded by a full and an
//    empty mbarrier. TMA zero-fills past K, past N and past M. The
//    payload's tensor map is encoded once per weight (the wrapper caches
//    it), x's at each launch on the host; both reach the kernel as
//    __grid_constant__ parameters;
//  * the product is the transposed one, y^T = q^T . x^T, on
//    wgmma.m64n64k16 in its register-A form: the converted weights are
//    the A fragments (64 weight columns x 16 k a warpgroup), x's tile is
//    B straight from the TMA's swizzled shared memory (K-major, no
//    convert, no copy). Form (b) of the two: the weights never go back to
//    shared memory as 16-bit values, which halves the shared-memory
//    traffic of form (a) and needs no second swizzled tile. A thread
//    reads its fragment's bytes with 16-bit loads (two neighbouring
//    columns at each k row the fragment needs: conflict-free under the
//    swizzle) and converts them exactly: fp16 by the 1024 + v bias (one
//    byte permute and one f16x2 subtract a pair), bf16 through fp32
//    (2^23 + v). A-row r = 16w + g + 8h of warp w is weight column
//    16w + 2g + h; the epilogue undoes that permutation;
//  * one instruction shape for every M: x rows are padded to whole
//    64-row tiles (TMA zero fill), and the converted A fragments of a
//    k-step feed the wgmma of every M tile of the block, so each weight
//    byte is read and converted once for M <= 256 (MT = 1, 2 or 4 tiles;
//    M > 256 takes a grid dimension of 256-row groups);
//  * split-K without partials in HBM: the K splits of one N tile are a
//    thread-block cluster (split_plan in qmatmul.py: <= 8 splits, a
//    function of K, N and the SM count only). Each block puts its fp32
//    partial of one M tile in its own shared memory (the idle ring);
//    after a cluster barrier rank r sums its 1/cs share of the tile's
//    elements over ranks 0..cs-1 in that order through distributed shared
//    memory, applies the scale and stores. One launch a product;
//  * fp32 accumulation; the scale applied once after the sum. Every
//    row's arithmetic depends on that row alone, so a row gives the same
//    bits at any M and at any place in the batch (tree verify at M = 8
//    against decode at M = 64).
// A payload whose row is not a multiple of 16 bytes (N % 16 != 0) cannot
// be a TMA tensor: the consumers then read it from global memory with the
// same 16-bit loads (MT = 1 only, off the serving path's shapes).
// fp32 activations take a plain fp32-FMA kernel with the same split plan
// and a combine launch (no TF32: it would change the numbers).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

#include <cstring>
#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;
using f16 = __half;

constexpr int BN = 128;     // weight columns per block: two warpgroups of 64
constexpr int BK = 64;      // k per stage (the split plan's unit)
constexpr int NCONS = 256;  // consumer threads (two warpgroups)
constexpr int NT = NCONS + 32;  // + the producer warp
constexpr int XBYTES = 64 * BK * 2;  // one 64-row x tile of a stage
constexpr int LDR = BN + 4;          // fp32 row stride of the reduction tile

template <bool INT4> struct WTile {
  static constexpr int ROWS = INT4 ? BK / 2 : BK;  // payload rows a stage
  static constexpr int BYTES = ROWS * BN;
};
template <bool INT4, int MT> struct Ring {
  static constexpr int NSTAGE = MT == 4 ? 5 : 6;
  static constexpr int STAGE = WTile<INT4>::BYTES + MT * XBYTES;  // multiple of 1024
  static constexpr int SMEM = 1024 + NSTAGE * STAGE + 2 * NSTAGE * 8;
};

struct QArgs {
  const void* x;       // [M, Kx] bf16 / fp16 / fp32 (zeros past K)
  const int8_t* q;     // [K, N] int8 or [ceil(K/2), N] packed int4
  const float* scale;  // [N]
  void* out;           // [M, N]
  float* part;         // fp32 x only: [splits, M, N] when splits > 1
  int M, N, K, Kx, prows;
  int splits, cps;     // K splits of cps BK-chunks each
  int out_dt;          // 0 fp32, 1 bf16, 2 fp16
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// ---- mbarriers, TMA, clusters -------------------------------------------
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// wait until the phase of parity `parity` has completed; a pipeline that
// stalls for seconds traps (a launch error) instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t spins = 0; !done; ++spins) {
    if (spins == (1u << 28)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;\n" ::
                   : "memory");
}
__device__ __forceinline__ float4 ld_cluster_f4(uint32_t local, int rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(local), "r"(rank));
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(remote)
               : "memory");
  return v;
}

// ---- wgmma ----------------------------------------------------------------
// descriptor of a K-major, 128-byte-swizzled [64 rows][64 k] 16-bit tile
// (TMA's SWIZZLE_128B layout, 1024-byte aligned): SBO = 1024 bytes
// between 8-row groups; a k-step of 16 advances the start by 32 bytes
__device__ __forceinline__ uint64_t xdesc(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(1024 >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x 64] += a[64 x 16] (registers) . b[16 x 64] (shared, descriptor)
template <typename T>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a, uint64_t desc) {
#define FF_WGMMA_RS(TY)                                                                         \
  asm volatile(                                                                                 \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                                              \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "                               \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "       \
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"                                             \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),     \
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),          \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),          \
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])           \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1))
  if constexpr (std::is_same<T, bf16>::value) {
    FF_WGMMA_RS("bf16");
  } else {
    FF_WGMMA_RS("f16");
  }
#undef FF_WGMMA_RS
}

// ---- the convert ------------------------------------------------------------
// bytes i and j of z, each a value v biased to v + BIAS (0..255), as two
// exact T values packed lo | hi << 16
template <typename T, int BIAS>
__device__ __forceinline__ uint32_t cvt2(uint32_t z, int i, int j) {
  if constexpr (std::is_same<T, f16>::value) {
    // fp16 1024 + u has u in its low mantissa bits: subtract 1024 + BIAS
    const uint32_t h = __byte_perm(z, 0x64646464u, i | (4 << 4) | (j << 8) | (4 << 12));
    const __half2 r = __hsub2(*reinterpret_cast<const __half2*>(&h),
                              __half2half2(__ushort_as_half((unsigned short)(0x6400 + BIAS))));
    return *reinterpret_cast<const uint32_t*>(&r);
  } else {
    // fp32 2^23 + u, minus 2^23 + BIAS: exact; then to bf16 (|v| <= 128)
    constexpr float B = 8388608.f + BIAS;
    const float lo = __int_as_float(__byte_perm(z, 0x4B000000u, 0x7540 + i)) - B;
    const float hi = __int_as_float(__byte_perm(z, 0x4B000000u, 0x7540 + j)) - B;
    const __nv_bfloat162 r = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&r);
  }
}

// the 16-bit word of payload row `row` (of the stage), columns colb and
// colb + 1 of the block's 128: from the swizzled stage, or from global
// memory (zeros past the payload) when the payload is not a TMA tensor
template <bool TMAW>
__device__ __forceinline__ uint32_t ld_w16(const unsigned char* ws, const QArgs& a, int prow0,
                                           int n0, int row, int colb) {
  if constexpr (TMAW) {
    return *reinterpret_cast<const uint16_t*>(ws + row * BN + ((((colb >> 4) ^ (row & 7)) << 4) |
                                                               (colb & 15)));
  } else {
    const int prow = prow0 + row, col = n0 + colb;
    if (prow >= a.prows || col >= a.N) return 0u;
    return *reinterpret_cast<const uint16_t*>(a.q + (size_t)prow * a.N + col);
  }
}

// A fragments of k-step kk of the stage for this thread: rows g, g + 8
// of its warp's 16 (weight columns colb, colb + 1), k pairs (2c, 2c+1)
// and (2c+8, 2c+9). z holds [q(k, c0), q(k, c0+1), q(k+1, c0),
// q(k+1, c0+1)] biased, so bytes (0, 2) are A-row g's pair and (1, 3)
// A-row g + 8's.
template <typename T, bool INT4, bool TMAW>
__device__ __forceinline__ void load_a(uint32_t (&af)[4], const unsigned char* ws, const QArgs& a,
                                       int prow0, int n0, int colb, int c, int kk) {
  uint32_t z[2];
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    if constexpr (INT4) {
      // packed row kk*8 + c + 4p holds k rows 2c + 8p (low) and +1 (high)
      const uint32_t u = ld_w16<TMAW>(ws, a, prow0, n0, kk * 8 + c + 4 * p, colb) ^ 0x8888u;
      z[p] = (u & 0x0F0Fu) | (((u >> 4) & 0x0F0Fu) << 16);
    } else {
      const int r = kk * 16 + 2 * c + 8 * p;
      z[p] = (ld_w16<TMAW>(ws, a, prow0, n0, r, colb) |
              (ld_w16<TMAW>(ws, a, prow0, n0, r + 1, colb) << 16)) ^
             0x80808080u;
    }
  }
  constexpr int BIAS = INT4 ? 8 : 128;
  af[0] = cvt2<T, BIAS>(z[0], 0, 2);
  af[1] = cvt2<T, BIAS>(z[0], 1, 3);
  af[2] = cvt2<T, BIAS>(z[1], 0, 2);
  af[3] = cvt2<T, BIAS>(z[1], 1, 3);
}

// ---- stores -------------------------------------------------------------------
// out[row, col..col+n-1] = v[0..n-1] * scale, n = 2 or 4, in a.out_dt
template <int NV>
__device__ __forceinline__ void store_scaled(const QArgs& a, int row, int col, const float* v) {
  float y[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) y[i] = v[i] * a.scale[col + i];
  const size_t o = (size_t)row * a.N + col;
  if (a.out_dt == 0) {
    float* p = reinterpret_cast<float*>(a.out) + o;
    if constexpr (NV == 4) {
      *reinterpret_cast<float4*>(p) = make_float4(y[0], y[1], y[2], y[3]);
    } else {
      *reinterpret_cast<float2*>(p) = make_float2(y[0], y[1]);
    }
    return;
  }
  uint32_t w[NV / 2];
#pragma unroll
  for (int i = 0; i < NV / 2; ++i) {
    if (a.out_dt == 1) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(y[2 * i], y[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&h);
    } else {
      const __half2 h = __floats2half2_rn(y[2 * i], y[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
  }
  uint16_t* p = reinterpret_cast<uint16_t*>(a.out) + o;
  if constexpr (NV == 4) {
    *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  } else {
    *reinterpret_cast<uint32_t*>(p) = w[0];
  }
}

// ---------------------------------------------------------------------
// 16-bit activations: TMA ring, wgmma, cluster split-K
// ---------------------------------------------------------------------
template <typename T, bool INT4, int MT, bool TMAW>
__global__ void __launch_bounds__(NT, MT == 1 ? 2 : 1)
    qmm_wgmma_kernel(const __grid_constant__ CUtensorMap tw, const __grid_constant__ CUtensorMap tx,
                     const QArgs a) {
  using W = WTile<INT4>;
  using RG = Ring<INT4, MT>;
  constexpr int NSTAGE = RG::NSTAGE;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t ring = smem_addr(smem);
  const uint32_t full0 = ring + NSTAGE * RG::STAGE, empty0 = full0 + NSTAGE * 8;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int cs = a.splits, rank = blockIdx.x;  // the cluster is the K splits of one N tile
  const int n0 = blockIdx.y * BN, m0 = blockIdx.z * (64 * MT);
  const int nk = (a.K + BK - 1) / BK;
  const int c0 = rank * a.cps, nchunks = max(min(nk, c0 + a.cps) - c0, 0);

  if (tid == 0) {
    for (int s = 0; s < NSTAGE; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, NCONS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == NCONS / 32) {
    // ---- producer warp: lane 0 keeps the ring full ----
    if (lane == 0) {
      constexpr int TX = (TMAW ? W::BYTES : 0) + MT * XBYTES;
      for (int i = 0; i < nchunks; ++i) {
        const int s = i % NSTAGE, r = i / NSTAGE, chunk = c0 + i;
        if (r > 0) mbar_wait(empty0 + 8 * s, (r - 1) & 1);
        const uint32_t st = ring + s * RG::STAGE, bar = full0 + 8 * s;
        mbar_expect_tx(bar, TX);
        if constexpr (TMAW) tma_load_2d(st, &tw, n0, chunk * W::ROWS, bar);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          tma_load_2d(st + W::BYTES + mt * XBYTES, &tx, chunk * BK, m0 + mt * 64, bar);
      }
    }
    __syncwarp();
    if (cs > 1)
      for (int mt = 0; mt < MT; ++mt) {
        cluster_sync();  // partials written
        cluster_sync();  // partials read
      }
    return;
  }

  // ---- consumer warpgroups ----
  const int wg = warp >> 2, w = warp & 3, g = lane >> 2, c = lane & 3;
  const int colb = 64 * wg + 16 * w + 2 * g;  // this thread's column pair in the block
  float acc[MT][32];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[mt][e] = 0.f;

  // One chunk: convert each k-step's A fragments into registers of their
  // own while the previous k-step's wgmmas run, then let the chunk's
  // wgmmas run on while the next chunk converts; the stage of chunk i - 1
  // is released once wait_group 1 says its wgmmas are done. The A
  // registers of two chunks alternate (buffer P), so none is written
  // while a wgmma that reads it is in flight.
  uint32_t af[2][4][4];
  auto chunk = [&](int i, auto pbuf) {
    constexpr int P = decltype(pbuf)::value;
    const int s = i % NSTAGE, r = i / NSTAGE;
    mbar_wait(full0 + 8 * s, r & 1);
    const unsigned char* ws = smem + s * RG::STAGE;
    const uint32_t xs = ring + s * RG::STAGE + W::BYTES;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) fence_acc(acc[mt]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      load_a<T, INT4, TMAW>(af[P][kk], ws, a, (c0 + i) * W::ROWS, n0, colb, c, kk);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        wgmma_rs<T>(acc[mt], af[P][kk], xdesc(xs + mt * XBYTES) + 2 * kk);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) fence_acc(acc[mt]);
    if (i > 0) mbar_arrive(empty0 + 8 * ((i - 1) % NSTAGE));  // chunk i - 1 is done
  };
  for (int i = 0; i < nchunks; i += 2) {
    chunk(i, std::integral_constant<int, 0>());
    if (i + 1 < nchunks) chunk(i + 1, std::integral_constant<int, 1>());
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) fence_acc(acc[mt]);

  // accumulator element 4j + 2h + e: A-row 16w + g + 8h (weight column
  // colb + h), x row 8j + 2c + e of the M tile
  const int col = n0 + colb;
  if (cs == 1) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int row = m0 + mt * 64 + 8 * j + 2 * c + e;
          if (row < a.M && col < a.N) {
            const float v[2] = {acc[mt][4 * j + e], acc[mt][4 * j + 2 + e]};
            store_scaled<2>(a, row, col, v);
          }
        }
    return;
  }
  // split-K: fp32 partials of one M tile in the idle ring, then each rank
  // sums its share of the tile over ranks 0..cs-1 in order
  float* red = reinterpret_cast<float*>(smem);
  const int u0 = rank * (64 * BN / 4) / cs, u1 = (rank + 1) * (64 * BN / 4) / cs;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    asm volatile("bar.sync 1, %0;\n" ::"n"(NCONS) : "memory");  // both warpgroups off the ring
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        *reinterpret_cast<float2*>(red + (8 * j + 2 * c + e) * LDR + colb) =
            make_float2(acc[mt][4 * j + e], acc[mt][4 * j + 2 + e]);
    cluster_sync();
    for (int u = u0 + tid; u < u1; u += NCONS) {
      const int row = u / (BN / 4), cb = 4 * (u % (BN / 4));
      const int grow = m0 + mt * 64 + row, gcol = n0 + cb;
      if (grow >= a.M || gcol >= a.N) continue;
      const uint32_t la = smem_addr(red + row * LDR + cb);
      float4 sum = ld_cluster_f4(la, 0);
      for (int rr = 1; rr < cs; ++rr) {
        const float4 p = ld_cluster_f4(la, rr);
        sum.x += p.x;
        sum.y += p.y;
        sum.z += p.z;
        sum.w += p.w;
      }
      const float v[4] = {sum.x, sum.y, sum.z, sum.w};
      store_scaled<4>(a, grow, gcol, v);
    }
    cluster_sync();
  }
}

// ---------------------------------------------------------------------
// fp32 activations: plain fp32 FMA (exact operands, no TF32)
// ---------------------------------------------------------------------
constexpr int FM = 16;   // rows of x per block
constexpr int FN = 64;   // weight columns per block
constexpr int FNT = 256;

template <bool INT4>
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
      xs[r][i % BK] = (m0 + r < a.M && k < a.K) ? x[(size_t)(m0 + r) * a.Kx + k] : 0.f;
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
      continue;
    }
    const float y = acc[r] * a.scale[n];
    if (a.out_dt == 0) reinterpret_cast<float*>(a.out)[o] = y;
    else if (a.out_dt == 1) reinterpret_cast<bf16*>(a.out)[o] = __float2bfloat16(y);
    else reinterpret_cast<f16*>(a.out)[o] = __float2half_rn(y);
  }
}

// fp32 x with splits > 1: out[m, n] = (sum over splits s = 0, 1, ... of
// part[s, m, n]) * scale[n]
__global__ void combine_kernel(const QArgs a) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)a.M * a.N) return;
  const size_t mn = (size_t)a.M * a.N;
  float s = a.part[i];
  for (int z = 1; z < a.splits; ++z) s += a.part[z * mn + i];
  s *= a.scale[i % a.N];
  if (a.out_dt == 0) reinterpret_cast<float*>(a.out)[i] = s;
  else if (a.out_dt == 1) reinterpret_cast<bf16*>(a.out)[i] = __float2bfloat16(s);
  else reinterpret_cast<f16*>(a.out)[i] = __float2half_rn(s);
}

// ---- host side ------------------------------------------------------------------
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, which the CUDA runtime has loaded
// (no link against libcuda)
EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* h = dlopen("libcuda.so.1", RTLD_NOW | RTLD_GLOBAL);
    if (h) fn = reinterpret_cast<EncodeTiled>(dlsym(h, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

// a 2-D row-major [rows][cols] tensor map, boxes of [box_rows][box_cols],
// 128-byte swizzle, zeros out of bounds
int encode_2d(CUtensorMap* map, CUtensorMapDataType dt, const void* ptr, uint64_t rows,
              uint64_t cols, int elem_bytes, uint32_t box_rows, uint32_t box_cols) {
  EncodeTiled fn = encode_fn();
  if (!fn) return (int)cudaErrorSharedObjectSymbolNotFound;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * (uint64_t)elem_bytes};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t es[2] = {1, 1};
  const CUresult r = fn(map, dt, 2, const_cast<void*>(ptr), dims, strides, box, es,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <typename T, bool INT4, int MT, bool TMAW>
cudaError_t launch_wgmma(const CUtensorMap& tw, const CUtensorMap& tx, const QArgs& a,
                         cudaStream_t st) {
  static bool attr_set = false;
  auto kern = qmm_wgmma_kernel<T, INT4, MT, TMAW>;
  constexpr int smem = Ring<INT4, MT>::SMEM;
  if (!attr_set) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.splits, (a.N + BN - 1) / BN, (a.M + 64 * MT - 1) / (64 * MT));
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = a.splits > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kern, tw, tx, a);
}

template <typename T, bool INT4>
cudaError_t dispatch_mt(const CUtensorMap& tw, const CUtensorMap& tx, const QArgs& a,
                        bool tmaw, cudaStream_t st) {
  if (!tmaw) return launch_wgmma<T, INT4, 1, false>(tw, tx, a, st);
  if (a.M <= 64) return launch_wgmma<T, INT4, 1, true>(tw, tx, a, st);
  if (a.M <= 128) return launch_wgmma<T, INT4, 2, true>(tw, tx, a, st);
  return launch_wgmma<T, INT4, 4, true>(tw, tx, a, st);
}

}  // namespace

// The payload's tensor map (128 bytes into map_out), encoded once per
// weight by the wrapper: q [prows, N] int8, N % 16 == 0, q 16-byte
// aligned, boxes of one stage's payload rows x 128 columns. Returns 0 on
// success.
extern "C" int ff_qmatmul_wmap(const void* q, int prows, int N, int int4, void* map_out) {
  if (prows <= 0 || N <= 0 || N % 16 || ((uintptr_t)q & 15)) return (int)cudaErrorInvalidValue;
  CUtensorMap map;
  const int rc = encode_2d(&map, CU_TENSOR_MAP_DATA_TYPE_UINT8, q, prows, N, 1,
                           int4 ? WTile<true>::ROWS : WTile<false>::ROWS, BN);
  if (rc == 0) memcpy(map_out, &map, sizeof(map));
  return rc;
}

// x [M, Kx] (x_dt 0 fp32, 1 bf16, 2 fp16; zeros in columns K..Kx-1; Kx %
// 8 == 0), q the int8 [K, N] or packed int4 [ceil(K/2), N] payload, scale
// fp32 [N], out [M, N] in out_dt. wmap: the payload's tensor map from
// ff_qmatmul_wmap, or null when the payload is not a TMA tensor (N % 16
// != 0). 16-bit x: one launch, the K splits a cluster (splits <= 8).
// fp32 x: with splits > 1, part is an fp32 [splits, M, N] scratch and a
// combine launch follows. Returns cudaGetLastError() after the
// launch(es): 0 on success.
extern "C" int ff_qmatmul(const void* x, const void* q, const float* scale, void* out,
                          float* part, const void* wmap, int M, int N, int K, int Kx,
                          int splits, int cps, int int4, int x_dt, int out_dt, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || N % 4 || Kx % 8 || Kx < K || splits < 1 || cps < 1 ||
      (long long)splits * cps * BK < K || out_dt < 0 || out_dt > 2 || x_dt < 0 || x_dt > 2)
    return (int)cudaErrorInvalidValue;
  QArgs a;
  a.x = x; a.q = reinterpret_cast<const int8_t*>(q); a.scale = scale; a.out = out;
  a.part = part; a.M = M; a.N = N; a.K = K; a.Kx = Kx; a.prows = int4 ? (K + 1) / 2 : K;
  a.splits = splits; a.cps = cps; a.out_dt = out_dt;
  cudaStream_t st = (cudaStream_t)stream;
  if (x_dt == 0) {
    if (splits > 1 && !part) return (int)cudaErrorInvalidValue;
    const dim3 grid((N + FN - 1) / FN, (M + FM - 1) / FM, splits);
    if (int4) qmm_fp32_kernel<true><<<grid, FNT, 0, st>>>(a);
    else qmm_fp32_kernel<false><<<grid, FNT, 0, st>>>(a);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess || splits == 1) return (int)e;
    const size_t n = (size_t)M * N;
    combine_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(a);
    return (int)cudaGetLastError();
  }
  if (splits > 8) return (int)cudaErrorInvalidValue;
  CUtensorMap tw, tx;
  if (wmap) memcpy(&tw, wmap, sizeof(tw));
  else memset(&tw, 0, sizeof(tw));
  int rc = encode_2d(&tx, x_dt == 1 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                    : CU_TENSOR_MAP_DATA_TYPE_FLOAT16,
                     x, M, Kx, 2, 64, BK);
  if (rc) return rc;
  cudaError_t e;
  if (x_dt == 1) e = int4 ? dispatch_mt<bf16, true>(tw, tx, a, wmap, st)
                          : dispatch_mt<bf16, false>(tw, tx, a, wmap, st);
  else e = int4 ? dispatch_mt<f16, true>(tw, tx, a, wmap, st)
                : dispatch_mt<f16, false>(tw, tx, a, wmap, st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
