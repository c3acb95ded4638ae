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
// What bounds each kernel on this card:
//  * K2 (decode: G*Q query rows of which G are real) reads every valid
//    K/V row once and does ~4*G*Q flops per cache element, far below the
//    ~295 flop/byte where bf16 tensor cores become the limit: it is bound
//    by the HBM bytes of the valid prefix, 2*R*KH*len*D*itemsize, and at
//    short caches by the latency of its first tile;
//  * K1 (prefill chunks, tree verify: G*Q = 64..256 rows) does ~64x more
//    flops per byte, still below that line: bytes again, provided the
//    products run on the tensor cores (scalar fp32 FMA made it
//    shared-memory-bound at 6% of its bound).
//
// What the design does about it (bf16 cache, the serving path):
//  * grid (query tile x S-split, kv head, row). A block serves 64 of the
//    G*Q query rows of one (row, kv head), four warps of 16 rows each, and
//    reads each 64-position K/V tile of its S range from HBM once;
//  * K/V tiles arrive by 16-byte cp.async into a 3-stage ring of bf16
//    tiles (XOR-swizzled 16-byte chunks, so ldmatrix is conflict-free):
//    tiles j+1 and j+2 are in flight while tile j computes. Positions past
//    len are zero-filled, never read. The first tiles are requested right
//    after the block's scalars arrive, before q is read: a decode block
//    that streams one tile waits on two memory latencies, not a chain;
//  * S = Q.K^T and O += P.V run on mma.sync.m16n8k16 (bf16 in, fp32
//    accumulate), operands by ldmatrix; q is held in registers, P is
//    rounded to bf16 in registers (the reference's p.to(dt)) and never
//    touches shared memory. 96 KiB of shared memory a block at D = 128,
//    so two blocks share an SM. A tile that every key of a row sees, with
//    no ALiBi or bias, skips the per-key mask tests (same arithmetic);
//  * finished rows go through shared memory and out in 16-byte stores;
//  * a query tile stops streaming at ceil(min(len, max qpos + 1) / 64)
//    under causal masking (tiles past it are fully masked for every row);
//  * split-S (flash-decoding): when R*KH blocks cannot fill the SMs, the
//    host's plan (split_plan in attention.py, a function of R, KH, S and
//    the SM count only) cuts the tiles into n_split ranges of tps tiles.
//    Each split writes a partial (m, l, unnormalised O) in fp32; a second
//    small kernel combines the splits in a fixed order (deterministic);
//  * K2's fused append: the block of query tile 0 in the split that owns
//    appos[r] writes k_new/v_new into the cache; every block that streams
//    position appos[r] copies it from k_new/v_new instead of the cache,
//    so no block reads a row another block writes and no ordering or
//    proxy fence is needed;
//  * the softmax partition over S is 64-position tiles whatever Q, and
//    each row's arithmetic depends only on that row: a width-1 decode, a
//    width-8 decode and a K1 call over the same cache give bitwise equal
//    rows for the same query.
// The fp16 cache takes the same tensor-core body with the f16 form of the
// mma (P rounded to fp16, the reference's p.to(dt)). Head dims 64 and 128
// here; 256 and its multiples are served by the wide kernels (one block
// per 256-column slice of O, q and K staged in 256-column chunks; see
// their section). Other head dims are served by a cache padded to the
// next of these (ops/inc_attention.py cache_head_dim).
// The fp32 cache type keeps scalar FMA (TF32 tensor cores would lose the
// 2e-5 parity) with the same grid, split plan, causal cut and append.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BS = 64;     // cache positions per S-tile (never depends on Q)
constexpr int QM = 64;     // query rows per block (a grid dimension)
constexpr int NT_MMA = 128;   // 16-bit kernel: four warps of 16 query rows
constexpr int NT_SIMT = 256;  // fp32 kernel
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
  float* part_o;       // [n_split, R, Q, H, D] when n_split > 1
  float* part_ml;      // [n_split, R, Q, H, 2]
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
// over the column slices of the wide kernels.
template <bool APPEND>
__device__ Block block_setup(const Args& a, int bx) {
  __shared__ int qmax;
  Block b;
  b.r = blockIdx.z;
  b.kh = blockIdx.y;
  b.qt = bx / a.n_split;
  b.split = bx % a.n_split;
  b.G = a.H / a.KH;
  b.GQ = b.G * a.Q;
  b.q0 = b.qt * QM;
  // every scalar load issued before the first use of any of them: the
  // block's first tile waits on one memory latency, not a chain of them
  const int gq = b.q0 + threadIdx.x;
  const bool has_q = a.causal && threadIdx.x < QM && gq < b.GQ;
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

// One output element of a finished row: normalised and rounded like the
// reference (to the cache type, then to the output type) when there is
// one split, else the split's unnormalised fp32 partial.
template <typename T>
__device__ __forceinline__ void store_out(const Args& a, const Block& b, size_t row, int D,
                                          int d, float o, float l) {
  if (a.n_split == 1) {
    put_out(a.out, row * D + d, a.out_dt, round_to<T>(o / fmaxf(l, 1e-30f)));
  } else {
    a.part_o[((size_t)b.split * a.R * a.Q * a.H + row) * D + d] = o;
  }
}

// The split's running max and sum of a finished row (split-S only).
__device__ __forceinline__ void store_ml(const Args& a, const Block& b, size_t row, float m,
                                         float l) {
  if (a.n_split == 1) return;
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

// ---------------------------------------------------------------------
// bf16 / fp16 cache: tensor cores (mma.sync.m16n8k16), cp.async ring
// ---------------------------------------------------------------------

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

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c[16x8] += a[16x16] . b[16x8], T (bf16 or fp16) operands, fp32 accumulate
template <typename T>
__device__ __forceinline__ void mma16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  if constexpr (std::is_same<T, bf16>::value) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
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

// element offset of 16-byte chunk `ch` of tile row `row` ([BS][D] tile,
// chunks XOR-swizzled by row so that 8 rows of one chunk hit 8 banks)
template <int D>
__device__ __forceinline__ int swz(int row, int ch) {
  return row * D + ((ch ^ (row & 7)) << 3);
}

// the K/V ring
template <int D>
constexpr size_t mma_smem_bytes() {
  return 2 * (size_t)NSTAGE * 2 * BS * D;
}

// 16 staged fp32 rows (row stride D + 4) out to dst(row) as E, in
// 16-byte stores
template <typename E, int D, typename Dst>
__device__ __forceinline__ void copy_rows(const float* st, int lane, int rows, Dst dst) {
  constexpr int EPC = 16 / (int)sizeof(E);  // elements per 16-byte chunk
  constexpr int CPR = D / EPC;              // chunks per row
  for (int c = lane; c < 16 * CPR; c += 32) {
    const int row = c / CPR, ch = c % CPR;
    if (row >= rows) continue;
    const float4* src = reinterpret_cast<const float4*>(st + row * (D + 4) + ch * EPC);
    uint4 v;
    if constexpr (EPC == 4) {
      v = *reinterpret_cast<const uint4*>(src);
    } else {
      const float4 x0 = src[0], x1 = src[1];
      E* e = reinterpret_cast<E*>(&v);
      e[0] = from_f<E>(x0.x); e[1] = from_f<E>(x0.y); e[2] = from_f<E>(x0.z);
      e[3] = from_f<E>(x0.w); e[4] = from_f<E>(x1.x); e[5] = from_f<E>(x1.y);
      e[6] = from_f<E>(x1.z); e[7] = from_f<E>(x1.w);
    }
    reinterpret_cast<uint4*>(dst(row))[ch] = v;
  }
}

// A warp's 16 finished rows (mma accumulator layout) go through shared
// memory `st` as fp32 (padded rows: conflict-free) and out to dst(row), a
// row of dtype code dt, in 16-byte stores; normalised and rounded like
// store_out when `normalise`. The accumulators are dead once staged, so
// the branch on dt costs the main loop no registers.
template <typename T, int D, typename Dst>
__device__ __forceinline__ void warp_store(float* st, const float (&o)[D / 8][4], const float* l,
                                           bool normalise, int lane, int rows, int dt,
                                           Dst dst) {
  constexpr int LD = D + 4;
  const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float x = o[n][2 * i + e];
        if (normalise) x = round_to<T>(x / fmaxf(l[i], 1e-30f));
        st[(gid + 8 * i) * LD + n * 8 + tig * 2 + e] = x;
      }
  __syncwarp();
  if (dt == 0) copy_rows<float, D>(st, lane, rows, dst);
  else if (dt == 1) copy_rows<bf16, D>(st, lane, rows, dst);
  else copy_rows<f16, D>(st, lane, rows, dst);
}

// A block's finished rows: the ring is idle (last loop barrier passed, no
// copy pending), so each warp stages its rows in its own 16 x DW slice of
// it. The rows are columns [c0, c0 + DW) of head dim D (c0 = 0, DW = D but
// in the wide kernels); the split's (m, l) go out with column slice 0.
template <typename T, int DW>
__device__ __forceinline__ void mma_epilogue(const Args& a, const Block& b,
                                             unsigned char* smem_raw, int warp, int lane,
                                             int wrow, const float (&o)[DW / 8][4],
                                             const float* m, const float* l, const bool* rok,
                                             const size_t* orow, int D, int c0) {
  const int nrows = min(16, b.GQ - wrow);
  float* st = reinterpret_cast<float*>(smem_raw) + warp * 16 * (DW + 4);
  if (a.n_split == 1) {
    const size_t esize = a.out_dt == 0 ? 4 : 2;
    warp_store<T, DW>(st, o, l, true, lane, nrows, a.out_dt, [&](int row) {
      return static_cast<void*>(static_cast<char*>(a.out) +
                                (out_row(a, b, wrow + row) * D + c0) * esize);
    });
  } else {
    const size_t base = (size_t)b.split * a.R * a.Q * a.H;
    warp_store<T, DW>(st, o, l, false, lane, nrows, 0, [&](int row) {
      return static_cast<void*>(a.part_o + (base + out_row(a, b, wrow + row)) * D + c0);
    });
    if (c0 == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
        if (rok[i] && (lane & 3) == 0) store_ml(a, b, orow[i], m[i], l[i]);
    }
  }
}

// One S-tile's online softmax over this warp's scores s (16 rows x 64
// keys, mma accumulator layout: row i of this thread = elements 2i, 2i+1),
// then O += P . V with P rounded to T and V the tile's [BS][DW] slice in
// shared memory (swizzled). Every row's arithmetic depends on that row only.
template <typename T, int DW>
__device__ __forceinline__ void tile_softmax_pv(const Args& a, const Block& b, float (&s)[8][4],
                                                float (&o)[DW / 8][4], float* m, float* l,
                                                const bool* rok, const int* qp,
                                                const float* slope, const float* const* brow,
                                                int s0, const T* vs_, int lane) {
  constexpr int ND = DW / 8;
  const int tig = lane & 3;
  float corr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    // every key of the tile visible to this row and nothing added:
    // the same scaled product score() returns, without its tests
    const bool plain = rok[i] && s0 + BS <= b.len && (!a.causal || s0 + BS - 1 <= qp[i]) &&
                       !a.alibi && !a.bias;
    if (plain) {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) s[n][2 * i + e] = s[n][2 * i + e] * a.scale;
    } else {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          s[n][2 * i + e] = score(a, b, s[n][2 * i + e], rok[i], qp[i], slope[i], brow[i],
                                  s0 + n * 8 + tig * 2 + e);
    }
    float mx = NEG_INF;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) mx = fmaxf(mx, s[n][2 * i + e]);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[i], mx);
    float sum = 0.f;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p = __expf(s[n][2 * i + e] - m_new);
        s[n][2 * i + e] = p;
        sum += p;
      }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    corr[i] = __expf(m[i] - m_new);
    l[i] = l[i] * corr[i] + sum;
    m[i] = m_new;
  }
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    o[n][0] *= corr[0];
    o[n][1] *= corr[0];
    o[n][2] *= corr[1];
    o[n][3] *= corr[1];
  }
  // O += P . V: P (rounded to T) as A fragments, 4 k-steps of 16 keys
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t pa[4];
    pa[0] = pack2<T>(s[2 * kk][0], s[2 * kk][1]);
    pa[1] = pack2<T>(s[2 * kk][2], s[2 * kk][3]);
    pa[2] = pack2<T>(s[2 * kk + 1][0], s[2 * kk + 1][1]);
    pa[3] = pack2<T>(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
    for (int dp = 0; dp < ND / 2; ++dp) {
      uint32_t vb[4];
      const int key = kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3);
      ldmatrix_x4_trans(vb, vs_ + swz<DW>(key, dp * 2 + (lane >> 4)));
      mma16<T>(o[2 * dp], pa, vb[0], vb[1]);
      mma16<T>(o[2 * dp + 1], pa, vb[2], vb[3]);
    }
  }
}

template <typename T, int D, bool APPEND>
__global__ void __launch_bounds__(NT_MMA, 2) attend_mma_kernel(const Args a) {
  static_assert(D <= 128, "D = 256 and past: the wide kernel");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);        // [NSTAGE][K|V][BS][D]
  constexpr int CH = D / 8;                        // 16-byte chunks per row
  constexpr int KS = D / 16;                       // k-steps of q.k
  constexpr int ND = D / 8;                        // n-tiles of p.v

  const Block b = block_setup<APPEND>(a, blockIdx.x);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane >> 2, tig = lane & 3;
  const size_t head = ((size_t)b.r * a.KH + b.kh) * (size_t)a.S * D;
  const T* kc = reinterpret_cast<const T*>(a.k) + head;
  const T* vc = reinterpret_cast<const T*>(a.v) + head;
  const size_t nsrc = ((size_t)b.r * a.KH + b.kh) * D;
  const T* kn = APPEND ? reinterpret_cast<const T*>(a.k_new) + nsrc : nullptr;
  const T* vn = APPEND ? reinterpret_cast<const T*>(a.v_new) + nsrc : nullptr;

  auto load_tile = [&](int t, int st) {
    T* ks_ = ring + (size_t)st * 2 * BS * D;
    T* vs_ = ks_ + BS * D;
    for (int c = tid; c < BS * CH; c += NT_MMA) {
      const int row = c / CH, ch = c % CH, pos = t * BS + row;
      const T *ksrc = kc, *vsrc = vc;
      int bytes = 16;
      if (pos == b.app) {
        ksrc = kn + ch * 8;
        vsrc = vn + ch * 8;
      } else if (pos < b.len) {
        ksrc = kc + (size_t)pos * D + ch * 8;
        vsrc = vc + (size_t)pos * D + ch * 8;
      } else {
        bytes = 0;  // past the valid prefix: zeros, nothing read
      }
      cp_async16(ks_ + swz<D>(row, ch), ksrc, bytes);
      cp_async16(vs_ + swz<D>(row, ch), vsrc, bytes);
    }
  };
  // the first tiles go out before anything else is read
  const int ntiles = max(b.t1 - b.t0, 0);
#pragma unroll
  for (int i = 0; i < NSTAGE - 1; ++i) {
    if (i < ntiles) load_tile(b.t0 + i, i);
    cp_async_commit();
  }

  // this thread's two query rows: gid and gid + 8 of its warp's 16
  const int wrow = b.q0 + warp * 16;
  const bool wactive = wrow < b.GQ;
  bool rok[2];
  int qp[2];
  float slope[2];
  const float* brow[2];
  size_t orow[2];
  const T* qrow[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int gq = wrow + gid + 8 * i;
    rok[i] = gq < b.GQ;
    const int gqc = rok[i] ? gq : 0;
    const int g = gqc / a.Q, qi = gqc % a.Q;
    qp[i] = a.qpos[b.r * a.Q + qi];
    slope[i] = a.alibi ? a.alibi[b.kh * b.G + g] : 0.f;
    brow[i] = a.bias ? a.bias + ((size_t)b.r * a.Q + qi) * a.S : nullptr;
    orow[i] = out_row(a, b, gqc);
    qrow[i] = reinterpret_cast<const T*>(a.q) + orow[i] * D;
  }
  // q as mma A fragments, kept in registers for the whole stream
  uint32_t qa[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e & 1, d = ks * 16 + tig * 2 + 8 * (e >> 1);
      qa[ks][e] = rok[i] ? *reinterpret_cast<const uint32_t*>(qrow[i] + d) : 0u;
    }

  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  for (int j = 0; j < ntiles; ++j) {
    if (j + NSTAGE - 1 < ntiles) load_tile(b.t0 + j + NSTAGE - 1, (j + NSTAGE - 1) % NSTAGE);
    cp_async_commit();
    cp_async_wait<NSTAGE - 1>();  // tile j has landed (this thread's part)
    __syncthreads();              // ... and every thread's
    if (wactive) {
      const T* ks_ = ring + (size_t)(j % NSTAGE) * 2 * BS * D;
      const T* vs_ = ks_ + BS * D;
      const int s0 = (b.t0 + j) * BS;
      // S = q . k^T: 16 rows x 64 keys, 8 n-tiles of 8 keys
      float s[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t kb[4];
          const int key = np * 16 + (lane & 7) + ((lane >> 4) << 3);
          ldmatrix_x4(kb, ks_ + swz<D>(key, ks * 2 + ((lane >> 3) & 1)));
          mma16<T>(s[2 * np], qa[ks], kb[0], kb[1]);
          mma16<T>(s[2 * np + 1], qa[ks], kb[2], kb[3]);
        }
      }
      tile_softmax_pv<T, D>(a, b, s, o, m, l, rok, qp, slope, brow, s0, vs_, lane);
    }
    __syncthreads();  // the next iteration refills this stage
  }

  if (wactive) mma_epilogue<T, D>(a, b, smem_raw, warp, lane, wrow, o, m, l, rok, orow, D, 0);
  // after the rows are out, when O's registers are free (no block reads
  // the appended row)
  if (APPEND) append_store<T>(a, b, D);
}

// ---------------------------------------------------------------------
// head dims 256 and past (a multiple of DC = 256): the wide kernels
// ---------------------------------------------------------------------
// A block owns one DC-column slice of O for its (row, kv head, query
// tile, split): grid x = query tiles x splits x D / DC. Its scores run
// over the full D: per S-tile, the D / DC chunks of q and K are staged
// through shared memory one after another (q chunk beside K chunk) and
// their products summed in order, then the tile's V slice is staged for
// P . V. Every column slice computes the same scores, so each of them
// normalises its slice alike; slice 0 writes the split's (m, l) and K2's
// append. The 16-bit ring holds WSTAGE stages of two [BS][DC] halves:
// (q chunk, K chunk) or (V slice, unused), 192 KiB whatever D is.

constexpr int DC = 256;     // head-dim columns a wide block owns
constexpr int WSTAGE = 3;   // wide 16-bit ring depth

constexpr size_t wide_mma_smem_bytes() { return (size_t)WSTAGE * 2 * BS * DC * 2; }

template <typename T, bool APPEND>
__global__ void __launch_bounds__(NT_MMA, 1) attend_mma_wide_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);  // [WSTAGE][2][BS][DC]
  constexpr int CH = DC / 8;                 // 16-byte chunks per staged row
  constexpr int KS = DC / 16;                // k-steps of one chunk's q.k
  constexpr int ND = DC / 8;                 // n-tiles of p.v (the slice)
  const int D = a.D, nch = D / DC;
  const int col = blockIdx.x % nch;
  const Block b = block_setup<APPEND>(a, blockIdx.x / nch);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane >> 2;
  const size_t head = ((size_t)b.r * a.KH + b.kh) * (size_t)a.S * D;
  const T* kc = reinterpret_cast<const T*>(a.k) + head;
  const T* vc = reinterpret_cast<const T*>(a.v) + head;
  const size_t nsrc = ((size_t)b.r * a.KH + b.kh) * D;
  const T* kn = APPEND ? reinterpret_cast<const T*>(a.k_new) + nsrc : nullptr;
  const T* vn = APPEND ? reinterpret_cast<const T*>(a.v_new) + nsrc : nullptr;
  const T* qg = reinterpret_cast<const T*>(a.q);

  // sub-step u of the stream: tile u / (nch + 1); part p = u % (nch + 1)
  // is (q, K) chunk p for p < nch, else the tile's V slice
  auto load_sub = [&](int u, int st) {
    const int t = b.t0 + u / (nch + 1), p = u % (nch + 1);
    T* lo = ring + (size_t)st * 2 * BS * DC;
    T* hi = lo + BS * DC;
    for (int c = tid; c < BS * CH; c += NT_MMA) {
      const int row = c / CH, ch = c % CH, pos = t * BS + row;
      if (p < nch) {
        const int cofs = p * DC + ch * 8, gq = b.q0 + row;
        cp_async16(lo + swz<DC>(row, ch), gq < b.GQ ? qg + out_row(a, b, gq) * D + cofs : qg,
                   gq < b.GQ ? 16 : 0);
        const T* ksrc = kc;
        int bytes = 16;
        if (pos == b.app) ksrc = kn + cofs;
        else if (pos < b.len) ksrc = kc + (size_t)pos * D + cofs;
        else bytes = 0;  // past the valid prefix: zeros, nothing read
        cp_async16(hi + swz<DC>(row, ch), ksrc, bytes);
      } else {
        const int cofs = col * DC + ch * 8;
        const T* vsrc = vc;
        int bytes = 16;
        if (pos == b.app) vsrc = vn + cofs;
        else if (pos < b.len) vsrc = vc + (size_t)pos * D + cofs;
        else bytes = 0;
        cp_async16(lo + swz<DC>(row, ch), vsrc, bytes);
      }
    }
  };
  const int nsub = max(b.t1 - b.t0, 0) * (nch + 1);
#pragma unroll
  for (int i = 0; i < WSTAGE - 1; ++i) {
    if (i < nsub) load_sub(i, i);
    cp_async_commit();
  }

  const int wrow = b.q0 + warp * 16;
  const bool wactive = wrow < b.GQ;
  bool rok[2];
  int qp[2];
  float slope[2];
  const float* brow[2];
  size_t orow[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int gq = wrow + gid + 8 * i;
    rok[i] = gq < b.GQ;
    const int gqc = rok[i] ? gq : 0;
    const int g = gqc / a.Q, qi = gqc % a.Q;
    qp[i] = a.qpos[b.r * a.Q + qi];
    slope[i] = a.alibi ? a.alibi[b.kh * b.G + g] : 0.f;
    brow[i] = a.bias ? a.bias + ((size_t)b.r * a.Q + qi) * a.S : nullptr;
    orow[i] = out_row(a, b, gqc);
  }

  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float s[8][4];

  for (int u = 0; u < nsub; ++u) {
    if (u + WSTAGE - 1 < nsub) load_sub(u + WSTAGE - 1, (u + WSTAGE - 1) % WSTAGE);
    cp_async_commit();
    cp_async_wait<WSTAGE - 1>();
    __syncthreads();
    if (wactive) {
      const T* lo = ring + (size_t)(u % WSTAGE) * 2 * BS * DC;
      const int p = u % (nch + 1);
      if (p < nch) {
        // S += q[:, chunk p] . K[:, chunk p]^T, the chunks in order
        if (p == 0) {
#pragma unroll
          for (int n = 0; n < 8; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
        }
        const T* ks_ = lo + BS * DC;
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          uint32_t qf[4];
          ldmatrix_x4(qf, lo + swz<DC>(warp * 16 + (lane & 15), ks * 2 + (lane >> 4)));
#pragma unroll
          for (int np = 0; np < 4; ++np) {
            uint32_t kb[4];
            const int key = np * 16 + (lane & 7) + ((lane >> 4) << 3);
            ldmatrix_x4(kb, ks_ + swz<DC>(key, ks * 2 + ((lane >> 3) & 1)));
            mma16<T>(s[2 * np], qf, kb[0], kb[1]);
            mma16<T>(s[2 * np + 1], qf, kb[2], kb[3]);
          }
        }
      } else {
        tile_softmax_pv<T, DC>(a, b, s, o, m, l, rok, qp, slope, brow,
                               (b.t0 + u / (nch + 1)) * BS, lo, lane);
      }
    }
    __syncthreads();  // the next sub-step refills this stage
  }

  if (wactive)
    mma_epilogue<T, DC>(a, b, smem_raw, warp, lane, wrow, o, m, l, rok, orow, D, col * DC);
  if (APPEND && col == 0) append_store<T>(a, b, D);
}

// ---------------------------------------------------------------------
// fp32 cache: scalar FMA over shared-memory tiles
// ---------------------------------------------------------------------

template <int D>
constexpr size_t simt_smem_bytes() {
  // q tile, K tile (padded rows), V tile, scores/probabilities,
  // m / l / correction per query row, qpos per query row
  return sizeof(float) * (QM * D + BS * (D + 1) + BS * D + QM * BS + 3 * QM) +
         sizeof(int) * QM;
}

template <int D, bool APPEND>
__global__ void __launch_bounds__(NT_SIMT) attend_simt_kernel(const Args a) {
  extern __shared__ float smem[];
  constexpr int KS = D + 1;  // padded K row stride: conflict-free column reads
  constexpr int NWARPS = NT_SIMT / 32;
  float* q_s = smem;               // [QM][D]
  float* k_s = q_s + QM * D;       // [BS][KS]
  float* v_s = k_s + BS * KS;      // [BS][D]
  float* p_s = v_s + BS * D;       // [QM][BS]
  float* m_s = p_s + QM * BS;      // [QM]
  float* l_s = m_s + QM;           // [QM]
  float* c_s = l_s + QM;           // [QM]
  int* qp_s = reinterpret_cast<int*>(c_s + QM);  // [QM]

  const Block b = block_setup<APPEND>(a, blockIdx.x);
  const int tid = threadIdx.x;
  const size_t head = ((size_t)b.r * a.KH + b.kh) * (size_t)a.S * D;
  const float* kc = reinterpret_cast<const float*>(a.k) + head;
  const float* vc = reinterpret_cast<const float*>(a.v) + head;
  const size_t nsrc = ((size_t)b.r * a.KH + b.kh) * D;
  const float* qg = reinterpret_cast<const float*>(a.q);

  // accumulator ownership: thread tid owns dim my_d of query rows
  // row0, row0 + RSTEP, ...
  constexpr int NACC = QM * D / NT_SIMT;
  constexpr int RSTEP = NT_SIMT / D;
  const int my_d = tid % D, row0 = tid / D;
  // score ownership: thread tid owns key column sc of rows srow0 + i*SSTEP
  constexpr int SSTEP = NT_SIMT / BS;
  constexpr int NSC = QM / SSTEP;
  const int sc = tid % BS, srow0 = tid / BS;

  for (int e = tid; e < QM * D; e += NT_SIMT) {
    const int row = e / D, d = e % D, gq = b.q0 + row;
    q_s[e] = gq < b.GQ ? qg[out_row(a, b, gq) * D + d] : 0.f;
  }
  for (int row = tid; row < QM; row += NT_SIMT) {
    const int gq = b.q0 + row;
    qp_s[row] = gq < b.GQ ? a.qpos[b.r * a.Q + gq % a.Q] : 0;
    m_s[row] = NEG_INF;
    l_s[row] = 0.f;
  }
  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;
  __syncthreads();

  for (int t = b.t0; t < b.t1; ++t) {
    const int s0 = t * BS;
    for (int e = tid; e < BS * D; e += NT_SIMT) {
      const int s = e / D, d = e % D, pos = s0 + s;
      float kv = 0.f, vv = 0.f;
      if (pos == b.app) {
        kv = reinterpret_cast<const float*>(a.k_new)[nsrc + d];
        vv = reinterpret_cast<const float*>(a.v_new)[nsrc + d];
      } else if (pos < b.len) {
        kv = kc[(size_t)pos * D + d];
        vv = vc[(size_t)pos * D + d];
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
#pragma unroll
      for (int i = 0; i < NSC; ++i) {
        const int row = srow0 + i * SSTEP, gq = b.q0 + row;
        const bool ok = gq < b.GQ;
        const int qi = ok ? gq % a.Q : 0, g = ok ? gq / a.Q : 0;
        p_s[row * BS + sc] =
            score(a, b, dots[i], ok, qp_s[row], a.alibi ? a.alibi[b.kh * b.G + g] : 0.f,
                  a.bias ? a.bias + ((size_t)b.r * a.Q + qi) * a.S : nullptr, s0 + sc);
      }
    }
    __syncthreads();

    // online softmax, one warp per query row (BS == 64: two keys a lane)
    const int warp = tid / 32, lane = tid % 32;
    for (int row = warp; row < QM; row += NWARPS) {
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
      p_s[row * BS + lane] = p0;
      p_s[row * BS + lane + 32] = p1;
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

  if (APPEND) append_store<float>(a, b, D);
#pragma unroll
  for (int i = 0; i < NACC; ++i) {
    const int row = row0 + i * RSTEP, gq = b.q0 + row;
    if (gq >= b.GQ) continue;
    const size_t orow = out_row(a, b, gq);
    store_out<float>(a, b, orow, D, my_d, acc[i], l_s[row]);
    if (my_d == 0) store_ml(a, b, orow, m_s[row], l_s[row]);
  }
}

// fp32 cache, D = 256 and past: the scalar kernel's tiles at DC columns. Per
// S-tile the q and K chunks are staged one after another and the dots
// summed over them in order (the same d order as one D-wide pass), then
// the tile's V slice; the block owns O's columns [col * DC, col * DC + DC).
template <bool APPEND>
__global__ void __launch_bounds__(NT_SIMT) attend_simt_wide_kernel(const Args a) {
  extern __shared__ float smem[];
  constexpr int KS = DC + 1;
  constexpr int NWARPS = NT_SIMT / 32;
  float* q_s = smem;               // [QM][DC]
  float* k_s = q_s + QM * DC;      // [BS][KS]
  float* v_s = k_s + BS * KS;      // [BS][DC]
  float* p_s = v_s + BS * DC;      // [QM][BS]
  float* m_s = p_s + QM * BS;      // [QM]
  float* l_s = m_s + QM;           // [QM]
  float* c_s = l_s + QM;           // [QM]
  int* qp_s = reinterpret_cast<int*>(c_s + QM);  // [QM]

  const int D = a.D, nch = D / DC;
  const int col = blockIdx.x % nch;
  const Block b = block_setup<APPEND>(a, blockIdx.x / nch);
  const int tid = threadIdx.x;
  const size_t head = ((size_t)b.r * a.KH + b.kh) * (size_t)a.S * D;
  const float* kc = reinterpret_cast<const float*>(a.k) + head;
  const float* vc = reinterpret_cast<const float*>(a.v) + head;
  const size_t nsrc = ((size_t)b.r * a.KH + b.kh) * D;
  const float* qg = reinterpret_cast<const float*>(a.q);

  static_assert(NT_SIMT == DC, "thread tid owns column tid of every query row");
  constexpr int NACC = QM;
  const int my_d = tid % DC;
  constexpr int SSTEP = NT_SIMT / BS;
  constexpr int NSC = QM / SSTEP;
  const int sc = tid % BS, srow0 = tid / BS;

  for (int row = tid; row < QM; row += NT_SIMT) {
    const int gq = b.q0 + row;
    qp_s[row] = gq < b.GQ ? a.qpos[b.r * a.Q + gq % a.Q] : 0;
    m_s[row] = NEG_INF;
    l_s[row] = 0.f;
  }
  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;
  __syncthreads();

  for (int t = b.t0; t < b.t1; ++t) {
    const int s0 = t * BS;
    float dots[NSC];
#pragma unroll
    for (int i = 0; i < NSC; ++i) dots[i] = 0.f;
    for (int c = 0; c < nch; ++c) {
      for (int e = tid; e < QM * DC; e += NT_SIMT) {
        const int row = e / DC, d = e % DC, gq = b.q0 + row;
        q_s[e] = gq < b.GQ ? qg[out_row(a, b, gq) * D + c * DC + d] : 0.f;
      }
      for (int e = tid; e < BS * DC; e += NT_SIMT) {
        const int sp = e / DC, d = e % DC, pos = s0 + sp;
        float kv = 0.f;
        if (pos == b.app) kv = reinterpret_cast<const float*>(a.k_new)[nsrc + c * DC + d];
        else if (pos < b.len) kv = kc[(size_t)pos * D + c * DC + d];
        k_s[sp * KS + d] = kv;
      }
      __syncthreads();
      for (int d = 0; d < DC; ++d) {
        const float kd = k_s[sc * KS + d];
#pragma unroll
        for (int i = 0; i < NSC; ++i) dots[i] += q_s[(srow0 + i * SSTEP) * DC + d] * kd;
      }
      __syncthreads();  // the next chunk overwrites q_s / k_s
    }
#pragma unroll
    for (int i = 0; i < NSC; ++i) {
      const int row = srow0 + i * SSTEP, gq = b.q0 + row;
      const bool ok = gq < b.GQ;
      const int qi = ok ? gq % a.Q : 0, g = ok ? gq / a.Q : 0;
      p_s[row * BS + sc] =
          score(a, b, dots[i], ok, qp_s[row], a.alibi ? a.alibi[b.kh * b.G + g] : 0.f,
                a.bias ? a.bias + ((size_t)b.r * a.Q + qi) * a.S : nullptr, s0 + sc);
    }
    for (int e = tid; e < BS * DC; e += NT_SIMT) {
      const int sp = e / DC, d = e % DC, pos = s0 + sp;
      float vv = 0.f;
      if (pos == b.app) vv = reinterpret_cast<const float*>(a.v_new)[nsrc + col * DC + d];
      else if (pos < b.len) vv = vc[(size_t)pos * D + col * DC + d];
      v_s[sp * DC + d] = vv;
    }
    __syncthreads();

    const int warp = tid / 32, lane = tid % 32;
    for (int row = warp; row < QM; row += NWARPS) {
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
      p_s[row * BS + lane] = p0;
      p_s[row * BS + lane + 32] = p1;
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        l_s[row] = l_s[row] * corr + sum;
        m_s[row] = m_new;
        c_s[row] = corr;
      }
    }
    __syncthreads();

    {
      float pv[NACC];
#pragma unroll
      for (int i = 0; i < NACC; ++i) pv[i] = 0.f;
      for (int sp = 0; sp < BS; ++sp) {
        const float vv = v_s[sp * DC + my_d];
#pragma unroll
        for (int i = 0; i < NACC; ++i) pv[i] += p_s[i * BS + sp] * vv;
      }
#pragma unroll
      for (int i = 0; i < NACC; ++i) acc[i] = acc[i] * c_s[i] + pv[i];
    }
    __syncthreads();  // the next tile overwrites k_s / v_s / p_s
  }

  if (APPEND && col == 0) append_store<float>(a, b, D);
#pragma unroll
  for (int i = 0; i < NACC; ++i) {
    const int gq = b.q0 + i;
    if (gq >= b.GQ) continue;
    const size_t orow = out_row(a, b, gq);
    store_out<float>(a, b, orow, D, col * DC + my_d, acc[i], l_s[i]);
    if (col == 0 && my_d == 0) store_ml(a, b, orow, m_s[i], l_s[i]);
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

// One attention launch (grid x = query tiles x splits x nx column
// slices), its dynamic shared-memory limit raised once per kernel, then
// the split-S combine when there are splits.
template <typename T, typename Kern>
int launch_with(Kern kern, size_t smem, bool& smem_set, int nx, int threads, int D,
                const Args& a, cudaStream_t stream) {
  cudaError_t err = cudaSuccess;
  if (!smem_set) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  const dim3 grid((unsigned)(((a.H / a.KH) * a.Q + QM - 1) / QM * a.n_split * nx),
                  (unsigned)a.KH, (unsigned)a.R);
  kern<<<grid, threads, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.n_split == 1) return (int)err;
  const int rows = a.R * a.Q * a.H;
  combine_kernel<T><<<rows, D < DC ? D : DC, 2 * a.n_split * sizeof(float), stream>>>(
      a.part_o, a.part_ml, a.out, a.out_dt, rows, D, a.n_split);
  return (int)cudaGetLastError();
}

template <typename T, int D, bool APPEND>
int launch(const Args& a, cudaStream_t stream) {
  constexpr bool MMA = sizeof(T) == 2;  // bf16 / fp16 cache: tensor cores
  constexpr size_t smem = MMA ? mma_smem_bytes<D>() : simt_smem_bytes<D>();
  // if constexpr: a bf16/fp16 cache never instantiates the fp32 kernel's
  // twin, nor fp32 the tensor-core one
  auto kern = [] {
    if constexpr (MMA) return attend_mma_kernel<T, D, APPEND>;
    else return attend_simt_kernel<D, APPEND>;
  }();
  static bool smem_set = false;  // one attribute call per instantiation
  return launch_with<T>(kern, smem, smem_set, 1, MMA ? NT_MMA : NT_SIMT, D, a, stream);
}

// D a multiple of DC: one block per DC-column slice of O
template <typename T, bool APPEND>
int launch_wide(const Args& a, cudaStream_t stream) {
  constexpr bool MMA = sizeof(T) == 2;
  constexpr size_t smem = MMA ? wide_mma_smem_bytes() : simt_smem_bytes<DC>();
  auto kern = [] {
    if constexpr (MMA) return attend_mma_wide_kernel<T, APPEND>;
    else return attend_simt_wide_kernel<APPEND>;
  }();
  static bool smem_set = false;
  return launch_with<T>(kern, smem, smem_set, a.D / DC, MMA ? NT_MMA : NT_SIMT, a.D, a, stream);
}

// dtype codes: 0 fp32, 1 bf16, 2 fp16 (kernels/attention.py _KERNEL_DTYPES);
// one kernel per (cache dtype, head dim, append), out's dtype at run time
template <int D, bool APPEND>
int dispatch_cache(const Args& a, int cache_dt, cudaStream_t st) {
  if (cache_dt == 0) return launch<float, D, APPEND>(a, st);
  if (cache_dt == 1) return launch<bf16, D, APPEND>(a, st);
  if (cache_dt == 2) return launch<f16, D, APPEND>(a, st);
  return (int)cudaErrorInvalidValue;
}

template <bool APPEND>
int dispatch_wide(const Args& a, int cache_dt, cudaStream_t st) {
  if (cache_dt == 0) return launch_wide<float, APPEND>(a, st);
  if (cache_dt == 1) return launch_wide<bf16, APPEND>(a, st);
  if (cache_dt == 2) return launch_wide<f16, APPEND>(a, st);
  return (int)cudaErrorInvalidValue;
}

template <bool APPEND>
int dispatch(const Args& a, int D, int cache_dt, cudaStream_t st) {
  if (a.out_dt < 0 || a.out_dt > 2) return (int)cudaErrorInvalidValue;
  if (D == 64) return dispatch_cache<64, APPEND>(a, cache_dt, st);
  if (D == 128) return dispatch_cache<128, APPEND>(a, cache_dt, st);
  if (D >= DC && D % DC == 0) return dispatch_wide<APPEND>(a, cache_dt, st);
  return (int)cudaErrorInvalidValue;
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
  a.scale = scale; a.causal = causal; a.out_dt = out_dt;
  return a;
}

bool plan_ok(int S, int n_split, int tps, const float* part_o, const float* part_ml) {
  if (n_split < 1 || tps < 1 || (long long)n_split * tps * BS < S) return false;
  return n_split == 1 || (part_o && part_ml);
}

}  // namespace

// Both entries take the same arguments (K1 ignores k_new/v_new/appos) and
// return cudaGetLastError() after the launch(es): 0 on success. The S
// range is cut into n_split splits of tps 64-position tiles; with
// n_split > 1, part_o [n_split, R, Q, H, D] and part_ml [n_split, R, Q,
// H, 2] (fp32) hold the partials and a combine kernel follows. D is 64,
// 128 or a multiple of 256; cache_dt and out_dt are dtype codes (0
// fp32, 1 bf16, 2 fp16).
extern "C" int ff_flash_attend(const void* q, void* k, void* v, const int* lengths,
                               const int* qpos, const float* bias, const float* alibi,
                               const void* k_new, const void* v_new, const int* appos,
                               void* out, float* part_o, float* part_ml, int R, int Q,
                               int H, int KH, int S, int D, int n_split, int tps,
                               float scale, int causal, int cache_dt, int out_dt,
                               void* stream) {
  if (!plan_ok(S, n_split, tps, part_o, part_ml)) return (int)cudaErrorInvalidValue;
  const Args a = make_args(q, k, v, lengths, qpos, bias, alibi, nullptr, nullptr, nullptr,
                           out, part_o, part_ml, R, Q, H, KH, S, D, n_split, tps, scale,
                           causal, out_dt);
  return dispatch<false>(a, D, cache_dt, (cudaStream_t)stream);
}

extern "C" int ff_flash_attend_append(const void* q, void* k, void* v,
                                      const int* lengths, const int* qpos,
                                      const float* bias, const float* alibi,
                                      const void* k_new, const void* v_new,
                                      const int* appos, void* out, float* part_o,
                                      float* part_ml, int R, int Q, int H, int KH, int S,
                                      int D, int n_split, int tps, float scale, int causal,
                                      int cache_dt, int out_dt, void* stream) {
  if (!k_new || !v_new || !appos || !plan_ok(S, n_split, tps, part_o, part_ml))
    return (int)cudaErrorInvalidValue;
  const Args a = make_args(q, k, v, lengths, qpos, bias, alibi, k_new, v_new, appos, out,
                           part_o, part_ml, R, Q, H, KH, S, D, n_split, tps, scale, causal,
                           out_dt);
  return dispatch<true>(a, D, cache_dt, (cudaStream_t)stream);
}
