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
//    products run on the tensor cores. With an fp32 cache the products
//    stay on FFMA (67 TFLOP/s), where a 64-row tile is above fp32's ~20
//    flop/byte line: operations bound it (see the fp32 section).
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
//  * partials out (out == null): every split, one split included, writes
//    its partial and no combine runs; the caller reconciles them. A
//    sequence-parallel rank does so across the ranks that hold the other
//    cache rows (ops/inc_attention.py _seq_attend): its cache is rows
//    off .. off + S - 1 of the sequence and it passes lengths, qpos and
//    appos less off, which masks, cuts and applies ALiBi as on the whole;
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
// here; 256 and its multiples are served by the wide kernel: a cluster of
// one block per 256-column slice of O, which computes the scores once and
// sums the ranks' partial S tiles through distributed shared memory, q
// staged once, two blocks an SM and a plan of its own (see its section).
// Other head dims are served by a cache padded to the next of these
// (ops/inc_attention.py cache_head_dim; 320 -> 512).
// The fp32 cache type keeps exact FFMA products (TF32 tensor cores would
// lose the 2e-5 parity): register-blocked kernels over a cp.async ring of
// half tiles, their query tile sized to G*Q by the host, with the same
// grid, split plan, causal cut, append and row invariance, in
// csrc/flash_attend_f32.cu. Both sources share csrc/flash_attend.cuh.

#include "flash_attend.cuh"

namespace {

// ---------------------------------------------------------------------
// bf16 / fp16 cache: tensor cores (mma.sync.m16n8k16), cp.async ring
// ---------------------------------------------------------------------

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
// the combine when `normalise` (RCP: by one reciprocal a row, not a
// division an element: the wide kernel's D / 4 elements a thread). The
// accumulators are dead once staged, so the branch on dt costs the main
// loop no registers.
template <typename T, int D, bool RCP, typename Dst>
__device__ __forceinline__ void warp_store(float* st, const float (&o)[D / 8][4], const float* l,
                                           bool normalise, int lane, int rows, int dt,
                                           Dst dst) {
  constexpr int LD = D + 4;
  const int gid = lane >> 2, tig = lane & 3;
  const float inv[2] = {1.f / fmaxf(l[0], 1e-30f), 1.f / fmaxf(l[1], 1e-30f)};
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float x = o[n][2 * i + e];
        if (normalise) x = round_to<T>(RCP ? x * inv[i] : x / fmaxf(l[i], 1e-30f));
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
template <typename T, int DW, bool RCP = false>
__device__ __forceinline__ void mma_epilogue(const Args& a, const Block& b,
                                             unsigned char* smem_raw, int warp, int lane,
                                             int wrow, const float (&o)[DW / 8][4],
                                             const float* m, const float* l, const bool* rok,
                                             const size_t* orow, int D, int c0) {
  const int nrows = min(16, b.GQ - wrow);
  float* st = reinterpret_cast<float*>(smem_raw) + warp * 16 * (DW + 4);
  if (!a.partial) {
    const size_t esize = a.out_dt == 0 ? 4 : 2;
    warp_store<T, DW, RCP>(st, o, l, true, lane, nrows, a.out_dt, [&](int row) {
      return static_cast<void*>(static_cast<char*>(a.out) +
                                (out_row(a, b, wrow + row) * D + c0) * esize);
    });
  } else {
    const size_t base = (size_t)b.split * a.R * a.Q * a.H;
    warp_store<T, DW, RCP>(st, o, l, false, lane, nrows, 0, [&](int row) {
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

  const Block b = block_setup<APPEND>(a, blockIdx.x, QM);
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
// head dims 256 and past (a multiple of DC = 256): the wide kernel
// ---------------------------------------------------------------------
// What bounds it: bytes, as at D <= 128 (every valid K/V row read once, q
// read and O written once; well below bf16's ~295 flop/byte), D / DC
// times more of them a stream. At the serving shapes (R 8, S 256, one
// valid tile a stream) a block streams one tile, so the launch is one
// round of memory latency a block plus its own instructions: what costs
// is a second wave of blocks, a chain of dependent copies, bytes or
// products done twice, and any long serial stretch of a block (a block's
// 64 x 256 output once took ~5 us to normalise by a division an element;
// one reciprocal a row now). Over a long cache it is the bytes in flight.
//
// The design: one thread-block cluster of cs blocks (ranks) a stream,
// query tile and split; block (cluster g, rank r) owns the DC-column slice
// c = g cs + r of O. Up to D = 2048 a stream has one cluster (cs = D / DC)
// and rank r owns score chunk r; past it ncl = ceil(nch / 8) clusters of
// cs = ceil(nch / ncl) ranks, rank r owning chunks r, r + cs, ... (each
// cluster computes the scores again; a block with c >= nch owns no slice).
//  * scores once a cluster: each rank multiplies q and K over its own
//    chunks, writes its partial 64 x 64 fp32 S tile to shared memory, and
//    after a cluster barrier every rank sums all ranks' partials through
//    distributed shared memory in rank order: every rank holds the same
//    bits, runs the same softmax and P . V over its own V slice. K is read
//    once, and the Q.K^T products are not repeated a slice;
//  * q resident: the rank's q chunks are staged once, beside its first K
//    unit, and read by ldmatrix at every tile;
//  * a ring of WSLOT [BS][DC] units (the rank's K chunks of a tile, then
//    its V slice): the next unit is in flight while one computes, and a
//    tile's K and V both leave before its first product;
//  * two blocks an SM (112 KiB of shared memory up to D = 2048), so the
//    other block's copies hide one's latency (rather than one block with a
//    producer warp feeding TMA and wgmma consumers: a block's 64 query rows
//    are 4 mma.sync warps, and at one tile a stream there is no stream of
//    tiles for a producer to run ahead on); the host's plan
//    (wide_split_plan in kernels/attention.py, a function of R, KH, S, D
//    and the SM count) counts the blocks this launch really makes and
//    splits S only as far as one wave holds;
//  * the partial buffer is reused at every tile: a rank writes it after
//    the cluster's "read" barrier of the tile before, whose wait it
//    overlaps with that tile's P . V and the next K unit.
// Slice 0 writes the split's (m, l) and K2's append, as every slice holds
// the same (m, l).

constexpr int WSLOT = 2;      // wide kernel: K/V units in flight
constexpr int WCLUSTER = 8;   // most blocks a cluster (the portable limit)

// The wide launch at head dim D: nch DC-column chunks, ncl clusters of cs
// ranks a (stream, query tile, split), at most kpr score chunks a rank.
struct WideShape {
  int nch, ncl, cs, kpr;
};
__host__ __device__ inline WideShape wide_shape(int D) {
  WideShape w;
  w.nch = D / DC;
  w.ncl = (w.nch + WCLUSTER - 1) / WCLUSTER;
  w.cs = (w.nch + w.ncl - 1) / w.ncl;
  w.kpr = (w.nch + w.cs - 1) / w.cs;
  return w;
}

constexpr size_t WUNIT = (size_t)BS * DC;         // elements of one [BS][DC] unit
constexpr size_t WXBUF = (size_t)QM * BS * 4;     // bytes of a partial S tile, fp32

// q chunks, the ring, and the partial S tile (clusters of 2 or more)
inline size_t wide_mma_smem_bytes(const WideShape& w) {
  return (w.kpr + WSLOT) * WUNIT * 2 + (w.cs > 1 ? WXBUF : 0);
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}
// 16 bytes at shared address `local` of cluster rank `rank`
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

template <typename T, bool APPEND>
__global__ void __launch_bounds__(NT_MMA, 2) attend_mma_wide_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  constexpr int CH = DC / 8;   // 16-byte chunks per staged row
  constexpr int KS = DC / 16;  // k-steps of one chunk's q.k
  constexpr int ND = DC / 8;   // n-tiles of p.v (the slice)
  const WideShape w = wide_shape(a.D);
  const int D = a.D, nblk = w.ncl * w.cs;
  const int rank = blockIdx.x % w.cs;
  const int col = blockIdx.x % nblk;                 // g cs + rank
  const bool slice = col < w.nch;
  const int kpr = (w.nch - rank + w.cs - 1) / w.cs;  // chunks rank, rank + cs, ...
  const Block b = block_setup<APPEND>(a, blockIdx.x / nblk, QM);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane >> 2;
  T* qs = reinterpret_cast<T*>(smem_raw);            // [kpr][QM][DC]
  T* ring = qs + w.kpr * WUNIT;                      // [WSLOT][BS][DC]
  float4* xbuf = reinterpret_cast<float4*>(ring + WSLOT * WUNIT);  // [4 warps][8][32]
  const size_t head = ((size_t)b.r * a.KH + b.kh) * (size_t)a.S * D;
  const T* kc = reinterpret_cast<const T*>(a.k) + head;
  const T* vc = reinterpret_cast<const T*>(a.v) + head;
  const size_t nsrc = ((size_t)b.r * a.KH + b.kh) * D;
  const T* kn = APPEND ? reinterpret_cast<const T*>(a.k_new) + nsrc : nullptr;
  const T* vn = APPEND ? reinterpret_cast<const T*>(a.v_new) + nsrc : nullptr;
  const T* qg = reinterpret_cast<const T*>(a.q);

  // unit u of the stream: tile u / upt; part p = u % upt is K chunk
  // rank + p cs for p < kpr, else the tile's V slice
  const int upt = kpr + (slice ? 1 : 0);
  auto load_unit = [&](int u, int st) {
    const int t = b.t0 + u / upt, p = u % upt;
    const bool isv = p == kpr;
    const int c0 = (isv ? col : rank + p * w.cs) * DC;
    const T* src = isv ? vc : kc;
    const T* fresh = isv ? vn : kn;
    T* dst = ring + st * WUNIT;
    for (int c = tid; c < BS * CH; c += NT_MMA) {
      const int row = c / CH, ch = c % CH, pos = t * BS + row;
      const T* s = src;
      int bytes = 16;
      if (pos == b.app) s = fresh + c0 + ch * 8;
      else if (pos < b.len) s = src + (size_t)pos * D + c0 + ch * 8;
      else bytes = 0;  // past the valid prefix: zeros, nothing read
      cp_async16(dst + swz<DC>(row, ch), s, bytes);
    }
  };
  const int ntiles = max(b.t1 - b.t0, 0), nunits = ntiles * upt;
  if (ntiles > 0) {
    // q, once: the rank's chunks of the tile's query rows (rows past G*Q
    // zero-filled), in the first unit's copy group
    for (int p = 0; p < kpr; ++p)
      for (int c = tid; c < QM * CH; c += NT_MMA) {
        const int row = c / CH, ch = c % CH, gq = b.q0 + row;
        const bool ok = gq < b.GQ;
        cp_async16(qs + p * WUNIT + swz<DC>(row, ch),
                   ok ? qg + out_row(a, b, gq) * D + (rank + p * w.cs) * DC + ch * 8 : qg,
                   ok ? 16 : 0);
      }
  }
#pragma unroll
  for (int i = 0; i < WSLOT - 1; ++i) {
    if (i < nunits) load_unit(i, i);
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
  // this thread's float4 of n-tile n in every rank's partial buffer
  const uint32_t xslot = smem_addr(xbuf + warp * 8 * 32 + lane);

  for (int u = 0; u < nunits; ++u) {
    if (u + WSLOT - 1 < nunits) load_unit(u + WSLOT - 1, (u + WSLOT - 1) % WSLOT);
    cp_async_commit();
    cp_async_wait<WSLOT - 1>();
    __syncthreads();
    const T* us = ring + (u % WSLOT) * WUNIT;
    const int t = u / upt, p = u % upt;
    if (p < kpr) {
      // S += q[:, chunk] . K[:, chunk]^T over the rank's chunks in order
      if (wactive) {
        if (p == 0) {
#pragma unroll
          for (int n = 0; n < 8; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
        }
        const T* qc = qs + p * WUNIT;
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          uint32_t qf[4];
          ldmatrix_x4(qf, qc + swz<DC>(warp * 16 + (lane & 15), ks * 2 + (lane >> 4)));
#pragma unroll
          for (int np = 0; np < 4; ++np) {
            uint32_t kb[4];
            const int key = np * 16 + (lane & 7) + ((lane >> 4) << 3);
            ldmatrix_x4(kb, us + swz<DC>(key, ks * 2 + ((lane >> 3) & 1)));
            mma16<T>(s[2 * np], qf, kb[0], kb[1]);
            mma16<T>(s[2 * np + 1], qf, kb[2], kb[3]);
          }
        }
      }
      if (p == kpr - 1 && w.cs > 1) {
        // the cluster's partials summed in rank order (every thread of
        // the block takes the barriers; a warp without rows in one rank
        // has none in any)
        if (t > 0) cluster_wait();  // every rank has read the last tile's
        if (wactive) {
#pragma unroll
          for (int n = 0; n < 8; ++n)
            xbuf[(warp * 8 + n) * 32 + lane] = make_float4(s[n][0], s[n][1], s[n][2], s[n][3]);
        }
        cluster_arrive();
        cluster_wait();
        if (wactive) {
#pragma unroll
          for (int n = 0; n < 8; ++n) {
            const float4 x = ld_cluster_f4(xslot + n * 32 * 16, 0);
            s[n][0] = x.x; s[n][1] = x.y; s[n][2] = x.z; s[n][3] = x.w;
          }
          for (int r = 1; r < w.cs; ++r)
#pragma unroll
            for (int n = 0; n < 8; ++n) {
              const float4 x = ld_cluster_f4(xslot + n * 32 * 16, r);
              s[n][0] += x.x; s[n][1] += x.y; s[n][2] += x.z; s[n][3] += x.w;
            }
        }
        cluster_arrive();  // this rank's reads of the tile are done
      }
    } else if (wactive) {
      tile_softmax_pv<T, DC>(a, b, s, o, m, l, rok, qp, slope, brow, (b.t0 + t) * BS, us, lane);
    }
    __syncthreads();  // the next unit refills this slot
  }

  // the rows go through the idle q and ring space, never the partial
  // buffer, which other ranks may still read
  if (wactive && slice)
    mma_epilogue<T, DC, true>(a, b, smem_raw, warp, lane, wrow, o, m, l, rok, orow, D, col * DC);
  if (APPEND && col == 0) append_store<T>(a, b, D);
  if (ntiles > 0 && w.cs > 1) cluster_wait();  // no rank reads this block's buffer now
}

// ---------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------

// dtype codes 1 bf16, 2 fp16 (kernels/attention.py _KERNEL_DTYPES; 0, fp32,
// is csrc/flash_attend_f32.cu's); one kernel per (cache dtype, head dim,
// append), out's dtype at run time
template <typename T, int D, bool APPEND>
int launch(const Args& a, cudaStream_t stream) {
  static size_t smem_set = 0;
  return launch_with<T>(attend_mma_kernel<T, D, APPEND>, mma_smem_bytes<D>(), smem_set, QM, 1,
                        NT_MMA, D, a, stream);
}

// D a multiple of DC: clusters of the DC-column slices of O
template <typename T, bool APPEND>
int launch_wide(const Args& a, cudaStream_t stream) {
  static size_t smem_set = 0;
  const WideShape w = wide_shape(a.D);
  return launch_with<T>(attend_mma_wide_kernel<T, APPEND>, wide_mma_smem_bytes(w), smem_set, QM,
                        w.ncl * w.cs, NT_MMA, a.D, a, stream, w.cs);
}

template <typename T, bool APPEND>
int launch_dim(const Args& a, int D, cudaStream_t st) {
  if (D == 64) return launch<T, 64, APPEND>(a, st);
  if (D == 128) return launch<T, 128, APPEND>(a, st);
  if (D >= DC && D % DC == 0) return launch_wide<T, APPEND>(a, st);
  return (int)cudaErrorInvalidValue;
}

template <bool APPEND>
int dispatch(const Args& a, int D, int cache_dt, int qm, cudaStream_t st) {
  if (a.out_dt < 0 || a.out_dt > 2 || qm != QM) return (int)cudaErrorInvalidValue;
  if (cache_dt == 1) return launch_dim<bf16, APPEND>(a, D, st);
  if (cache_dt == 2) return launch_dim<f16, APPEND>(a, D, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace
