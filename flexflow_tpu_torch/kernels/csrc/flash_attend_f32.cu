// KV-cache serving attention for Hopper (sm_90a): the fp32-cache forms of
// K1 (ff_flash_attend) and K2 (ff_flash_attend_append), which replace the
// Pallas TPU kernels of flexflow_tpu/kernels/attention.py (_kernel /
// _stream_attend, pallas_call at :483; _append_kernel, :514) for an fp32
// KV cache, with the semantics of its reference_attend. csrc/flash_attend.cu
// holds the bf16 / fp16 forms; csrc/flash_attend.cuh what both share.

#include "flash_attend.cuh"

namespace {

// ---------------------------------------------------------------------
// fp32 cache: register-blocked FFMA over a cp.async ring
// ---------------------------------------------------------------------
// Products stay exact fp32 FFMA: TF32 tensor cores would lose the 2e-5
// parity. What bounds each form on this card: a decode tile (G*Q <= 16
// real rows) does ~8 flops per cache byte, below fp32's ~20 flop/byte
// line (67 TFLOP/s over 3.35 TB/s), so it is bound by the bytes of the
// valid prefix, and at short caches by the latency of its first units;
// a prefill or verify tile of 64 rows does ~32, so it is bound by FFMA
// issue. The design:
//  * the query tile is sized to the real rows: QM = 8, 16 or 32 rows here
//    (2 or 4 warps; 8 or 16 in the wide kernel), 64 in the tile kernel
//    below, the least that holds G*Q, chosen on the host (attention.py
//    f32_tile_plan): a decode of 8 real rows computes 8, not 64;
//  * K and V arrive as units of KU = 32 cache positions (half a softmax
//    tile) by 16-byte cp.async into a ring of NST units (4; 2 in the wide
//    kernel), zero-filled past len without reading. q is staged once,
//    with the first unit, so the first tiles are requested before q. One
//    barrier a unit: it frees the slot the next request overwrites;
//  * a warp's lanes are 4 row groups x 8 key groups. A thread scores RT
//    rows x 8 keys (keys 8j + lane % 8 of the tile), q and K read as
//    float4 from padded rows (conflict-free; q by broadcast), then
//    accumulates RT rows x DC/8 columns of P.V (columns 32c + 4 (lane % 8)
//    + e), the p of each key taken by shuffle from the lane that scored it:
//    P never touches shared memory. A thread does 16 RT FFMA per 4 + RT
//    float4 reads in Q.K and 4 RT per DC/32 in P.V;
//  * the online softmax runs in registers, a row's max and sum over its 8
//    key lanes by xor shuffles;
//  * at D = 128 a block holds 70-83 KiB, so two share an SM, as
//    split_plan assumes.
// The wide kernel (D = 256 n): a block owns one DC = 256-column slice of O;
// its scores sum the D / DC chunks of q (staged whole, once) and K in
// order, and its V units are its slice. q takes QM (D + 4) floats, so its
// tiles are 8 or 16 rows: 97 KiB a block at D = 512 and QM = 16.
// Every row's arithmetic depends on that row only and runs in a fixed
// order: its dot over d ascending (explicit fmaf chains), the 64-position
// softmax partition, P.V over keys ascending, explicitly rounded steps
// that no contraction changes. Widths 1 and 8 and K1 give bitwise equal
// rows whatever QM, as the 16-bit kernels do.

constexpr int KU = 32;  // cache positions a staged fp32 unit: half an S-tile

__host__ __device__ constexpr int f32_stages(bool wide) { return wide ? 2 : 4; }

// q [QM][D + 4] and the ring [NST][KU][DCOL + 4], fp32: the padded rows
// keep the float4 reads conflict-free (attention.py f32_tile_plan counts
// the same bytes)
__host__ __device__ constexpr size_t f32_smem_bytes(int qm, int D, int dcol, int nst) {
  return sizeof(float) * ((size_t)qm * (D + 4) + (size_t)nst * KU * (dcol + 4));
}

// score() in explicitly rounded steps: the same bits in every
// instantiation, and the reference's order (scale, ALiBi, bias)
__device__ __forceinline__ float score_f32(const Args& a, const Block& b, float dot,
                                           bool row_ok, int qp, float slope,
                                           const float* brow, int pos) {
  if (!row_ok || pos >= b.len || (a.causal && pos > qp)) return NEG_INF;
  float s = __fmul_rn(dot, a.scale);
  if (a.alibi) s = __fsub_rn(s, __fmul_rn(slope, (float)(qp - pos)));
  if (brow) s = __fadd_rn(s, brow[pos]);
  return s;
}

// four consecutive elements of an output of dtype code dt, one store
__device__ __forceinline__ void put_out4(void* out, size_t i, int dt, const float* x) {
  if (dt == 0) {
    *reinterpret_cast<float4*>(static_cast<float*>(out) + i) = make_float4(x[0], x[1], x[2], x[3]);
  } else if (dt == 1) {
    *reinterpret_cast<uint2*>(static_cast<bf16*>(out) + i) =
        make_uint2(pack2<bf16>(x[0], x[1]), pack2<bf16>(x[2], x[3]));
  } else {
    *reinterpret_cast<uint2*>(static_cast<f16*>(out) + i) =
        make_uint2(pack2<f16>(x[0], x[1]), pack2<f16>(x[2], x[3]));
  }
}

// DCOL: the columns of a staged unit and of O a block owns (D at 64 and
// 128; DC in the wide kernel, where D is a.D); NW warps of RT rows a
// thread: QM = NW * 4 * RT query rows a block.
template <int DCOL, int NW, int RT, bool WIDE, bool APPEND>
__global__ void __launch_bounds__(NW * 32, 2) attend_f32_kernel(const Args a) {
  constexpr int NT = NW * 32;
  constexpr int QMB = NW * 4 * RT;         // query rows a block
  constexpr int NST = f32_stages(WIDE);    // ring depth, in units
  constexpr int RSTR = DCOL + 4;           // ring row stride (floats)
  constexpr int SLOT = KU * RSTR;
  constexpr int NCG = DCOL / 32;           // a thread's float4 column groups of O
  constexpr unsigned FULL = 0xffffffffu;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int D = WIDE ? a.D : DCOL;
  const int nch = WIDE ? D / DCOL : 1;     // K chunks a score sums over
  const int col = WIDE ? (int)blockIdx.x % nch : 0;  // O's column slice
  const Block b = block_setup<APPEND>(a, WIDE ? (int)blockIdx.x / nch : (int)blockIdx.x, QMB);
  const int QSTR = D + 4;
  float* q_s = reinterpret_cast<float*>(smem_raw);   // [QMB][QSTR]
  float* ring = q_s + QMB * QSTR;                     // [NST][KU][RSTR]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rg = lane >> 3, kg = lane & 7;
  const size_t head = ((size_t)b.r * a.KH + b.kh) * (size_t)a.S * D;
  const float* kc = reinterpret_cast<const float*>(a.k) + head;
  const float* vc = reinterpret_cast<const float*>(a.v) + head;
  const size_t nsrc = ((size_t)b.r * a.KH + b.kh) * D;
  const float* kn = APPEND ? reinterpret_cast<const float*>(a.k_new) + nsrc : nullptr;
  const float* vn = APPEND ? reinterpret_cast<const float*>(a.v_new) + nsrc : nullptr;
  const float* qg = reinterpret_cast<const float*>(a.q);

  // unit u of the stream: tile u / upt; its parts 0 .. 2 nch - 1 are K
  // (half h, chunk c), then the two V halves of O's column slice
  const int upt = 2 * nch + 2;
  const int ntiles = max(b.t1 - b.t0, 0);
  const int nun = ntiles * upt;
  auto load_unit = [&](int u) {
    const int t = b.t0 + u / upt, p = u % upt;
    const bool isk = p < 2 * nch;
    const int h = isk ? p / nch : p - 2 * nch;
    const int c0 = (isk ? p % nch : col) * DCOL;
    const float* src = isk ? kc : vc;
    const float* fresh = isk ? kn : vn;
    float* dst = ring + (u % NST) * SLOT;
    constexpr int CPR = DCOL / 4;          // 16-byte chunks a row
    for (int e = tid; e < KU * CPR; e += NT) {
      const int row = e / CPR, ch = e % CPR, pos = t * BS + h * KU + row;
      const float* from = src;
      int bytes = 16;
      if (pos == b.app) from = fresh + c0 + ch * 4;
      else if (pos < b.len) from = src + (size_t)pos * D + c0 + ch * 4;
      else bytes = 0;  // past the valid prefix: zeros, nothing read
      cp_async16(dst + row * RSTR + ch * 4, from, bytes);
    }
  };
  // the first unit, then q (rows past G*Q zeros), then the ring's lead
  if (nun > 0) {
    load_unit(0);
    const int cpr = D / 4;
    for (int e = tid; e < QMB * cpr; e += NT) {
      const int row = e / cpr, ch = e % cpr, gq = b.q0 + row;
      const bool ok = gq < b.GQ;
      cp_async16(q_s + row * QSTR + ch * 4, ok ? qg + out_row(a, b, gq) * D + ch * 4 : qg,
                 ok ? 16 : 0);
    }
  }
  cp_async_commit();
#pragma unroll
  for (int i = 1; i < NST - 1; ++i) {
    if (i < nun) load_unit(i);
    cp_async_commit();
  }

  // this thread's rows: 4 i + rg of its warp's 4 RT
  int lr[RT], qp[RT];
  bool rok[RT];
  float slope[RT];
  const float* brow[RT];
  size_t orow[RT];
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    lr[i] = warp * 4 * RT + 4 * i + rg;
    const int gq = b.q0 + lr[i];
    rok[i] = gq < b.GQ;
    const int gqc = rok[i] ? gq : 0;
    const int g = gqc / a.Q, qi = gqc % a.Q;
    qp[i] = a.qpos[b.r * a.Q + qi];
    slope[i] = a.alibi ? a.alibi[b.kh * b.G + g] : 0.f;
    brow[i] = a.bias ? a.bias + ((size_t)b.r * a.Q + qi) * a.S : nullptr;
    orow[i] = out_row(a, b, gqc);
  }
  float acc[RT][4 * NCG];
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int e = 0; e < 4 * NCG; ++e) acc[i][e] = 0.f;
  float m[RT], l[RT];
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
  }

  // wait for unit u, then (every thread past unit u - 1) request unit
  // u + NST - 1 into the slot u - 1 used; returns unit u's slot
  int u = 0;
  auto next_unit = [&]() -> const float* {
    cp_async_wait<NST - 2>();
    __syncthreads();
    if (u + NST - 1 < nun) load_unit(u + NST - 1);
    cp_async_commit();
    return ring + (u++ % NST) * SLOT;
  };

  for (int t = 0; t < ntiles; ++t) {
    const int s0 = (b.t0 + t) * BS;
    // S = q . k^T: s[i][j] is row i against key 8 j + kg of the tile
    float s[RT][8];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      for (int c = 0; c < nch; ++c) {
        const float* ks = next_unit();
        const float* qb = q_s + c * DCOL;
#pragma unroll 4
        for (int d = 0; d < DCOL; d += 4) {
          float4 qv[RT], kv[4];
#pragma unroll
          for (int i = 0; i < RT; ++i)
            qv[i] = *reinterpret_cast<const float4*>(qb + lr[i] * QSTR + d);
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
            kv[jj] = *reinterpret_cast<const float4*>(ks + (8 * jj + kg) * RSTR + d);
#pragma unroll
          for (int i = 0; i < RT; ++i)
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
              float& x = s[i][4 * h + jj];
              x = __fmaf_rn(qv[i].x, kv[jj].x, x);
              x = __fmaf_rn(qv[i].y, kv[jj].y, x);
              x = __fmaf_rn(qv[i].z, kv[jj].z, x);
              x = __fmaf_rn(qv[i].w, kv[jj].w, x);
            }
        }
      }
    }
    // the tile's online softmax, in registers
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      // every key of the tile visible to this row and nothing added: the
      // scaled product score_f32 returns, without its tests
      const bool plain = rok[i] && s0 + BS <= b.len && (!a.causal || s0 + BS - 1 <= qp[i]) &&
                         !a.alibi && !a.bias;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        s[i][j] = plain ? __fmul_rn(s[i][j], a.scale)
                        : score_f32(a, b, s[i][j], rok[i], qp[i], slope[i], brow[i],
                                    s0 + 8 * j + kg);
      float mx = s[i][0];
#pragma unroll
      for (int j = 1; j < 8; ++j) mx = fmaxf(mx, s[i][j]);
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[i][j] = expf(__fsub_rn(s[i][j], m_new));
        sum = __fadd_rn(sum, s[i][j]);
      }
      sum = __fadd_rn(sum, __shfl_xor_sync(FULL, sum, 1));
      sum = __fadd_rn(sum, __shfl_xor_sync(FULL, sum, 2));
      sum = __fadd_rn(sum, __shfl_xor_sync(FULL, sum, 4));
      const float corr = expf(__fsub_rn(m[i], m_new));
      l[i] = __fmaf_rn(l[i], corr, sum);
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < 4 * NCG; ++e) acc[i][e] = __fmul_rn(acc[i][e], corr);
    }
    // O += P . V over the tile's keys in order
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float* vs = next_unit();
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          float p[RT];
#pragma unroll
          for (int i = 0; i < RT; ++i) p[i] = __shfl_sync(FULL, s[i][4 * h + jj], (lane & 24) | kk);
          const float* vrow = vs + (8 * jj + kk) * RSTR + 4 * kg;
#pragma unroll
          for (int cg = 0; cg < NCG; ++cg) {
            const float4 v = *reinterpret_cast<const float4*>(vrow + 32 * cg);
#pragma unroll
            for (int i = 0; i < RT; ++i) {
              acc[i][4 * cg + 0] = __fmaf_rn(p[i], v.x, acc[i][4 * cg + 0]);
              acc[i][4 * cg + 1] = __fmaf_rn(p[i], v.y, acc[i][4 * cg + 1]);
              acc[i][4 * cg + 2] = __fmaf_rn(p[i], v.z, acc[i][4 * cg + 2]);
              acc[i][4 * cg + 3] = __fmaf_rn(p[i], v.w, acc[i][4 * cg + 3]);
            }
          }
        }
    }
  }
  cp_async_wait<0>();  // only empty groups can remain

  // finished rows: normalised and rounded like the reference (to the
  // output type) when there is one split and an output, else the split's
  // unnormalised fp32 partial and, with column slice 0, its (m, l)
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    if (!rok[i]) continue;
    const size_t c0 = orow[i] * D + (size_t)col * DCOL + 4 * kg;
    if (!a.partial) {
      const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int cg = 0; cg < NCG; ++cg) {
        float x[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) x[e] = __fdiv_rn(acc[i][4 * cg + e], den);
        put_out4(a.out, c0 + 32 * cg, a.out_dt, x);
      }
    } else {
      float* po = a.part_o + (size_t)b.split * a.R * a.Q * a.H * D + c0;
#pragma unroll
      for (int cg = 0; cg < NCG; ++cg)
        *reinterpret_cast<float4*>(po + 32 * cg) =
            make_float4(acc[i][4 * cg], acc[i][4 * cg + 1], acc[i][4 * cg + 2], acc[i][4 * cg + 3]);
      if (col == 0 && kg == 0) store_ml(a, b, orow[i], m[i], l[i]);
    }
  }
  // after the rows are out (no block reads the appended row)
  if (APPEND && col == 0) append_store<float>(a, b, D);
}

// The 64-row query tile at D = 64 and 128 (prefill chunks, wide verify),
// the one that FFMA issue bounds. In the kernel above, Q.K's 16 RT FFMA
// per 4 + RT float4 reads and P.V's shuffle a row a key keep shared
// memory and the shuffle unit as busy as the FFMA pipes. Here each phase
// has its own thread tile:
//  * Q.K: a thread scores 8 rows x 4 keys (rows r + 8i, keys k + 16j of
//    the tile, over both K units of the tile at once): 128 FFMA per 12
//    float4 reads; the dots go to a [key][row] tile P in shared memory;
//  * softmax: two threads a row, 32 keys each, in place in P;
//  * P.V: a thread accumulates 8 rows x 8 columns, reading 2 float4 of P
//    and 2 of V per key: 64 FFMA per 4 float4 reads.
// q, the ring and P are XOR-swizzled by 16-byte chunk (no padding), so
// every float4 read is conflict-free and a block holds 112.5 KiB at
// D = 128: two share an SM. Each row's arithmetic is the kernel above's
// step for step (its dot chain, score_f32, the sum over the 8 key lanes
// in the same tree, P.V over keys in order), so a row's bits do not
// depend on which query tile served it.

// element of chunk c (4 floats) of row r in a [rows][w] fp32 tile whose
// chunks are XOR-swizzled by the row's low 3 bits
__device__ __forceinline__ int swz4(int r, int c, int w) { return r * w + ((c ^ (r & 7)) << 2); }
// P [BS keys][64 rows]: element (key, row)
__device__ __forceinline__ int pidx(int key, int row) {
  return key * 64 + (((row >> 2) ^ (key & 7)) << 2) + (row & 3);
}

__host__ __device__ constexpr size_t f32_tile_smem_bytes(int D) {
  // q [64][D], the ring [4][KU][D], P [BS][64], corr and l [64]
  return sizeof(float) * ((size_t)64 * D + (size_t)4 * KU * D + (size_t)BS * 64 + 2 * 64);
}

template <int D, bool APPEND>
__global__ void __launch_bounds__(128, 2) attend_f32_tile_kernel(const Args a) {
  constexpr int NT = 128, QMB = 64, NST = 4, CPR = D / 4;
  constexpr int NCG = D / 64;  // a P.V thread's float4 column groups
  constexpr unsigned FULL = 0xffffffffu;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* q_s = reinterpret_cast<float*>(smem_raw);  // [64][D]
  float* ring = q_s + QMB * D;                      // [NST][KU][D]
  float* pt = ring + NST * KU * D;                  // [BS][64]
  float* corr_s = pt + BS * QMB;                    // [64]
  float* l_s = corr_s + QMB;                        // [64]
  const Block b = block_setup<APPEND>(a, blockIdx.x, QMB);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t head = ((size_t)b.r * a.KH + b.kh) * (size_t)a.S * D;
  const float* kc = reinterpret_cast<const float*>(a.k) + head;
  const float* vc = reinterpret_cast<const float*>(a.v) + head;
  const size_t nsrc = ((size_t)b.r * a.KH + b.kh) * D;
  const float* kn = APPEND ? reinterpret_cast<const float*>(a.k_new) + nsrc : nullptr;
  const float* vn = APPEND ? reinterpret_cast<const float*>(a.v_new) + nsrc : nullptr;
  const float* qg = reinterpret_cast<const float*>(a.q);

  // unit u: tile u / 4, part u % 4 = K half 0, K half 1, V half 0, V half 1
  const int ntiles = max(b.t1 - b.t0, 0);
  const int nun = ntiles * 4;
  auto request = [&](int u) {  // one commit group per unit, empty past the stream
    if (u < nun) {
      const int t = b.t0 + u / 4, p = u % 4;
      const float* src = p < 2 ? kc : vc;
      const float* fresh = p < 2 ? kn : vn;
      float* dst = ring + (u % NST) * KU * D;
      for (int e = tid; e < KU * CPR; e += NT) {
        const int row = e / CPR, ch = e % CPR, pos = t * BS + (p & 1) * KU + row;
        const float* from = src;
        int bytes = 16;
        if (pos == b.app) from = fresh + ch * 4;
        else if (pos < b.len) from = src + (size_t)pos * D + ch * 4;
        else bytes = 0;  // past the valid prefix: zeros, nothing read
        cp_async16(dst + swz4(row, ch, D), from, bytes);
      }
      if (u == 0) {  // q with the first unit (rows past G*Q zeros)
        for (int e = tid; e < QMB * CPR; e += NT) {
          const int row = e / CPR, ch = e % CPR, gq = b.q0 + row;
          const bool ok = gq < b.GQ;
          cp_async16(q_s + swz4(row, ch, D), ok ? qg + out_row(a, b, gq) * D + ch * 4 : qg,
                     ok ? 16 : 0);
        }
      }
    }
    cp_async_commit();
  };
  request(0);
  request(1);
  request(2);

  // softmax role: row sr, key lanes 4 sh .. 4 sh + 3 of the tile's 8
  const int sr = tid >> 1, sh = tid & 1;
  const int sgq = b.q0 + sr;
  const bool srok = sgq < b.GQ;
  const int sgqc = srok ? sgq : 0;
  const int sqp = a.qpos[b.r * a.Q + sgqc % a.Q];
  const float sslope = a.alibi ? a.alibi[b.kh * b.G + sgqc / a.Q] : 0.f;
  const float* sbrow = a.bias ? a.bias + ((size_t)b.r * a.Q + sgqc % a.Q) * a.S : nullptr;
  float m = NEG_INF, l = 0.f;
  // Q.K role: rows qr + 8 i, keys qk + 16 j
  const int qr = (lane >> 3) + 4 * (warp & 1), qk = (lane & 7) + 8 * (warp >> 1);
  // P.V role: rows 8 vr .. 8 vr + 7, columns 4 vc4 + 32 (NCG vh + c) + e
  const int vc4 = lane & 7, vr = (lane >> 3) + 4 * (warp >> 1), vh = warp & 1;
  float acc[8][4 * NCG];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int e = 0; e < 4 * NCG; ++e) acc[r][e] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    const int s0 = (b.t0 + t) * BS;
    const int u = 4 * t;
    // --- Q.K over both K units of the tile (slots 0 and 1: u % NST == 0) ---
    cp_async_wait<1>();
    __syncthreads();
    request(u + 3);
    {
      float s[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
      // rows qr + 8 i share their swizzle (qr & 7), keys qk + 16 j theirs
      // (qk & 7): chunk 8 c8 + cc of a row sits at 8 c8 + (cc ^ x)
      const float* qb = q_s + qr * D;
      const float* kb = ring + qk * D;
      for (int c8 = 0; c8 < CPR / 8; ++c8) {
#pragma unroll
        for (int cc = 0; cc < 8; ++cc) {
          const float* qp_ = qb + 32 * c8 + ((cc ^ (qr & 7)) << 2);
          const float* kp_ = kb + 32 * c8 + ((cc ^ (qk & 7)) << 2);
          float4 qv[8], kv[4];
#pragma unroll
          for (int i = 0; i < 8; ++i) qv[i] = *reinterpret_cast<const float4*>(qp_ + 8 * i * D);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            kv[j] = *reinterpret_cast<const float4*>(kp_ + (j & 1) * 16 * D + (j >> 1) * KU * D);
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              float& x = s[i][j];
              x = __fmaf_rn(qv[i].x, kv[j].x, x);
              x = __fmaf_rn(qv[i].y, kv[j].y, x);
              x = __fmaf_rn(qv[i].z, kv[j].z, x);
              x = __fmaf_rn(qv[i].w, kv[j].w, x);
            }
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) pt[pidx(qk + 16 * j, qr + 8 * i)] = s[i][j];
    }
    __syncthreads();
    // --- softmax of row sr over its keys 8 j + 4 sh + kk, in place ---
    {
      float x[4][8];
      const bool plain = srok && s0 + BS <= b.len && (!a.causal || s0 + BS - 1 <= sqp) &&
                         !a.alibi && !a.bias;
      float mx = NEG_INF;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int key = 8 * j + 4 * sh + kk;
          const float d = pt[pidx(key, sr)];
          x[kk][j] = plain ? __fmul_rn(d, a.scale)
                           : score_f32(a, b, d, srok, sqp, sslope, sbrow, s0 + key);
          mx = fmaxf(mx, x[kk][j]);
        }
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
      const float m_new = fmaxf(m, mx);
      float part[4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        part[kk] = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float p = expf(__fsub_rn(x[kk][j], m_new));
          pt[pidx(8 * j + 4 * sh + kk, sr)] = p;
          part[kk] = __fadd_rn(part[kk], p);
        }
      }
      // the kernel above's butterfly over key lanes 0..7, as a tree
      const float half = __fadd_rn(__fadd_rn(part[0], part[1]), __fadd_rn(part[2], part[3]));
      const float sum = __fadd_rn(half, __shfl_xor_sync(FULL, half, 1));
      const float corr = expf(__fsub_rn(m, m_new));
      l = __fmaf_rn(l, corr, sum);
      m = m_new;
      if (sh == 0) corr_s[sr] = corr;
    }
    // --- O += P . V over the tile's keys in order ---
#pragma unroll
    for (int hv = 0; hv < 2; ++hv) {
      if (hv == 0) cp_async_wait<1>();
      else cp_async_wait<2>();
      __syncthreads();
      request(u + 4 + 2 * hv);
      if (hv == 0) request(u + 5);
      if (hv == 0) {
        const float4 c0 = *reinterpret_cast<const float4*>(corr_s + 8 * vr);
        const float4 c1 = *reinterpret_cast<const float4*>(corr_s + 8 * vr + 4);
        const float cr[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int e = 0; e < 4 * NCG; ++e) acc[r][e] = __fmul_rn(acc[r][e], cr[r]);
      }
      // V unit hv in slot 2 + hv; key 32 hv + 8 k8 + m has swizzle m
      const float* vs = ring + (2 + hv) * KU * D + 32 * NCG * vh;
      const float* pb = pt + (KU * hv) * 64;
      for (int k8 = 0; k8 < KU / 8; ++k8) {
#pragma unroll
        for (int mm = 0; mm < 8; ++mm) {
          const int kk = 8 * k8 + mm;
          const int po = (((2 * vr) ^ mm) << 2);
          const float4 p0 = *reinterpret_cast<const float4*>(pb + kk * 64 + po);
          const float4 p1 = *reinterpret_cast<const float4*>(pb + kk * 64 + (po ^ 4));
          const float p[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
          const float* vrow = vs + kk * D + ((vc4 ^ mm) << 2);
#pragma unroll
          for (int c = 0; c < NCG; ++c) {
            const float4 v = *reinterpret_cast<const float4*>(vrow + 32 * c);
#pragma unroll
            for (int r = 0; r < 8; ++r) {
              acc[r][4 * c + 0] = __fmaf_rn(p[r], v.x, acc[r][4 * c + 0]);
              acc[r][4 * c + 1] = __fmaf_rn(p[r], v.y, acc[r][4 * c + 1]);
              acc[r][4 * c + 2] = __fmaf_rn(p[r], v.z, acc[r][4 * c + 2]);
              acc[r][4 * c + 3] = __fmaf_rn(p[r], v.w, acc[r][4 * c + 3]);
            }
          }
        }
      }
    }
  }
  cp_async_wait<0>();  // only empty groups can remain
  if (sh == 0) {
    l_s[sr] = l;
    if (a.partial && srok) store_ml(a, b, out_row(a, b, sgq), m, l);
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int gq = b.q0 + 8 * vr + r;
    if (gq >= b.GQ) continue;
    const size_t c0 = out_row(a, b, gq) * D + 4 * vc4;
    if (!a.partial) {
      const float den = fmaxf(l_s[8 * vr + r], 1e-30f);
#pragma unroll
      for (int c = 0; c < NCG; ++c) {
        float x[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) x[e] = __fdiv_rn(acc[r][4 * c + e], den);
        put_out4(a.out, c0 + 32 * (NCG * vh + c), a.out_dt, x);
      }
    } else {
      float* po = a.part_o + (size_t)b.split * a.R * a.Q * a.H * D + c0;
#pragma unroll
      for (int c = 0; c < NCG; ++c)
        *reinterpret_cast<float4*>(po + 32 * (NCG * vh + c)) =
            make_float4(acc[r][4 * c], acc[r][4 * c + 1], acc[r][4 * c + 2], acc[r][4 * c + 3]);
    }
  }
  if (APPEND) append_store<float>(a, b, D);
}

// ---------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------

// the fp32 kernel of one plan: NW warps of RT rows a thread
template <int DCOL, int NW, int RT, bool WIDE, bool APPEND>
int launch_f32(const Args& a, cudaStream_t stream) {
  static size_t smem_set = 0;  // the attribute, per instantiation
  const int D = WIDE ? a.D : DCOL;
  return launch_with<float>(attend_f32_kernel<DCOL, NW, RT, WIDE, APPEND>,
                            f32_smem_bytes(NW * 4 * RT, D, DCOL, f32_stages(WIDE)), smem_set,
                            NW * 4 * RT, D / DCOL, NW * 32, D, a, stream);
}

// one kernel per (head dim, append, query tile), out's dtype at run time;
// qm is the host's query tile (kernels/attention.py f32_tile_plan)
template <int D, bool APPEND>
int launch_dim(const Args& a, int qm, cudaStream_t stream) {
  if (qm == 8) return launch_f32<D, 2, 1, false, APPEND>(a, stream);
  if (qm == 16) return launch_f32<D, 4, 1, false, APPEND>(a, stream);
  if (qm == 32) return launch_f32<D, 4, 2, false, APPEND>(a, stream);
  if (qm == 64) {
    static size_t smem_set = 0;
    return launch_with<float>(attend_f32_tile_kernel<D, APPEND>, f32_tile_smem_bytes(D), smem_set,
                              64, 1, 128, D, a, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// dtype code 0, fp32 (kernels/attention.py _KERNEL_DTYPES)
template <bool APPEND>
int dispatch(const Args& a, int D, int cache_dt, int qm, cudaStream_t st) {
  if (a.out_dt < 0 || a.out_dt > 2 || cache_dt != 0) return (int)cudaErrorInvalidValue;
  if (D == 64) return launch_dim<64, APPEND>(a, qm, st);
  if (D == 128) return launch_dim<128, APPEND>(a, qm, st);
  if (D >= DC && D % DC == 0) {
    // D a multiple of DC: one block per DC-column slice of O
    if (qm == 8) return launch_f32<DC, 2, 1, true, APPEND>(a, st);
    if (qm == 16) return launch_f32<DC, 4, 1, true, APPEND>(a, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace
