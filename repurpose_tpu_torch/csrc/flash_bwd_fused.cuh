// The fused tensor-core attention backward for Hopper (sm_90a), bf16 at Dh
// 64, the bias form: flash_bwd_fused_tc_kernel (flash_bwd.cu), the long-T
// backward (T > 2048) of `flash_backward` and of the stream wrappers
// `flash_bwd_dq_stream` / `flash_bwd_dkv_stream`, then
// flash_bwd_fused_dq_kernel, which scales dq and rounds it to bf16.
//
// It fuses the TPU kernels of repurpose_tpu/ops/flash_attention.py that the
// first design of flash_bwd_stream.cu replaces one by one at the other
// widths: `_bwd_dq_stream_kernel` (line 859), `_bwd_dq_packed_stream_kernel`
// (line 914) and `_bwd_dq_hbm_kernel` (line 992) for dq, with
// `_bwd_dkv_stream_kernel` (line 1200) for dk/dv. On the TPU the split
// was the design: its grid runs in order, so a second pass over the pairs
// is cheap, and it has no atomics to add dq across key blocks.
//
// What it computes is the TPU stream kernels' function in their bias form,
// with the rounding points of the dense pair (flash_bwd_tc.cuh), on the
// outputs of flash_bwd_stream_prep (q_s, {lse, delta}, {key flag,
// segment}):
//   p_ij  = R(exp(R(s_ij + (allowed(i, j) ? 0 : -1e9) - lse_i)))
//   ds_ij = R(p_ij * R(dp_ij - d_i))
//   dk_j  = sum_i bf16(ds_ij) q_s_i,  dv_j = sum_i bf16(p_ij) g_i
//   dq_i  = bf16(scale * sum_j bf16(ds_ij) k_j)    one float32 sum, rounded once
// with exp as the forward's exp_fast (ex2.approx, relative error ~1e-5,
// under the bf16 ulp p is rounded to) and the roundings as the forward's
// round_bf16x2 (flash_fwd_tc.cuh). The sweep is a dk/dv sweep: each 64-key
// tile kt takes the query tiles [0, ceil(kvl / 64)), packed [lo[kt],
// min(hi[kt], ceil(kvl / 64))) of `packed_block_bounds` at 64/64 (each
// video's run, the stream forward's sweep: on the model's rows, where each
// video is one run, the tiles outside carry an exact 0 softmax mass), whose
// symmetry (kt in qt's range exactly where qt is in kt's) makes these also
// the pairs of each query tile's own key sweep. dq rows at or past kvl, and
// rows of a query tile whose own range is empty, are 0; so are dk/dv rows at
// or past kvl.
//
// What bounds it: the elementwise work per (query, key) pair (the bias, the
// bf16 roundings, the exp, ds), which takes more instruction slots than the
// 64x64x64 products it feeds. A dq and a dk/dv kernel (the dense pair's
// split) would do it twice, with seven products where five suffice. Here
// each pair's p and ds are formed once, from five products.
//
// Design.
//   - A block owns 128 keys of one head: two consumer warpgroups of 64 keys
//     each and one producer warpgroup. K and V stay in shared memory for the
//     whole sweep, dK and dV in registers. The producer streams the sweep's
//     q_s / g tiles with their {lse, delta} and {flag, segment} through a
//     4-stage TMA ring, once for both consumers. (64 keys a block, two
//     blocks an SM, loads each tile twice as often: on an H100 it ran 1-2 %
//     slower at [1, 32768], 4 % faster at [1, 16384].)
//   - Per query tile a warpgroup runs, for its key tile: S^T = K Q_s^T and
//     dP^T = V G^T (wgmma m64n64k16 from shared memory, keys as M); p and
//     ds from the accumulators straight into the register A operands (an
//     accumulator written in place would serialise the wgmma pipeline);
//     dV += P^T G and dK += dS^T Q_s; dS^T in bf16 to shared memory; then,
//     after a barrier of the warpgroup, the tile's dq partial dS K over its
//     64 keys (dS^T as the transposed A operand, K as the transposed B).
//   - dq: the partial goes from registers to a shared tile (double-buffered,
//     in the accumulators' own order, so that the stores meet no bank
//     conflict), and the warpgroup's thread 0 adds it into the float32
//     accumulator [B, H, Tp, 64] with a TMA bulk reduce-add
//     (cp.reduce.async.bulk .add.f32), which runs while the next query tile
//     is computed. Each block starts its sweep at its own diagonal tile and
//     wraps, so that blocks in flight add into different tiles (measured
//     neutral: the adds cost ~1 % of the kernel either way).
//     flash_bwd_fused_dq_kernel then reads the accumulator (in that order)
//     and writes dq = bf16(scale * sum). The two warpgroups share nothing
//     but the ring. (Summing the two partials in the block first, each
//     warpgroup taking 32 columns over all 128 keys, halves the adds but
//     syncs the warpgroups every tile: it ran no faster on an H100.)
//   - dq's float32 sum is therefore taken in an order that changes from run
//     to run (which add reaches the L2 first), so dq may differ in its last
//     bits between runs; dk and dv are summed in registers in a fixed order
//     and do not.
//   - A warpgroup skips the query tiles outside its own key tile's range
//     (packed rows), and a key tile at or past kvl; a block with neither
//     half live writes its zeros and leaves.
//   - One block an SM, 384 threads: the producer warpgroup gives registers
//     back (setmaxnreg: 24 a thread) so that the consumers hold dK, dV, S,
//     dP, both A operands and the dq partial in 240 (at 168, what 384
//     threads start with, they spill and ptxas serialises the wgmma); about
//     180 KB of shared memory.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_bwd_tc.cuh"
#include "flash_fwd_tc.cuh"
#include "hopper.cuh"

namespace bwd_fused {

using namespace hopper;
using bf16 = __nv_bfloat16;
using bwd_tc::Args;
using bwd_tc::BQ;
using bwd_tc::MASK_BIAS;
using bwd_tc::META;
using bwd_tc::TILE_BYTES;
using fwd_tc::exp_fast;
using fwd_tc::round_bf16x2;

constexpr int HALVES = 2;                     // 64-key tiles of a block
constexpr int BK = HALVES * BQ;               // keys of a block
constexpr int STAGES = 4;                     // ring depth
constexpr int WG = 128;                       // threads of a warpgroup
constexpr int CONSUMERS = HALVES * WG;        // one warpgroup per key tile
constexpr int THREADS = CONSUMERS + WG;       // and a producer warpgroup
// registers a thread: 168 at launch (65536 over 384 threads), then the
// producer gives back what the consumers take: 128 x 24 + 256 x 240 <= 384 x 168
constexpr int LAUNCH_REGS = 168;
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;
static_assert(WG * PRODUCER_REGS + CONSUMERS * CONSUMER_REGS <= THREADS * LAUNCH_REGS,
              "fused bwd: the consumers' registers do not fit");
constexpr unsigned DQ_TILE = BQ * TC_DH * 4;  // a [64, 64] float32 dq partial
constexpr int DQ_F4 = BQ * TC_DH / 4;         // its float4s

struct __align__(1024) Smem {
  bf16 k[HALVES][BQ * TC_DH];   // TMA: key rows, 128-byte swizzle
  bf16 v[HALVES][BQ * TC_DH];
  bf16 ds[HALVES][BQ * TC_DH];  // dS^T: key rows, queries along the swizzled row
  bf16 q[STAGES][BQ * TC_DH];
  bf16 g[STAGES][BQ * TC_DH];
  float4 dq[HALVES][2][DQ_F4];  // each warpgroup's dq partials on their way to the reduce-add
  float2 rows[STAGES][BQ];      // {lse, delta} of the tile's rows
  int2 row_info[STAGES][BQ];    // {flag, segment} of the tile's rows
  int2 key_info[BK];            // {flag, segment} of the block's keys
  uint64_t own, full[STAGES], empty[STAGES];
};
constexpr size_t SMEM = sizeof(Smem) + 1024;  // the window is aligned by hand
static_assert(SMEM + 1024 <= 232448, "fused bwd: past the shared memory of a block");

struct Params {
  Args a;      // q_s, k, v, g, the prep's rows / info, kvl, lo / hi; out0 dk, out1 dv
  float* acc;  // [B, H, Tp, 64] float32, zeroed: the dq sums
};

// Byte offset of element (row, col) of a [64, 64] bf16 tile with 128-byte
// rows under the 128-byte swizzle (TMA's layout, and the wgmma descriptors').
__device__ __forceinline__ int sw(int row, int col) {
  return row * 128 + ((((col >> 3) ^ row) & 7) << 4) + (col & 7) * 2;
}

// p of two pairs of one key row in the bias form: the score biased, not
// selected, where the pair is not allowed (bwd_tc::prob2 selects), with
// exp_fast and round_bf16x2; 0 for a key past T.
template <bool SM_BF16>
__device__ __forceinline__ float2 prob2(float s0, float s1, int ok, bool same0, bool same1,
                                        float lse0, float lse1) {
  float x0 = s0 + (ok == 1 && same0 ? 0.f : MASK_BIAS) - lse0;
  float x1 = s1 + (ok == 1 && same1 ? 0.f : MASK_BIAS) - lse1;
  if constexpr (SM_BF16) round_bf16x2(x0, x1);
  float p0 = exp_fast(x0), p1 = exp_fast(x1);
  if constexpr (SM_BF16) round_bf16x2(p0, p1);
  return ok < 0 ? make_float2(0.f, 0.f) : make_float2(p0, p1);
}

// ds of two pairs: R(p * R(dp - delta)).
template <bool SM_BF16>
__device__ __forceinline__ float2 dsoft2(float2 p, float dp0, float dp1, float delta0,
                                         float delta1) {
  float d0 = dp0 - delta0, d1 = dp1 - delta1;
  if constexpr (SM_BF16) round_bf16x2(d0, d1);
  d0 *= p.x;
  d1 *= p.y;
  if constexpr (SM_BF16) round_bf16x2(d0, d1);
  return make_float2(d0, d1);
}

// The two bf16 values of an A-operand register, as floats.
__device__ __forceinline__ float2 unpack_bf16(uint32_t u) {
  return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xFFFF0000u));
}

// The dq partial of thread t of a warpgroup (rows r, r + 8; columns 8j +
// c0, + 1) into `part`, float4 j at 128 j + t: consecutive threads on
// consecutive 16 bytes.
__device__ __forceinline__ void stage_partial(float4* part, const float (&dq)[32], int t) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
    part[j * WG + t] = make_float4(dq[4 * j], dq[4 * j + 1], dq[4 * j + 2], dq[4 * j + 3]);
}

// Adds the dq partial `part` of query tile qt (head h, batch row b) into
// the accumulator, by the TMA unit; committed as this thread's bulk group.
__device__ __forceinline__ void reduce_add(const Params& prm, int b, int h, int qt,
                                           const float4* part) {
  const Args& a = prm.a;
  bulk_reduce_add_f32(prm.acc + (((long long)b * a.H + h) * a.Tp + qt * BQ) * TC_DH, part,
                      DQ_TILE);
  bulk_commit();
}

// The block: keys [128 blockIdx.x, + 128) of head blockIdx.y, batch row
// blockIdx.z.
template <bool SM_BF16>
__device__ __forceinline__ void fused_block(const Params& prm) {
  const Args& a = prm.a;
  extern __shared__ unsigned char smem_raw[];
  Smem& s = bwd_tc::smem_as<Smem>(smem_raw);
  const int kb = blockIdx.x, j0 = kb * BK, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, T_len = a.T;
  const long long D = (long long)a.H * TC_DH;
  bf16* dk_bh = a.out0 + (long long)b * T_len * D + h * TC_DH;
  bf16* dv_bh = a.out1 + (long long)b * T_len * D + h * TC_DH;

  // each 64-key tile's sweep; a tile at or past kvl, or with an empty
  // range, is dead
  // (read through shuffles, so that the compiler sees the branches around the
  // consumers' wgmma are warp-uniform)
  const int kvl = __shfl_sync(0xffffffffu, a.kvl[b], 0);
  int lo[HALVES], hi[HALVES];
  bool live[HALVES];
#pragma unroll
  for (int hk = 0; hk < HALVES; ++hk) {
    const int2 r = j0 + BQ * hk < kvl ? bwd_tc::sweep(a, b, 2 * kb + hk, kvl) : make_int2(0, 0);
    lo[hk] = __shfl_sync(0xffffffffu, r.x, 0);
    hi[hk] = __shfl_sync(0xffffffffu, r.y, 0);
    live[hk] = lo[hk] < hi[hk];
  }
  if (!live[0] && !live[1]) {
#pragma unroll
    for (int hk = 0; hk < HALVES; ++hk) {
      bwd_tc::zero_rows(dk_bh, D, j0 + BQ * hk, T_len, tid, THREADS);
      bwd_tc::zero_rows(dv_bh, D, j0 + BQ * hk, T_len, tid, THREADS);
    }
    return;
  }
  // the union of the live ranges, swept from the block's diagonal tile on
  const int qt_lo = live[0] ? (live[1] ? min(lo[0], lo[1]) : lo[0]) : lo[1];
  const int qt_hi = live[0] ? (live[1] ? max(hi[0], hi[1]) : hi[0]) : hi[1];
  const int n = qt_hi - qt_lo;
  const int start = qt_lo + min(max(2 * kb - qt_lo, 0), n - 1);

  if (tid == 0) {
    mbar_init(&s.own, 1);
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&s.full[i], 1);
      mbar_init(&s.empty[i], CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const float2* rows_bh = a.rows + ((long long)b * a.H + h) * a.Tp;
  const int2* info_b = a.info + (long long)b * a.Tp;

  // the role, read through a shuffle so that the compiler sees it is
  // warp-uniform, as the consumers' wgmma need
  const int w = __shfl_sync(0xffffffffu, tid / WG, 0);
  if (w == HALVES) {
    // the producer warpgroup: one thread issues every copy
    reg_lower<PRODUCER_REGS>();
    if (tid == CONSUMERS) {
      unsigned own_bytes = 0;
      for (int hk = 0; hk < HALVES; ++hk)
        if (live[hk]) own_bytes += 2 * TILE_BYTES + META;
      mbar_arrive_expect_tx(&s.own, own_bytes);
      for (int hk = 0; hk < HALVES; ++hk) {
        if (!live[hk]) continue;
        tma_load_rows(s.k[hk], &a.k, &s.own, h, j0 + BQ * hk, b);
        tma_load_rows(s.v[hk], &a.v, &s.own, h, j0 + BQ * hk, b);
        bulk_load(s.key_info + BQ * hk, info_b + j0 + BQ * hk, META, &s.own);
      }
      for (int i = 0, qt = start; i < n; ++i, qt = qt + 1 == qt_hi ? qt_lo : qt + 1) {
        const int st = i % STAGES;
        mbar_wait(&s.empty[st], ((i / STAGES) & 1) ^ 1);  // the first round passes
        mbar_arrive_expect_tx(&s.full[st], 2 * TILE_BYTES + 2 * META);
        tma_load_rows(s.q[st], &a.q, &s.full[st], h, qt * BQ, b);
        tma_load_rows(s.g[st], &a.g, &s.full[st], h, qt * BQ, b);
        bulk_load(s.rows[st], rows_bh + qt * BQ, META, &s.full[st]);
        bulk_load(s.row_info[st], info_b + qt * BQ, META, &s.full[st]);
      }
    }
    return;
  }

  // consumer warpgroup w: keys r and r + 8 of its tile (rows), query columns
  // c0 + 8n and c0 + 8n + 1
  reg_raise<CONSUMER_REGS>();
  const int t = tid % WG, lane = t % 32, r = 16 * (t / 32) + lane / 4, c0 = 2 * (lane % 4);
  mbar_wait(&s.own, 0);
  const int2 key[2] = {s.key_info[BQ * w + r], s.key_info[BQ * w + r + 8]};  // {flag, segment}
  // this tile's sweep (selected, not indexed by w: no local-memory array)
  const bool my_live = w ? live[1] : live[0];
  const int my_lo = w ? lo[1] : lo[0], my_hi = w ? hi[1] : hi[0];
  const uint64_t dK = sw128_desc(s.k[w], 16, SW_GROUP), dV = sw128_desc(s.v[w], 16, SW_GROUP);
  const uint64_t dKmn = sw128_desc(s.k[w], SW_GROUP, SW_GROUP);  // K as dq's MN-major B
  const uint64_t dDS = sw128_desc(s.ds[w], SW_GROUP, SW_GROUP);  // dS^T as dq's MN-major A
  char* ds_tile = reinterpret_cast<char*>(s.ds[w]);
  // accumulators, defined once: each product's first slice overwrites its
  // own (accumulate = 0), so no other instruction writes them inside the
  // wgmma pipeline, which would serialise it
  float dk[32], dv[32], dq[32], sc[32], dp[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk[i] = dv[i] = dq[i] = sc[i] = dp[i] = 0.f;
  // read by the dv / dk products, which run into the ds work / next iteration
  uint32_t p_a[4][4] = {}, ds_a[4][4] = {};
  int prev_qt = -1, flushes = 0;

  for (int i = 0, qt = start; i < n; ++i, qt = qt + 1 == qt_hi ? qt_lo : qt + 1) {
    const int st = i % STAGES;
    const bool mine = my_live && my_lo <= qt && qt < my_hi;  // this tile sweeps qt
    mbar_wait(&s.full[st], (i / STAGES) & 1);
    const uint64_t dQ = sw128_desc(s.q[st], 16, SW_GROUP), dG = sw128_desc(s.g[st], 16, SW_GROUP);
    if (mine) {
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_ss(sc, dK + K_STEP * kk, dQ + K_STEP * kk, kk);  // s^T
      wg_commit();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_ss(dp, dV + K_STEP * kk, dG + K_STEP * kk, kk);  // dp^T
      wg_commit();
      wg_wait<1>();  // s^T, and every product of the previous tile, are done
      reg_fence(sc);
    } else {
      wg_wait<0>();
    }
    reg_fence(p_a);
    reg_fence(ds_a);
    reg_fence(dq);
    if (i > 0) mbar_arrive(&s.empty[(i - 1) % STAGES]);  // done with that stage
    if (mine) {
      // p^T of s^T (queries c0 + 8nn and + 1 of keys r, r + 8), straight into
      // the A operand: the pair (s[2q], s[2q + 1]) is register q % 4 of slice
      // q / 4. The bf16 interior keeps p nowhere else (its values are bf16:
      // ds unpacks them); the float32 interior keeps it in s, in place.
      // Writing the accumulators in place would serialise the wgmma.
#pragma unroll
      for (int nn = 0; nn < 8; ++nn) {
        const float4 rs = *reinterpret_cast<const float4*>(&s.rows[st][8 * nn + c0]);
        const int4 ri = *reinterpret_cast<const int4*>(&s.row_info[st][8 * nn + c0]);
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int q = 2 * nn + hf;
          const float2 p = prob2<SM_BF16>(sc[2 * q], sc[2 * q + 1], key[hf].x,
                                          key[hf].y == ri.y, key[hf].y == ri.w, rs.x, rs.z);
          p_a[q / 4][q % 4] = pack_bf16<SM_BF16>(p.x, p.y);
          if constexpr (!SM_BF16) {
            sc[2 * q] = p.x;
            sc[2 * q + 1] = p.y;
          }
        }
      }
      const uint64_t dGt = sw128_desc(s.g[st], SW_GROUP, SW_GROUP);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs_tb(dv, p_a[kk], dGt + MN_STEP * kk);  // dv += p^T g
      wg_commit();
      wg_wait<1>();  // dp^T is in; dv runs under the ds work
      reg_fence(dp);
#pragma unroll
      for (int nn = 0; nn < 8; ++nn) {  // ds^T of dp^T, straight into the A operand
        const float4 rs = *reinterpret_cast<const float4*>(&s.rows[st][8 * nn + c0]);
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int q = 2 * nn + hf;
          const float2 p = SM_BF16 ? unpack_bf16(p_a[q / 4][q % 4])
                                   : make_float2(sc[2 * q], sc[2 * q + 1]);
          const float2 ds = dsoft2<SM_BF16>(p, dp[2 * q], dp[2 * q + 1], rs.y, rs.w);
          ds_a[q / 4][q % 4] = pack_bf16<SM_BF16>(ds.x, ds.y);
        }
      }
      const uint64_t dQt = sw128_desc(s.q[st], SW_GROUP, SW_GROUP);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs_tb(dk, ds_a[kk], dQt + MN_STEP * kk);  // dk += ds^T q_s
      wg_commit();
      // dS^T to shared memory for dq (the A operand's slice kk holds key rows
      // r, r + 8 at query columns 16kk + c0, + 8); the dq product that read
      // it last, the previous tile's, is done (the wait above)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          *reinterpret_cast<uint32_t*>(ds_tile + sw(r + 8 * (e & 1), 16 * kk + 8 * (e >> 1) + c0)) =
              ds_a[kk][e];
    }
    // the previous tile's dq partial to the reduce-add, then this tile's
    // product; a barrier of the warpgroup makes the partial (for the TMA
    // unit) and dS^T (for the wgmma) visible, its thread 0 issues the add
    const bool flush = prev_qt >= 0;
    if (flush) stage_partial(s.dq[w][flushes & 1], dq, t);
    if (flush || mine) {
      if (t == 0) bulk_wait_read<0>();  // the partial before: its buffer is free after this
      fence_async_shared();
      named_barrier(w ? 3 : 2, WG);
    }
    if (flush) {
      if (t == 0) reduce_add(prm, b, h, prev_qt, s.dq[w][flushes & 1]);
      ++flushes;
      prev_qt = -1;
    }
    if (mine) {  // dq partial = dS K over this tile's 64 keys
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_ss_tt(dq, dDS + MN_STEP * kk, dKmn + MN_STEP * kk, kk);
      wg_commit();
      prev_qt = qt;
    }
  }
  wg_wait<0>();
  reg_fence(dq);
  reg_fence(dk);
  reg_fence(dv);
  if (prev_qt >= 0) {  // the last partial
    stage_partial(s.dq[w][flushes & 1], dq, t);
    if (t == 0) bulk_wait_read<0>();
    fence_async_shared();
    named_barrier(w ? 3 : 2, WG);
    if (t == 0) reduce_add(prm, b, h, prev_qt, s.dq[w][flushes & 1]);
  }
  if (t == 0) bulk_wait_all();  // the shared tiles outlive every reduce-add
  if (my_live) {
    bwd_tc::store(dk_bh, D, dk, j0 + BQ * w, T_len, kvl, 1.f, t);
    bwd_tc::store(dv_bh, D, dv, j0 + BQ * w, T_len, kvl, 1.f, t);
  } else {
    bwd_tc::zero_rows(dk_bh, D, j0 + BQ * w, T_len, t, WG);
    bwd_tc::zero_rows(dv_bh, D, j0 + BQ * w, T_len, t, WG);
  }
}

// dq = bf16(scale * acc) on the rows of query tiles with a live range (0
// elsewhere, and at or past kvl): one float4 of the accumulator a thread, in
// the order fused_block writes it (float4 j of thread t at 128 j + t, its
// rows r, r + 8 and columns 8 j + c0, + 1).
__device__ __forceinline__ void dq_out(const float4* acc, const int* kvl_b, const int* tile_lo,
                                       const int* tile_hi, bf16* dq, int B, int T_len, int Tp,
                                       int H, float scale) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int n_tiles = Tp / BQ;
  const long long tile = idx / DQ_F4;
  if (tile >= (long long)B * H * n_tiles) return;
  const int f = static_cast<int>(idx % DQ_F4), qt = static_cast<int>(tile % n_tiles);
  const int h = static_cast<int>((tile / n_tiles) % H), b = static_cast<int>(tile / n_tiles / H);
  const int j = f / WG, t = f % WG, lane = t % 32;
  const int r = 16 * (t / 32) + lane / 4, c = 8 * j + 2 * (lane % 4);
  const int kvl = kvl_b[b];
  bool live = qt * BQ < kvl;
  if (tile_lo != nullptr)
    live = live && tile_lo[(long long)b * n_tiles + qt] <
                       min(tile_hi[(long long)b * n_tiles + qt], (kvl + BQ - 1) / BQ);
  const float4 x = acc[idx];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = qt * BQ + r + 8 * half;
    if (row >= T_len) continue;
    const bool on = live && row < kvl;
    const float x0 = half ? x.z : x.x, x1 = half ? x.w : x.y;
    *reinterpret_cast<__nv_bfloat162*>(dq + (((long long)b * T_len + row) * H + h) * TC_DH + c) =
        __floats2bfloat162_rn(on ? x0 * scale : 0.f, on ? x1 * scale : 0.f);
  }
}

}  // namespace bwd_fused
