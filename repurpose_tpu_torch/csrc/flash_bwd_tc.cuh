// The dense tensor-core attention backward for Hopper (sm_90a), bf16 at Dh
// 64, T <= 2048 (the training step) in the select form of the TPU dense
// kernels: one warpgroup mainloop for dq and one for dk/dv, instantiated by
// the kernels flash_bwd_{dq,dkv}_tc_kernel (flash_bwd.cu), which name the
// TPU kernels they replace; this note is the design. The long-T backward in
// bf16 at Dh 64, in the bias form of the TPU stream kernels, is one fused
// kernel on these helpers, flash_bwd_fused.cuh. Both run after
// flash_bwd_stream_prep_kernel (flash_bwd_stream.cu), which makes q_s,
// {lse, delta} and {key flag, segment} once per backward.
//
// What they compute, with the saved forward out `o` and lse, the upstream
// gradient `g`, scale = 1/sqrt(Dh) (or a zero-padded head's own), per batch
// row b and head h:
//   q_s   = round_bf16(float(q) * scale)          (the prep)
//   s_ij  = dot(q_s_i, k_j) in float32
//   p_ij  = allowed(i, j) ? R(exp(R(s_ij - lse_i))) : 0
//   allowed(i, j) = key_valid[j] && (no seg_ids || seg_ids[i] == seg_ids[j])
//   dp_ij = dot(g_i, v_j) in float32
//   d_i   = sum_d g_id * o_id in float32           (delta, the prep)
//   ds_ij = R(p_ij * R(dp_ij - d_i))
//   dq_i  = scale * sum_j bf16(ds_ij) k_j          float32 sums
//   dk_j  = sum_i bf16(ds_ij) q_s_i                (no extra scale: q_s has it)
//   dv_j  = sum_i bf16(p_ij) g_i
// R(.) rounds to bf16 under the bf16 softmax interior (else the identity);
// keys past T have p = 0. The bias form (p = R(exp(R(s_ij + (allowed ? 0 :
// -1e9) - lse_i)))) differs from this only on packed rows, and there only
// where a query row has no allowed key in its sweep (its lse then sits near
// -1e9, so the bias form's p is not 0): padding inside kvl whose own
// segment holds no valid key. The model gives such rows g = 0, but the
// dense kernels' contract holds for any g, so they take the select form.
//
// The sweeps, with kvl = last valid key + 1 of the batch row and 64-row
// tiles:
//   - dq, per query tile qt: key tiles [0, ceil(kvl / 64)), packed
//     [lo[b, qt], min(hi[b, qt], ceil(kvl / 64))), where lo/hi
//     (`segment_tile_bounds` at 64/64) span every position of each segment
//     id that owns a row of the tile, wherever it lies: tiles outside hold
//     no key of those ids, which the select form gives p = 0 exactly, for
//     any layout. A query tile at or past kvl, or whose range is empty,
//     writes dq = 0; so do rows at or past kvl.
//   - dk/dv, per key tile kt: query tiles [0, ceil(kvl / 64)), packed
//     [lo[b, kt], min(hi[b, kt], ceil(kvl / 64))): the mask seg_q == seg_k is
//     symmetric, so the key tile's own bounds are exactly the query tiles
//     whose videos overlap it (lo <= ki < hi on the TPU, fa:1239-1241). Key
//     tiles at or past kvl, or with an empty range, write zeros; so do key
//     rows at or past kvl.
// Query rows past kvl carry lse = 1e30 from the forward (p = 0).
//
// Design.
//   - A block is one warpgroup of consumers (128 threads) and one producer
//     warp. The producer feeds a 3-stage ring through TMA (4D tensor maps over
//     the strided [B, T, H, Dh] views, 128-byte swizzle; rows past T arrive
//     as zeros) and bulk copies (the padded stats / info tiles), completing
//     on mbarriers; consumers release a stage with an arrive on its "empty"
//     barrier. A sweep shorter than the ring fills only its first stages; a
//     block with nothing to sweep writes its zeros and leaves before any
//     barrier exists, producer included.
//   - Products are wgmma m64n64k16 with float32 register accumulators. dq:
//     S = Q_s K^T and dP = G V^T from shared memory (both K-major), p and ds
//     formed in registers on the accumulator layout, then dq += dS K with dS
//     as the register A operand and K as the transposed (MN-major) B operand
//     of the same shared tile. dk/dv: S^T = K Q_s^T and dP^T = V G^T with
//     keys as M, so that P^T and dS^T are already the A operands of
//     dV += P^T G and dK += dS^T Q_s; lse and delta broadcast along columns.
//     No score tile touches shared memory. Each product is waited for only
//     where its result or its stage is next needed: dV runs while ds is
//     formed, and dq / dK while the next tile's S and dP are issued. Under
//     the bf16 interior p and ds are already bf16 values and pack into A
//     operands by a byte permute.
//   - 64-row tiles, about 68 KB of shared memory; dq at <= 128 registers
//     (three blocks an SM), dk/dv at <= 200 (two); static_asserts below.
// What bounds it: the elementwise work per (query, key) pair (the mask, two
// bf16 roundings, expf and the ds roundings) costs more issue slots than the
// three or four 64x64x64 products it feeds. The roundings run two values at
// a time (round2: one cvt.rn.bf16x2.f32), which leaves every result bit as
// it was; PERF.md has the times.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace bwd_tc {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int BQ = ROWS;                    // rows of a query or key tile
constexpr int TILE = 64;                    // the tile of the packed bounds (64/64)
constexpr int STAGES = 3;                   // ring depth
constexpr int CONSUMERS = 128;              // one warpgroup
constexpr int THREADS = CONSUMERS + 32;     // and one producer warp
constexpr unsigned TILE_BYTES = BQ * TC_DH * 2;  // a [64, 64] bf16 tile
constexpr unsigned META = BQ * 8;           // 64 float2 / int2
constexpr float MASK_BIAS = -1e9f;          // NEG_INF of repurpose_tpu/ops/attention.py
constexpr size_t SM_SMEM = 233472;          // bytes of shared memory per SM
// __launch_bounds__ minimum blocks an SM of the two kernels
constexpr int DQ_MIN_BLOCKS = 3;
constexpr int DKV_MIN_BLOCKS = 2;

// Two values rounded to bf16 under the bf16 interior, by one
// cvt.rn.bf16x2.f32 for both (one conversion a value costs the elementwise
// work most of its time), and unchanged under the float32 interior.
template <bool SM_BF16>
__device__ __forceinline__ float2 round2(float a, float b) {
  if constexpr (SM_BF16) return __bfloat1622float2(__floats2bfloat162_rn(a, b));
  else return make_float2(a, b);
}

// Shared memory of the dq kernel: this query tile's q_s and g, a ring of
// K / V tiles with their keys' {flag, segment}, this tile's rows' {lse,
// delta} and {flag, segment}, the barriers. Tiles are 1024-byte aligned
// (the swizzle's period).
struct __align__(1024) DqSmem {
  bf16 q[BQ * TC_DH];
  bf16 g[BQ * TC_DH];
  bf16 k[STAGES][BQ * TC_DH];
  bf16 v[STAGES][BQ * TC_DH];
  int2 keys[STAGES][BQ];
  float2 rows[BQ];
  int2 row_info[BQ];
  uint64_t own, full[STAGES], empty[STAGES];
};

// Shared memory of the dk/dv kernel: this key tile's K and V and its keys'
// {flag, segment}, a ring of q_s / g tiles with their rows' {lse, delta} and
// {flag, segment}, the barriers.
struct __align__(1024) DkvSmem {
  bf16 k[BQ * TC_DH];
  bf16 v[BQ * TC_DH];
  bf16 q[STAGES][BQ * TC_DH];
  bf16 g[STAGES][BQ * TC_DH];
  float2 rows[STAGES][BQ];
  int2 row_info[STAGES][BQ];
  int2 key_info[BQ];
  uint64_t own, full[STAGES], empty[STAGES];
};

// + 1024: the dynamic window is aligned by hand. Three dq and two dk/dv
// blocks share an SM (1 KB of each block's share is reserved); registers
// hold them there too (the kernels' __launch_bounds__).
constexpr size_t SMEM_DQ = sizeof(DqSmem) + 1024;
constexpr size_t SMEM_DKV = sizeof(DkvSmem) + 1024;
static_assert(DQ_MIN_BLOCKS * (SMEM_DQ + 1024) <= SM_SMEM,
              "dq tc: three blocks no longer share an SM");
static_assert(DKV_MIN_BLOCKS * (SMEM_DKV + 1024) <= SM_SMEM,
              "dk/dv tc: two blocks no longer share an SM");

template <typename S>
__device__ __forceinline__ S& smem_as(unsigned char* raw) {
  return *reinterpret_cast<S*>(raw + ((1024 - (smem_addr(raw) & 1023)) & 1023));
}

struct Args {
  CUtensorMap q, k, v, g;  // q: the prep's q_s
  const float2* rows;      // [B, H, Tp] {lse, delta}
  const int2* info;        // [B, Tp] {key flag, segment}
  const int* kvl;          // [B]
  const int* tile_lo;      // [B, ceil(T / 64)], null: unpacked
  const int* tile_hi;
  bf16 *out0, *out1;  // dq, or dk and dv: [B, T, H, 64]
  int T, Tp, H;
  float scale;
};

// p of two scores, in place, with the rounding points above (SM_BF16: the
// bf16 softmax interior): key flags `ok` 1 valid, 0 masked, -1 past T. p is
// 0 wherever the pair is not allowed; the score then carries the bias all
// the same, so that the exp never overflows.
template <bool SM_BF16>
__device__ __forceinline__ void prob2(float& s0, float& s1, int ok0, int ok1, bool same0,
                                      bool same1, float lse0, float lse1) {
  const bool allowed0 = ok0 == 1 && same0, allowed1 = ok1 == 1 && same1;
  const float2 x = round2<SM_BF16>(s0 + (allowed0 ? 0.f : MASK_BIAS) - lse0,
                                   s1 + (allowed1 ? 0.f : MASK_BIAS) - lse1);
  const float2 p = round2<SM_BF16>(expf(x.x), expf(x.y));
  s0 = allowed0 ? p.x : 0.f;
  s1 = allowed1 ? p.y : 0.f;
}

// ds of two pairs, over dp in place: R(p * R(dp - delta)).
template <bool SM_BF16>
__device__ __forceinline__ void dsoft2(float p0, float p1, float& dp0, float& dp1, float delta0,
                                       float delta1) {
  const float2 dd = round2<SM_BF16>(dp0 - delta0, dp1 - delta1);
  const float2 ds = round2<SM_BF16>(p0 * dd.x, p1 * dd.y);
  dp0 = ds.x;
  dp1 = ds.y;
}

// Rows row0 + (the accumulator rows of thread `tid` of its warpgroup) of one
// head of a [B, T, H, 64] output: acc * mul before kvl, 0 from kvl to T.
__device__ __forceinline__ void store(bf16* out_bh, long long row_stride, const float (&d)[32],
                                      int row0, int T_len, int kvl, float mul, int tid) {
  const int lane = tid % 32, r = 16 * (tid / 32) + lane / 4, c0 = 2 * (lane % 4);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int t = row0 + r + 8 * half;
    if (t >= T_len) continue;
    bf16* row = out_bh + (long long)t * row_stride;
    const bool live = t < kvl;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float x0 = live ? d[4 * n + 2 * half] * mul : 0.f;
      const float x1 = live ? d[4 * n + 2 * half + 1] * mul : 0.f;
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * n + c0) = __floats2bfloat162_rn(x0, x1);
    }
  }
}

// Zeros for rows row0..row0 + 64 (those before T) of one head, by `threads`
// threads from thread `tid`.
__device__ __forceinline__ void zero_rows(bf16* out_bh, long long row_stride, int row0,
                                          int T_len, int tid, int threads) {
  for (int idx = tid; idx < BQ * 8; idx += threads) {
    const int t = row0 + idx / 8;
    if (t < T_len)
      *reinterpret_cast<uint4*>(out_bh + (long long)t * row_stride + (idx % 8) * 8) =
          make_uint4(0, 0, 0, 0);
  }
}

__device__ __forceinline__ void init_barriers(uint64_t* own, uint64_t* full, uint64_t* empty) {
  mbar_init(own, 1);
  for (int i = 0; i < STAGES; ++i) {
    mbar_init(&full[i], 1);
    mbar_init(&empty[i], CONSUMERS);
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// [lo, hi) of 64-row tiles that tile `tile` of batch row b sweeps:
// [0, ceil(kvl / 64)), packed bounded by the tile's own [lo, hi).
__device__ __forceinline__ int2 sweep(const Args& a, int b, int tile, int kvl) {
  int lo = 0, hi = (kvl + BQ - 1) / BQ;
  if (a.tile_lo != nullptr) {
    const long long n_tiles = (a.T + TILE - 1) / TILE;
    lo = a.tile_lo[(long long)b * n_tiles + tile];
    hi = min(a.tile_hi[(long long)b * n_tiles + tile], hi);
  }
  return make_int2(lo, hi);
}

// One block of the dq kernel: query tile blockIdx.x of head blockIdx.y,
// batch row blockIdx.z.
template <bool SM_BF16>
__device__ __forceinline__ void dq_block(const Args& a) {
  extern __shared__ unsigned char smem_raw[];
  DqSmem& s = smem_as<DqSmem>(smem_raw);
  const int qt = blockIdx.x, q0 = qt * BQ, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, T_len = a.T;
  const long long D = (long long)a.H * TC_DH;
  bf16* dq_bh = a.out0 + (long long)b * T_len * D + h * TC_DH;

  const int kvl = a.kvl[b];
  const int2 range = sweep(a, b, qt, kvl);
  const int kt_lo = range.x, kt_hi = range.y;
  if (q0 >= kvl || kt_lo >= kt_hi) {  // padding rows, or no key to sweep: dq = 0
    zero_rows(dq_bh, D, q0, T_len, threadIdx.x, blockDim.x);
    return;
  }
  if (tid == 0) init_barriers(&s.own, s.full, s.empty);
  __syncthreads();
  const float2* rows_bh = a.rows + ((long long)b * a.H + h) * a.Tp;
  const int2* info_b = a.info + (long long)b * a.Tp;

  // the role, read through a shuffle so that the compiler sees it is
  // warp-uniform, as the consumers' wgmma need
  if (__shfl_sync(0xffffffffu, tid / CONSUMERS, 0) != 0) {
    // the producer warp: one thread issues every copy
    if (tid == CONSUMERS) {
      mbar_arrive_expect_tx(&s.own, 2 * TILE_BYTES + 2 * META);
      tma_load_rows(s.q, &a.q, &s.own, h, q0, b);
      tma_load_rows(s.g, &a.g, &s.own, h, q0, b);
      bulk_load(s.rows, rows_bh + q0, META, &s.own);
      bulk_load(s.row_info, info_b + q0, META, &s.own);
      for (int kt = kt_lo, i = 0; kt < kt_hi; ++kt, ++i) {
        const int st = i % STAGES;
        mbar_wait(&s.empty[st], ((i / STAGES) & 1) ^ 1);  // the first round passes
        mbar_arrive_expect_tx(&s.full[st], 2 * TILE_BYTES + META);
        tma_load_rows(s.k[st], &a.k, &s.full[st], h, kt * BQ, b);
        tma_load_rows(s.v[st], &a.v, &s.full[st], h, kt * BQ, b);
        bulk_load(s.keys[st], info_b + kt * BQ, META, &s.full[st]);
      }
    }
    return;
  }

  // consumers: rows r and r + 8 of the tile, columns c0 + 8n and c0 + 8n + 1
  const int lane = tid % 32, r = 16 * (tid / 32) + lane / 4, c0 = 2 * (lane % 4);
  mbar_wait(&s.own, 0);
  const float2 stat[2] = {s.rows[r], s.rows[r + 8]};  // {lse, delta}
  const int seg[2] = {s.row_info[r].y, s.row_info[r + 8].y};
  const uint64_t dQ = sw128_desc(s.q, 16, SW_GROUP), dG = sw128_desc(s.g, 16, SW_GROUP);
  float dq[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dq[i] = 0.f;
  uint32_t ds_a[4][4] = {};  // read by the dq product, which runs into the next iteration

  for (int kt = kt_lo, i = 0; kt < kt_hi; ++kt, ++i) {
    const int st = i % STAGES;
    mbar_wait(&s.full[st], (i / STAGES) & 1);
    const uint64_t dK = sw128_desc(s.k[st], 16, SW_GROUP), dV = sw128_desc(s.v[st], 16, SW_GROUP);
    float sc[32], dp[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) sc[j] = dp[j] = 0.f;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_ss(sc, dQ + K_STEP * kk, dK + K_STEP * kk);  // s
    wg_commit();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_ss(dp, dG + K_STEP * kk, dV + K_STEP * kk);  // dp
    wg_commit();
    wg_wait<1>();  // s, and the previous tile's dq product, are done
    reg_fence(sc);
    reg_fence(ds_a);
    if (i > 0) mbar_arrive(&s.empty[(i - 1) % STAGES]);  // done with that stage
#pragma unroll
    for (int n = 0; n < 8; ++n) {  // p over s, in place: keys c0 + 8n and + 1 of a row
      const int4 kf = *reinterpret_cast<const int4*>(&s.keys[st][8 * n + c0]);  // {flag, seg} x 2
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        prob2<SM_BF16>(sc[4 * n + 2 * hf], sc[4 * n + 2 * hf + 1], kf.x, kf.z, kf.y == seg[hf],
                       kf.w == seg[hf], stat[hf].x, stat[hf].x);
    }
    wg_wait<0>();
    reg_fence(dp);
#pragma unroll
    for (int n = 0; n < 8; ++n) {  // ds over dp, in place
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        dsoft2<SM_BF16>(sc[4 * n + 2 * hf], sc[4 * n + 2 * hf + 1], dp[4 * n + 2 * hf],
                        dp[4 * n + 2 * hf + 1], stat[hf].y, stat[hf].y);
    }
    acc_to_a<SM_BF16>(dp, ds_a);
    const uint64_t dKt = sw128_desc(s.k[st], SW_GROUP, SW_GROUP);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs_tb(dq, ds_a[kk], dKt + MN_STEP * kk);  // dq += ds K
    wg_commit();
  }
  wg_wait<0>();
  reg_fence(dq);
  store(dq_bh, D, dq, q0, T_len, kvl, a.scale, threadIdx.x);
}

// One block of the dk/dv kernel: key tile blockIdx.x of head blockIdx.y,
// batch row blockIdx.z.
template <bool SM_BF16>
__device__ __forceinline__ void dkv_block(const Args& a) {
  extern __shared__ unsigned char smem_raw[];
  DkvSmem& s = smem_as<DkvSmem>(smem_raw);
  const int kt = blockIdx.x, j0 = kt * BQ, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, T_len = a.T;
  const long long D = (long long)a.H * TC_DH;
  bf16* dk_bh = a.out0 + (long long)b * T_len * D + h * TC_DH;
  bf16* dv_bh = a.out1 + (long long)b * T_len * D + h * TC_DH;

  const int kvl = a.kvl[b];
  const int2 range = sweep(a, b, kt, kvl);  // the mask is symmetric: the key tile's own
  const int qt_lo = range.x, qt_hi = range.y;
  if (j0 >= kvl || qt_lo >= qt_hi) {  // no valid key, or no query to sweep: 0
    zero_rows(dk_bh, D, j0, T_len, threadIdx.x, blockDim.x);
    zero_rows(dv_bh, D, j0, T_len, threadIdx.x, blockDim.x);
    return;
  }
  if (tid == 0) init_barriers(&s.own, s.full, s.empty);
  __syncthreads();
  const float2* rows_bh = a.rows + ((long long)b * a.H + h) * a.Tp;
  const int2* info_b = a.info + (long long)b * a.Tp;

  if (__shfl_sync(0xffffffffu, tid / CONSUMERS, 0) != 0) {  // as in the dq kernel
    // the producer warp: one thread issues every copy
    if (tid == CONSUMERS) {
      mbar_arrive_expect_tx(&s.own, 2 * TILE_BYTES + META);
      tma_load_rows(s.k, &a.k, &s.own, h, j0, b);
      tma_load_rows(s.v, &a.v, &s.own, h, j0, b);
      bulk_load(s.key_info, info_b + j0, META, &s.own);
      for (int qt = qt_lo, i = 0; qt < qt_hi; ++qt, ++i) {
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

  // consumers: keys r and r + 8 of the tile (rows), query columns c0 + 8n
  // and c0 + 8n + 1
  const int lane = tid % 32, r = 16 * (tid / 32) + lane / 4, c0 = 2 * (lane % 4);
  mbar_wait(&s.own, 0);
  const int2 key[2] = {s.key_info[r], s.key_info[r + 8]};  // {flag, segment}
  const uint64_t dK = sw128_desc(s.k, 16, SW_GROUP), dV = sw128_desc(s.v, 16, SW_GROUP);
  float dk[32], dv[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;
  // read by the dv / dk products, which run into the ds work / next iteration
  uint32_t p_a[4][4] = {}, ds_a[4][4] = {};

  for (int qt = qt_lo, i = 0; qt < qt_hi; ++qt, ++i) {
    const int st = i % STAGES;
    mbar_wait(&s.full[st], (i / STAGES) & 1);
    const uint64_t dQ = sw128_desc(s.q[st], 16, SW_GROUP), dG = sw128_desc(s.g[st], 16, SW_GROUP);
    float sc[32], dp[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) sc[j] = dp[j] = 0.f;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_ss(sc, dK + K_STEP * kk, dQ + K_STEP * kk);  // s^T
    wg_commit();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_ss(dp, dV + K_STEP * kk, dG + K_STEP * kk);  // dp^T
    wg_commit();
    wg_wait<1>();  // s^T, and the previous tile's dv / dk products, are done
    reg_fence(sc);
    reg_fence(p_a);
    reg_fence(ds_a);
    if (i > 0) mbar_arrive(&s.empty[(i - 1) % STAGES]);  // done with that stage
#pragma unroll
    for (int n = 0; n < 8; ++n) {  // p^T over s^T, in place: queries c0 + 8n and + 1 of a key
      const float4 rs = *reinterpret_cast<const float4*>(&s.rows[st][8 * n + c0]);  // {lse, delta} x 2
      const int4 ri = *reinterpret_cast<const int4*>(&s.row_info[st][8 * n + c0]);  // {flag, seg} x 2
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        prob2<SM_BF16>(sc[4 * n + 2 * hf], sc[4 * n + 2 * hf + 1], key[hf].x, key[hf].x,
                       key[hf].y == ri.y, key[hf].y == ri.w, rs.x, rs.z);
    }
    acc_to_a<SM_BF16>(sc, p_a);
    const uint64_t dGt = sw128_desc(s.g[st], SW_GROUP, SW_GROUP);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs_tb(dv, p_a[kk], dGt + MN_STEP * kk);  // dv += p^T g
    wg_commit();
    wg_wait<1>();  // dp^T is in; dv runs under the ds work
    reg_fence(dp);
#pragma unroll
    for (int n = 0; n < 8; ++n) {  // ds^T over dp^T, in place
      const float4 rs = *reinterpret_cast<const float4*>(&s.rows[st][8 * n + c0]);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        dsoft2<SM_BF16>(sc[4 * n + 2 * hf], sc[4 * n + 2 * hf + 1], dp[4 * n + 2 * hf],
                        dp[4 * n + 2 * hf + 1], rs.y, rs.w);
    }
    acc_to_a<SM_BF16>(dp, ds_a);
    const uint64_t dQt = sw128_desc(s.q[st], SW_GROUP, SW_GROUP);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs_tb(dk, ds_a[kk], dQt + MN_STEP * kk);  // dk += ds^T q_s
    wg_commit();
  }
  wg_wait<0>();
  reg_fence(dk);
  reg_fence(dv);
  store(dk_bh, D, dk, j0, T_len, kvl, 1.f, threadIdx.x);
  store(dv_bh, D, dv, j0, T_len, kvl, 1.f, threadIdx.x);
}

// Fills `a` for a launch: the tensor maps of q_s (contiguous [B, T, H, 64])
// and of k, v, g (element strides (batch, token, head) in `strides`, 9
// values), the prep's rows / info, kvl and, packed, lo / hi. Returns 0, or
// cudaErrorInvalidValue for a view no tensor map can describe.
inline int make_args(Args& a, const void* qs, const void* k, const void* v, const void* g,
                     const long long* strides, const void* rows, const void* info,
                     const void* kvl, const void* lo, const void* hi, void* out0, void* out1,
                     int B, int T_len, int H, float scale) {
  const long long qs_strides[3] = {(long long)T_len * H * TC_DH, (long long)H * TC_DH, TC_DH};
  const void* bases[4] = {qs, k, v, g};
  CUtensorMap* maps[4] = {&a.q, &a.k, &a.v, &a.g};
  for (int i = 0; i < 4; ++i) {
    const long long* st = i == 0 ? qs_strides : strides + 3 * (i - 1);
    const int err = encode_rows(maps[i], bases[i], B, T_len, H, st[0], st[1], st[2]);
    if (err != 0) return err;
  }
  a.rows = static_cast<const float2*>(rows);
  a.info = static_cast<const int2*>(info);
  a.kvl = static_cast<const int*>(kvl);
  a.tile_lo = static_cast<const int*>(lo);
  a.tile_hi = static_cast<const int*>(hi);
  a.out0 = static_cast<bf16*>(out0);
  a.out1 = static_cast<bf16*>(out1);
  a.T = T_len;
  a.Tp = (T_len + BQ - 1) / BQ * BQ;
  a.H = H;
  a.scale = scale;
  return 0;
}

// Launches `kernel` (a __global__ wrapper of dq_block, or with dq false of
// dkv_block) over the 64-row tiles, heads and batch rows; returns
// cudaGetLastError().
inline int launch(void (*kernel)(Args), bool dq, const Args& a, int B, cudaStream_t stream) {
  const size_t smem = dq ? SMEM_DQ : SMEM_DKV;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(a.Tp / BQ, a.H, B);
  kernel<<<grid, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace bwd_tc
