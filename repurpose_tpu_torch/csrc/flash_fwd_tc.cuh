// The tensor-core attention forward for Hopper (sm_90a), bf16 at Dh 64: one
// warpgroup mainloop shared by two kernels,
//   - flash_fwd_tc_kernel (flash_fwd.cu), the attention forward with its
//     LSE, unpacked and packed, under either softmax interior, over the
//     sweep its wrapper hands it: the dense one (`segment_tile_bounds`) for
//     the dense forward (T <= 2048), the stream one (`packed_block_bounds`)
//     for the long-T forward;
//   - flash_fwd_nt_tc_kernel (flash_fwd_nt.cu), the no-transpose forward of
//     the attention bench tool: no LSE, every query row computed, the float32
//     interior, G = heads_per_block heads per block.
// Each .cu names which TPU kernels its kernel replaces; this note is the
// design both share.
//
// What one consumer warpgroup computes, for one 64-row query tile of one
// head, over the key tiles of its sweep (64 keys each, the step of the
// plain version `flash_forward_stream_reference`, k_block = STREAM_TILE):
//   q_s   = round_bf16(float(q) * scale)          once, in shared memory
//   s_ij  = R(dot(q_s_i, k_j) in float32 + bias_ij)
//           bias: 0 allowed, -1e9 masked key or (packed) other video, -inf
//           for keys past T (p = 0, no part in the max)
//   m'    = max(m, max_j s_ij)                     float32, m from -1e30
//   alpha = exp(m - m')
//   p_ij  = R(exp(R(s_ij - R(m'))))
//   l'    = l * alpha + sum_j p_ij                 float32
//   acc'  = acc * alpha + sum_j bf16(p_ij) v_j     float32
//   out_i = acc_i / l_i,  lse_i = m_i + log(l_i)
// R rounds to bf16 under the bf16 interior and is the identity under the
// float32 one: the rounding points of flash_fwd_stream.cu's first design
// (fa:623-654), so the two designs compute the same function.
//
// Design.
//   - A block is G consumer warpgroups (one per head of the block) and one
//     producer warp. The producer's lane 0 loads the G Q tiles and then,
//     per key tile, the G K and G V tiles by TMA (4D tensor maps over the
//     strided [B, T, H, 64] views, 128-byte swizzle, rows past T zero-filled;
//     hopper.cuh), while its 32 lanes write the tile's per-key bias (and
//     segment) beside them; the stage completes on its "full" mbarrier (32
//     arrivals and the TMA bytes). Consumers release a stage with an arrive
//     on its "empty" mbarrier. Ring depth 3 at G = 1 and 2 (about 58 / 112 KB
//     a block), 2 at G = 4 (160 KB; 3 would pass the 227 KB a block may
//     use). A 2-stage ring leaves each tile's load latency exposed: at G = 2
//     the third stage took the tool's shape from 0.286 to 0.225 ms on an
//     H100.
//   - Each consumer warpgroup scales its Q tile in place in shared memory
//     (generic stores, then fence.proxy.async and a named barrier before
//     the first wgmma reads it).
//   - S = Q_s K^T: four wgmma m64n64k16 from shared memory (both K-major),
//     float32 accumulators in registers; the bias, max, exp and sum run on
//     the accumulator layout (a row's 64 columns live in one quad: the max
//     reduces with two xor shuffles; l is kept per thread and reduced once
//     at the end).
//   - O += P V: P is the S accumulator repacked in place as the register A
//     operand (`acc_to_a`: a byte permute under the bf16 interior, where p
//     already holds bf16 values; a round-to-nearest pack under the float32
//     one), V the transposed (MN-major) B operand of its own [keys, 64]
//     tile.
//   - Software pipelining inside the warpgroup: iteration i issues S_i, then
//     O += P_{i-1} V_{i-1}, waits only for S_i, runs the softmax of tile i
//     while the tensor cores do P V, then waits for P V, releases stage i-1,
//     rescales O by alpha_i and repacks P_i.
//   - Occupancy. A block is 4 G + 1 warps, and an SM's registers are four
//     banks of 16384, one per warp scheduler. At G = 1 three blocks share an
//     SM at <= 128 registers a thread (15 warps: four to a bank); at G = 2
//     and 4 one block does (shared memory), G = 4 at <= 96 registers (17
//     warps: five to a bank). ptxas -v: the stream kernel 110-118
//     registers, 128 packed under the float32 interior (4 bytes spilled);
//     the nt kernel 111 at G = 1 and 2, 94 at G = 4 (144 bytes spilled).
// What bounds it: the operations (4 kvl^2 H Dh at 989 TFLOP/s) in theory;
// on the card the elementwise softmax per (query, key) pair and how far one
// warpgroup's softmax runs under another's products, not the bytes it
// reads: with no K/V copy after the ring's first round (wrong values,
// timing only) the kernel at [1, 32768] ran 3.6 % faster, though it moves
// 27.8 GB from L2 a launch, and blocks of 2, 3 or 4 query tiles sharing one
// K/V ring ran no faster at the long shapes than these one-tile blocks,
// slower at some (PERF.md). Under the bf16 interior each score takes three
// bf16 roundings, an exp and a handful of adds. The roundings run on pairs:
// s and p by one cvt.rn.bf16x2.f32 for two scores, and s - R(m') as one
// sub.rn.bf16x2 on the pair of s kept packed (with the max as max.bf16x2),
// whose single rounding gives the float32 subtraction's rounded value, so
// the bits are the plain version's; the exp runs as ex2.approx (exp_fast).
// Pairing s and p and exp_fast took the [1, 32768] forward from ~9.2 ms
// (one cvt per score, expf) to ~5.5 ms on an H100, the packed subtraction
// 7-12 % further at every shape (PERF.md). Neither a fourth block an SM (at
// a 2-stage ring) nor one empty-barrier arrive per warp gained anything.
//
// What was hard. The ring needs the per-key flags beside K and V, and a
// bulk copy cannot take the uint8 key_valid row (no 16-byte alignment at
// b * T): the producer warp's lanes write them, and the full barrier counts
// their 32 arrivals beside lane 0's TMA bytes. The stream and nt semantics
// differ only in the sweep, the live rows and the LSE, so one mainloop
// takes both as template flags; nt's kvl, which its wrapper does not
// compute, is found by each block in one pass over key_valid. The dense and
// the long-T forward differ only in the sweep, which their wrappers take
// from one record made per batch (`attention_sweep`), so one kernel serves
// both and no block scans key_valid or the segments for it.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math_constants.h>
#include <stdint.h>

#include "hopper.cuh"

namespace fwd_tc {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int BQ = ROWS;  // query rows of a tile
constexpr int BK = ROWS;  // keys of a tile: the online-softmax step
constexpr int DH = TC_DH;
constexpr int CONSUMERS = 128;  // threads of a consumer warpgroup
constexpr unsigned TILE_BYTES = BQ * DH * 2;
constexpr float MASK_BIAS = -1e9f;  // NEG_INF of repurpose_tpu/ops/attention.py
constexpr float SKIP_LSE = 1e30f;
constexpr float M_INIT = -1e30f;

// Launch geometry per heads-per-block G (static data, usable in
// __launch_bounds__ and device code alike).
template <int G>
struct Cfg {
  static constexpr int STAGES = G == 4 ? 2 : 3;  // 3 at G = 4 passes 227 KB
  static constexpr int THREADS = G * CONSUMERS + 32;
  static constexpr int MIN_BLOCKS = G == 1 ? 3 : 1;
};

template <int G>
struct __align__(1024) Smem {
  static constexpr int S = Cfg<G>::STAGES;
  bf16 q[G][BQ * DH];
  bf16 k[S][G][BK * DH];
  bf16 v[S][G][BK * DH];
  float kbias[S][BK];  // 0 valid, -1e9 masked, -inf past T
  int kseg[S][BK];     // the key's segment (packed)
  uint64_t own, full[S], empty[S];
};

// + 1024: the dynamic window is aligned by hand to the swizzle's period.
template <int G>
constexpr size_t smem_bytes() {
  return sizeof(Smem<G>) + 1024;
}
// (Each block also holds 1 KB of the SM's shared memory and a little static
// shared memory of its own.)
static_assert(3 * (sizeof(Smem<1>) + 2048) <= 233472, "G = 1: three blocks no longer share an SM");
static_assert(smem_bytes<2>() + 1024 <= 232448, "G = 2: past the shared memory of a block");
static_assert(smem_bytes<4>() + 1024 <= 232448, "G = 4: past the shared memory of a block");

struct Params {
  CUtensorMap q, k, v;       // [B, T, H, 64] bf16 views
  const uint8_t* key_valid;  // [B, T]
  const int* seg_ids;        // [B, T], packed only
  const int* kvl;            // [B]: last valid key + 1 (stream); null: scanned (nt)
  const int* tile_lo;        // [B, ceil(T / 64)] key-tile bounds, packed only
  const int* tile_hi;
  bf16* out;   // [B, T, H * 64]
  float* lse;  // [B, H, T], or null (nt)
  int T, H;
  float scale;
};

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// a and b rounded to bf16 (to nearest, ties to even), as floats: one paired
// conversion (cvt.rn.bf16x2.f32) and two bit moves. The three roundings per
// score under the bf16 interior are the costliest part of the softmax step;
// pairing them halves the conversions (one value at a time, or integer
// arithmetic on the bits, left the kernel 1.6-1.7x slower on an H100).
__device__ __forceinline__ void round_bf16x2(float& a, float& b) {
  __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  const uint32_t u = *reinterpret_cast<uint32_t*>(&v);
  a = __uint_as_float(u << 16);
  b = __uint_as_float(u & 0xFFFF0000u);
}

// e**x as 2**(x log2 e) by the hardware's ex2.approx: relative error under
// ~1e-5 where p is not 0 (|x| < 88; the rounding of x log2 e dominates),
// far under the bf16 ulp p is rounded to and the tolerance of the float32
// interior; results below 2**-126 flush to 0.
__device__ __forceinline__ float exp_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

// Two floats as one bf16x2 register (lo, hi), each rounded to nearest
// (ties to even): one cvt.rn.bf16x2.f32; and its halves back as floats.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ float lo_bf16(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float hi_bf16(uint32_t u) { return __uint_as_float(u & 0xFFFF0000u); }

__device__ __forceinline__ uint32_t max_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("max.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// a - b on bf16 pairs, rounded once to bf16 (to nearest, ties to even). For
// finite bf16 a and b this equals R(float32(a - b)), the float32
// subtraction's two roundings (checked for every pair on the CPU: tests/
// test_torch_flash_stream.py); a result below bf16's normal range goes to
// exp_fast, whose .ftz input gives 1 for it as for a flushed 0.
__device__ __forceinline__ uint32_t sub_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("sub.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// One online-softmax step on the S accumulator of a key tile, in place: s
// becomes p (see the note at the top). `kbias` / `kseg` are the tile's keys,
// `qseg` the segments of this thread's rows r and r + 8; m and l (l per
// thread: this thread's columns only) advance, alpha is returned per row.
// Scores go in pairs (a row's columns c and c + 1). The bf16 interior keeps
// each pair's s as one bf16x2 register: the max and s - R(m') run on the
// pairs (max.bf16x2, sub.rn.bf16x2), so of its three roundings only those
// of s and p are conversions; the float32 interior runs on floats.
template <bool SM_BF16, bool PACKED>
__device__ __forceinline__ void softmax_step(float (&sc)[32], const float* kbias,
                                             const int* kseg, const int (&qseg)[2],
                                             float (&m)[2], float (&l)[2], float (&alpha)[2],
                                             int c0) {
  uint32_t s2[SM_BF16 ? 16 : 1];  // the bf16 interior's s, pair i = sc[2i], sc[2i + 1]
  uint32_t mx2[2] = {0xFF80FF80u, 0xFF80FF80u};  // -inf, -inf
  float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const float2 kb = *reinterpret_cast<const float2*>(kbias + 8 * n + c0);
    int2 ks = make_int2(0, 0);
    if constexpr (PACKED) ks = *reinterpret_cast<const int2*>(kseg + 8 * n + c0);
#pragma unroll
    for (int row = 0; row < 2; ++row) {
      float b0 = kb.x, b1 = kb.y;
      if constexpr (PACKED) {
        if (ks.x != qseg[row]) b0 = fminf(b0, MASK_BIAS);
        if (ks.y != qseg[row]) b1 = fminf(b1, MASK_BIAS);
      }
      const float x0 = sc[4 * n + 2 * row] + b0, x1 = sc[4 * n + 2 * row + 1] + b1;
      if constexpr (SM_BF16) {
        s2[2 * n + row] = pack_bf16x2(x0, x1);
        mx2[row] = max_bf16x2(mx2[row], s2[2 * n + row]);
      } else {
        sc[4 * n + 2 * row] = x0;
        sc[4 * n + 2 * row + 1] = x1;
        mx[row] = fmaxf(mx[row], fmaxf(x0, x1));
      }
    }
  }
  uint32_t m2[2];  // R(m') in both halves
  float m_sm[2];
#pragma unroll
  for (int row = 0; row < 2; ++row) {
    if constexpr (SM_BF16) mx[row] = fmaxf(lo_bf16(mx2[row]), hi_bf16(mx2[row]));
    mx[row] = fmaxf(mx[row], __shfl_xor_sync(0xffffffffu, mx[row], 1));
    mx[row] = fmaxf(mx[row], __shfl_xor_sync(0xffffffffu, mx[row], 2));
    const float m_new = fmaxf(m[row], mx[row]);
    alpha[row] = expf(m[row] - m_new);
    m_sm[row] = SM_BF16 ? round_bf16(m_new) : m_new;
    if constexpr (SM_BF16) m2[row] = (__float_as_uint(m_sm[row]) >> 16) * 0x10001u;
    m[row] = m_new;
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const int row = (i >> 1) & 1;
    float y0, y1;
    if constexpr (SM_BF16) {
      const uint32_t y = sub_bf16x2(s2[i >> 1], m2[row]);
      y0 = lo_bf16(y);
      y1 = hi_bf16(y);
    } else {
      y0 = sc[i] - m_sm[row];
      y1 = sc[i + 1] - m_sm[row];
    }
    float p0 = exp_fast(y0), p1 = exp_fast(y1);
    if constexpr (SM_BF16) round_bf16x2(p0, p1);
    sc[i] = p0;
    sc[i + 1] = p1;
    sum[row] += p0 + p1;
  }
  l[0] = l[0] * alpha[0] + sum[0];
  l[1] = l[1] * alpha[1] + sum[1];
}

// Out rows q0..q0 + 63 (those before T) of one head: 0, and lse = SKIP_LSE
// (the stream semantics' dead tile).
__device__ void skip_tile(const Params& p, int b, int h, int q0) {
  const long long D = (long long)p.H * DH;
  bf16* out_bh = p.out + (long long)b * p.T * D + h * DH;
  for (int idx = threadIdx.x; idx < BQ * 8; idx += blockDim.x) {
    const int t = q0 + idx / 8;
    if (t < p.T)
      *reinterpret_cast<uint4*>(out_bh + (long long)t * D + (idx % 8) * 8) = make_uint4(0, 0, 0, 0);
  }
  float* lse_bh = p.lse + ((long long)b * p.H + h) * p.T;
  for (int r = threadIdx.x; r < BQ; r += blockDim.x)
    if (q0 + r < p.T) lse_bh[q0 + r] = SKIP_LSE;
}

// The block: G heads h0.. of query tile blockIdx.x, batch row blockIdx.z.
// NT: the no-transpose semantics (every row computed, the sweep to kvl or,
// with no valid key, all of T; no LSE); else the stream semantics (the
// sweep from the wrapper's kvl and, PACKED, tile bounds; rows at or past kvl
// and dead tiles get 0 / SKIP_LSE).
template <int G, bool SM_BF16, bool PACKED, bool NT>
__device__ __forceinline__ void run_block(const Params& p) {
  static_assert(NT || G == 1, "the stream semantics run one head a block");
  using C = Cfg<G>;
  constexpr int S = C::STAGES;
  extern __shared__ unsigned char smem_raw[];
  Smem<G>& s = *reinterpret_cast<Smem<G>*>(
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023));
  const int qt = blockIdx.x, q0 = qt * BQ, h0 = blockIdx.y * G, b = blockIdx.z;
  const int tid = threadIdx.x, T_len = p.T;
  const uint8_t* valid_row = p.key_valid + (long long)b * T_len;
  const int* seg_row = PACKED ? p.seg_ids + (long long)b * T_len : nullptr;

  // the sweep, in 64-key tiles
  int kvl, kt_lo = 0, kt_hi;
  if constexpr (NT) {
    __shared__ int s_kvl;
    if (tid == 0) s_kvl = 0;
    __syncthreads();
    int last = 0;
    for (int j = tid; j < T_len; j += C::THREADS)
      if (valid_row[j]) last = j + 1;
    atomicMax(&s_kvl, last);
    __syncthreads();
    kvl = s_kvl;
    kt_hi = ((kvl > 0 ? kvl : T_len) + BK - 1) / BK;
  } else {
    kvl = p.kvl[b];
    kt_hi = (kvl + BK - 1) / BK;
    if constexpr (PACKED) {
      const long long n_tiles = (T_len + BQ - 1) / BQ;
      kt_lo = p.tile_lo[(long long)b * n_tiles + qt];
      kt_hi = min(p.tile_hi[(long long)b * n_tiles + qt], kt_hi);
    }
    if (q0 >= kvl || kt_lo >= kt_hi) {  // padding rows, or no key to sweep
      skip_tile(p, b, h0, q0);
      return;
    }
  }
  if (tid == 0) {
    mbar_init(&s.own, 1);
    for (int i = 0; i < S; ++i) {
      mbar_init(&s.full[i], 32);
      mbar_init(&s.empty[i], G * CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the role, read through a shuffle so that the compiler sees it is
  // warp-uniform, as the consumers' wgmma need
  const int g = __shfl_sync(0xffffffffu, tid / CONSUMERS, 0);
  if (g == G) {
    // the producer warp: lane 0 issues the copies, every lane writes the
    // bias (and segment) of two keys per tile
    const int lane = tid % 32;
    if (lane == 0) {
      mbar_arrive_expect_tx(&s.own, G * TILE_BYTES);
      for (int i = 0; i < G; ++i) tma_load_rows(s.q[i], &p.q, &s.own, h0 + i, q0, b);
    }
    for (int kt = kt_lo, i = 0; kt < kt_hi; ++kt, ++i) {
      const int st = i % S;
      mbar_wait(&s.empty[st], ((i / S) & 1) ^ 1);  // the first round passes
#pragma unroll
      for (int part = 0; part < BK / 32; ++part) {
        const int c = lane + 32 * part, j = kt * BK + c;
        s.kbias[st][c] = j < T_len ? (valid_row[j] ? 0.f : MASK_BIAS) : -CUDART_INF_F;
        if constexpr (PACKED) s.kseg[st][c] = j < T_len ? seg_row[j] : INT_MIN;
      }
      if (lane == 0) {
        mbar_arrive_expect_tx(&s.full[st], 2 * G * TILE_BYTES);
        for (int i2 = 0; i2 < G; ++i2) {
          tma_load_rows(s.k[st][i2], &p.k, &s.full[st], h0 + i2, kt * BK, b);
          tma_load_rows(s.v[st][i2], &p.v, &s.full[st], h0 + i2, kt * BK, b);
        }
      } else {
        mbar_arrive(&s.full[st]);
      }
    }
    return;
  }

  // consumer warpgroup g: head h0 + g; rows r and r + 8 of the tile, columns
  // c0 + 8n and c0 + 8n + 1
  const int t = tid % CONSUMERS, lane = t % 32;
  const int r = 16 * (t / 32) + lane / 4, c0 = 2 * (lane % 4);
  int qseg[2] = {0, 0};
  if constexpr (PACKED) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = q0 + r + 8 * half;
      qseg[half] = row < T_len ? seg_row[row] : INT_MIN;
    }
  }
  mbar_wait(&s.own, 0);
  {  // q_s = round(float(q) * scale), in place (the swizzle does not matter)
    uint4* q4 = reinterpret_cast<uint4*>(s.q[g]);
    for (int i = t; i < BQ * DH / 8; i += CONSUMERS) {
      uint4 raw = q4[i];
      bf16* e = reinterpret_cast<bf16*>(&raw);
#pragma unroll
      for (int j = 0; j < 8; ++j) e[j] = __float2bfloat16_rn(__bfloat162float(e[j]) * p.scale);
      q4[i] = raw;
    }
    fence_async_shared();
    named_barrier(1 + g, CONSUMERS);
  }
  const uint64_t dQ = sw128_desc(s.q[g], 16, SW_GROUP);
  float o[32], sc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = sc[i] = 0.f;
  float m[2] = {M_INIT, M_INIT}, l[2] = {0.f, 0.f}, alpha[2];
  uint32_t pa[4][4];  // P of the previous tile, read by its P V product

  // key tile 0: S and its softmax step
  mbar_wait(&s.full[0], 0);
  {
    const uint64_t dK = sw128_desc(s.k[0][g], 16, SW_GROUP);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_ss(sc, dQ + K_STEP * kk, dK + K_STEP * kk, kk);
    wg_commit();
    wg_wait<0>();
    reg_fence(sc);
  }
  softmax_step<SM_BF16, PACKED>(sc, s.kbias[0], s.kseg[0], qseg, m, l, alpha, c0);
  acc_to_a<SM_BF16>(sc, pa);

  const int n = kt_hi - kt_lo;
  for (int i = 1; i < n; ++i) {
    const int st = i % S, prev = (i - 1) % S;
    mbar_wait(&s.full[st], (i / S) & 1);
    const uint64_t dK = sw128_desc(s.k[st][g], 16, SW_GROUP);
    const uint64_t dV = sw128_desc(s.v[prev][g], SW_GROUP, SW_GROUP);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_ss(sc, dQ + K_STEP * kk, dK + K_STEP * kk, kk);  // S_i
    wg_commit();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs_tb(o, pa[kk], dV + MN_STEP * kk);  // O += P V
    wg_commit();
    wg_wait<1>();  // S_i is in; P V runs under the softmax step
    reg_fence(sc);
    softmax_step<SM_BF16, PACKED>(sc, s.kbias[st], s.kseg[st], qseg, m, l, alpha, c0);
    wg_wait<0>();
    reg_fence(o);
    reg_fence(pa);
    mbar_arrive(&s.empty[prev]);  // done with stage i - 1
#pragma unroll
    for (int j = 0; j < 32; ++j) o[j] *= alpha[(j >> 1) & 1];
    acc_to_a<SM_BF16>(sc, pa);
  }
  {  // the last tile's P V
    const uint64_t dV = sw128_desc(s.v[(n - 1) % S][g], SW_GROUP, SW_GROUP);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs_tb(o, pa[kk], dV + MN_STEP * kk);
    wg_commit();
    wg_wait<0>();
    reg_fence(o);
  }

  // epilogue: out = O / l (stream: 0 at or past kvl), lse = m + log(l)
  const int h = h0 + g;
  const long long D = (long long)p.H * DH;
  bf16* out_bh = p.out + (long long)b * T_len * D + h * DH;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float lt = l[half];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const int row = q0 + r + 8 * half;
    if (row >= T_len) continue;
    const bool live = NT || row < kvl;
    bf16* dst = out_bh + (long long)row * D;
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
      const float x0 = live ? o[4 * nb + 2 * half] / lt : 0.f;
      const float x1 = live ? o[4 * nb + 2 * half + 1] / lt : 0.f;
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * nb + c0) = __floats2bfloat162_rn(x0, x1);
    }
    if constexpr (!NT) {
      if (lane % 4 == 0)
        p.lse[((long long)b * p.H + h) * T_len + row] = live ? m[half] + logf(lt) : SKIP_LSE;
    }
  }
}

// Encodes the three tensor maps of q/k/v ([B, T, H, 64] bf16 views with
// element strides (batch, token, head) in `strides`, 9 values).
inline int encode_qkv(Params& p, const void* q, const void* k, const void* v,
                      const long long* strides, int B, int T_len, int H) {
  const void* bases[3] = {q, k, v};
  CUtensorMap* maps[3] = {&p.q, &p.k, &p.v};
  for (int i = 0; i < 3; ++i) {
    const int err = encode_rows(maps[i], bases[i], B, T_len, H, strides[3 * i],
                                strides[3 * i + 1], strides[3 * i + 2]);
    if (err != 0) return err;
  }
  return 0;
}

// Launches `kernel` (a __global__ wrapper of run_block<G, ...>) over the
// query tiles, head groups and batch rows; returns cudaGetLastError().
template <int G>
int launch(void (*kernel)(Params), const Params& p, int B, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<G>();
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((p.T + BQ - 1) / BQ, p.H / G, B);
  kernel<<<grid, Cfg<G>::THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace fwd_tc
