// Masked multi-head attention backward for Hopper (sm_90a), T <= 2048 (the
// training step): two kernels, dq and dk/dv, each computing its own gradient
// with no atomics (deterministic).
//
// Replaces the TPU kernels of repurpose_tpu/ops/flash_attention.py:
//   - `_bwd_dq_kernel` (line 783; pallas_calls lines 1411, 1439), unpacked
//     and packed, by flash_bwd_dq_tc_kernel (bf16 at Dh 64) and
//     flash_bwd_dq_kernel (every other instance);
//   - `_bwd_dkv_kernel` + `_dkv_compute` (lines 1109, 1149; pallas_calls
//     lines 1528, 1599), unpacked and packed, by flash_bwd_dkv_tc_kernel and
//     flash_bwd_dkv_kernel.
// A null `seg_ids` (tensor-core: a null lo / hi) selects the unpacked
// variant of each. The tensor-core pair's bias-form instances are the
// long-T backward's bf16 Dh 64 kernels too (flash_bwd_stream.cu names the
// TPU kernels they replace there).
//
// What they compute, with the saved forward out `o` and lse, the upstream
// gradient `g`, scale = 1/sqrt(Dh), per batch row b and head h:
//   q_s   = round_to_input_dtype(float(q) * scale)
//   s_ij  = dot(q_s_i, k_j) in float32
//   p_ij  = exp(R(s_ij + bias_j - lse_i))         unpacked, bias_j = 0 or -1e9
//   p_ij  = allowed(i, j) ? exp(R(s_ij - lse_i)) : 0    packed (select form:
//           masked entries are selected away, never multiplied by a mask,
//           since exp of a masked score may overflow)
//   dp_ij = dot(g_i, v_j) in float32
//   d_i   = sum_d g_id * o_id in float32           (delta)
//   ds_ij = R(p_ij * R(dp_ij - d_i))
//   dq_i  = scale * sum_j in(ds_ij) k_j            float32 sums
//   dk_j  = sum_i in(ds_ij) q_s_i                  (no extra scale: q_s has it)
//   dv_j  = sum_i in(p_ij) g_i
// R(.) rounds to the softmax interior's type (bf16 when sm_bf16, and the exp
// is then rounded to bf16 as well); in(.) rounds to the input dtype. Outputs
// are in the input dtype. Skipping, as on the TPU: dq rows at or past kvl
// (last valid key + 1 of the batch row) and dk/dv rows at or past kvl are 0;
// query rows past kvl carry lse = 1e30 from the forward, so their p is 0 and
// the dk/dv sweep over query tiles stops at kvl.
//
// What bounds them. At the training shapes ([6, 2048, 8, 64] bf16, packed
// rows ~90 % full) each kernel does three (dq: s, dp, dq) or four (dk/dv:
// s, dp, dv, dk) products of 2*Dh operations per allowed (query, key) pair,
// ~100 GFLOP together, ~0.1 ms at 989 TFLOP/s, against ~50 MB of traffic
// (~15 us at 3.35 TB/s): they are bound by operations.
//
// Two designs share the contract above.
//
// bf16 at Dh 64 (the model's shape) takes the tensor-core kernels,
// flash_bwd_{dq,dkv}_tc_kernel: the select-form instances of the wgmma/TMA
// mainloops of flash_bwd_tc.cuh (the design is there), whose bias-form
// instances are the long-T backward. They read the outputs of
// flash_bwd_stream_prep_kernel (q_s, {lse, delta}, {key flag, segment}),
// made once per backward, and sweep 64-row tiles [0, ceil(kvl / 64)) and,
// packed, only the tiles [lo, hi) that hold every position of each segment
// id owning a row of the tile (`segment_tile_bounds` at 64/64, wherever the
// id's positions lie): in the select form every pair left out has p = 0 and
// so ds = 0, so the bounded sweep adds exactly what the full one would, for
// any layout. Unpacked, the select and the bias form are the same function.
//
// Every other instance (float32, which must keep float32 parity and so
// cannot use TF32 tensor cores, and bf16 at Dh 16, 32 and 128) keeps the
// first design. The TPU kernels hold a whole [Tq, T] (dq) or [T, Tk] (dk/dv)
// float32 slab in VMEM; a Hopper block has 227 KB of shared memory, so here
// one block owns a 64-row query tile (dq) or a 64-row key tile (dk/dv) of
// one head and sweeps the other axis in 64-row tiles up to kvl, accumulating
// in float32 registers (bf16: wmma 16x16x16 on the tensor cores) or shared
// memory (float32: scalar FMAs, since TF32 would lose float32 parity). The
// saved lse normalises every tile exactly, so no online rescaling is needed.
// The two-kernel split keeps results deterministic; it recomputes s and dp
// in both kernels. The bf16 dk/dv kernel stages its register accumulators
// for the store in the query tile's shared memory, which keeps it at two
// blocks per SM, and delta is summed by two threads per row with every load
// in flight at once. This design has no bf16 Dh 64 instance.
//
// Layout: q/k/v/g/o are read through (batch, token, head) strides with a
// contiguous Dh axis and 16-byte row starts; lse is [B, H, T] float32;
// dq/dk/dv are written [B, T, H, Dh] contiguous. Dh is 16, 32, 64 or 128; T is
// any length >= 1 (the ragged edge is masked).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

#include "flash_bwd_tc.cuh"

namespace {

constexpr int BQ = 64;  // query rows per tile: four warps of 16
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr float MASK_BIAS = -1e9f;  // NEG_INF of repurpose_tpu/ops/attention.py
constexpr float SKIP_LSE = 1e30f;
constexpr int NO_SEG = INT_MIN;  // segment of a query row past T: matches no key

using bf16 = __nv_bfloat16;

struct Strides {
  long long b, t, h;  // in elements
};

struct Args {
  const void *q, *k, *v, *g, *o;
  Strides sq, sk, sv, sg, so;
  const uint8_t* key_valid;
  const int* seg_ids;  // null: unpacked
  const float* lse;
  void *dq, *dk, *dv;
  int T, H;
  float scale;
  int sm_bf16;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16_rn(x); }

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Tile geometry for one (element type, head width).
template <typename T, int DH>
struct Geo {
  static constexpr bool kBf16 = std::is_same<T, bf16>::value;
  // keys per tile: 64, except float32 at Dh 128, where 32 keeps the dk/dv
  // kernel's shared memory under 227 KB
  static constexpr int BK = (kBf16 || DH <= 64) ? 64 : 32;
  // bf16 rows pad by 8 elements (wmma wants 32-byte aligned tile starts and a
  // stride that is a multiple of 8); float32 rows pad by 1 so the scalar
  // loops walk distinct banks
  static constexpr int LD = DH + (kBf16 ? 8 : 1);   // Q, G, K, V tiles
  static constexpr int LDS = BK + 4;                 // float32 s and dp tiles
  static constexpr int LDP = BK + (kBf16 ? 8 : 1);  // p and ds in T
  static constexpr int LDA = DH + 4;                 // float32 accumulators
  static constexpr int VEC = 16 / sizeof(T);         // elements per 16 bytes
  static constexpr size_t align(size_t x) { return (x + 127) / 128 * 128; }
  static constexpr size_t tile(int rows) { return align(sizeof(T) * rows * LD); }
  static constexpr size_t f32(int n) { return align(sizeof(float) * n); }
};

// Shared memory of the dq kernel.
template <typename T, int DH>
struct DqSmem {
  using G = Geo<T, DH>;
  static constexpr size_t kQ = 0;
  static constexpr size_t kG = kQ + G::tile(BQ);
  static constexpr size_t kK = kG + G::tile(BQ);
  static constexpr size_t kV = kK + G::tile(G::BK);
  static constexpr size_t kS = kV + G::tile(G::BK);
  static constexpr size_t kDP = kS + G::f32(BQ * G::LDS);
  static constexpr size_t kDS = kDP + G::f32(BQ * G::LDS);
  static constexpr size_t kAcc = kDS + G::align(sizeof(T) * BQ * G::LDP);
  static constexpr size_t kKeyOk = kAcc + G::f32(BQ * G::LDA);
  static constexpr size_t kKeySeg = kKeyOk + G::f32(G::BK);
  static constexpr size_t kQSeg = kKeySeg + G::f32(G::BK);
  static constexpr size_t kLse = kQSeg + G::f32(BQ);
  static constexpr size_t kDelta = kLse + G::f32(BQ);
  static constexpr size_t kBytes = kDelta + G::f32(BQ);
};

// Shared memory of the dk/dv kernel. bf16 accumulates dk/dv in registers and
// stages them for the store in the per-query-tile region (Q .. ds), free
// after the sweep: that keeps the bf16 kernel at two blocks per SM.
template <typename T, int DH>
struct DkvSmem {
  using G = Geo<T, DH>;
  static constexpr size_t kK = 0;
  static constexpr size_t kV = kK + G::tile(G::BK);
  static constexpr size_t kQ = kV + G::tile(G::BK);
  static constexpr size_t kG = kQ + G::tile(BQ);
  static constexpr size_t kS = kG + G::tile(BQ);
  static constexpr size_t kDP = kS + G::f32(BQ * G::LDS);
  static constexpr size_t kP = kDP + G::f32(BQ * G::LDS);
  static constexpr size_t kDS = kP + G::align(sizeof(T) * BQ * G::LDP);
  static constexpr size_t kTileEnd = kDS + G::align(sizeof(T) * BQ * G::LDP);
  static constexpr size_t kAccK = G::kBf16 ? kQ : kTileEnd;
  static constexpr size_t kAccV = kAccK + G::f32(G::BK * G::LDA);
  static constexpr size_t kAccEnd = kAccV + G::f32(G::BK * G::LDA);
  static_assert(!G::kBf16 || kAccEnd <= kTileEnd, "staging overflows the tile region");
  static constexpr size_t kKeyOk = G::kBf16 ? kTileEnd : kAccEnd;
  static constexpr size_t kKeySeg = kKeyOk + G::f32(G::BK);
  static constexpr size_t kQSeg = kKeySeg + G::f32(G::BK);
  static constexpr size_t kLse = kQSeg + G::f32(BQ);
  static constexpr size_t kDelta = kLse + G::f32(BQ);
  static constexpr size_t kBytes = kDelta + G::f32(BQ);
};

// Last valid key + 1 of batch row `valid_row` (0 when none is valid).
__device__ int kv_len(const uint8_t* valid_row, int T_len, int* s_kvl) {
  if (threadIdx.x == 0) *s_kvl = 0;
  __syncthreads();
  int last = 0;
  for (int j = threadIdx.x; j < T_len; j += THREADS)
    if (valid_row[j]) last = j + 1;
  atomicMax(s_kvl, last);
  __syncthreads();
  return *s_kvl;
}

// Copies `rows` rows row0.. of one head into shared memory, zero-filling rows
// at or past T. With `scale` > 0 each element becomes round(float(x) * scale).
template <typename T, int DH>
__device__ void load_rows(T* dst, const T* src, long long row_stride, int row0, int rows,
                          int T_len, float scale) {
  using G = Geo<T, DH>;
  constexpr int CH = DH / G::VEC;
  for (int idx = threadIdx.x; idx < rows * CH; idx += THREADS) {
    const int r = idx / CH, ch = idx % CH;
    T* d = dst + r * G::LD + ch * G::VEC;
    if (row0 + r < T_len) {
      const uint4 raw = *reinterpret_cast<const uint4*>(
          src + (long long)(row0 + r) * row_stride + ch * G::VEC);
      const T* vals = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int e = 0; e < G::VEC; ++e)
        d[e] = scale > 0.f ? from_f<T>(to_f(vals[e]) * scale) : vals[e];
    } else {
#pragma unroll
      for (int e = 0; e < G::VEC; ++e) d[e] = from_f<T>(0.f);
    }
  }
}

// Writes `rows` rows row0.. of one head of a [B, T, H, Dh] output from a
// float32 tile (times `mul`), or zeros for rows at or past kvl.
template <typename T, int DH>
__device__ void store_rows(T* out_bh, long long row_stride, const float* acc, int row0,
                           int rows, int T_len, int kvl, float mul) {
  using G = Geo<T, DH>;
  constexpr int CH = DH / G::VEC;
  for (int idx = threadIdx.x; idx < rows * CH; idx += THREADS) {
    const int r = idx / CH, ch = idx % CH, t = row0 + r;
    if (t >= T_len) continue;
    __align__(16) T vals[G::VEC];
#pragma unroll
    for (int e = 0; e < G::VEC; ++e)
      vals[e] = from_f<T>(acc != nullptr && t < kvl
                              ? acc[r * G::LDA + ch * G::VEC + e] * mul : 0.f);
    *reinterpret_cast<uint4*>(out_bh + t * row_stride + ch * G::VEC) =
        *reinterpret_cast<const uint4*>(vals);
  }
}

// C[16 rows of this warp, BK] = A[16 rows, Dh] . B[BK, Dh]^T in float32.
template <typename T, int DH>
__device__ void warp_abt(const T* sA, const T* sB, float* sC, int warp, int lane) {
  using G = Geo<T, DH>;
  if constexpr (G::kBf16) {
    using namespace nvcuda;
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[DH / 16];
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      wmma::load_matrix_sync(a[kk], sA + warp * 16 * G::LD + kk * 16, G::LD);
#pragma unroll
    for (int n = 0; n < G::BK / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        // B^T as a column-major [Dh, 16] operand is B's own row-major tile
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bt;
        wmma::load_matrix_sync(bt, sB + n * 16 * G::LD + kk * 16, G::LD);
        wmma::mma_sync(acc, a[kk], bt, acc);
      }
      wmma::store_matrix_sync(sC + warp * 16 * G::LDS + n * 16, acc, G::LDS,
                              wmma::mem_row_major);
    }
  } else {
    const int r = warp * 16 + lane / 2, half = lane & 1;
    for (int i = 0; i < G::BK / 2; ++i) {
      const int c = 2 * i + half;
      float acc = 0.f;
#pragma unroll 8
      for (int d = 0; d < DH; ++d) acc += to_f(sA[r * G::LD + d]) * to_f(sB[c * G::LD + d]);
      sC[r * G::LDS + c] = acc;
    }
  }
}

// delta of the 64 query rows of a tile: sum_d g * o in float32 (g from the
// shared tile, o from device memory); 0 for rows at or past T. Two threads
// per row, each summing half of Dh, so every load is issued at once; row r
// is computed by threads 2r and 2r + 1, which sit in the warp that reads it.
template <typename T, int DH>
__device__ void tile_delta(const T* sG, const T* o_bh, long long o_row_stride, int row0,
                           int T_len, float* rowDelta) {
  using G = Geo<T, DH>;
  const int r = threadIdx.x / 2, half = threadIdx.x & 1, t = row0 + r;
  float acc = 0.f;
  if (t < T_len) {
    const T* o_row = o_bh + (long long)t * o_row_stride + half * (DH / 2);
    const T* g_row = sG + r * G::LD + half * (DH / 2);
#pragma unroll
    for (int d = 0; d < DH / 2; ++d) acc += to_f(g_row[d]) * to_f(o_row[d]);
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  if (half == 0) rowDelta[r] = acc;
}

// p and ds of this warp's 16 query rows against the key tile, from s and dp
// (the TPU kernels' rounding points); p goes to sP when it is given.
template <typename T, int DH>
__device__ void warp_probs(const float* sS, const float* sDP, T* sP, T* sDS,
                           const int* keyOk, const int* keySeg, const int* qSeg,
                           const float* rowLse, const float* rowDelta, bool packed,
                           int sm_bf16, int warp, int lane) {
  using G = Geo<T, DH>;
  const int r = warp * 16 + lane / 2, half = lane & 1;
  const float lse = rowLse[r], delta = rowDelta[r];
  const int qs = qSeg[r];
  for (int i = 0; i < G::BK / 2; ++i) {
    const int c = 2 * i + half;
    const int ok = keyOk[c];  // 1 valid, 0 masked, -1 past T (no such key)
    const float s = sS[r * G::LDS + c];
    float p = 0.f;
    if (packed) {
      if (ok == 1 && keySeg[c] == qs)
        p = sm_bf16 ? round_bf16(expf(round_bf16(s - lse))) : expf(s - lse);
    } else if (ok >= 0) {
      const float x = s + (ok ? 0.f : MASK_BIAS) - lse;
      p = sm_bf16 ? round_bf16(expf(round_bf16(x))) : expf(x);
    }
    const float dd = sDP[r * G::LDS + c] - delta;
    const float ds = sm_bf16 ? round_bf16(p * round_bf16(dd)) : p * dd;
    if (sP != nullptr) sP[r * G::LDP + c] = from_f<T>(p);
    sDS[r * G::LDP + c] = from_f<T>(ds);
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS) flash_bwd_dq_kernel(Args a) {
  using G = Geo<T, DH>;
  using L = DqSmem<T, DH>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem + L::kQ);
  T* sG = reinterpret_cast<T*>(smem + L::kG);
  T* sK = reinterpret_cast<T*>(smem + L::kK);
  T* sV = reinterpret_cast<T*>(smem + L::kV);
  float* sS = reinterpret_cast<float*>(smem + L::kS);
  float* sDP = reinterpret_cast<float*>(smem + L::kDP);
  T* sDS = reinterpret_cast<T*>(smem + L::kDS);
  float* sAcc = reinterpret_cast<float*>(smem + L::kAcc);
  int* keyOk = reinterpret_cast<int*>(smem + L::kKeyOk);
  int* keySeg = reinterpret_cast<int*>(smem + L::kKeySeg);
  int* qSeg = reinterpret_cast<int*>(smem + L::kQSeg);
  float* rowLse = reinterpret_cast<float*>(smem + L::kLse);
  float* rowDelta = reinterpret_cast<float*>(smem + L::kDelta);
  __shared__ int s_kvl;

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int T_len = a.T, H = a.H;
  const long long D = (long long)H * DH;
  const uint8_t* valid_row = a.key_valid + (long long)b * T_len;
  const int* seg_row = a.seg_ids ? a.seg_ids + (long long)b * T_len : nullptr;
  T* dq_bh = static_cast<T*>(a.dq) + (long long)b * T_len * D + h * DH;

  const int kvl = kv_len(valid_row, T_len, &s_kvl);
  if (q0 >= kvl) {  // padding rows: dq = 0
    store_rows<T, DH>(dq_bh, D, nullptr, q0, BQ, T_len, kvl, 0.f);
    return;
  }

  const T* q = static_cast<const T*>(a.q) + b * a.sq.b + h * a.sq.h;
  const T* k = static_cast<const T*>(a.k) + b * a.sk.b + h * a.sk.h;
  const T* v = static_cast<const T*>(a.v) + b * a.sv.b + h * a.sv.h;
  const T* g = static_cast<const T*>(a.g) + b * a.sg.b + h * a.sg.h;
  const T* o = static_cast<const T*>(a.o) + b * a.so.b + h * a.so.h;
  const float* lse_bh = a.lse + ((long long)b * H + h) * T_len;

  load_rows<T, DH>(sQ, q, a.sq.t, q0, BQ, T_len, a.scale);
  load_rows<T, DH>(sG, g, a.sg.t, q0, BQ, T_len, 0.f);
  for (int i = tid; i < BQ; i += THREADS) {
    const int t = q0 + i;
    qSeg[i] = t < T_len ? (seg_row ? seg_row[t] : 0) : NO_SEG;
    rowLse[i] = t < T_len ? lse_bh[t] : SKIP_LSE;
  }
  if constexpr (!G::kBf16)
    for (int i = tid; i < BQ * G::LDA; i += THREADS) sAcc[i] = 0.f;
  __syncthreads();
  tile_delta<T, DH>(sG, o, a.so.t, q0, T_len, rowDelta);

  using namespace nvcuda;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[DH / 16];
  if constexpr (G::kBf16) {
#pragma unroll
    for (int n = 0; n < DH / 16; ++n) wmma::fill_fragment(acc[n], 0.f);
  }

  const int n_tiles = (kvl + G::BK - 1) / G::BK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int j0 = kt * G::BK;
    __syncthreads();  // the previous tile's K/V are no longer read
    load_rows<T, DH>(sK, k, a.sk.t, j0, G::BK, T_len, 0.f);
    load_rows<T, DH>(sV, v, a.sv.t, j0, G::BK, T_len, 0.f);
    for (int c = tid; c < G::BK; c += THREADS) {
      const int j = j0 + c;
      keyOk[c] = j < T_len ? (valid_row[j] ? 1 : 0) : -1;
      keySeg[c] = (seg_row && j < T_len) ? seg_row[j] : 0;
    }
    __syncthreads();

    warp_abt<T, DH>(sQ, sK, sS, warp, lane);   // s
    warp_abt<T, DH>(sG, sV, sDP, warp, lane);  // dp
    __syncwarp();
    warp_probs<T, DH>(sS, sDP, nullptr, sDS, keyOk, keySeg, qSeg, rowLse, rowDelta,
                      seg_row != nullptr, a.sm_bf16, warp, lane);
    __syncwarp();

    // dq[16 rows] += ds[16 rows, BK] . K[BK, Dh]
    if constexpr (G::kBf16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> da[G::BK / 16];
#pragma unroll
      for (int kk = 0; kk < G::BK / 16; ++kk)
        wmma::load_matrix_sync(da[kk], sDS + warp * 16 * G::LDP + kk * 16, G::LDP);
#pragma unroll
      for (int n = 0; n < DH / 16; ++n) {
#pragma unroll
        for (int kk = 0; kk < G::BK / 16; ++kk) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> kb;
          wmma::load_matrix_sync(kb, sK + kk * 16 * G::LD + n * 16, G::LD);
          wmma::mma_sync(acc[n], da[kk], kb, acc[n]);
        }
      }
    } else {
      const int r = warp * 16 + lane / 2, half = lane & 1;
      for (int i = 0; i < DH / 2; ++i) {
        const int c = 2 * i + half;
        float sum = 0.f;
#pragma unroll 8
        for (int j = 0; j < G::BK; ++j) sum += to_f(sDS[r * G::LDP + j]) * to_f(sK[j * G::LD + c]);
        sAcc[r * G::LDA + c] += sum;
      }
    }
  }
  if constexpr (G::kBf16) {
#pragma unroll
    for (int n = 0; n < DH / 16; ++n)
      wmma::store_matrix_sync(sAcc + warp * 16 * G::LDA + n * 16, acc[n], G::LDA,
                              wmma::mem_row_major);
  }
  __syncthreads();
  store_rows<T, DH>(dq_bh, D, sAcc, q0, BQ, T_len, kvl, a.scale);
}

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS) flash_bwd_dkv_kernel(Args a) {
  using G = Geo<T, DH>;
  using L = DkvSmem<T, DH>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sK = reinterpret_cast<T*>(smem + L::kK);
  T* sV = reinterpret_cast<T*>(smem + L::kV);
  T* sQ = reinterpret_cast<T*>(smem + L::kQ);
  T* sG = reinterpret_cast<T*>(smem + L::kG);
  float* sS = reinterpret_cast<float*>(smem + L::kS);
  float* sDP = reinterpret_cast<float*>(smem + L::kDP);
  T* sP = reinterpret_cast<T*>(smem + L::kP);
  T* sDS = reinterpret_cast<T*>(smem + L::kDS);
  float* sAccK = reinterpret_cast<float*>(smem + L::kAccK);
  float* sAccV = reinterpret_cast<float*>(smem + L::kAccV);
  int* keyOk = reinterpret_cast<int*>(smem + L::kKeyOk);
  int* keySeg = reinterpret_cast<int*>(smem + L::kKeySeg);
  int* qSeg = reinterpret_cast<int*>(smem + L::kQSeg);
  float* rowLse = reinterpret_cast<float*>(smem + L::kLse);
  float* rowDelta = reinterpret_cast<float*>(smem + L::kDelta);
  __shared__ int s_kvl;

  const int j0 = blockIdx.x * G::BK, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int T_len = a.T, H = a.H;
  const long long D = (long long)H * DH;
  const uint8_t* valid_row = a.key_valid + (long long)b * T_len;
  const int* seg_row = a.seg_ids ? a.seg_ids + (long long)b * T_len : nullptr;
  T* dk_bh = static_cast<T*>(a.dk) + (long long)b * T_len * D + h * DH;
  T* dv_bh = static_cast<T*>(a.dv) + (long long)b * T_len * D + h * DH;

  const int kvl = kv_len(valid_row, T_len, &s_kvl);
  if (j0 >= kvl) {  // keys past the last valid one: dk = dv = 0
    store_rows<T, DH>(dk_bh, D, nullptr, j0, G::BK, T_len, kvl, 0.f);
    store_rows<T, DH>(dv_bh, D, nullptr, j0, G::BK, T_len, kvl, 0.f);
    return;
  }

  const T* q = static_cast<const T*>(a.q) + b * a.sq.b + h * a.sq.h;
  const T* k = static_cast<const T*>(a.k) + b * a.sk.b + h * a.sk.h;
  const T* v = static_cast<const T*>(a.v) + b * a.sv.b + h * a.sv.h;
  const T* g = static_cast<const T*>(a.g) + b * a.sg.b + h * a.sg.h;
  const T* o = static_cast<const T*>(a.o) + b * a.so.b + h * a.so.h;
  const float* lse_bh = a.lse + ((long long)b * H + h) * T_len;

  load_rows<T, DH>(sK, k, a.sk.t, j0, G::BK, T_len, 0.f);
  load_rows<T, DH>(sV, v, a.sv.t, j0, G::BK, T_len, 0.f);
  for (int c = tid; c < G::BK; c += THREADS) {
    const int j = j0 + c;
    keyOk[c] = j < T_len ? (valid_row[j] ? 1 : 0) : -1;
    keySeg[c] = (seg_row && j < T_len) ? seg_row[j] : 0;
  }
  if constexpr (!G::kBf16)
    for (int i = tid; i < G::BK * G::LDA; i += THREADS) sAccK[i] = sAccV[i] = 0.f;

  using namespace nvcuda;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> accK[DH / 16], accV[DH / 16];
  if constexpr (G::kBf16) {
#pragma unroll
    for (int n = 0; n < DH / 16; ++n) {
      wmma::fill_fragment(accK[n], 0.f);
      wmma::fill_fragment(accV[n], 0.f);
    }
  }

  const int n_tiles = (kvl + BQ - 1) / BQ;  // query rows past kvl have p = 0
  for (int qt = 0; qt < n_tiles; ++qt) {
    const int i0 = qt * BQ;
    __syncthreads();  // the previous tile's Q/G/p/ds are no longer read
    load_rows<T, DH>(sQ, q, a.sq.t, i0, BQ, T_len, a.scale);
    load_rows<T, DH>(sG, g, a.sg.t, i0, BQ, T_len, 0.f);
    for (int i = tid; i < BQ; i += THREADS) {
      const int t = i0 + i;
      qSeg[i] = t < T_len ? (seg_row ? seg_row[t] : 0) : NO_SEG;
      rowLse[i] = t < T_len ? lse_bh[t] : SKIP_LSE;
    }
    __syncthreads();

    tile_delta<T, DH>(sG, o, a.so.t, i0, T_len, rowDelta);
    warp_abt<T, DH>(sQ, sK, sS, warp, lane);   // s
    warp_abt<T, DH>(sG, sV, sDP, warp, lane);  // dp
    __syncwarp();
    warp_probs<T, DH>(sS, sDP, sP, sDS, keyOk, keySeg, qSeg, rowLse, rowDelta,
                      seg_row != nullptr, a.sm_bf16, warp, lane);
    __syncthreads();  // every query row's p and ds are in place

    // dv[keys] += p^T . G and dk[keys] += ds^T . Q_s over this query tile
    if constexpr (G::kBf16) {
      // this warp's 16 keys; p^T as a column-major [16 keys, 16 queries]
      // operand is p's own row-major tile
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> pa, da;
        wmma::load_matrix_sync(pa, sP + kk * 16 * G::LDP + warp * 16, G::LDP);
        wmma::load_matrix_sync(da, sDS + kk * 16 * G::LDP + warp * 16, G::LDP);
#pragma unroll
        for (int n = 0; n < DH / 16; ++n) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> gb, qb;
          wmma::load_matrix_sync(gb, sG + kk * 16 * G::LD + n * 16, G::LD);
          wmma::mma_sync(accV[n], pa, gb, accV[n]);
          wmma::load_matrix_sync(qb, sQ + kk * 16 * G::LD + n * 16, G::LD);
          wmma::mma_sync(accK[n], da, qb, accK[n]);
        }
      }
    } else {
      for (int idx = tid; idx < G::BK * DH; idx += THREADS) {
        const int c = idx / DH, d = idx % DH;
        float sv = 0.f, sk = 0.f;
#pragma unroll 8
        for (int i = 0; i < BQ; ++i) {
          sv += to_f(sP[i * G::LDP + c]) * to_f(sG[i * G::LD + d]);
          sk += to_f(sDS[i * G::LDP + c]) * to_f(sQ[i * G::LD + d]);
        }
        sAccV[c * G::LDA + d] += sv;
        sAccK[c * G::LDA + d] += sk;
      }
    }
  }
  if constexpr (G::kBf16) {
    __syncthreads();  // the staging overlays tiles other warps may still read
#pragma unroll
    for (int n = 0; n < DH / 16; ++n) {
      wmma::store_matrix_sync(sAccK + warp * 16 * G::LDA + n * 16, accK[n], G::LDA,
                              wmma::mem_row_major);
      wmma::store_matrix_sync(sAccV + warp * 16 * G::LDA + n * 16, accV[n], G::LDA,
                              wmma::mem_row_major);
    }
  }
  __syncthreads();
  store_rows<T, DH>(dk_bh, D, sAccK, j0, G::BK, T_len, kvl, 1.f);
  store_rows<T, DH>(dv_bh, D, sAccV, j0, G::BK, T_len, kvl, 1.f);
}

template <typename T, int DH>
int launch(bool dq, const Args& a, int B, cudaStream_t stream) {
  using G = Geo<T, DH>;
  const size_t smem = dq ? DqSmem<T, DH>::kBytes : DkvSmem<T, DH>::kBytes;
  void (*kernel)(Args) = dq ? &flash_bwd_dq_kernel<T, DH> : &flash_bwd_dkv_kernel<T, DH>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int tile = dq ? BQ : G::BK;
  dim3 grid((a.T + tile - 1) / tile, a.H, B);
  kernel<<<grid, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_dh(bool dq, int Dh, const Args& a, int B, cudaStream_t stream) {
  switch (Dh) {
    case 16: return launch<T, 16>(dq, a, B, stream);
    case 32: return launch<T, 32>(dq, a, B, stream);
    case 64:  // bf16 at Dh 64 takes the tensor-core kernels
      if constexpr (std::is_same<T, bf16>::value) return (int)cudaErrorInvalidValue;
      else return launch<T, 64>(dq, a, B, stream);
    case 128: return launch<T, 128>(dq, a, B, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

int run(bool dq, const void* q, const void* k, const void* v, const void* g,
        const void* o, const long long* strides, const void* key_valid,
        const void* seg_ids, const void* lse, void* out0, void* out1, int B, int T_len,
        int H, int Dh, int is_bf16, int sm_bf16, float scale, void* stream) {
  if (B <= 0 || T_len <= 0 || H <= 0) return 0;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.g = g;
  a.o = o;
  Strides* st[5] = {&a.sq, &a.sk, &a.sv, &a.sg, &a.so};
  for (int i = 0; i < 5; ++i) *st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  a.key_valid = static_cast<const uint8_t*>(key_valid);
  a.seg_ids = static_cast<const int*>(seg_ids);
  a.lse = static_cast<const float*>(lse);
  a.dq = dq ? out0 : nullptr;
  a.dk = dq ? nullptr : out0;
  a.dv = dq ? nullptr : out1;
  a.T = T_len;
  a.H = H;
  a.scale = scale;
  a.sm_bf16 = sm_bf16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch_dh<bf16>(dq, Dh, a, B, s) : dispatch_dh<float>(dq, Dh, a, B, s);
}

// ---- the tensor-core kernels: bf16 at Dh 64 ------------------------------------------

// The mainloops and their design: flash_bwd_tc.cuh. MASK: the select form
// (the dense backward) or the bias form (the long-T backward).
template <bool SM_BF16, bwd_tc::Mask MASK>
__global__ void __launch_bounds__(bwd_tc::THREADS, bwd_tc::DQ_MIN_BLOCKS)
    flash_bwd_dq_tc_kernel(const __grid_constant__ bwd_tc::Args a) {
  bwd_tc::dq_block<SM_BF16, MASK>(a);
}

template <bool SM_BF16, bwd_tc::Mask MASK>
__global__ void __launch_bounds__(bwd_tc::THREADS, bwd_tc::DKV_MIN_BLOCKS)
    flash_bwd_dkv_tc_kernel(const __grid_constant__ bwd_tc::Args a) {
  bwd_tc::dkv_block<SM_BF16, MASK>(a);
}

int run_tc(bool dq, const void* qs, const void* k, const void* v, const void* g,
           const long long* strides, const void* rows, const void* info, const void* kvl,
           const void* lo, const void* hi, void* out0, void* out1, int B, int T_len, int H,
           int sm_bf16, int select, float scale, cudaStream_t stream) {
  using bwd_tc::BIAS;
  using bwd_tc::SELECT;
  if (B <= 0 || T_len <= 0 || H <= 0) return 0;
  if (!kvl || (lo == nullptr) != (hi == nullptr)) return (int)cudaErrorInvalidValue;
  bwd_tc::Args a;
  const int err = bwd_tc::make_args(a, qs, k, v, g, strides, rows, info, kvl, lo, hi, out0,
                                    out1, B, T_len, H, scale);
  if (err != 0) return err;
  void (*const kernels[2][2][2])(bwd_tc::Args) = {  // [dq][sm_bf16][select]
      {{&flash_bwd_dkv_tc_kernel<false, BIAS>, &flash_bwd_dkv_tc_kernel<false, SELECT>},
       {&flash_bwd_dkv_tc_kernel<true, BIAS>, &flash_bwd_dkv_tc_kernel<true, SELECT>}},
      {{&flash_bwd_dq_tc_kernel<false, BIAS>, &flash_bwd_dq_tc_kernel<false, SELECT>},
       {&flash_bwd_dq_tc_kernel<true, BIAS>, &flash_bwd_dq_tc_kernel<true, SELECT>}}};
  return bwd_tc::launch(kernels[dq][sm_bf16 != 0][select != 0], dq, a, B, stream);
}

}  // namespace

// C entry points, bound with ctypes (repurpose_tpu_torch/native.py).
// `strides` holds 15 element strides: (batch, token, head) of q, k, v, g, o in
// that order. is_bf16 selects bf16 (1) or float32 (0) for q/k/v/g/o and the
// outputs; a null seg_ids selects the unpacked variant. Each returns
// cudaGetLastError() after its launch (0 on success); bf16 at Dh 64 is
// refused (cudaErrorInvalidValue): it takes the tensor-core entry points
// below.
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v, const void* g,
                            const void* o, const long long* strides, const void* key_valid,
                            const void* seg_ids, const void* lse, void* dq, int B,
                            int T_len, int H, int Dh, int is_bf16, int sm_bf16,
                            float scale, void* stream) {
  return run(true, q, k, v, g, o, strides, key_valid, seg_ids, lse, dq, nullptr, B, T_len,
             H, Dh, is_bf16, sm_bf16, scale, stream);
}

extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* g,
                             const void* o, const long long* strides,
                             const void* key_valid, const void* seg_ids, const void* lse,
                             void* dk, void* dv, int B, int T_len, int H, int Dh,
                             int is_bf16, int sm_bf16, float scale, void* stream) {
  return run(false, q, k, v, g, o, strides, key_valid, seg_ids, lse, dk, dv, B, T_len, H,
             Dh, is_bf16, sm_bf16, scale, stream);
}

// The tensor-core entry points (bf16, Dh 64), the dense and the long-T
// backward both, on the outputs of flash_bwd_stream_prep
// (flash_bwd_stream.cu): qs [B, T, H, 64] bf16 contiguous, rows [B, H, Tp]
// {lse, delta} float32 and info [B, Tp] {key flag, segment} int32, Tp = T
// rounded up to 64. `strides` holds 9 element strides: (batch, token, head)
// of k, v, g. kvl is int32 [B]; lo / hi are int32 [B, ceil(T / 64)], both
// null unpacked: for the dense backward (select 1: the select form) each
// query tile's span of every position of its segment ids
// (`segment_tile_bounds` at 64/64), for the long-T one (select 0: the bias
// form) `packed_block_bounds` at 64/64. Each returns cudaGetLastError()
// after its launch (0 on success), or cudaErrorInvalidValue for a view no
// tensor map can describe.
extern "C" int flash_bwd_dq_tc(const void* qs, const void* k, const void* v, const void* g,
                               const long long* strides, const void* rows, const void* info,
                               const void* kvl, const void* lo, const void* hi, void* dq, int B,
                               int T_len, int H, int sm_bf16, int select, float scale,
                               void* stream) {
  return run_tc(true, qs, k, v, g, strides, rows, info, kvl, lo, hi, dq, nullptr, B, T_len, H,
                sm_bf16, select, scale, static_cast<cudaStream_t>(stream));
}

extern "C" int flash_bwd_dkv_tc(const void* qs, const void* k, const void* v, const void* g,
                                const long long* strides, const void* rows, const void* info,
                                const void* kvl, const void* lo, const void* hi, void* dk,
                                void* dv, int B, int T_len, int H, int sm_bf16, int select,
                                float scale, void* stream) {
  return run_tc(false, qs, k, v, g, strides, rows, info, kvl, lo, hi, dk, dv, B, T_len, H,
                sm_bf16, select, scale, static_cast<cudaStream_t>(stream));
}
