// Masked multi-head attention forward for Hopper (sm_90a), with the
// per-row log-sum-exp.
//
// Replaces the TPU kernel `_flash_fwd_kernel` of
// repurpose_tpu/ops/flash_attention.py (line 227), in its unpacked and its
// sequence-packed (`packed=True`) variant. Two designs, by dtype and head
// width: bf16 at Dh 64 (the model's shape) takes `flash_fwd_tc_kernel`, the
// tensor-core design of flash_fwd_tc.cuh; float32 (which must keep float32
// parity, so no TF32 tensor cores) and bf16 at Dh 16, 32, 128 and 256 keep the
// first design, `flash_fwd_kernel<T, DH>`, which has no bf16 Dh 64 instance.
// In both a `seg_ids` pointer null or not selects the unpacked or the
// packed variant.
//
// What both compute, per batch row b, head h and query row i < kvl:
//   q_s    = round_to_input_dtype(float(q) * scale)        scale = 1/sqrt(Dh)
//   s_j    = dot(q_s, k_j) in float32 + (allowed(i, j) ? 0 : -1e9)
//   allowed(i, j) = key_valid[j] && (no seg_ids || seg_ids[i] == seg_ids[j])
//   p_j    = exp(s_j - max_j s_j)          (bf16 interior: s and s - m rounded
//                                           to bf16, and exp(.) rounded to bf16)
//   out_i  = (sum_j round_to_v_dtype(p_j) v_j) / (sum_j p_j)   float32 sums
//   lse_i  = max_j s_j + log(sum_j p_j)
// and for every query row i >= kvl (kvl = last valid key + 1 of the batch
// row): out_i = 0, lse_i = 1e30. The TPU kernel skips whole query blocks
// past kvl; these kernels skip row by row. Nothing downstream reads those
// rows. Both run the online softmax over 64-key tiles (the recurrence of
// flash_fwd_stream.cu's note), which reaches the same values up to rounding.
//
// What bounds it. At the main path's shapes ([8, 2048, 8, 64] bf16, about
// 60 % of each bucket valid) the work is the two products, 4*B*H*T*T*Dh
// operations (68.7 GFLOP unpadded, ~69 us at 989 TFLOP/s), against ~67 MB of
// q/k/v/out traffic (~20 us at 3.35 TB/s): it is bound by operations; on the
// card the tensor-core design is bound by the softmax's elementwise work per
// (query, key) pair, as flash_fwd_tc.cuh says.
//
// The tensor-core design (bf16, Dh 64; flash_fwd_tc.cuh has the whole
// note): one consumer warpgroup per 64-row query tile and head and one
// producer warp feeding a 3-stage TMA ring of K/V tiles; S = Q_s K^T and
// O += P V by wgmma m64n64k16 with float32 register accumulators; the
// online softmax on the accumulator layout with paired bf16 roundings. Its
// sweep comes from the wrapper, made once per batch (`attention_sweep`, the
// same record the backward's prep reads): key tiles [0, ceil(kvl / 64))
// unpacked and [lo, min(hi, ceil(kvl / 64))) packed. The dense forward
// hands it lo / hi from `segment_tile_bounds` at 64/64, the span of every
// position of each segment id owning a row of the query tile. A tile left
// out holds, for every row of the query tile, only keys at -1e9 (another
// id's, or masked): on a row that attends a key it could only add
// exp(-1e9 - m) = 0, or a running max that the first tile with a real key
// wipes out (alpha = 0), so the bounded sweep gives the bits of the sweep to
// kvl there. A row that attends no key (padding inside kvl) averages v over
// its swept tiles; nothing reads it. A query tile at or past kvl, or with an
// empty range, writes 0 and lse = 1e30. The same kernel is the long-T
// forward's (flash_fwd_stream.cu's note), handed `packed_block_bounds`
// instead. One head a block: two heads a block (one block an SM, the
// producer and the bias shared) ran 1.17-1.25x slower on an H100 (PERF.md).
//
// The first design (float32; bf16 at Dh 16, 32, 128, 256): one block per (64-row
// query tile, head, batch row), four warps of 16 query rows each, a sweep
// over every 64-key tile up to kvl staged in shared memory, and running max /
// running denominator / float32 output accumulator per row, with the divide
// deferred to the end (as on the TPU). Query tiles at or past kvl do no work,
// so the padding of a bucket costs nothing. bf16 products run on the tensor
// cores through `nvcuda::wmma` (16x16x16, float32 accumulate); float32
// inputs take scalar FMAs, since TF32 would lose the float32 parity the
// tests hold it to.
//
// Layout: q/k/v are read in place through (batch, token, head) strides, so
// the three column slices of the [B, T, 3*H*Dh] QKV projection go in without
// a copy; the innermost (Dh) axis is contiguous and every row starts on a
// 16-byte boundary. out is [B, T, H*Dh] contiguous, lse [B, H, T] float32.
// Dh is 16, 32, 64, 128 or 256; T is any length >= 1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

#include "flash_fwd_tc.cuh"

namespace {

constexpr int BQ = 64;       // query rows per block
constexpr int WARPS = 4;     // each warp owns 16 query rows
constexpr int THREADS = WARPS * 32;
constexpr float MASK_BIAS = -1e9f;  // NEG_INF of repurpose_tpu/ops/attention.py
constexpr float SKIP_LSE = 1e30f;
constexpr float M_INIT = -1e30f;

using bf16 = __nv_bfloat16;

struct Strides {
  long long qb, qt, qh, kb, kt, kh, vb, vt, vh;  // in elements
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

// Shared-memory tile geometry for one (element type, head width).
template <typename T, int DH>
struct Tiles {
  static constexpr bool kBf16 = std::is_same<T, bf16>::value;
  // keys per tile: 64, except float32 at Dh 256, where 32 keeps the block
  // under the 227 KB of shared memory (its Q tile and float32 output
  // accumulator alone take 130 KB)
  static constexpr int BK = (kBf16 || DH <= 128) ? 64 : 32;
  static constexpr int LDS = BK + 4;  // row stride of the float32 score tile
  // bf16 rows pad by 8 elements (16 bytes): wmma wants 32-byte aligned tile
  // starts and a stride that is a multiple of 8; float32 rows pad by 1 so the
  // scalar loops walk distinct banks.
  static constexpr int LD = DH + (kBf16 ? 8 : 1);  // Q, K, V tiles
  static constexpr int LDP = BK + (kBf16 ? 8 : 1);  // probabilities
  static constexpr int LDO = DH + 4;  // float32 output accumulator
  static constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte access

  static constexpr size_t align(size_t x) { return (x + 127) / 128 * 128; }
  static constexpr size_t kQ = 0;
  static constexpr size_t kK = kQ + align(sizeof(T) * BQ * LD);
  static constexpr size_t kV = kK + align(sizeof(T) * BK * LD);
  static constexpr size_t kS = kV + align(sizeof(T) * BK * LD);
  static constexpr size_t kP = kS + align(sizeof(float) * BQ * LDS);
  static constexpr size_t kO = kP + align(sizeof(T) * BQ * LDP);
  static constexpr size_t kKeyOk = kO + align(sizeof(float) * BQ * LDO);
  static constexpr size_t kKeySeg = kKeyOk + align(sizeof(int) * BK);
  static constexpr size_t kQSeg = kKeySeg + align(sizeof(int) * BK);
  static constexpr size_t kRowM = kQSeg + align(sizeof(int) * BQ);
  static constexpr size_t kRowL = kRowM + align(sizeof(float) * BQ);
  static constexpr size_t kBytes = kRowL + align(sizeof(float) * BQ);
  static_assert(kBytes <= 227 * 1024, "shared memory past the 227 KB a block may use");
};

// Copies a [ROWS, DH] tile of rows row0.. of one head into shared memory,
// zero-filling rows at or past T. With `scale` > 0 each element becomes
// round(float(x) * scale), the TPU kernel's scaled q.
template <typename T, int DH, int ROWS>
__device__ void load_tile(T* dst, const T* src, long long row_stride, int row0,
                          int T_len, float scale) {
  using G = Tiles<T, DH>;
  constexpr int CH = DH / G::VEC;  // 16-byte chunks per row
  for (int idx = threadIdx.x; idx < ROWS * CH; idx += THREADS) {
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

// S[16 rows of this warp, 64 keys] = Q_s K^T in float32.
template <typename T, int DH>
__device__ void warp_scores(const T* sQ, const T* sK, float* sS, int warp, int lane) {
  using G = Tiles<T, DH>;
  if constexpr (G::kBf16) {
    using namespace nvcuda;
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qa[DH / 16];
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      wmma::load_matrix_sync(qa[kk], sQ + warp * 16 * G::LD + kk * 16, G::LD);
#pragma unroll
    for (int n = 0; n < G::BK / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        // K^T as a column-major [Dh, 16 keys] operand: element (d, key) sits
        // at sK[key * LD + d], i.e. K's own row-major tile.
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kb;
        wmma::load_matrix_sync(kb, sK + n * 16 * G::LD + kk * 16, G::LD);
        wmma::mma_sync(acc, qa[kk], kb, acc);
      }
      wmma::store_matrix_sync(sS + warp * 16 * G::LDS + n * 16, acc, G::LDS,
                              wmma::mem_row_major);
    }
  } else {
    const int r = warp * 16 + lane / 2, half = lane & 1;
    for (int i = 0; i < G::BK / 2; ++i) {
      const int c = 2 * i + half;
      float acc = 0.f;
#pragma unroll 8
      for (int d = 0; d < DH; ++d) acc += to_f(sQ[r * G::LD + d]) * to_f(sK[c * G::LD + d]);
      sS[r * G::LDS + c] = acc;
    }
  }
}

// O[16 rows] = alpha_row * O + P V, O in float32 shared memory.
template <typename T, int DH>
__device__ void warp_pv(const T* sP, const T* sV, float* sO, float alpha, int warp,
                        int lane) {
  using G = Tiles<T, DH>;
  const int r = warp * 16 + lane / 2, half = lane & 1;
  if constexpr (G::kBf16) {
    using namespace nvcuda;
    for (int i = 0; i < DH / 2; ++i) sO[r * G::LDO + 2 * i + half] *= alpha;
    __syncwarp();
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pa[G::BK / 16];
#pragma unroll
    for (int kk = 0; kk < G::BK / 16; ++kk)
      wmma::load_matrix_sync(pa[kk], sP + warp * 16 * G::LDP + kk * 16, G::LDP);
#pragma unroll
    for (int n = 0; n < DH / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      float* o = sO + warp * 16 * G::LDO + n * 16;
      wmma::load_matrix_sync(acc, o, G::LDO, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < G::BK / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vb;
        wmma::load_matrix_sync(vb, sV + kk * 16 * G::LD + n * 16, G::LD);
        wmma::mma_sync(acc, pa[kk], vb, acc);
      }
      wmma::store_matrix_sync(o, acc, G::LDO, wmma::mem_row_major);
    }
  } else {
    for (int i = 0; i < DH / 2; ++i) {
      const int c = 2 * i + half;
      float acc = 0.f;
#pragma unroll 8
      for (int j = 0; j < G::BK; ++j) acc += to_f(sP[r * G::LDP + j]) * to_f(sV[j * G::LD + c]);
      sO[r * G::LDO + c] = sO[r * G::LDO + c] * alpha + acc;
    }
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, Strides st,
                     const uint8_t* __restrict__ key_valid,
                     const int* __restrict__ seg_ids, T* __restrict__ out,
                     float* __restrict__ lse, int T_len, int H, float scale,
                     int sm_bf16) {
  using G = Tiles<T, DH>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem + G::kQ);
  T* sK = reinterpret_cast<T*>(smem + G::kK);
  T* sV = reinterpret_cast<T*>(smem + G::kV);
  float* sS = reinterpret_cast<float*>(smem + G::kS);
  T* sP = reinterpret_cast<T*>(smem + G::kP);
  float* sO = reinterpret_cast<float*>(smem + G::kO);
  int* keyOk = reinterpret_cast<int*>(smem + G::kKeyOk);
  int* keySeg = reinterpret_cast<int*>(smem + G::kKeySeg);
  int* qSeg = reinterpret_cast<int*>(smem + G::kQSeg);
  float* rowM = reinterpret_cast<float*>(smem + G::kRowM);
  float* rowL = reinterpret_cast<float*>(smem + G::kRowL);
  __shared__ int s_kvl;

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long long D = (long long)H * DH;
  const uint8_t* valid_row = key_valid + (long long)b * T_len;
  const int* seg_row = seg_ids ? seg_ids + (long long)b * T_len : nullptr;
  T* out_bh = out + (long long)b * T_len * D + h * DH;
  float* lse_bh = lse + ((long long)b * H + h) * T_len;

  // kvl: last valid key + 1 of this batch row (0 when none is valid)
  if (tid == 0) s_kvl = 0;
  __syncthreads();
  int last = 0;
  for (int j = tid; j < T_len; j += THREADS)
    if (valid_row[j]) last = j + 1;
  atomicMax(&s_kvl, last);
  __syncthreads();
  const int kvl = s_kvl;

  if (q0 < kvl) {
    load_tile<T, DH, BQ>(sQ, q + b * st.qb + h * st.qh, st.qt, q0, T_len, scale);
    for (int i = tid; i < BQ; i += THREADS)
      qSeg[i] = (seg_row && q0 + i < T_len) ? seg_row[q0 + i] : 0;
    for (int i = tid; i < BQ * G::LDO; i += THREADS) sO[i] = 0.f;

    // Per-row online-softmax state. Lanes 2r and 2r+1 of a warp share query
    // row r of the warp's 16; lane parity picks the even or odd columns.
    const int r = warp * 16 + lane / 2, half = lane & 1;
    float m_i = M_INIT, l_i = 0.f;
    const int n_tiles = (kvl + G::BK - 1) / G::BK;
    for (int kt = 0; kt < n_tiles; ++kt) {
      const int j0 = kt * G::BK;
      __syncthreads();  // the previous tile's K/V are no longer read
      load_tile<T, DH, G::BK>(sK, k + b * st.kb + h * st.kh, st.kt, j0, T_len, 0.f);
      load_tile<T, DH, G::BK>(sV, v + b * st.vb + h * st.vh, st.vt, j0, T_len, 0.f);
      for (int c = tid; c < G::BK; c += THREADS) {
        const int j = j0 + c;
        keyOk[c] = j < T_len ? (valid_row[j] ? 1 : 0) : -1;  // -1: no such key
        keySeg[c] = (seg_row && j < T_len) ? seg_row[j] : 0;
      }
      __syncthreads();

      warp_scores<T, DH>(sQ, sK, sS, warp, lane);
      __syncwarp();

      const int qs = qSeg[r];
      float sv[G::BK / 2];
      float tmax = -CUDART_INF_F;
#pragma unroll
      for (int i = 0; i < G::BK / 2; ++i) {
        const int c = 2 * i + half;
        const int ok = keyOk[c];
        float s = -CUDART_INF_F;
        if (ok >= 0) {
          const bool allowed = ok && (!seg_row || keySeg[c] == qs);
          s = sS[r * G::LDS + c] + (allowed ? 0.f : MASK_BIAS);
          if (sm_bf16) s = round_bf16(s);
        }
        sv[i] = s;
        tmax = fmaxf(tmax, s);
      }
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
      const float m_new = fmaxf(m_i, tmax);
      const float alpha = expf(m_i - m_new);
      float rowsum = 0.f;
#pragma unroll
      for (int i = 0; i < G::BK / 2; ++i) {
        float p = 0.f;
        if (sv[i] != -CUDART_INF_F)
          p = sm_bf16 ? round_bf16(expf(round_bf16(sv[i] - m_new))) : expf(sv[i] - m_new);
        rowsum += p;
        sP[r * G::LDP + 2 * i + half] = from_f<T>(p);
      }
      rowsum += __shfl_xor_sync(0xffffffffu, rowsum, 1);
      l_i = l_i * alpha + rowsum;
      m_i = m_new;
      __syncwarp();

      warp_pv<T, DH>(sP, sV, sO, alpha, warp, lane);
      __syncwarp();
    }
    if (half == 0) {
      rowM[r] = m_i;
      rowL[r] = l_i;
    }
  }
  __syncthreads();

  // Coalesced epilogue: out = O / l (zero past kvl), lse = m + log(l).
  constexpr int CH = DH / G::VEC;
  for (int idx = tid; idx < BQ * CH; idx += THREADS) {
    const int rr = idx / CH, ch = idx % CH, t = q0 + rr;
    if (t >= T_len) continue;
    __align__(16) T vals[G::VEC];
#pragma unroll
    for (int e = 0; e < G::VEC; ++e)
      vals[e] = from_f<T>(t < kvl ? sO[rr * G::LDO + ch * G::VEC + e] / rowL[rr] : 0.f);
    *reinterpret_cast<uint4*>(out_bh + t * D + ch * G::VEC) =
        *reinterpret_cast<const uint4*>(vals);
  }
  for (int rr = tid; rr < BQ; rr += THREADS) {
    const int t = q0 + rr;
    if (t < T_len) lse_bh[t] = t < kvl ? rowM[rr] + logf(rowL[rr]) : SKIP_LSE;
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, Strides st,
           const void* key_valid, const void* seg_ids, void* out, void* lse, int B,
           int T_len, int H, float scale, int sm_bf16, cudaStream_t stream) {
  constexpr size_t smem = Tiles<T, DH>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T_len + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<T, DH><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), st,
      static_cast<const uint8_t*>(key_valid), static_cast<const int*>(seg_ids),
      static_cast<T*>(out), static_cast<float*>(lse), T_len, H, scale, sm_bf16);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_dh(int Dh, const void* q, const void* k, const void* v, Strides st,
                const void* key_valid, const void* seg_ids, void* out, void* lse, int B,
                int T_len, int H, float scale, int sm_bf16, cudaStream_t stream) {
  switch (Dh) {
    case 16:
      return launch<T, 16>(q, k, v, st, key_valid, seg_ids, out, lse, B, T_len, H, scale, sm_bf16, stream);
    case 32:
      return launch<T, 32>(q, k, v, st, key_valid, seg_ids, out, lse, B, T_len, H, scale, sm_bf16, stream);
    case 64:  // bf16 at Dh 64 takes flash_fwd_tc_kernel
      if constexpr (std::is_same<T, bf16>::value) return (int)cudaErrorInvalidValue;
      else
        return launch<T, 64>(q, k, v, st, key_valid, seg_ids, out, lse, B, T_len, H, scale,
                             sm_bf16, stream);
    case 128:
      return launch<T, 128>(q, k, v, st, key_valid, seg_ids, out, lse, B, T_len, H, scale, sm_bf16, stream);
    case 256:
      return launch<T, 256>(q, k, v, st, key_valid, seg_ids, out, lse, B, T_len, H, scale, sm_bf16, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The tensor-core design (bf16, Dh 64): flash_fwd_tc.cuh.
template <bool SM_BF16, bool PACKED>
__global__ void __launch_bounds__(fwd_tc::Cfg<1>::THREADS, fwd_tc::Cfg<1>::MIN_BLOCKS)
    flash_fwd_tc_kernel(const __grid_constant__ fwd_tc::Params p) {
  fwd_tc::run_block<1, SM_BF16, PACKED, false>(p);
}

}  // namespace

// C entry point, bound with ctypes (repurpose_tpu_torch/native.py). Strides
// are in elements; is_bf16 selects bf16 (1) or float32 (0) q/k/v/out; a null
// seg_ids selects the unpacked variant. Returns cudaGetLastError() after the
// launch (0 on success); bf16 at Dh 64 is refused (cudaErrorInvalidValue):
// it takes flash_fwd_tc below.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, long long qb,
                         long long qt, long long qh, long long kb, long long kt,
                         long long kh, long long vb, long long vt, long long vh,
                         const void* key_valid, const void* seg_ids, void* out,
                         void* lse, int B, int T_len, int H, int Dh, int is_bf16,
                         int sm_bf16, float scale, void* stream) {
  if (B <= 0 || T_len <= 0 || H <= 0) return 0;
  const Strides st{qb, qt, qh, kb, kt, kh, vb, vt, vh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch_dh<bf16>(Dh, q, k, v, st, key_valid, seg_ids, out, lse, B, T_len, H,
                             scale, sm_bf16, s);
  return dispatch_dh<float>(Dh, q, k, v, st, key_valid, seg_ids, out, lse, B, T_len, H,
                            scale, sm_bf16, s);
}

// The tensor-core entry point (bf16, Dh 64), of the dense and the long-T
// forward: `strides` holds 9 element strides, (batch, token, head) of q, k,
// v; kvl is int32 [B], and a null seg_ids selects the unpacked variant, else
// lo / hi (int32 [B, ceil(T / 64)]) are the key-tile bounds of the sweep.
// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for a view no tensor map can describe.
extern "C" int flash_fwd_tc(const void* q, const void* k, const void* v, const long long* strides,
                            const void* key_valid, const void* seg_ids, const void* kvl,
                            const void* lo, const void* hi, void* out, void* lse, int B, int T_len,
                            int H, int sm_bf16, float scale, void* stream) {
  if (B <= 0 || T_len <= 0 || H <= 0) return 0;
  if (!kvl || (seg_ids && (!lo || !hi))) return (int)cudaErrorInvalidValue;
  fwd_tc::Params p;
  const int err = fwd_tc::encode_qkv(p, q, k, v, strides, B, T_len, H);
  if (err != 0) return err;
  p.key_valid = static_cast<const uint8_t*>(key_valid);
  p.seg_ids = static_cast<const int*>(seg_ids);
  p.kvl = static_cast<const int*>(kvl);
  p.tile_lo = static_cast<const int*>(lo);
  p.tile_hi = static_cast<const int*>(hi);
  p.out = static_cast<bf16*>(out);
  p.lse = static_cast<float*>(lse);
  p.T = T_len;
  p.H = H;
  p.scale = scale;
  void (*kernel)(fwd_tc::Params) =
      seg_ids ? (sm_bf16 ? &flash_fwd_tc_kernel<true, true> : &flash_fwd_tc_kernel<false, true>)
              : (sm_bf16 ? &flash_fwd_tc_kernel<true, false> : &flash_fwd_tc_kernel<false, false>);
  return fwd_tc::launch<1>(kernel, p, B, static_cast<cudaStream_t>(stream));
}
