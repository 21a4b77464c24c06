// "No-transpose" masked multi-head attention forward on the flat [B, T, D]
// layout, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_fwd_kernel_nt` of tools/bench_attention_fwd.py
// (line 73, `mha_pallas_nt`; pallas_call line 119). It is an experiment
// beside csrc/flash_fwd.cu, not a variant of it: one block computes G =
// heads_per_block heads of a 64-row query tile, so each K/V tile is read
// once for all G heads, and nothing is transposed. Two kernels, by dtype and
// head width: bf16 at Dh 64 (the tool's shape) takes `flash_fwd_nt_tc_kernel`,
// the tensor-core design of flash_fwd_tc.cuh; float32 (float32 parity) and
// bf16 at Dh 16, 32 and 128 keep the first design, `flash_fwd_nt_kernel`,
// which has no bf16 Dh 64 instance.
//
// What both compute, per batch row b, head h and EVERY query row i < T:
//   q_s   = round_to_input_dtype(float(q) * scale)          scale = 1/sqrt(Dh)
//   s_j   = dot(q_s, k_j) in float32 + (key_valid[j] ? 0 : -1e9)   (added)
//   e_j   = exp(s_j - max_j s_j) in float32
//   out_i = (sum_j round_to_v_dtype(e_j) v_j) / (sum_j e_j)   float32 sums
// No LSE, no prefix skip: rows past the last valid key are computed, and a
// row whose keys are all masked averages v over every key (its scores all
// round to -1e9 in float32). Both kernels run the online softmax over key
// tiles: they round e_j against the running max where the plain version
// uses the final max (bf16 outputs agree to ~1e-2 of max |out|, float32 to
// ~1e-6). Keys past kvl (last valid key + 1) add exactly 0 once a valid key
// has been seen, so the sweep stops at kvl; with no valid key it covers all
// T. Every block finds kvl itself (one pass over its row's key_valid).
//
// What bounds it. At the tool's shape ([8, 2048, 8 * 64] bf16, 1800 valid
// keys) the two products are 4 * B * H * T * 1800 * Dh = 60.4 GFLOP, ~61 us
// at 989 TFLOP/s, against ~67 MB of q/k/v/out (~20 us at 3.35 TB/s): bound
// by operations.
//
// The tensor-core design (bf16, Dh 64): flash_fwd_tc.cuh's mainloop with
// the float32 interior and no LSE. A block is G consumer warpgroups, one
// per head, over one ring of [64 keys, 64] K and V tiles per head that a
// producer warp fills by TMA from the flat rows viewed as [B, T, H, 64]
// (3 stages, 2 at G = 4). What G costs is occupancy: G = 1 runs three blocks
// (12 consumer warps) an SM, G = 2 and 4 one block each (shared memory),
// G = 4 at <= 96 registers (a few spills). The tool's hpb 2 runs at about
// SDPA's time (PERF.md).
//
// The first design: four warps of 16 query rows; per 64-key tile (32 in
// float32, for shared memory) K and V of the whole head group land in
// shared memory once, then for each head in turn the warp takes Q_s K^T,
// its online-softmax step and P V, with a running max / denominator per
// (row, head) and a float32 accumulator per (row, head) in shared memory.
// bf16 products run on the tensor cores through `nvcuda::wmma` (16x16x16,
// float32 accumulate) as in flash_fwd.cu; float32 takes scalar FMAs. The
// head group costs shared memory: G * Dh <= 256, so one block per SM at
// G * Dh = 256 (~217 KB float32).
//
// Layout: q/k/v [B, T, D] read through (batch, token) strides with a
// contiguous feature axis and rows on 16-byte boundaries; out [B, T, D]
// contiguous. Dh is 16, 32, 64 or 128; G is 1, 2 or 4 with G * Dh <= 256.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

#include "flash_fwd_tc.cuh"

namespace {

constexpr int BQ = 64;  // query rows per block
constexpr int WARPS = 4;  // each warp owns 16 query rows
constexpr int THREADS = WARPS * 32;
constexpr float MASK_BIAS = -1e9f;  // NEG_INF of repurpose_tpu/ops/attention.py
constexpr float M_INIT = -1e30f;

using bf16 = __nv_bfloat16;

struct Strides {
  long long qb, qt, kb, kt, vb, vt;  // in elements
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16_rn(x); }

// Shared-memory geometry for one (element type, head width, heads per block).
template <typename T, int DH, int G>
struct Tiles {
  static constexpr bool kBf16 = std::is_same<T, bf16>::value;
  static constexpr int BK = kBf16 ? 64 : 32;  // keys per tile
  static constexpr int W = G * DH;  // columns of the head group
  // bf16 rows pad by 8 elements (wmma: 32-byte aligned tiles, stride a
  // multiple of 8); float32 rows by 1, so the scalar loops walk distinct banks.
  static constexpr int LD = W + (kBf16 ? 8 : 1);  // Q, K, V tiles
  static constexpr int LDS = BK + 4;  // float32 scores
  static constexpr int LDP = BK + (kBf16 ? 8 : 1);  // probabilities
  static constexpr int LDO = W + 4;  // float32 output accumulators
  static constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte access

  static constexpr size_t align(size_t x) { return (x + 127) / 128 * 128; }
  static constexpr size_t kQ = 0;
  static constexpr size_t kK = kQ + align(sizeof(T) * BQ * LD);
  static constexpr size_t kV = kK + align(sizeof(T) * BK * LD);
  static constexpr size_t kS = kV + align(sizeof(T) * BK * LD);
  static constexpr size_t kP = kS + align(sizeof(float) * BQ * LDS);
  static constexpr size_t kO = kP + align(sizeof(T) * BQ * LDP);
  static constexpr size_t kKeyOk = kO + align(sizeof(float) * BQ * LDO);
  static constexpr size_t kRowL = kKeyOk + align(sizeof(int) * BK);
  static constexpr size_t kBytes = kRowL + align(sizeof(float) * BQ * G);
};

// Copies `rows` rows (row0..) of the head group's W columns into shared
// memory, zero-filling rows at or past T. With `scale` > 0 each element
// becomes round(float(x) * scale), the TPU kernel's scaled q.
template <typename T, int DH, int G>
__device__ void load_tile(T* dst, const T* src, long long row_stride, int row0, int rows,
                          int T_len, float scale) {
  using Gm = Tiles<T, DH, G>;
  constexpr int CH = Gm::W / Gm::VEC;  // 16-byte chunks per row
  for (int idx = threadIdx.x; idx < rows * CH; idx += THREADS) {
    const int r = idx / CH, ch = idx % CH;
    T* d = dst + r * Gm::LD + ch * Gm::VEC;
    if (row0 + r < T_len) {
      const uint4 raw = *reinterpret_cast<const uint4*>(
          src + (long long)(row0 + r) * row_stride + ch * Gm::VEC);
      const T* vals = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int e = 0; e < Gm::VEC; ++e)
        d[e] = scale > 0.f ? from_f<T>(to_f(vals[e]) * scale) : vals[e];
    } else {
#pragma unroll
      for (int e = 0; e < Gm::VEC; ++e) d[e] = from_f<T>(0.f);
    }
  }
}

// S[16 rows of this warp, BK keys] = Q_s K^T of head h, in float32.
template <typename T, int DH, int G>
__device__ void warp_scores(const T* sQ, const T* sK, float* sS, int h, int warp, int lane) {
  using Gm = Tiles<T, DH, G>;
  constexpr int BK = Gm::BK, LD = Gm::LD, LDS = Gm::LDS;
  if constexpr (Gm::kBf16) {
    using namespace nvcuda;
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qa[DH / 16];
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      wmma::load_matrix_sync(qa[kk], sQ + warp * 16 * LD + h * DH + kk * 16, LD);
#pragma unroll
    for (int n = 0; n < BK / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        // K^T as a column-major [Dh, 16 keys] operand: K's own row-major tile
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kb;
        wmma::load_matrix_sync(kb, sK + n * 16 * LD + h * DH + kk * 16, LD);
        wmma::mma_sync(acc, qa[kk], kb, acc);
      }
      wmma::store_matrix_sync(sS + warp * 16 * LDS + n * 16, acc, LDS, wmma::mem_row_major);
    }
  } else {
    const int r = warp * 16 + lane / 2, half = lane & 1;
    const T* qrow = sQ + r * LD + h * DH;
    for (int i = 0; i < BK / 2; ++i) {
      const int c = 2 * i + half;
      const T* krow = sK + c * LD + h * DH;
      float acc = 0.f;
#pragma unroll 8
      for (int d = 0; d < DH; ++d) acc += to_f(qrow[d]) * to_f(krow[d]);
      sS[r * LDS + c] = acc;
    }
  }
}

// O_h[16 rows] = alpha_row * O_h + P V_h, O in float32 shared memory.
template <typename T, int DH, int G>
__device__ void warp_pv(const T* sP, const T* sV, float* sO, float alpha, int h, int warp,
                        int lane) {
  using Gm = Tiles<T, DH, G>;
  constexpr int BK = Gm::BK, LD = Gm::LD, LDP = Gm::LDP, LDO = Gm::LDO;
  const int r = warp * 16 + lane / 2, half = lane & 1;
  float* orow = sO + r * LDO + h * DH;
  if constexpr (Gm::kBf16) {
    using namespace nvcuda;
    for (int i = 0; i < DH / 2; ++i) orow[2 * i + half] *= alpha;
    __syncwarp();
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pa[BK / 16];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wmma::load_matrix_sync(pa[kk], sP + warp * 16 * LDP + kk * 16, LDP);
#pragma unroll
    for (int n = 0; n < DH / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      float* o = sO + warp * 16 * LDO + h * DH + n * 16;
      wmma::load_matrix_sync(acc, o, LDO, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vb;
        wmma::load_matrix_sync(vb, sV + kk * 16 * LD + h * DH + n * 16, LD);
        wmma::mma_sync(acc, pa[kk], vb, acc);
      }
      wmma::store_matrix_sync(o, acc, LDO, wmma::mem_row_major);
    }
  } else {
    for (int i = 0; i < DH / 2; ++i) {
      const int c = 2 * i + half;
      float acc = 0.f;
#pragma unroll 8
      for (int j = 0; j < BK; ++j) acc += to_f(sP[r * LDP + j]) * to_f(sV[j * LD + h * DH + c]);
      orow[c] = orow[c] * alpha + acc;
    }
  }
}

template <typename T, int DH, int G>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_nt_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, Strides st,
                        const uint8_t* __restrict__ key_valid, T* __restrict__ out,
                        int T_len, int D, float scale) {
  using Gm = Tiles<T, DH, G>;
  constexpr int BK = Gm::BK, LDS = Gm::LDS, LDP = Gm::LDP, LDO = Gm::LDO;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem + Gm::kQ);
  T* sK = reinterpret_cast<T*>(smem + Gm::kK);
  T* sV = reinterpret_cast<T*>(smem + Gm::kV);
  float* sS = reinterpret_cast<float*>(smem + Gm::kS);
  T* sP = reinterpret_cast<T*>(smem + Gm::kP);
  float* sO = reinterpret_cast<float*>(smem + Gm::kO);
  int* keyOk = reinterpret_cast<int*>(smem + Gm::kKeyOk);
  float* rowL = reinterpret_cast<float*>(smem + Gm::kRowL);
  __shared__ int s_kvl;

  const int q0 = blockIdx.x * BQ, col0 = blockIdx.y * Gm::W, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const uint8_t* valid_row = key_valid + (long long)b * T_len;

  // kvl: last valid key + 1 of this batch row (0 when none is valid)
  if (tid == 0) s_kvl = 0;
  __syncthreads();
  int last = 0;
  for (int j = tid; j < T_len; j += THREADS)
    if (valid_row[j]) last = j + 1;
  atomicMax(&s_kvl, last);
  __syncthreads();
  const int n_keys = s_kvl > 0 ? s_kvl : T_len;

  load_tile<T, DH, G>(sQ, q + b * st.qb + col0, st.qt, q0, BQ, T_len, scale);
  for (int i = tid; i < BQ * LDO; i += THREADS) sO[i] = 0.f;

  // Per-(row, head) online-softmax state. Lanes 2r and 2r+1 of a warp share
  // query row r of the warp's 16; lane parity picks even or odd columns.
  const int r = warp * 16 + lane / 2, half = lane & 1;
  float m_i[G], l_i[G];
#pragma unroll
  for (int h = 0; h < G; ++h) {
    m_i[h] = M_INIT;
    l_i[h] = 0.f;
  }
  const int n_tiles = (n_keys + BK - 1) / BK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int j0 = kt * BK;
    __syncthreads();  // the previous tile's K/V are no longer read
    load_tile<T, DH, G>(sK, k + b * st.kb + col0, st.kt, j0, BK, T_len, 0.f);
    load_tile<T, DH, G>(sV, v + b * st.vb + col0, st.vt, j0, BK, T_len, 0.f);
    for (int c = tid; c < BK; c += THREADS) {
      const int j = j0 + c;
      keyOk[c] = j < T_len ? (valid_row[j] ? 1 : 0) : -1;  // -1: no such key
    }
    __syncthreads();

#pragma unroll
    for (int h = 0; h < G; ++h) {
      warp_scores<T, DH, G>(sQ, sK, sS, h, warp, lane);
      __syncwarp();
      float sv[BK / 2];
      float tmax = -CUDART_INF_F;
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int c = 2 * i + half;
        const int ok = keyOk[c];
        const float s = ok >= 0 ? sS[r * LDS + c] + (ok ? 0.f : MASK_BIAS) : -CUDART_INF_F;
        sv[i] = s;
        tmax = fmaxf(tmax, s);
      }
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
      const float m_new = fmaxf(m_i[h], tmax);
      const float alpha = expf(m_i[h] - m_new);
      float rowsum = 0.f;
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const float p = sv[i] != -CUDART_INF_F ? expf(sv[i] - m_new) : 0.f;
        rowsum += p;
        sP[r * LDP + 2 * i + half] = from_f<T>(p);
      }
      rowsum += __shfl_xor_sync(0xffffffffu, rowsum, 1);
      l_i[h] = l_i[h] * alpha + rowsum;
      m_i[h] = m_new;
      __syncwarp();
      warp_pv<T, DH, G>(sP, sV, sO, alpha, h, warp, lane);
      __syncwarp();
    }
  }
  if (half == 0) {
#pragma unroll
    for (int h = 0; h < G; ++h) rowL[r * G + h] = l_i[h];
  }
  __syncthreads();

  // Coalesced epilogue: out = O / l on every row before T.
  constexpr int CH = Gm::W / Gm::VEC;
  T* out_b = out + (long long)b * T_len * D + col0;
  for (int idx = tid; idx < BQ * CH; idx += THREADS) {
    const int rr = idx / CH, ch = idx % CH, t = q0 + rr;
    if (t >= T_len) continue;
    const float l = rowL[rr * G + ch * Gm::VEC / DH];  // a chunk lies in one head
    __align__(16) T vals[Gm::VEC];
#pragma unroll
    for (int e = 0; e < Gm::VEC; ++e) vals[e] = from_f<T>(sO[rr * LDO + ch * Gm::VEC + e] / l);
    *reinterpret_cast<uint4*>(out_b + (long long)t * D + ch * Gm::VEC) =
        *reinterpret_cast<const uint4*>(vals);
  }
}

template <typename T, int DH, int G>
int launch(const void* q, const void* k, const void* v, Strides st, const void* key_valid,
           void* out, int B, int T_len, int H, float scale, cudaStream_t stream) {
  constexpr size_t smem = Tiles<T, DH, G>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_nt_kernel<T, DH, G>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T_len + BQ - 1) / BQ, H / G, B);
  flash_fwd_nt_kernel<T, DH, G><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), st,
      static_cast<const uint8_t*>(key_valid), static_cast<T*>(out), T_len, H * DH, scale);
  return (int)cudaGetLastError();
}

template <typename T, int DH>
int dispatch_g(int G, const void* q, const void* k, const void* v, Strides st,
               const void* key_valid, void* out, int B, int T_len, int H, float scale,
               cudaStream_t stream) {
  switch (G) {
    case 1:
      return launch<T, DH, 1>(q, k, v, st, key_valid, out, B, T_len, H, scale, stream);
    case 2:
      return launch<T, DH, 2>(q, k, v, st, key_valid, out, B, T_len, H, scale, stream);
    case 4:
      if constexpr (4 * DH <= 256)
        return launch<T, DH, 4>(q, k, v, st, key_valid, out, B, T_len, H, scale, stream);
      return (int)cudaErrorInvalidValue;
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int dispatch_dh(int Dh, int G, const void* q, const void* k, const void* v, Strides st,
                const void* key_valid, void* out, int B, int T_len, int H, float scale,
                cudaStream_t stream) {
  switch (Dh) {
    case 16:
      return dispatch_g<T, 16>(G, q, k, v, st, key_valid, out, B, T_len, H, scale, stream);
    case 32:
      return dispatch_g<T, 32>(G, q, k, v, st, key_valid, out, B, T_len, H, scale, stream);
    case 64:  // bf16 at Dh 64 takes flash_fwd_nt_tc_kernel
      if constexpr (std::is_same<T, bf16>::value) return (int)cudaErrorInvalidValue;
      else return dispatch_g<T, 64>(G, q, k, v, st, key_valid, out, B, T_len, H, scale, stream);
    case 128:
      return dispatch_g<T, 128>(G, q, k, v, st, key_valid, out, B, T_len, H, scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The tensor-core design (bf16, Dh 64): flash_fwd_tc.cuh, one consumer
// warpgroup per head of the block.
template <int G>
__global__ void __launch_bounds__(fwd_tc::Cfg<G>::THREADS, fwd_tc::Cfg<G>::MIN_BLOCKS)
    flash_fwd_nt_tc_kernel(const __grid_constant__ fwd_tc::Params p) {
  fwd_tc::run_block<G, false, false, true>(p);
}

}  // namespace

// C entry point, bound with ctypes (repurpose_tpu_torch/native.py). Strides
// are in elements; heads_per_block (G) must divide H; is_bf16 selects bf16
// (1) or float32 (0) q/k/v/out. Returns cudaGetLastError() after the launch
// (0 on success); bf16 at Dh 64 is refused (cudaErrorInvalidValue): it takes
// flash_fwd_nt_tc below.
extern "C" int flash_fwd_nt(const void* q, const void* k, const void* v, long long qb,
                            long long qt, long long kb, long long kt, long long vb,
                            long long vt, const void* key_valid, void* out, int B, int T_len,
                            int H, int Dh, int heads_per_block, int is_bf16, float scale,
                            void* stream) {
  if (B <= 0 || T_len <= 0 || H <= 0) return 0;
  if (heads_per_block <= 0 || H % heads_per_block) return (int)cudaErrorInvalidValue;
  const Strides st{qb, qt, kb, kt, vb, vt};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch_dh<bf16>(Dh, heads_per_block, q, k, v, st, key_valid, out, B, T_len, H,
                             scale, s);
  return dispatch_dh<float>(Dh, heads_per_block, q, k, v, st, key_valid, out, B, T_len, H,
                            scale, s);
}

// The tensor-core entry point (bf16, Dh 64), arguments as above. Returns
// cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for a view no tensor map can describe.
extern "C" int flash_fwd_nt_tc(const void* q, const void* k, const void* v, long long qb,
                               long long qt, long long kb, long long kt, long long vb,
                               long long vt, const void* key_valid, void* out, int B, int T_len,
                               int H, int heads_per_block, float scale, void* stream) {
  if (B <= 0 || T_len <= 0 || H <= 0) return 0;
  if (heads_per_block <= 0 || H % heads_per_block) return (int)cudaErrorInvalidValue;
  // the flat [B, T, H * 64] rows as [B, T, H, 64] views
  const long long strides[9] = {qb, qt, fwd_tc::DH, kb, kt, fwd_tc::DH, vb, vt, fwd_tc::DH};
  fwd_tc::Params p;
  const int err = fwd_tc::encode_qkv(p, q, k, v, strides, B, T_len, H);
  if (err != 0) return err;
  p.key_valid = static_cast<const uint8_t*>(key_valid);
  p.seg_ids = nullptr;
  p.kvl = nullptr;
  p.tile_lo = p.tile_hi = nullptr;
  p.out = static_cast<bf16*>(out);
  p.lse = nullptr;
  p.T = T_len;
  p.H = H;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (heads_per_block) {
    case 1: return fwd_tc::launch<1>(&flash_fwd_nt_tc_kernel<1>, p, B, s);
    case 2: return fwd_tc::launch<2>(&flash_fwd_nt_tc_kernel<2>, p, B, s);
    case 4: return fwd_tc::launch<4>(&flash_fwd_nt_tc_kernel<4>, p, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
