// Streaming masked multi-head attention forward for long sequences on
// Hopper (sm_90a), with the per-row log-sum-exp.
//
// Two kernels, by dtype and head width, replace the three long-T TPU
// forwards of repurpose_tpu/ops/flash_attention.py:
//   - `_flash_fwd_stream_kernel` (line 592; pallas_call line 474), unpacked,
//     2048 < T <= 8192;
//   - `_flash_fwd_packed_stream_kernel` (line 512; pallas_call line 418),
//     sequence-packed with the key sweep bounded to [lo, hi), same window;
//   - `_flash_fwd_hbm_kernel` (line 657; pallas_call line 375), T > 8192,
//     unpacked and packed.
// On the TPU the stream and HBM kernels differ only in where K/V live (a
// VMEM slab, or HBM with double-buffered DMA). On Hopper K/V always come
// from device memory, so the three fold into one: a `seg_ids` pointer null
// or not selects the packed variant. bf16 at Dh 64 (the model's shape)
// takes the tensor-core design of flash_fwd_tc.cuh, whose one kernel,
// flash_fwd.cu's `flash_fwd_tc_kernel`, serves the dense and the long-T
// forward, each handed its own sweep; float32 (which must keep float32
// parity, so no TF32 tensor cores) and bf16 at Dh 16, 32, 128 and 256 keep the
// first design, `flash_fwd_stream_kernel<T, DH>` of this file, which has no
// bf16 Dh 64 instance.
//
// What both compute, per batch row b, head h and 64-row query tile qt, over
// the key tiles kt of its sweep (64 keys each), with the TPU stream
// kernels' recurrence and rounding points (fa:623-654):
//   q_s   = round_to_input_dtype(float(q) * scale)            scale = 1/sqrt(Dh)
//   s_ij  = round_sm(dot(q_s_i, k_j) in float32 + (allowed(i, j) ? 0 : -1e9))
//   allowed(i, j) = key_valid[j] && (no seg_ids || seg_ids[i] == seg_ids[j])
//   m'    = max(m, max_j s_ij)                    float32, m starts at -1e30
//   alpha = exp(m - m')                           float32
//   p_ij  = round_sm(exp(round_sm(s_ij - round_sm(m'))))
//   l'    = l * alpha + sum_j p_ij                float32
//   acc'  = acc * alpha + sum_j round_to_v_dtype(p_ij) v_j   float32
//   out_i = acc_i / l_i,  lse_i = m_i + log(l_i)
// (round_sm is a bf16 rounding under the bf16 softmax interior, else the
// identity). The sweep is kt in [0, ceil(kvl / 64)) unpacked and
// [lo[b, qt], min(hi[b, qt], ceil(kvl / 64))) packed, where kvl is the last
// valid key + 1 of the batch row and lo/hi come from `packed_block_bounds`
// (the port of `_packed_block_bounds`, fa:486) at 64/64: key tiles outside
// it hold only other videos' keys, whose softmax mass is exactly 0. Keys
// past T do not exist (p = 0). A query tile at or past kvl, or whose range
// is empty, writes out = 0 and lse = 1e30 (fa:689-700); inside a live tile,
// rows at or past kvl do the same, row by row (the TPU kernel computes
// them; nothing reads them). kvl and the packed bounds come from the
// wrapper (the TPU kernels' scalar-prefetch operands), made once per batch
// (`attention_sweep`) and shared by every layer, so no block scans
// key_valid.
//
// What bounds it. At [1, 32768, 8, 64] bf16 with kvl ~ 0.9 T the two
// products are 4 * kvl^2 * H * Dh = 2.2 TFLOP (1.79 ms at 989 TFLOP/s)
// against ~200 MB of q/k/v/out traffic (0.06 ms at 3.35 TB/s): bound by
// operations. Packed, the bounded sweep cuts the operations to the videos'
// own squares (~0.07 ms for 12 videos of 1000-2500 s in one 32768 row);
// without it, a packed row would cost what an unpacked one costs.
//
// The tensor-core design (bf16, Dh 64; flash_fwd_tc.cuh has the whole
// note): one consumer warpgroup per 64-row query tile and one producer warp
// feeding a 3-stage TMA ring of K/V tiles (three blocks an SM); S = Q_s K^T
// and O += P V by wgmma m64n64k16 with float32 register accumulators, P fed
// back as the register A operand; the online softmax on the accumulator
// layout, its bf16 roundings in pairs, the next tile's S issued before this
// tile's P V is waited for. It runs at ~3x its bound at [1, 32768]
// (PERF.md): the softmax's elementwise work per (query, key) pair, not the
// products, takes the time. The dense forward launches the same kernel
// over the dense sweep (`segment_tile_bounds`) instead of this one's.
//
// The first design (float32; bf16 at Dh 16, 32, 128, 256): one block per (64-row
// query tile, head, batch row), four warps of 16 query rows each, the online
// softmax with the running max / denominator per row and the output
// accumulator in float32 shared memory, the divide deferred to the end. K/V
// tiles arrive through a two-stage cp.async ring: the copy of key tile kt+1
// starts before tile kt is computed (the counterpart of the HBM kernel's
// double-buffered make_async_copy, fa:704-735). bf16 products run on the
// tensor cores through `nvcuda::wmma` (16x16x16, float32 accumulate);
// float32 inputs take scalar FMAs, as in flash_fwd.cu.
//
// Layout: q/k/v are read in place through (batch, token, head) strides (the
// column slices of the [B, T, 3*H*Dh] QKV projection go in without a copy);
// the innermost (Dh) axis is contiguous and every row starts on a 16-byte
// boundary. out is [B, T, H*Dh] contiguous, lse [B, H, T] float32. Every
// offset that can pass 2**31 (lse at b*H*T, the QKV batch stride) is 64-bit.
// Dh is 16, 32, 64, 128 or 256; T is any length >= 1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BQ = 64;       // query rows per block
constexpr int TILE = 64;     // the key tile of the sweep (packed_block_bounds at 64/64)
constexpr int STAGES = 2;    // K/V ring depth
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

// 16-byte asynchronous copy global -> shared; with `fill_zero` nothing is
// read and the 16 bytes become 0 (rows past T).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool fill_zero) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = fill_zero ? 0 : 16;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Shared-memory geometry for one (element type, head width).
template <typename T, int DH>
struct Tiles {
  static constexpr bool kBf16 = std::is_same<T, bf16>::value;
  // keys per ring stage: 64, except at Dh 256, where a two-stage ring of
  // 64-key K/V tiles does not fit in 227 KB: 32 (bf16) and 16 (float32)
  static constexpr int BK = DH <= 128 ? 64 : (kBf16 ? 32 : 16);
  static constexpr int PER = TILE / BK;  // ring stages per 64-key tile of the sweep
  static constexpr int LDS = BK + 4;     // row stride of the float32 score tile
  // Rows of the Q/K/V tiles pad by 16 bytes: cp.async needs 16-byte aligned
  // destinations, wmma 32-byte aligned tile starts and a stride that is a
  // multiple of 8 elements.
  static constexpr int LD = DH + 16 / static_cast<int>(sizeof(T));
  // bf16 probabilities get their own tile; float32 ones overwrite the
  // scores in place (each thread rewrites only the entries it read), which
  // keeps float32 Dh 128 inside the 227 KB a block may use.
  static constexpr int LDP = kBf16 ? BK + 8 : LDS;
  static constexpr int LDO = DH + 4;  // float32 output accumulator
  static constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte access

  static constexpr size_t align(size_t x) { return (x + 127) / 128 * 128; }
  static constexpr size_t kTileKV = align(sizeof(T) * BK * LD);
  static constexpr size_t kQ = 0;
  static constexpr size_t kK = kQ + align(sizeof(T) * BQ * LD);  // STAGES tiles
  static constexpr size_t kV = kK + STAGES * kTileKV;             // STAGES tiles
  static constexpr size_t kS = kV + STAGES * kTileKV;
  static constexpr size_t kP = kBf16 ? kS + align(sizeof(float) * BQ * LDS) : kS;
  static constexpr size_t kO = kBf16 ? kP + align(sizeof(T) * BQ * LDP)
                                     : kS + align(sizeof(float) * BQ * LDS);
  static constexpr int kMeta = static_cast<int>(align(sizeof(int) * BK) / sizeof(int));
  static constexpr size_t kKeyOk = kO + align(sizeof(float) * BQ * LDO);  // STAGES
  static constexpr size_t kKeySeg = kKeyOk + STAGES * sizeof(int) * kMeta;
  static constexpr size_t kQSeg = kKeySeg + STAGES * sizeof(int) * kMeta;
  static constexpr size_t kRowM = kQSeg + align(sizeof(int) * BQ);
  static constexpr size_t kRowL = kRowM + align(sizeof(float) * BQ);
  static constexpr size_t kBytes = kRowL + align(sizeof(float) * BQ);
  static_assert(kBytes <= 227 * 1024, "shared memory past the 227 KB a block may use");
};

// Copies the [64, DH] q tile of rows row0.. into shared memory, each element
// becoming round(float(x) * scale) (the TPU kernel's scaled q); rows at or
// past T are zero.
template <typename T, int DH>
__device__ void load_q_tile(T* dst, const T* src, long long row_stride, int row0,
                            int T_len, float scale) {
  using G = Tiles<T, DH>;
  constexpr int CH = DH / G::VEC;  // 16-byte chunks per row
  for (int idx = threadIdx.x; idx < BQ * CH; idx += THREADS) {
    const int r = idx / CH, ch = idx % CH;
    T* d = dst + r * G::LD + ch * G::VEC;
    if (row0 + r < T_len) {
      const uint4 raw = *reinterpret_cast<const uint4*>(
          src + (long long)(row0 + r) * row_stride + ch * G::VEC);
      const T* vals = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int e = 0; e < G::VEC; ++e) d[e] = from_f<T>(to_f(vals[e]) * scale);
    } else {
#pragma unroll
      for (int e = 0; e < G::VEC; ++e) d[e] = from_f<T>(0.f);
    }
  }
}

// Starts the cp.async copies of the [BK, DH] K or V tile of rows row0..;
// rows at or past T are zero-filled.
template <typename T, int DH>
__device__ void start_kv_tile_copy(T* dst, const T* src, long long row_stride, int row0,
                              int T_len) {
  using G = Tiles<T, DH>;
  constexpr int CH = DH / G::VEC;
  for (int idx = threadIdx.x; idx < G::BK * CH; idx += THREADS) {
    const int r = idx / CH, ch = idx % CH;
    const bool outside = row0 + r >= T_len;
    const T* s = src + (long long)(outside ? 0 : row0 + r) * row_stride + ch * G::VEC;
    cp_async16(dst + r * G::LD + ch * G::VEC, s, outside);
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
    flash_fwd_stream_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, Strides st,
                            const uint8_t* __restrict__ key_valid,
                            const int* __restrict__ seg_ids,
                            const int* __restrict__ kvl_rows,
                            const int* __restrict__ tile_lo,
                            const int* __restrict__ tile_hi, T* __restrict__ out,
                            float* __restrict__ lse, int T_len, int H, float scale,
                            int sm_bf16) {
  using G = Tiles<T, DH>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem + G::kQ);
  float* sS = reinterpret_cast<float*>(smem + G::kS);
  T* sP = reinterpret_cast<T*>(smem + G::kP);
  float* sO = reinterpret_cast<float*>(smem + G::kO);
  int* qSeg = reinterpret_cast<int*>(smem + G::kQSeg);
  float* rowM = reinterpret_cast<float*>(smem + G::kRowM);
  float* rowL = reinterpret_cast<float*>(smem + G::kRowL);

  const int qt = blockIdx.x, q0 = qt * BQ, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long long D = (long long)H * DH;
  const uint8_t* valid_row = key_valid + (long long)b * T_len;
  const int* seg_row = seg_ids ? seg_ids + (long long)b * T_len : nullptr;
  const T* k_bh = k + b * st.kb + h * st.kh;
  const T* v_bh = v + b * st.vb + h * st.vh;
  T* out_bh = out + (long long)b * T_len * D + h * DH;
  float* lse_bh = lse + ((long long)b * H + h) * T_len;

  // the sweep in key tiles of BK: [0, ceil(kvl / BK)), packed bounded by the
  // query tile's [lo, hi) in 64-key tiles
  const int kvl = kvl_rows[b];
  int kt_lo = 0, kt_hi = (kvl + G::BK - 1) / G::BK;
  if (seg_row) {
    const long long n_qt = (T_len + BQ - 1) / BQ;
    kt_lo = tile_lo[(long long)b * n_qt + qt] * G::PER;
    kt_hi = min(tile_hi[(long long)b * n_qt + qt] * G::PER, kt_hi);
  }
  const bool live = q0 < kvl && kt_lo < kt_hi;

  // K/V tile kt (and its key flags) into ring stage `stage`
  auto fetch = [&](int kt, int stage) {
    const int j0 = kt * G::BK;
    start_kv_tile_copy<T, DH>(reinterpret_cast<T*>(smem + G::kK + stage * G::kTileKV),
                              k_bh, st.kt, j0, T_len);
    start_kv_tile_copy<T, DH>(reinterpret_cast<T*>(smem + G::kV + stage * G::kTileKV),
                              v_bh, st.vt, j0, T_len);
    int* keyOk = reinterpret_cast<int*>(smem + G::kKeyOk) + stage * G::kMeta;
    int* keySeg = reinterpret_cast<int*>(smem + G::kKeySeg) + stage * G::kMeta;
    for (int c = tid; c < G::BK; c += THREADS) {
      const int j = j0 + c;
      keyOk[c] = j < T_len ? (valid_row[j] ? 1 : 0) : -1;  // -1: no such key
      keySeg[c] = (seg_row && j < T_len) ? seg_row[j] : 0;
    }
    cp_async_commit();
  };

  if (live) {
    fetch(kt_lo, 0);
    load_q_tile<T, DH>(sQ, q + b * st.qb + h * st.qh, st.qt, q0, T_len, scale);
    for (int i = tid; i < BQ; i += THREADS)
      qSeg[i] = (seg_row && q0 + i < T_len) ? seg_row[q0 + i] : 0;
    for (int i = tid; i < BQ * G::LDO; i += THREADS) sO[i] = 0.f;

    // Per-row online-softmax state. Lanes 2r and 2r+1 of a warp share query
    // row r of the warp's 16; lane parity picks the even or odd columns.
    const int r = warp * 16 + lane / 2, half = lane & 1;
    float m_i = M_INIT, l_i = 0.f;
    for (int kt = kt_lo; kt < kt_hi; ++kt) {
      const int stage = (kt - kt_lo) & 1;
      if (kt + 1 < kt_hi) {
        fetch(kt + 1, stage ^ 1);  // that stage was last read before the
        cp_async_wait<1>();        // previous iteration's closing barrier
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();  // tile kt (and the q tile) visible to every warp
      const T* sK = reinterpret_cast<const T*>(smem + G::kK + stage * G::kTileKV);
      const T* sV = reinterpret_cast<const T*>(smem + G::kV + stage * G::kTileKV);
      const int* keyOk = reinterpret_cast<const int*>(smem + G::kKeyOk) + stage * G::kMeta;
      const int* keySeg = reinterpret_cast<const int*>(smem + G::kKeySeg) + stage * G::kMeta;

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
      const float m_sm = sm_bf16 ? round_bf16(m_new) : m_new;
      float rowsum = 0.f;
#pragma unroll
      for (int i = 0; i < G::BK / 2; ++i) {
        float p = 0.f;
        if (sv[i] != -CUDART_INF_F)
          p = sm_bf16 ? round_bf16(expf(round_bf16(sv[i] - m_sm))) : expf(sv[i] - m_new);
        rowsum += p;
        sP[r * G::LDP + 2 * i + half] = from_f<T>(p);
      }
      rowsum += __shfl_xor_sync(0xffffffffu, rowsum, 1);
      l_i = l_i * alpha + rowsum;
      m_i = m_new;
      __syncwarp();

      warp_pv<T, DH>(sP, sV, sO, alpha, warp, lane);
      __syncthreads();  // every warp is done with this stage before it refills
    }
    if (half == 0) {
      rowM[r] = m_i;
      rowL[r] = l_i;
    }
  }
  __syncthreads();

  // Coalesced epilogue: out = O / l (zero past kvl or in a dead tile),
  // lse = m + log(l) (SKIP_LSE there).
  constexpr int CH = DH / G::VEC;
  for (int idx = tid; idx < BQ * CH; idx += THREADS) {
    const int rr = idx / CH, ch = idx % CH, t = q0 + rr;
    if (t >= T_len) continue;
    const bool row_live = live && t < kvl;
    __align__(16) T vals[G::VEC];
#pragma unroll
    for (int e = 0; e < G::VEC; ++e)
      vals[e] = from_f<T>(row_live ? sO[rr * G::LDO + ch * G::VEC + e] / rowL[rr] : 0.f);
    *reinterpret_cast<uint4*>(out_bh + (long long)t * D + ch * G::VEC) =
        *reinterpret_cast<const uint4*>(vals);
  }
  for (int rr = tid; rr < BQ; rr += THREADS) {
    const int t = q0 + rr;
    if (t < T_len) lse_bh[t] = (live && t < kvl) ? rowM[rr] + logf(rowL[rr]) : SKIP_LSE;
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, Strides st,
           const void* key_valid, const void* seg_ids, const void* kvl, const void* lo,
           const void* hi, void* out, void* lse, int B, int T_len, int H, float scale,
           int sm_bf16, cudaStream_t stream) {
  constexpr size_t smem = Tiles<T, DH>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_stream_kernel<T, DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T_len + BQ - 1) / BQ, H, B);
  flash_fwd_stream_kernel<T, DH><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), st,
      static_cast<const uint8_t*>(key_valid), static_cast<const int*>(seg_ids),
      static_cast<const int*>(kvl), static_cast<const int*>(lo),
      static_cast<const int*>(hi), static_cast<T*>(out), static_cast<float*>(lse), T_len,
      H, scale, sm_bf16);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_dh(int Dh, const void* q, const void* k, const void* v, Strides st,
                const void* key_valid, const void* seg_ids, const void* kvl,
                const void* lo, const void* hi, void* out, void* lse, int B, int T_len,
                int H, float scale, int sm_bf16, cudaStream_t stream) {
  switch (Dh) {
    case 16:
      return launch<T, 16>(q, k, v, st, key_valid, seg_ids, kvl, lo, hi, out, lse, B,
                           T_len, H, scale, sm_bf16, stream);
    case 32:
      return launch<T, 32>(q, k, v, st, key_valid, seg_ids, kvl, lo, hi, out, lse, B,
                           T_len, H, scale, sm_bf16, stream);
    case 64:  // bf16 at Dh 64 takes flash_fwd.cu's flash_fwd_tc_kernel
      if constexpr (std::is_same<T, bf16>::value) return (int)cudaErrorInvalidValue;
      else
        return launch<T, 64>(q, k, v, st, key_valid, seg_ids, kvl, lo, hi, out, lse, B,
                             T_len, H, scale, sm_bf16, stream);
    case 128:
      return launch<T, 128>(q, k, v, st, key_valid, seg_ids, kvl, lo, hi, out, lse, B,
                            T_len, H, scale, sm_bf16, stream);
    case 256:
      return launch<T, 256>(q, k, v, st, key_valid, seg_ids, kvl, lo, hi, out, lse, B,
                            T_len, H, scale, sm_bf16, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// C entry point, bound with ctypes (repurpose_tpu_torch/native.py). Strides
// are in elements; is_bf16 selects bf16 (1) or float32 (0) q/k/v/out; a null
// seg_ids selects the unpacked variant (lo and hi are then ignored). kvl is
// int32 [B]; lo/hi are int32 [B, ceil(T / 64)]. Returns cudaGetLastError()
// after the launch (0 on success); bf16 at Dh 64 is refused
// (cudaErrorInvalidValue): it takes flash_fwd.cu's flash_fwd_tc.
extern "C" int flash_fwd_stream(const void* q, const void* k, const void* v,
                                long long qb, long long qt, long long qh, long long kb,
                                long long kt, long long kh, long long vb, long long vt,
                                long long vh, const void* key_valid, const void* seg_ids,
                                const void* kvl, const void* lo, const void* hi,
                                void* out, void* lse, int B, int T_len, int H, int Dh,
                                int is_bf16, int sm_bf16, float scale, void* stream) {
  if (B <= 0 || T_len <= 0 || H <= 0) return 0;
  if (seg_ids && (!lo || !hi)) return (int)cudaErrorInvalidValue;
  const Strides st{qb, qt, qh, kb, kt, kh, vb, vt, vh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch_dh<bf16>(Dh, q, k, v, st, key_valid, seg_ids, kvl, lo, hi, out, lse,
                             B, T_len, H, scale, sm_bf16, s);
  return dispatch_dh<float>(Dh, q, k, v, st, key_valid, seg_ids, kvl, lo, hi, out, lse,
                            B, T_len, H, scale, sm_bf16, s);
}
