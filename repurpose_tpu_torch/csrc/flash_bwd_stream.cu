// Streaming masked multi-head attention backward for long sequences on
// Hopper (sm_90a): two kernels, dq and dk/dv, each computing its own
// gradient with no atomics (deterministic).
//
// They replace the four long-T TPU backward kernels of
// repurpose_tpu/ops/flash_attention.py:
//   - flash_bwd_dq_stream_kernel<T, DH> replaces
//       `_bwd_dq_stream_kernel` (line 859; pallas_call line 1439), unpacked,
//       2048 < T <= 8192;
//       `_bwd_dq_packed_stream_kernel` (line 914; pallas_call line 1387),
//       sequence-packed with the key sweep bounded to [lo, hi), same window;
//       `_bwd_dq_hbm_kernel` (line 992; pallas_call line 1359), T > 8192,
//       unpacked and packed;
//   - flash_bwd_dkv_stream_kernel<T, DH> replaces `_bwd_dkv_stream_kernel`
//     (line 1200; pallas_calls line 1569 and, packed, 1493), every T > 2048.
// On the TPU the three dq kernels differ only in where K/V live (a VMEM slab,
// or HBM with double-buffered DMA) and in whether the sweep is bounded. On
// Hopper K/V always come from device memory, so they fold into one kernel; a
// `seg_ids` pointer null or not selects the packed variant of each kernel.
//
// What they compute, with the saved forward out `o` and lse, the upstream
// gradient `g`, scale = 1/sqrt(Dh), per batch row b and head h, in the TPU
// stream kernels' bias form and rounding points (fa:891-903, 1245-1277):
//   q_s   = round_to_input_dtype(float(q) * scale)
//   s_ij  = dot(q_s_i, k_j) in float32
//   p_ij  = R(exp(R(s_ij + (allowed(i, j) ? 0 : -1e9) - lse_i)))
//   allowed(i, j) = key_valid[j] && (no seg_ids || seg_ids[i] == seg_ids[j])
//   dp_ij = dot(g_i, v_j) in float32
//   d_i   = sum_d g_id * o_id in float32           (delta)
//   ds_ij = R(p_ij * R(dp_ij - d_i))
//   dq_i  = scale * sum_j in(ds_ij) k_j            float32 sums
//   dk_j  = sum_i in(ds_ij) q_s_i                  (no extra scale: q_s has it)
//   dv_j  = sum_i in_g(p_ij) g_i
// R(.) rounds to bf16 under the bf16 softmax interior (else the identity);
// in(.) rounds to the input dtype. The dense kernels (flash_bwd.cu) use the
// select form for packed rows; on the rows the model gives a gradient (every
// valid row's own video has valid keys, padding has g = 0) the two forms give
// the same p.
//
// The sweeps, with kvl = last valid key + 1 of the batch row (from the
// wrapper) and 64-row tiles:
//   - dq, per query tile qt: key tiles [0, ceil(kvl / 64)), packed
//     [lo[b, qt], min(hi[b, qt], ceil(kvl / 64))), where lo/hi come from
//     `packed_block_bounds` at 64/64 (the port of `_packed_block_bounds`,
//     fa:486): tiles outside hold only other videos' keys, whose softmax
//     mass is exactly 0. A query tile at or past kvl, or whose range is
//     empty, writes dq = 0; so do rows at or past kvl.
//   - dk/dv, per key tile kt: query tiles [0, ceil(kvl / 64)), packed
//     [lo[b, kt], min(hi[b, kt], ceil(kvl / 64))): the mask seg_q == seg_k is
//     symmetric, so the key tile's own bounds are exactly the query tiles
//     whose videos overlap it, the pairs the TPU kernel keeps (lo <= ki <
//     hi over its query chunks, fa:1239-1241). Key tiles at or past kvl, or
//     with an empty range, write zeros; so do key rows at or past kvl.
// Query rows past kvl carry lse = 1e30 from the forward (p = 0) and g = 0.
//
// What bounds them. At [1, 32768, 8, 64] bf16 with kvl ~ 0.9 T, dq does three
// products (s, dp, dq) and dk/dv four (s, dp, dv, dk) of 2 * Dh operations per
// (query, key) pair: 3.3 and 4.5 TFLOP, 3.4 and 4.5 ms at 989 TFLOP/s, against
// ~0.3 GB of q/k/v/g/o/lse/gradient traffic (0.1 ms at 3.35 TB/s): bound by
// operations. Packed, the bounded sweeps cut the work to the videos' own
// squares; without them a packed row costs what an unpacked one costs.
//
// Two designs share the contract above.
//
// bf16 at Dh 64 (the model's shape) takes the tensor-core path, after a
// small prep kernel:
//   - flash_bwd_stream_prep_kernel runs once per backward (the wrapper hands
//     its outputs to the kernel below): q_s [B, T, H, 64] bf16, the per-row
//     stats {lse, delta} [B, H, Tp] float2 and the per-token info {key flag,
//     segment} [B, Tp] int2, Tp = T rounded up to 64, rows past T padded
//     (lse 1e30, delta 0, flag -1). It replaces what the TPU kernels repeat
//     per tile, the q scaling (fa:1253) and delta = rowsum(g o) (fa:1271):
//     the dk/dv kernel used to rescale Q in shared memory and re-read o from
//     device memory for every query tile of every key tile (~14 GB at
//     [1, 32768, 8, 64]). The dense backward's tensor-core kernels read the
//     same prep.
//   - dq, dk and dv are then one fused kernel of flash_bwd.cu,
//     flash_bwd_fused_tc_kernel (design in flash_bwd_fused.cuh): 128 keys a
//     block, a producer warpgroup feeding a 4-stage TMA ring, wgmma
//     m64n64k16 with register accumulators, each pair's p and ds formed
//     once in registers, and dq added across key blocks in float32 by TMA
//     reduce-adds, so that dq's last bits may change from run to run. The
//     stream wrappers take it too, each keeping its own gradients. At
//     [1, 32768, 8, 64] it runs at ~2.6x its bound (PERF.md).
//
// Every other instance (float32, which must keep float32 parity and so
// cannot use TF32 tensor cores, and bf16 at Dh 16, 32, 128 and 256) keeps the
// first design, described next. The TPU
// kernels hold [Tq, Dblk] query slabs and walk [k_block, Dblk] K/V chunks
// (dq) or [Qc, Dblk] query chunks (dk/dv) with f32 VMEM scratch; here one
// block owns a 64-row query tile (dq) or a key tile (dk/dv) of one head and
// walks the other axis in tiles through a two-stage cp.async ring (the copy
// of tile n+1 is issued before tile n is computed: the counterpart of the HBM
// kernel's double-buffered make_async_copy, fa:1030-1064), accumulating in
// float32 registers (bf16: wmma 16x16x16 on the tensor cores) or shared
// memory (float32: scalar FMAs, since TF32 would lose float32 parity). The
// saved lse normalises every tile exactly, so no online rescaling is needed.
// kvl and the packed bounds come from the wrapper (the TPU kernels' scalar-
// prefetch operands), so no block scans key_valid. The dk/dv kernel scales
// each q tile in shared memory after it lands (cp.async copies raw bytes) and
// sums delta from the g tile and o in device memory; its bf16 accumulators
// are staged for the store over the ring, and the dq kernel's over its score
// tiles (at Dh 256 over the ring and its score tiles). float32 Dh 128 and
// bf16 Dh 256 take 32-key tiles, float32 Dh 256 8-key tiles and a one-stage
// ring, and float32 writes p and ds over s and dp, to stay inside the 227 KB
// a block may use (Geo has the reckoning). This design has no
// bf16 Dh 64 instance: that shape takes the fused kernel.
//
// Layout: q/k/v/g/o are read through (batch, token, head) strides with a
// contiguous Dh axis and 16-byte row starts; lse is [B, H, T] float32;
// dq/dk/dv are written [B, T, H, Dh] contiguous. Every offset that can pass
// 2**31 (lse at b*H*T, the batch strides, b*T*H*Dh) is 64-bit. Dh is 16, 32,
// 64, 128 or 256; T is any length >= 1 (the ragged edge is masked).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int BQ = 64;      // query rows per tile: four warps of 16
constexpr int TILE = 64;    // the tile of the packed bounds (packed_block_bounds at 64/64)
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr float MASK_BIAS = -1e9f;  // NEG_INF of repurpose_tpu/ops/attention.py
constexpr float SKIP_LSE = 1e30f;
constexpr int NO_SEG = INT_MIN;  // segment of a query row past T: matches no key
constexpr size_t MAX_SMEM = 232448;  // bytes of shared memory a block may use

using bf16 = __nv_bfloat16;

struct Strides {
  long long b, t, h;  // in elements
};

struct Args {
  const void *q, *k, *v, *g, *o;
  Strides sq, sk, sv, sg, so;
  const uint8_t* key_valid;
  const int* seg_ids;  // null: unpacked
  const int* kvl;      // [B]
  const int* tile_lo;  // [B, ceil(T / 64)], packed only
  const int* tile_hi;
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

// Tile geometry for one (element type, head width).
template <typename T, int DH>
struct Geo {
  static constexpr bool kBf16 = std::is_same<T, bf16>::value;
  // keys per tile and ring depth: 64 keys and two stages, except where the
  // kernels' shared memory would pass 227 KB: float32 at Dh 128 takes 32-key
  // tiles; bf16 at Dh 256 32-key tiles; float32 at Dh 256 8-key tiles and
  // one stage (its dk/dv kernel's ring of float32 64-row Q and G tiles
  // alone takes 130 KB a stage)
  static constexpr int BK = DH <= 64 ? 64 : DH == 128 ? (kBf16 ? 64 : 32) : (kBf16 ? 32 : 8);
  static constexpr int STAGES = (!kBf16 && DH == 256) ? 1 : 2;
  static constexpr int PER = TILE / BK;  // key tiles per 64-key tile of the bounds
  // The bf16 dk/dv kernel's four warps split the key tile into KG groups of
  // 16 keys and Dh into WARPS / KG parts of DHW columns: each warp holds
  // register accumulators of 16 keys x DHW (at most 128) columns
  static constexpr int KG = kBf16 ? BK / 16 : WARPS;
  static constexpr int DHW = DH / (WARPS / KG);
  // Q, G, K, V rows pad by 16 bytes: cp.async needs 16-byte aligned
  // destinations, wmma 32-byte aligned tile starts and a stride that is a
  // multiple of 8 elements
  static constexpr int LD = DH + 16 / static_cast<int>(sizeof(T));
  static constexpr int LDS = BK + 4;                 // float32 s and dp tiles
  // bf16 p and ds get tiles of their own; float32 ones overwrite s and dp in
  // place (each thread rewrites only the entries it read)
  static constexpr int LDP = kBf16 ? BK + 8 : LDS;
  static constexpr int LDA = DH + 4;                 // float32 accumulators
  static constexpr int VEC = 16 / sizeof(T);         // elements per 16 bytes
  static constexpr size_t align(size_t x) { return (x + 127) / 128 * 128; }
  static constexpr size_t tile(int rows) { return align(sizeof(T) * rows * LD); }
  static constexpr size_t f32(int n) { return align(sizeof(float) * n); }
  static constexpr size_t pds() { return kBf16 ? align(sizeof(T) * BQ * LDP) : 0; }
};

// Shared memory of the dq kernel: the query tile's Q and G, a ring of K/V
// tiles and their key flags, the s / dp / ds tiles. bf16 accumulates dq in
// registers and stages it for the store over s and dp or, at Dh 256, over
// the ring and the score tiles, all free after the sweep.
template <typename T, int DH>
struct DqSmem {
  using G = Geo<T, DH>;
  static constexpr int STAGES = G::STAGES;
  static constexpr size_t kTileKV = G::tile(G::BK);  // one ring stage of K or V
  static constexpr size_t kMetaKV = G::f32(G::BK);   // one stage of key flags
  static constexpr size_t kQ = 0;
  static constexpr size_t kG = kQ + G::tile(BQ);
  static constexpr size_t kK = kG + G::tile(BQ);        // STAGES tiles
  static constexpr size_t kV = kK + STAGES * kTileKV;  // STAGES tiles
  static constexpr size_t kS = kV + STAGES * kTileKV;
  static constexpr size_t kDP = kS + G::f32(BQ * G::LDS);
  static constexpr size_t kDS = G::kBf16 ? kDP + G::f32(BQ * G::LDS) : kS;
  static constexpr size_t kTileEnd = kDP + G::f32(BQ * G::LDS) + G::pds();
  static constexpr bool kStageOverScores = G::f32(BQ * G::LDA) <= 2 * G::f32(BQ * G::LDS);
  static constexpr size_t kAcc = !G::kBf16 ? kTileEnd : kStageOverScores ? kS : kK;
  static_assert(!G::kBf16 || kAcc + G::f32(BQ * G::LDA) <= kTileEnd,
                "dq staging overflows the ring and the score tiles");
  static constexpr size_t kKeyOk = G::kBf16 ? kTileEnd : kAcc + G::f32(BQ * G::LDA);
  static constexpr size_t kKeySeg = kKeyOk + STAGES * kMetaKV;  // both STAGES
  static constexpr size_t kQSeg = kKeySeg + STAGES * kMetaKV;
  static constexpr size_t kLse = kQSeg + G::f32(BQ);
  static constexpr size_t kDelta = kLse + G::f32(BQ);
  static constexpr size_t kBytes = kDelta + G::f32(BQ);
  static_assert(kBytes <= MAX_SMEM, "dq: shared memory past the 227 KB a block may use");
};

// Shared memory of the dk/dv kernel: the key tile's K and V, a ring of Q/G
// tiles with their rows' segments and lse, the s / dp / p / ds tiles. bf16
// accumulates dk/dv in registers and stages them for the store over the
// ring, free after the sweep.
template <typename T, int DH>
struct DkvSmem {
  using G = Geo<T, DH>;
  static constexpr int STAGES = G::STAGES;
  static constexpr size_t kTileQ = G::tile(BQ);  // one ring stage of Q or G
  static constexpr size_t kMetaQ = G::f32(BQ);   // one stage of row segments or lse
  static constexpr size_t kK = 0;
  static constexpr size_t kV = kK + G::tile(G::BK);
  static constexpr size_t kQ = kV + G::tile(G::BK);     // STAGES tiles
  static constexpr size_t kG = kQ + STAGES * kTileQ;   // STAGES tiles
  static constexpr size_t kS = kG + STAGES * kTileQ;
  static constexpr size_t kDP = kS + G::f32(BQ * G::LDS);
  static constexpr size_t kP = G::kBf16 ? kDP + G::f32(BQ * G::LDS) : kS;
  static constexpr size_t kDS = G::kBf16 ? kP + G::pds() : kDP;
  static constexpr size_t kTileEnd = kDP + G::f32(BQ * G::LDS) + 2 * G::pds();
  static constexpr size_t kAccK = G::kBf16 ? kQ : kTileEnd;
  static constexpr size_t kAccV = kAccK + G::f32(G::BK * G::LDA);
  static constexpr size_t kAccEnd = kAccV + G::f32(G::BK * G::LDA);
  static_assert(!G::kBf16 || kAccEnd <= kS, "dk/dv staging overflows the ring");
  static constexpr size_t kKeyOk = G::kBf16 ? kTileEnd : kAccEnd;
  static constexpr size_t kKeySeg = kKeyOk + G::f32(G::BK);
  static constexpr size_t kQSeg = kKeySeg + G::f32(G::BK);  // both STAGES
  static constexpr size_t kLse = kQSeg + STAGES * kMetaQ;
  static constexpr size_t kDelta = kLse + STAGES * kMetaQ;
  static constexpr size_t kBytes = kDelta + G::f32(BQ);
  static_assert(kBytes <= MAX_SMEM, "dk/dv: shared memory past the 227 KB a block may use");
};

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

// Starts the cp.async copies of `rows` rows row0.. of one head into shared
// memory; rows at or past T are zero-filled.
template <typename T, int DH>
__device__ void start_rows_copy(T* dst, const T* src, long long row_stride, int row0,
                                int rows, int T_len) {
  using G = Geo<T, DH>;
  constexpr int CH = DH / G::VEC;
  for (int idx = threadIdx.x; idx < rows * CH; idx += THREADS) {
    const int r = idx / CH, ch = idx % CH;
    const bool outside = row0 + r >= T_len;
    const T* s = src + (long long)(outside ? 0 : row0 + r) * row_stride + ch * G::VEC;
    cp_async16(dst + r * G::LD + ch * G::VEC, s, outside);
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
    *reinterpret_cast<uint4*>(out_bh + (long long)t * row_stride + ch * G::VEC) =
        *reinterpret_cast<const uint4*>(vals);
  }
}

// C[16 rows of this warp, BK] = A[16 rows, Dh] . B[BK, Dh]^T in float32.
template <typename T, int DH>
__device__ void warp_abt(const T* sA, const T* sB, float* sC, int warp, int lane) {
  using G = Geo<T, DH>;
  if constexpr (G::kBf16) {
    using namespace nvcuda;
    // A's fragments stay in registers across the key tile up to Dh 128; at
    // Dh 256 (where the dq accumulators already hold 128 registers) each is
    // loaded where it is used
    constexpr int NA = DH <= 128 ? DH / 16 : 1;
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[NA];
    if constexpr (NA > 1) {
#pragma unroll
      for (int kk = 0; kk < NA; ++kk)
        wmma::load_matrix_sync(a[kk], sA + warp * 16 * G::LD + kk * 16, G::LD);
    }
#pragma unroll
    for (int n = 0; n < G::BK / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        if constexpr (NA == 1)
          wmma::load_matrix_sync(a[0], sA + warp * 16 * G::LD + kk * 16, G::LD);
        // B^T as a column-major [Dh, 16] operand is B's own row-major tile
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bt;
        wmma::load_matrix_sync(bt, sB + n * 16 * G::LD + kk * 16, G::LD);
        wmma::mma_sync(acc, a[NA == 1 ? 0 : kk], bt, acc);
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

// p and ds of this warp's 16 query rows against the key tile, from s and dp,
// in the bias form (the TPU stream kernels' rounding points); p goes to sP
// when it is given. float32 sP / sDS may alias sS / sDP: each entry is read
// before the same thread writes it.
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
    const float dd = sDP[r * G::LDS + c] - delta;
    float p = 0.f;
    if (ok >= 0) {
      const bool allowed = ok == 1 && (!packed || keySeg[c] == qs);
      const float x = s + (allowed ? 0.f : MASK_BIAS) - lse;
      p = sm_bf16 ? round_bf16(expf(round_bf16(x))) : expf(x);
    }
    const float ds = sm_bf16 ? round_bf16(p * round_bf16(dd)) : p * dd;
    if (sP != nullptr) sP[r * G::LDP + c] = from_f<T>(p);
    sDS[r * G::LDP + c] = from_f<T>(ds);
  }
}

// Key flags of key tile rows j0..j0 + BK: 1 valid, 0 masked, -1 past T; and
// their segments.
template <typename T, int DH>
__device__ void key_flags(int* keyOk, int* keySeg, const uint8_t* valid_row,
                          const int* seg_row, int j0, int T_len) {
  using G = Geo<T, DH>;
  for (int c = threadIdx.x; c < G::BK; c += THREADS) {
    const int j = j0 + c;
    keyOk[c] = j < T_len ? (valid_row[j] ? 1 : 0) : -1;
    keySeg[c] = (seg_row && j < T_len) ? seg_row[j] : 0;
  }
}

// Segments and lse of query tile rows i0..i0 + 64 (rows past T match no key
// and have p = 0).
__device__ void query_rows(int* qSeg, float* rowLse, const int* seg_row,
                           const float* lse_bh, int i0, int T_len) {
  for (int i = threadIdx.x; i < BQ; i += THREADS) {
    const int t = i0 + i;
    qSeg[i] = t < T_len ? (seg_row ? seg_row[t] : 0) : NO_SEG;
    rowLse[i] = t < T_len ? lse_bh[t] : SKIP_LSE;
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS) flash_bwd_dq_stream_kernel(Args a) {
  using G = Geo<T, DH>;
  using L = DqSmem<T, DH>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem + L::kQ);
  T* sG = reinterpret_cast<T*>(smem + L::kG);
  float* sS = reinterpret_cast<float*>(smem + L::kS);
  float* sDP = reinterpret_cast<float*>(smem + L::kDP);
  T* sDS = reinterpret_cast<T*>(smem + L::kDS);
  float* sAcc = reinterpret_cast<float*>(smem + L::kAcc);
  int* qSeg = reinterpret_cast<int*>(smem + L::kQSeg);
  float* rowLse = reinterpret_cast<float*>(smem + L::kLse);
  float* rowDelta = reinterpret_cast<float*>(smem + L::kDelta);

  const int qt = blockIdx.x, q0 = qt * BQ, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int T_len = a.T, H = a.H;
  const long long D = (long long)H * DH;
  const uint8_t* valid_row = a.key_valid + (long long)b * T_len;
  const int* seg_row = a.seg_ids ? a.seg_ids + (long long)b * T_len : nullptr;
  T* dq_bh = static_cast<T*>(a.dq) + (long long)b * T_len * D + h * DH;

  // the sweep in key tiles of BK: [0, ceil(kvl / BK)), packed bounded by the
  // query tile's [lo, hi) in 64-key tiles
  const int kvl = a.kvl[b];
  int kt_lo = 0, kt_hi = (kvl + G::BK - 1) / G::BK;
  if (seg_row) {
    const long long n_tiles = (T_len + TILE - 1) / TILE;
    kt_lo = a.tile_lo[(long long)b * n_tiles + qt] * G::PER;
    kt_hi = min(a.tile_hi[(long long)b * n_tiles + qt] * G::PER, kt_hi);
  }
  if (q0 >= kvl || kt_lo >= kt_hi) {  // padding rows, or no key to sweep: dq = 0
    store_rows<T, DH>(dq_bh, D, nullptr, q0, BQ, T_len, kvl, 0.f);
    return;
  }

  const T* q = static_cast<const T*>(a.q) + b * a.sq.b + h * a.sq.h;
  const T* k = static_cast<const T*>(a.k) + b * a.sk.b + h * a.sk.h;
  const T* v = static_cast<const T*>(a.v) + b * a.sv.b + h * a.sv.h;
  const T* g = static_cast<const T*>(a.g) + b * a.sg.b + h * a.sg.h;
  const T* o = static_cast<const T*>(a.o) + b * a.so.b + h * a.so.h;
  const float* lse_bh = a.lse + ((long long)b * H + h) * T_len;

  // K/V tile kt (and its key flags) into ring stage `stage`
  auto fetch = [&](int kt, int stage) {
    const int j0 = kt * G::BK;
    start_rows_copy<T, DH>(reinterpret_cast<T*>(smem + L::kK + stage * L::kTileKV), k,
                           a.sk.t, j0, G::BK, T_len);
    start_rows_copy<T, DH>(reinterpret_cast<T*>(smem + L::kV + stage * L::kTileKV), v,
                           a.sv.t, j0, G::BK, T_len);
    key_flags<T, DH>(reinterpret_cast<int*>(smem + L::kKeyOk + stage * L::kMetaKV),
                     reinterpret_cast<int*>(smem + L::kKeySeg + stage * L::kMetaKV),
                     valid_row, seg_row, j0, T_len);
    cp_async_commit();
  };

  fetch(kt_lo, 0);
  load_rows<T, DH>(sQ, q, a.sq.t, q0, BQ, T_len, a.scale);
  load_rows<T, DH>(sG, g, a.sg.t, q0, BQ, T_len, 0.f);
  query_rows(qSeg, rowLse, seg_row, lse_bh, q0, T_len);
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

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int stage = (kt - kt_lo) % G::STAGES;
    if constexpr (G::STAGES == 1) {
      if (kt > kt_lo) fetch(kt, 0);  // freed by the previous iteration's closing barrier
      cp_async_wait<0>();
    } else if (kt + 1 < kt_hi) {
      fetch(kt + 1, stage ^ 1);  // that stage was last read before the
      cp_async_wait<1>();        // previous iteration's closing barrier
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile kt visible to every warp
    const T* sK = reinterpret_cast<const T*>(smem + L::kK + stage * L::kTileKV);
    const T* sV = reinterpret_cast<const T*>(smem + L::kV + stage * L::kTileKV);
    const int* keyOk = reinterpret_cast<const int*>(smem + L::kKeyOk + stage * L::kMetaKV);
    const int* keySeg = reinterpret_cast<const int*>(smem + L::kKeySeg + stage * L::kMetaKV);

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
    __syncthreads();  // every warp is done with this stage before it refills
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
__global__ void __launch_bounds__(THREADS) flash_bwd_dkv_stream_kernel(Args a) {
  using G = Geo<T, DH>;
  using L = DkvSmem<T, DH>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sK = reinterpret_cast<T*>(smem + L::kK);
  T* sV = reinterpret_cast<T*>(smem + L::kV);
  float* sS = reinterpret_cast<float*>(smem + L::kS);
  float* sDP = reinterpret_cast<float*>(smem + L::kDP);
  T* sP = reinterpret_cast<T*>(smem + L::kP);
  T* sDS = reinterpret_cast<T*>(smem + L::kDS);
  float* sAccK = reinterpret_cast<float*>(smem + L::kAccK);
  float* sAccV = reinterpret_cast<float*>(smem + L::kAccV);
  int* keyOk = reinterpret_cast<int*>(smem + L::kKeyOk);
  int* keySeg = reinterpret_cast<int*>(smem + L::kKeySeg);
  float* rowDelta = reinterpret_cast<float*>(smem + L::kDelta);

  const int j0 = blockIdx.x * G::BK, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int T_len = a.T, H = a.H;
  const long long D = (long long)H * DH;
  const uint8_t* valid_row = a.key_valid + (long long)b * T_len;
  const int* seg_row = a.seg_ids ? a.seg_ids + (long long)b * T_len : nullptr;
  T* dk_bh = static_cast<T*>(a.dk) + (long long)b * T_len * D + h * DH;
  T* dv_bh = static_cast<T*>(a.dv) + (long long)b * T_len * D + h * DH;

  // the sweep in 64-row query tiles: [0, ceil(kvl / 64)), packed bounded by
  // the [lo, hi) of the 64-key tile that holds this key tile
  const int kvl = a.kvl[b];
  int qt_lo = 0, qt_hi = (kvl + BQ - 1) / BQ;
  if (seg_row) {
    const long long n_tiles = (T_len + TILE - 1) / TILE;
    qt_lo = a.tile_lo[(long long)b * n_tiles + j0 / TILE];
    qt_hi = min(a.tile_hi[(long long)b * n_tiles + j0 / TILE], qt_hi);
  }
  if (j0 >= kvl || qt_lo >= qt_hi) {  // no valid key, or no query to sweep: 0
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

  auto ring_q = [&](int stage) { return reinterpret_cast<T*>(smem + L::kQ + stage * L::kTileQ); };
  auto ring_g = [&](int stage) { return reinterpret_cast<T*>(smem + L::kG + stage * L::kTileQ); };
  auto ring_seg = [&](int stage) {
    return reinterpret_cast<int*>(smem + L::kQSeg + stage * L::kMetaQ);
  };
  auto ring_lse = [&](int stage) {
    return reinterpret_cast<float*>(smem + L::kLse + stage * L::kMetaQ);
  };
  // raw Q and G rows of query tile qt (and their segments and lse) into ring
  // stage `stage`
  auto fetch = [&](int qt, int stage) {
    const int i0 = qt * BQ;
    start_rows_copy<T, DH>(ring_q(stage), q, a.sq.t, i0, BQ, T_len);
    start_rows_copy<T, DH>(ring_g(stage), g, a.sg.t, i0, BQ, T_len);
    query_rows(ring_seg(stage), ring_lse(stage), seg_row, lse_bh, i0, T_len);
    cp_async_commit();
  };

  fetch(qt_lo, 0);
  load_rows<T, DH>(sK, k, a.sk.t, j0, G::BK, T_len, 0.f);
  load_rows<T, DH>(sV, v, a.sv.t, j0, G::BK, T_len, 0.f);
  key_flags<T, DH>(keyOk, keySeg, valid_row, seg_row, j0, T_len);
  if constexpr (!G::kBf16)
    for (int i = tid; i < G::BK * G::LDA; i += THREADS) sAccK[i] = sAccV[i] = 0.f;

  using namespace nvcuda;
  // bf16: this warp's 16 keys kg and DHW columns d0 of the accumulators
  const int kg = warp % G::KG, d0 = warp / G::KG * G::DHW;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> accK[G::DHW / 16], accV[G::DHW / 16];
  if constexpr (G::kBf16) {
#pragma unroll
    for (int n = 0; n < G::DHW / 16; ++n) {
      wmma::fill_fragment(accK[n], 0.f);
      wmma::fill_fragment(accV[n], 0.f);
    }
  }

  for (int qt = qt_lo; qt < qt_hi; ++qt) {
    const int stage = (qt - qt_lo) % G::STAGES;
    if constexpr (G::STAGES == 1) {
      if (qt > qt_lo) fetch(qt, 0);  // freed by the previous iteration's closing barrier
      cp_async_wait<0>();
    } else if (qt + 1 < qt_hi) {
      fetch(qt + 1, stage ^ 1);  // that stage was last read before the
      cp_async_wait<1>();        // previous iteration's closing barrier
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile qt (and K/V, key flags) visible to every thread
    T* sQ = ring_q(stage);
    const T* sG = ring_g(stage);
    // q_s = round(float(q) * scale), in place: cp.async brought raw q
    for (int i = tid; i < BQ * DH; i += THREADS) {
      T* x = sQ + (i / DH) * G::LD + i % DH;
      *x = from_f<T>(to_f(*x) * a.scale);
    }
    tile_delta<T, DH>(sG, o, a.so.t, qt * BQ, T_len, rowDelta);
    __syncthreads();  // the scaled tile visible to every warp

    warp_abt<T, DH>(sQ, sK, sS, warp, lane);   // s
    warp_abt<T, DH>(sG, sV, sDP, warp, lane);  // dp
    __syncwarp();
    warp_probs<T, DH>(sS, sDP, sP, sDS, keyOk, keySeg, ring_seg(stage), ring_lse(stage),
                      rowDelta, seg_row != nullptr, a.sm_bf16, warp, lane);
    __syncthreads();  // every query row's p and ds are in place

    // dv[keys] += p^T . G and dk[keys] += ds^T . Q_s over this query tile
    if constexpr (G::kBf16) {
      // this warp's 16 keys and DHW columns; p^T as a column-major
      // [16 keys, 16 queries] operand is p's own row-major tile
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> pa, da;
        wmma::load_matrix_sync(pa, sP + kk * 16 * G::LDP + kg * 16, G::LDP);
        wmma::load_matrix_sync(da, sDS + kk * 16 * G::LDP + kg * 16, G::LDP);
#pragma unroll
        for (int n = 0; n < G::DHW / 16; ++n) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> gb, qb;
          wmma::load_matrix_sync(gb, sG + kk * 16 * G::LD + d0 + n * 16, G::LD);
          wmma::mma_sync(accV[n], pa, gb, accV[n]);
          wmma::load_matrix_sync(qb, sQ + kk * 16 * G::LD + d0 + n * 16, G::LD);
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
    __syncthreads();  // this stage and the p / ds tiles are no longer read
  }
  if constexpr (G::kBf16) {  // staged over the ring, free after the last barrier
#pragma unroll
    for (int n = 0; n < G::DHW / 16; ++n) {
      wmma::store_matrix_sync(sAccK + kg * 16 * G::LDA + d0 + n * 16, accK[n], G::LDA,
                              wmma::mem_row_major);
      wmma::store_matrix_sync(sAccV + kg * 16 * G::LDA + d0 + n * 16, accV[n], G::LDA,
                              wmma::mem_row_major);
    }
  }
  __syncthreads();
  store_rows<T, DH>(dk_bh, D, sAccK, j0, G::BK, T_len, kvl, 1.f);
  store_rows<T, DH>(dv_bh, D, sAccV, j0, G::BK, T_len, kvl, 1.f);
}

// ---- the tensor-core path's prep: bf16 at Dh 64 --------------------------------------

// The prep: q_s, {lse, delta} and {key flag, segment} once per backward, eight
// threads per (b, t, h) row (16 bytes of q, g and o each), rows past T padded.
// Bound by bytes: q, g and o read once, q_s written once.
constexpr int PREP_THREADS = 256;

struct PrepArgs {
  const bf16 *q, *g, *o;
  Strides sq, sg, so;
  const float* lse;  // [B, H, T]
  const uint8_t* key_valid;
  const int* seg_ids;  // null: unpacked (segment 0)
  bf16* qs;            // [B, T, H, 64]
  float2* rows;        // [B, H, Tp]
  int2* info;          // [B, Tp]
  int B, T, Tp, H;
  float scale;
};

__global__ void __launch_bounds__(PREP_THREADS) flash_bwd_stream_prep_kernel(PrepArgs a) {
  const long long gid = (long long)blockIdx.x * PREP_THREADS + threadIdx.x;
  const long long row = gid / 8;
  const int part = static_cast<int>(gid % 8), h = static_cast<int>(row % a.H);
  const long long bt = row / a.H;
  const int t = static_cast<int>(bt % a.Tp);
  const long long b = bt / a.Tp;
  const bool real = b < a.B && t < a.T;
  float acc = 0.f;
  if (real) {
    const int c = 8 * part;
    const uint4 qv = *reinterpret_cast<const uint4*>(a.q + b * a.sq.b + t * a.sq.t + h * a.sq.h + c);
    const uint4 gv = *reinterpret_cast<const uint4*>(a.g + b * a.sg.b + t * a.sg.t + h * a.sg.h + c);
    const uint4 ov = *reinterpret_cast<const uint4*>(a.o + b * a.so.b + t * a.so.t + h * a.so.h + c);
    const bf16* qe = reinterpret_cast<const bf16*>(&qv);
    const bf16* ge = reinterpret_cast<const bf16*>(&gv);
    const bf16* oe = reinterpret_cast<const bf16*>(&ov);
    __align__(16) bf16 out[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      out[e] = __float2bfloat16_rn(__bfloat162float(qe[e]) * a.scale);
      acc += __bfloat162float(ge[e]) * __bfloat162float(oe[e]);
    }
    *reinterpret_cast<uint4*>(a.qs + ((b * a.T + t) * a.H + h) * hopper::TC_DH + c) =
        *reinterpret_cast<const uint4*>(out);
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);  // the row's eight parts
  acc += __shfl_xor_sync(0xffffffffu, acc, 2);
  acc += __shfl_xor_sync(0xffffffffu, acc, 4);
  if (part != 0 || b >= a.B) return;
  const float lse = t < a.T ? a.lse[(b * a.H + h) * a.T + t] : SKIP_LSE;
  a.rows[(b * a.H + h) * a.Tp + t] = make_float2(lse, t < a.T ? acc : 0.f);
  if (h == 0) {
    const int ok = t < a.T ? (a.key_valid[b * a.T + t] ? 1 : 0) : -1;
    const int sg = (a.seg_ids != nullptr && t < a.T) ? a.seg_ids[b * a.T + t] : 0;
    a.info[b * a.Tp + t] = make_int2(ok, sg);
  }
}

int run_prep(const void* q, const void* g, const void* o, const long long* strides,
             const void* lse, const void* key_valid, const void* seg_ids, void* qs, void* rows,
             void* info, int B, int T_len, int H, int Dh, float scale, cudaStream_t stream) {
  if (B <= 0 || T_len <= 0 || H <= 0) return 0;
  if (Dh != hopper::TC_DH) return (int)cudaErrorInvalidValue;
  PrepArgs a;
  a.q = static_cast<const bf16*>(q);
  a.g = static_cast<const bf16*>(g);
  a.o = static_cast<const bf16*>(o);
  Strides* st[3] = {&a.sq, &a.sg, &a.so};
  for (int i = 0; i < 3; ++i)
    *st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  a.lse = static_cast<const float*>(lse);
  a.key_valid = static_cast<const uint8_t*>(key_valid);
  a.seg_ids = static_cast<const int*>(seg_ids);
  a.qs = static_cast<bf16*>(qs);
  a.rows = static_cast<float2*>(rows);
  a.info = static_cast<int2*>(info);
  a.B = B;
  a.T = T_len;
  a.Tp = (T_len + BQ - 1) / BQ * BQ;
  a.H = H;
  a.scale = scale;
  const long long threads = (long long)B * a.Tp * H * 8;
  flash_bwd_stream_prep_kernel<<<(unsigned)((threads + PREP_THREADS - 1) / PREP_THREADS),
                                 PREP_THREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int DH>
int launch(bool dq, const Args& a, int B, cudaStream_t stream) {
  using G = Geo<T, DH>;
  const size_t smem = dq ? DqSmem<T, DH>::kBytes : DkvSmem<T, DH>::kBytes;
  void (*kernel)(Args) =
      dq ? &flash_bwd_dq_stream_kernel<T, DH> : &flash_bwd_dkv_stream_kernel<T, DH>;
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
    case 256: return launch<T, 256>(dq, a, B, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

int run(bool dq, const void* q, const void* k, const void* v, const void* g,
        const void* o, const long long* strides, const void* key_valid,
        const void* seg_ids, const void* kvl, const void* lo, const void* hi,
        const void* lse, void* out0, void* out1, int B, int T_len, int H, int Dh,
        int is_bf16, int sm_bf16, float scale, void* stream) {
  if (B <= 0 || T_len <= 0 || H <= 0) return 0;
  if (!kvl || (seg_ids && (!lo || !hi))) return (int)cudaErrorInvalidValue;
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
  a.kvl = static_cast<const int*>(kvl);
  a.tile_lo = static_cast<const int*>(lo);
  a.tile_hi = static_cast<const int*>(hi);
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

}  // namespace

// C entry points, bound with ctypes (repurpose_tpu_torch/native.py).
// `strides` holds 15 element strides: (batch, token, head) of q, k, v, g, o in
// that order. is_bf16 selects bf16 (1) or float32 (0) for q/k/v/g/o and the
// outputs; a null seg_ids selects the unpacked variant (lo and hi are then
// ignored). kvl is int32 [B]; lo/hi are int32 [B, ceil(T / 64)]
// (`packed_block_bounds` at 64/64). Each returns cudaGetLastError() after its
// launch (0 on success); bf16 at Dh 64 is refused (cudaErrorInvalidValue):
// it takes the tensor-core entry points of flash_bwd.cu.
extern "C" int flash_bwd_dq_stream(const void* q, const void* k, const void* v,
                                   const void* g, const void* o, const long long* strides,
                                   const void* key_valid, const void* seg_ids,
                                   const void* kvl, const void* lo, const void* hi,
                                   const void* lse, void* dq, int B, int T_len, int H,
                                   int Dh, int is_bf16, int sm_bf16, float scale,
                                   void* stream) {
  return run(true, q, k, v, g, o, strides, key_valid, seg_ids, kvl, lo, hi, lse, dq,
             nullptr, B, T_len, H, Dh, is_bf16, sm_bf16, scale, stream);
}

extern "C" int flash_bwd_dkv_stream(const void* q, const void* k, const void* v,
                                    const void* g, const void* o, const long long* strides,
                                    const void* key_valid, const void* seg_ids,
                                    const void* kvl, const void* lo, const void* hi,
                                    const void* lse, void* dk, void* dv, int B, int T_len,
                                    int H, int Dh, int is_bf16, int sm_bf16, float scale,
                                    void* stream) {
  return run(false, q, k, v, g, o, strides, key_valid, seg_ids, kvl, lo, hi, lse, dk, dv,
             B, T_len, H, Dh, is_bf16, sm_bf16, scale, stream);
}

// The tensor-core path's prep (bf16, Dh 64). `strides` holds 9 element
// strides: (batch, token, head) of q, g, o. It writes q_s [B, T, H, 64]
// bf16, rows [B, H, Tp] {lse, delta} float32 and info [B, Tp] {key flag,
// segment} int32, Tp = T rounded up to 64, which the tensor-core kernels of
// flash_bwd.cu read (qs contiguous) with kvl and, packed, lo/hi as above.
// Returns cudaGetLastError() after its launch (0 on success).
extern "C" int flash_bwd_stream_prep(const void* q, const void* g, const void* o,
                                     const long long* strides, const void* lse,
                                     const void* key_valid, const void* seg_ids, void* qs,
                                     void* rows, void* info, int B, int T_len, int H, int Dh,
                                     float scale, void* stream) {
  return run_prep(q, g, o, strides, lse, key_valid, seg_ids, qs, rows, info, B, T_len, H, Dh,
                  scale, static_cast<cudaStream_t>(stream));
}
