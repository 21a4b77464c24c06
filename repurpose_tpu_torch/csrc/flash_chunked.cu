// Head-chunked attention forward and backward for Hopper (sm_90a): the
// instances of the four first designs for heads wider than 256, where no
// fixed-width instance fits in a block's shared memory.
//
// They take the place of the first designs past Dh 256, and so replace the
// same TPU kernels of repurpose_tpu/ops/flash_attention.py, whose dispatcher
// `mha_pallas` (line 1688) runs any Dh:
//   - flash_fwd_chunked_kernel<T, false> (the dense forward of flash_fwd.cu):
//     `_flash_fwd_kernel` (line 227), unpacked and packed;
//   - flash_fwd_chunked_kernel<T, true> (the stream forward of
//     flash_fwd_stream.cu): `_flash_fwd_stream_kernel` (592),
//     `_flash_fwd_packed_stream_kernel` (512), `_flash_fwd_hbm_kernel` (657);
//   - flash_bwd_{dq,dkv}_chunked_kernel<T, false> (the dense pair of
//     flash_bwd.cu): `_bwd_dq_kernel` (783), `_bwd_dkv_kernel` +
//     `_dkv_compute` (1109, 1149);
//   - flash_bwd_{dq,dkv}_chunked_kernel<T, true> (the stream pair of
//     flash_bwd_stream.cu): `_bwd_dq_stream_kernel` (859),
//     `_bwd_dq_packed_stream_kernel` (914), `_bwd_dq_hbm_kernel` (992),
//     `_bwd_dkv_stream_kernel` (1200).
// The template flag STREAM selects the sweep and the rounding points of the
// design each instance stands in for, and nothing else:
//   - the dense forward sweeps every 64-key tile up to kvl and rounds
//     p = R(exp(R(s - m'))); the stream forward sweeps [0, ceil(kvl / 64)),
//     packed [lo, min(hi, ceil(kvl / 64))) of `packed_block_bounds`, and
//     rounds p = R(exp(R(s - R(m')))) (flash_fwd_stream.cu's note);
//   - the dense backward sweeps every tile up to kvl, in the select form when
//     packed (masked pairs are chosen away after the exp) and the bias form
//     unpacked; the stream backward sweeps as the stream forward does (dk/dv:
//     the key tile's own bounds), always in the bias form (flash_bwd.cu's and
//     flash_bwd_stream.cu's notes).
// What each computes is the contract of those files; only the order of the
// float32 sums over the head differs. Rows at or past kvl get out = 0 and
// lse = 1e30, dq = 0, dk = dv = 0, as in every other instance.
//
// Why chunks. A 64-row query tile of a Dh 512 head in float32 needs its Q
// tile and its float32 output accumulator alone, 260 KB, past the 227 KB a
// block may use; another fixed width would only move that limit. So the head
// axis is walked in chunks of DC = 64 columns (the wrapper zero-pads the head
// to a multiple of 64, with the head's own scale; zero columns add nothing to
// any product or to rowsum(g o)), and the kernel takes the number of chunks
// at run time: one build per (dtype, DC) serves every width.
//   - the scores of a (query tile, key tile) pair are summed chunk by chunk,
//     S = sum_c Q_c K_c^T (and dP = sum_c G_c V_c^T), each chunk of each
//     operand staged through shared memory in turn;
//   - the online softmax (forward) and p / ds (backward) are formed once on
//     the whole S, as in the fixed-width instances;
//   - the products that give a head-wide result walk the chunks again:
//     O_c = alpha O_c + P V_c in the forward, dq_c += dS K_c, dv_c += P^T G_c
//     and dk_c += dS^T Q_c in the backward;
//   - the float32 accumulators of a block's rows live in a float32 workspace
//     in device memory, [B, H, Tp, Dh] (Tp = T rounded up to 64), that the
//     wrapper allocates; each chunk of them is staged through shared memory
//     for its product and written back. One block owns its rows, so nothing
//     races; the first tile of a sweep writes its rows without reading them;
//   - delta = rowsum(g o) runs over the whole padded head, from device
//     memory, before any chunk.
//
// What bounds it. The products are those of the fixed-width instances (2 Dh
// operations per (query, key) pair and product); on top of them each swept
// tile pair moves every chunk of the accumulators through the workspace
// (read and written once per key tile in the forward and dq, per query tile
// in dk/dv) and re-reads the q chunks it scores against. This first design
// is simple, not fast: bf16 products on the tensor cores through
// `nvcuda::wmma` (16x16x16, float32 accumulate), float32 ones as scalar FMAs
// (TF32 would lose float32 parity). Its times stand in PERF.md.
//
// Layout: q/k/v/g/o are read through (batch, token, head) strides with a
// contiguous Dh axis and 16-byte row starts; out/dq/dk/dv are written
// [B, T, H, Dh] contiguous; lse is [B, H, T] float32. kvl is int32 [B]; lo /
// hi (packed, stream sweep) int32 [B, ceil(T / 64)]. Dh is any multiple of
// 64; T is any length >= 1. Every offset that can pass 2**31 is 64-bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math_constants.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BQ = 64;  // query rows per tile: four warps of 16
constexpr int BK = 64;  // keys per tile (the 64/64 tiles of the sweep)
constexpr int DC = 64;  // head columns per chunk
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr float MASK_BIAS = -1e9f;  // NEG_INF of repurpose_tpu/ops/attention.py
constexpr float SKIP_LSE = 1e30f;
constexpr float M_INIT = -1e30f;
constexpr int NO_SEG = INT_MIN;  // segment of a query row past T: matches no key

using bf16 = __nv_bfloat16;

struct Strides {
  long long b, t, h;  // in elements
};

struct Args {
  const void *q, *k, *v, *g, *o;  // g, o: backward only
  Strides sq, sk, sv, sg, so;
  const uint8_t* key_valid;
  const int* seg_ids;  // null: unpacked
  const int* kvl;      // [B]
  const int* tile_lo;  // [B, ceil(T / 64)], packed stream sweep only
  const int* tile_hi;
  const float* lse_in;  // backward: the forward's lse
  float* lse_out;       // forward
  void *out0, *out1;    // forward: out; dq: dq; dk/dv: dk, dv
  float *ws0, *ws1;     // float32 workspaces [B, H, Tp, Dh] (dk/dv: two)
  int T, H, Dh;
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

// Tile geometry for one element type: every operand tile is [64, DC].
template <typename T>
struct Geo {
  static constexpr bool kBf16 = std::is_same<T, bf16>::value;
  // bf16 rows pad by 8 elements (wmma wants 32-byte aligned tile starts and a
  // stride that is a multiple of 8); float32 rows pad by 1 so the scalar
  // loops walk distinct banks
  static constexpr int LD = DC + (kBf16 ? 8 : 1);   // operand chunks
  static constexpr int LDS = BK + 4;                 // float32 s and dp tiles
  static constexpr int LDP = BK + (kBf16 ? 8 : 1);  // p and ds in T
  static constexpr int LDA = DC + 4;                 // float32 accumulator chunks
  static constexpr int VEC = 16 / sizeof(T);         // elements per 16 bytes
  static constexpr size_t align(size_t x) { return (x + 127) / 128 * 128; }
  static constexpr size_t tile() { return align(sizeof(T) * 64 * LD); }
  static constexpr size_t f32(int n) { return align(sizeof(float) * n); }
  static constexpr size_t probs() { return align(sizeof(T) * 64 * LDP); }
};

// Shared memory of the forward: a Q chunk, a K or V chunk, s, p, the staged
// output chunk, key flags and per-row state.
template <typename T>
struct FwdSmem {
  using G = Geo<T>;
  static constexpr size_t kQ = 0;
  static constexpr size_t kKV = kQ + G::tile();
  static constexpr size_t kS = kKV + G::tile();
  static constexpr size_t kP = kS + G::f32(BQ * G::LDS);
  static constexpr size_t kAcc = kP + G::probs();
  static constexpr size_t kKeyOk = kAcc + G::f32(BQ * G::LDA);
  static constexpr size_t kKeySeg = kKeyOk + G::f32(BK);
  static constexpr size_t kQSeg = kKeySeg + G::f32(BK);
  static constexpr size_t kRowM = kQSeg + G::f32(BQ);
  static constexpr size_t kRowL = kRowM + G::f32(BQ);
  static constexpr size_t kRowAlpha = kRowL + G::f32(BQ);
  static constexpr size_t kBytes = kRowAlpha + G::f32(BQ);
  static_assert(kBytes <= 227 * 1024, "forward: shared memory past the 227 KB a block may use");
};

// Shared memory of the dq kernel: Q, K, G and V chunks, s, dp, ds, the
// staged dq chunk, key flags and per-row state.
template <typename T>
struct DqSmem {
  using G = Geo<T>;
  static constexpr size_t kQ = 0;
  static constexpr size_t kK = kQ + G::tile();
  static constexpr size_t kG = kK + G::tile();
  static constexpr size_t kV = kG + G::tile();
  static constexpr size_t kS = kV + G::tile();
  static constexpr size_t kDP = kS + G::f32(BQ * G::LDS);
  static constexpr size_t kDS = kDP + G::f32(BQ * G::LDS);
  static constexpr size_t kAcc = kDS + G::probs();
  static constexpr size_t kKeyOk = kAcc + G::f32(BQ * G::LDA);
  static constexpr size_t kKeySeg = kKeyOk + G::f32(BK);
  static constexpr size_t kQSeg = kKeySeg + G::f32(BK);
  static constexpr size_t kLse = kQSeg + G::f32(BQ);
  static constexpr size_t kDelta = kLse + G::f32(BQ);
  static constexpr size_t kBytes = kDelta + G::f32(BQ);
  static_assert(kBytes <= 227 * 1024, "dq: shared memory past the 227 KB a block may use");
};

// Shared memory of the dk/dv kernel: as dq's, with p beside ds and two
// staged accumulator chunks (dk, dv).
template <typename T>
struct DkvSmem {
  using G = Geo<T>;
  static constexpr size_t kK = 0;
  static constexpr size_t kV = kK + G::tile();
  static constexpr size_t kQ = kV + G::tile();
  static constexpr size_t kG = kQ + G::tile();
  static constexpr size_t kS = kG + G::tile();
  static constexpr size_t kDP = kS + G::f32(BQ * G::LDS);
  static constexpr size_t kP = kDP + G::f32(BQ * G::LDS);
  static constexpr size_t kDS = kP + G::probs();
  static constexpr size_t kAccK = kDS + G::probs();
  static constexpr size_t kAccV = kAccK + G::f32(BK * G::LDA);
  static constexpr size_t kKeyOk = kAccV + G::f32(BK * G::LDA);
  static constexpr size_t kKeySeg = kKeyOk + G::f32(BK);
  static constexpr size_t kQSeg = kKeySeg + G::f32(BK);
  static constexpr size_t kLse = kQSeg + G::f32(BQ);
  static constexpr size_t kDelta = kLse + G::f32(BQ);
  static constexpr size_t kBytes = kDelta + G::f32(BQ);
  static_assert(kBytes <= 227 * 1024, "dk/dv: shared memory past the 227 KB a block may use");
};

// Copies columns col0 .. col0 + DC of 64 rows row0.. of one head into shared
// memory, zero-filling rows at or past T. With `scale` > 0 each element
// becomes round(float(x) * scale), the TPU kernels' scaled q.
template <typename T>
__device__ void load_chunk(T* dst, const T* src, long long row_stride, int row0, int T_len,
                           int col0, float scale) {
  using G = Geo<T>;
  constexpr int CH = DC / G::VEC;  // 16-byte pieces per row
  for (int idx = threadIdx.x; idx < 64 * CH; idx += THREADS) {
    const int r = idx / CH, ch = idx % CH;
    T* d = dst + r * G::LD + ch * G::VEC;
    if (row0 + r < T_len) {
      const uint4 raw = *reinterpret_cast<const uint4*>(
          src + (long long)(row0 + r) * row_stride + col0 + ch * G::VEC);
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

// Stages columns col0 .. col0 + DC of the 64 workspace rows at `ws` (row
// stride Dh) into sAcc, each row times rowMul[r] when given; zeros when
// `fresh` (the first tile of the sweep: the workspace holds nothing yet).
template <typename T>
__device__ void stage_acc(float* sAcc, const float* ws, int Dh, int col0, const float* rowMul,
                          bool fresh) {
  using G = Geo<T>;
  for (int idx = threadIdx.x; idx < 64 * DC; idx += THREADS) {
    const int r = idx / DC, c = idx % DC;
    float x = 0.f;
    if (!fresh) {
      x = ws[(long long)r * Dh + col0 + c];
      if (rowMul != nullptr) x *= rowMul[r];
    }
    sAcc[r * G::LDA + c] = x;
  }
}

// Writes sAcc back to columns col0 .. col0 + DC of the 64 workspace rows.
template <typename T>
__device__ void unstage_acc(float* ws, const float* sAcc, int Dh, int col0) {
  using G = Geo<T>;
  for (int idx = threadIdx.x; idx < 64 * DC; idx += THREADS) {
    const int r = idx / DC, c = idx % DC;
    ws[(long long)r * Dh + col0 + c] = sAcc[r * G::LDA + c];
  }
}

// Writes the 64 rows row0.. of one head of a [B, T, H, Dh] output from the
// block's workspace rows `ws`: ws / rowDiv[r] where rowDiv is given, else
// ws * mul; zeros for rows at or past kvl, and everywhere when ws is null.
template <typename T>
__device__ void store_rows(T* out_bh, long long row_stride, const float* ws, int Dh, int row0,
                           int T_len, int kvl, float mul, const float* rowDiv) {
  using G = Geo<T>;
  const int ch_per_row = Dh / G::VEC;
  for (int idx = threadIdx.x; idx < 64 * ch_per_row; idx += THREADS) {
    const int r = idx / ch_per_row, ch = idx % ch_per_row, t = row0 + r;
    if (t >= T_len) continue;
    __align__(16) T vals[G::VEC];
#pragma unroll
    for (int e = 0; e < G::VEC; ++e) {
      float x = 0.f;
      if (ws != nullptr && t < kvl) {
        x = ws[(long long)r * Dh + ch * G::VEC + e];
        x = rowDiv != nullptr ? x / rowDiv[r] : x * mul;
      }
      vals[e] = from_f<T>(x);
    }
    *reinterpret_cast<uint4*>(out_bh + (long long)t * row_stride + ch * G::VEC) =
        *reinterpret_cast<const uint4*>(vals);
  }
}

// C[16 rows of this warp, BK] (+)= A[16 rows, DC] . B[BK, DC]^T in float32:
// one chunk's part of s (Q_c K_c^T) or dp (G_c V_c^T); `accumulate` adds it
// to what C holds (the chunks before).
template <typename T>
__device__ void warp_abt(const T* sA, const T* sB, float* sC, bool accumulate, int warp,
                         int lane) {
  using G = Geo<T>;
  if constexpr (G::kBf16) {
    using namespace nvcuda;
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[DC / 16];
#pragma unroll
    for (int kk = 0; kk < DC / 16; ++kk)
      wmma::load_matrix_sync(a[kk], sA + warp * 16 * G::LD + kk * 16, G::LD);
#pragma unroll
    for (int n = 0; n < BK / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      float* c = sC + warp * 16 * G::LDS + n * 16;
      if (accumulate)
        wmma::load_matrix_sync(acc, c, G::LDS, wmma::mem_row_major);
      else
        wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < DC / 16; ++kk) {
        // B^T as a column-major [DC, 16] operand is B's own row-major tile
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bt;
        wmma::load_matrix_sync(bt, sB + n * 16 * G::LD + kk * 16, G::LD);
        wmma::mma_sync(acc, a[kk], bt, acc);
      }
      wmma::store_matrix_sync(c, acc, G::LDS, wmma::mem_row_major);
    }
  } else {
    const int r = warp * 16 + lane / 2, half = lane & 1;
    for (int i = 0; i < BK / 2; ++i) {
      const int c = 2 * i + half;
      float acc = 0.f;
#pragma unroll 8
      for (int d = 0; d < DC; ++d) acc += to_f(sA[r * G::LD + d]) * to_f(sB[c * G::LD + d]);
      sC[r * G::LDS + c] = accumulate ? sC[r * G::LDS + c] + acc : acc;
    }
  }
}

// sAcc[16 rows of this warp, DC] += A[16 rows, BK] . B[BK, DC]: p v_c in the
// forward, ds k_c in dq (A in T with row stride LDP).
template <typename T>
__device__ void warp_ab_acc(const T* sA, const T* sB, float* sAcc, int warp, int lane) {
  using G = Geo<T>;
  if constexpr (G::kBf16) {
    using namespace nvcuda;
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[BK / 16];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wmma::load_matrix_sync(a[kk], sA + warp * 16 * G::LDP + kk * 16, G::LDP);
#pragma unroll
    for (int n = 0; n < DC / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      float* o = sAcc + warp * 16 * G::LDA + n * 16;
      wmma::load_matrix_sync(acc, o, G::LDA, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(b, sB + kk * 16 * G::LD + n * 16, G::LD);
        wmma::mma_sync(acc, a[kk], b, acc);
      }
      wmma::store_matrix_sync(o, acc, G::LDA, wmma::mem_row_major);
    }
  } else {
    const int r = warp * 16 + lane / 2, half = lane & 1;
    for (int i = 0; i < DC / 2; ++i) {
      const int c = 2 * i + half;
      float acc = 0.f;
#pragma unroll 8
      for (int j = 0; j < BK; ++j) acc += to_f(sA[r * G::LDP + j]) * to_f(sB[j * G::LD + c]);
      sAcc[r * G::LDA + c] += acc;
    }
  }
}

// Key flags of key tile rows j0..j0 + 64: 1 valid, 0 masked, -1 past T (no
// such key); and their segments.
__device__ void key_flags(int* keyOk, int* keySeg, const uint8_t* valid_row, const int* seg_row,
                          int j0, int T_len) {
  for (int c = threadIdx.x; c < BK; c += THREADS) {
    const int j = j0 + c;
    keyOk[c] = j < T_len ? (valid_row[j] ? 1 : 0) : -1;
    keySeg[c] = (seg_row && j < T_len) ? seg_row[j] : 0;
  }
}

// Segments and lse of query tile rows i0..i0 + 64 (rows past T match no key
// and have p = 0).
__device__ void query_rows(int* qSeg, float* rowLse, const int* seg_row, const float* lse_bh,
                           int i0, int T_len) {
  for (int i = threadIdx.x; i < BQ; i += THREADS) {
    const int t = i0 + i;
    qSeg[i] = t < T_len ? (seg_row ? seg_row[t] : 0) : NO_SEG;
    rowLse[i] = t < T_len ? lse_bh[t] : SKIP_LSE;
  }
}

// delta of the 64 query rows i0..: sum over the whole (padded) head of g * o
// in float32, from device memory; 0 for rows past T. Two threads a row.
template <typename T>
__device__ void rows_delta(const T* g_bh, long long g_row, const T* o_bh, long long o_row,
                           int i0, int T_len, int Dh, float* rowDelta) {
  using G = Geo<T>;
  const int r = threadIdx.x / 2, half = threadIdx.x & 1, t = i0 + r;
  float acc = 0.f;
  if (t < T_len) {
    const T* g_t = g_bh + (long long)t * g_row;
    const T* o_t = o_bh + (long long)t * o_row;
    for (int d = half * G::VEC; d < Dh; d += 2 * G::VEC) {
      const uint4 graw = *reinterpret_cast<const uint4*>(g_t + d);
      const uint4 oraw = *reinterpret_cast<const uint4*>(o_t + d);
      const T* gv = reinterpret_cast<const T*>(&graw);
      const T* ov = reinterpret_cast<const T*>(&oraw);
#pragma unroll
      for (int e = 0; e < G::VEC; ++e) acc += to_f(gv[e]) * to_f(ov[e]);
    }
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  if (half == 0) rowDelta[r] = acc;
}

// p and ds of this warp's 16 query rows against the key tile, from s and dp:
// the select form (`select`: the dense backward's packed rows) or the bias
// form; p goes to sP when it is given.
template <typename T>
__device__ void warp_probs(const float* sS, const float* sDP, T* sP, T* sDS, const int* keyOk,
                           const int* keySeg, const int* qSeg, const float* rowLse,
                           const float* rowDelta, bool packed, bool select, int sm_bf16,
                           int warp, int lane) {
  using G = Geo<T>;
  const int r = warp * 16 + lane / 2, half = lane & 1;
  const float lse = rowLse[r], delta = rowDelta[r];
  const int qs = qSeg[r];
  for (int i = 0; i < BK / 2; ++i) {
    const int c = 2 * i + half;
    const int ok = keyOk[c];
    const float s = sS[r * G::LDS + c];
    float p = 0.f;
    if (select) {
      if (ok == 1 && keySeg[c] == qs)
        p = sm_bf16 ? round_bf16(expf(round_bf16(s - lse))) : expf(s - lse);
    } else if (ok >= 0) {
      const bool allowed = ok == 1 && (!packed || keySeg[c] == qs);
      const float x = s + (allowed ? 0.f : MASK_BIAS) - lse;
      p = sm_bf16 ? round_bf16(expf(round_bf16(x))) : expf(x);
    }
    const float dd = sDP[r * G::LDS + c] - delta;
    const float ds = sm_bf16 ? round_bf16(p * round_bf16(dd)) : p * dd;
    if (sP != nullptr) sP[r * G::LDP + c] = from_f<T>(p);
    sDS[r * G::LDP + c] = from_f<T>(ds);
  }
}

// The tile range [lo, hi) a block sweeps: [0, ceil(kvl / 64)), bounded by
// the packed stream sweep's [lo, hi) of tile `tile` (STREAM and packed).
template <bool STREAM>
__device__ void sweep_range(const Args& a, int b, int tile, int kvl, int* lo, int* hi) {
  *lo = 0;
  *hi = (kvl + 63) / 64;
  if (STREAM && a.seg_ids != nullptr) {
    const long long n_tiles = (a.T + 63) / 64;
    *lo = a.tile_lo[(long long)b * n_tiles + tile];
    *hi = min(a.tile_hi[(long long)b * n_tiles + tile], *hi);
  }
}

template <typename T, bool STREAM>
__global__ void __launch_bounds__(THREADS) flash_fwd_chunked_kernel(Args a) {
  using G = Geo<T>;
  using L = FwdSmem<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem + L::kQ);
  T* sKV = reinterpret_cast<T*>(smem + L::kKV);
  float* sS = reinterpret_cast<float*>(smem + L::kS);
  T* sP = reinterpret_cast<T*>(smem + L::kP);
  float* sAcc = reinterpret_cast<float*>(smem + L::kAcc);
  int* keyOk = reinterpret_cast<int*>(smem + L::kKeyOk);
  int* keySeg = reinterpret_cast<int*>(smem + L::kKeySeg);
  int* qSeg = reinterpret_cast<int*>(smem + L::kQSeg);
  float* rowM = reinterpret_cast<float*>(smem + L::kRowM);
  float* rowL = reinterpret_cast<float*>(smem + L::kRowL);
  float* rowAlpha = reinterpret_cast<float*>(smem + L::kRowAlpha);

  const int qt = blockIdx.x, q0 = qt * BQ, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int T_len = a.T, H = a.H, Dh = a.Dh, n_chunks = Dh / DC;
  const long long D = (long long)H * Dh, Tp = (T_len + 63) / 64 * 64;
  const uint8_t* valid_row = a.key_valid + (long long)b * T_len;
  const int* seg_row = a.seg_ids ? a.seg_ids + (long long)b * T_len : nullptr;
  const T* q = static_cast<const T*>(a.q) + b * a.sq.b + h * a.sq.h;
  const T* k = static_cast<const T*>(a.k) + b * a.sk.b + h * a.sk.h;
  const T* v = static_cast<const T*>(a.v) + b * a.sv.b + h * a.sv.h;
  T* out_bh = static_cast<T*>(a.out0) + (long long)b * T_len * D + (long long)h * Dh;
  float* lse_bh = a.lse_out + ((long long)b * H + h) * T_len;
  float* ws = a.ws0 + (((long long)b * H + h) * Tp + q0) * Dh;  // this block's rows

  const int kvl = a.kvl[b];
  int kt_lo, kt_hi;
  sweep_range<STREAM>(a, b, qt, kvl, &kt_lo, &kt_hi);
  const bool live = q0 < kvl && kt_lo < kt_hi;

  if (live) {
    for (int i = tid; i < BQ; i += THREADS)
      qSeg[i] = (seg_row && q0 + i < T_len) ? seg_row[q0 + i] : 0;
    // Per-row online-softmax state. Lanes 2r and 2r+1 of a warp share query
    // row r of the warp's 16; lane parity picks the even or odd columns.
    const int r = warp * 16 + lane / 2, half = lane & 1;
    float m_i = M_INIT, l_i = 0.f;
    for (int kt = kt_lo; kt < kt_hi; ++kt) {
      const int j0 = kt * BK;
      for (int c = 0; c < n_chunks; ++c) {  // s = sum_c Q_c K_c^T
        __syncthreads();  // the previous chunk's (or tile's) operands are no longer read
        load_chunk<T>(sQ, q, a.sq.t, q0, T_len, c * DC, a.scale);
        load_chunk<T>(sKV, k, a.sk.t, j0, T_len, c * DC, 0.f);
        if (c == 0) key_flags(keyOk, keySeg, valid_row, seg_row, j0, T_len);
        __syncthreads();
        warp_abt<T>(sQ, sKV, sS, c > 0, warp, lane);
      }
      __syncwarp();

      const int qs = qSeg[r];
      float sv[BK / 2];
      float tmax = -CUDART_INF_F;
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int c = 2 * i + half;
        const int ok = keyOk[c];
        float s = -CUDART_INF_F;
        if (ok >= 0) {
          const bool allowed = ok && (!seg_row || keySeg[c] == qs);
          s = sS[r * G::LDS + c] + (allowed ? 0.f : MASK_BIAS);
          if (a.sm_bf16) s = round_bf16(s);
        }
        sv[i] = s;
        tmax = fmaxf(tmax, s);
      }
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
      const float m_new = fmaxf(m_i, tmax);
      const float alpha = expf(m_i - m_new);
      // the stream forward rounds the running max itself under the bf16 interior
      const float m_sm = (STREAM && a.sm_bf16) ? round_bf16(m_new) : m_new;
      float rowsum = 0.f;
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        float p = 0.f;
        if (sv[i] != -CUDART_INF_F)
          p = a.sm_bf16 ? round_bf16(expf(round_bf16(sv[i] - m_sm))) : expf(sv[i] - m_new);
        rowsum += p;
        sP[r * G::LDP + 2 * i + half] = from_f<T>(p);
      }
      rowsum += __shfl_xor_sync(0xffffffffu, rowsum, 1);
      l_i = l_i * alpha + rowsum;
      m_i = m_new;
      if (half == 0) rowAlpha[r] = alpha;

      for (int c = 0; c < n_chunks; ++c) {  // O_c = alpha O_c + P V_c
        __syncthreads();  // p, alpha in place; the previous chunk written back
        load_chunk<T>(sKV, v, a.sv.t, j0, T_len, c * DC, 0.f);
        stage_acc<T>(sAcc, ws, Dh, c * DC, rowAlpha, kt == kt_lo);
        __syncthreads();
        warp_ab_acc<T>(sP, sKV, sAcc, warp, lane);
        __syncthreads();
        unstage_acc<T>(ws, sAcc, Dh, c * DC);
      }
    }
    if (half == 0) {
      rowM[r] = m_i;
      rowL[r] = l_i;
    }
  }
  __syncthreads();  // the workspace rows and rowM / rowL written

  // out = O / l (zero past kvl or in a dead tile), lse = m + log(l) (1e30 there)
  store_rows<T>(out_bh, D, live ? ws : nullptr, Dh, q0, T_len, kvl, 1.f, rowL);
  for (int rr = tid; rr < BQ; rr += THREADS) {
    const int t = q0 + rr;
    if (t < T_len) lse_bh[t] = (live && t < kvl) ? rowM[rr] + logf(rowL[rr]) : SKIP_LSE;
  }
}

template <typename T, bool STREAM>
__global__ void __launch_bounds__(THREADS) flash_bwd_dq_chunked_kernel(Args a) {
  using G = Geo<T>;
  using L = DqSmem<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem + L::kQ);
  T* sK = reinterpret_cast<T*>(smem + L::kK);
  T* sG = reinterpret_cast<T*>(smem + L::kG);
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

  const int qt = blockIdx.x, q0 = qt * BQ, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int T_len = a.T, H = a.H, Dh = a.Dh, n_chunks = Dh / DC;
  const long long D = (long long)H * Dh, Tp = (T_len + 63) / 64 * 64;
  const uint8_t* valid_row = a.key_valid + (long long)b * T_len;
  const int* seg_row = a.seg_ids ? a.seg_ids + (long long)b * T_len : nullptr;
  T* dq_bh = static_cast<T*>(a.out0) + (long long)b * T_len * D + (long long)h * Dh;
  float* ws = a.ws0 + (((long long)b * H + h) * Tp + q0) * Dh;

  const int kvl = a.kvl[b];
  int kt_lo, kt_hi;
  sweep_range<STREAM>(a, b, qt, kvl, &kt_lo, &kt_hi);
  if (q0 >= kvl || kt_lo >= kt_hi) {  // padding rows, or no key to sweep: dq = 0
    store_rows<T>(dq_bh, D, nullptr, Dh, q0, T_len, kvl, 0.f, nullptr);
    return;
  }

  const T* q = static_cast<const T*>(a.q) + b * a.sq.b + h * a.sq.h;
  const T* k = static_cast<const T*>(a.k) + b * a.sk.b + h * a.sk.h;
  const T* v = static_cast<const T*>(a.v) + b * a.sv.b + h * a.sv.h;
  const T* g = static_cast<const T*>(a.g) + b * a.sg.b + h * a.sg.h;
  const T* o = static_cast<const T*>(a.o) + b * a.so.b + h * a.so.h;
  const float* lse_bh = a.lse_in + ((long long)b * H + h) * T_len;
  const bool select = !STREAM && seg_row != nullptr;

  query_rows(qSeg, rowLse, seg_row, lse_bh, q0, T_len);
  rows_delta<T>(g, a.sg.t, o, a.so.t, q0, T_len, Dh, rowDelta);

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int j0 = kt * BK;
    for (int c = 0; c < n_chunks; ++c) {  // s = sum_c Q_c K_c^T, dp = sum_c G_c V_c^T
      __syncthreads();
      load_chunk<T>(sQ, q, a.sq.t, q0, T_len, c * DC, a.scale);
      load_chunk<T>(sK, k, a.sk.t, j0, T_len, c * DC, 0.f);
      load_chunk<T>(sG, g, a.sg.t, q0, T_len, c * DC, 0.f);
      load_chunk<T>(sV, v, a.sv.t, j0, T_len, c * DC, 0.f);
      if (c == 0) key_flags(keyOk, keySeg, valid_row, seg_row, j0, T_len);
      __syncthreads();
      warp_abt<T>(sQ, sK, sS, c > 0, warp, lane);
      warp_abt<T>(sG, sV, sDP, c > 0, warp, lane);
    }
    __syncwarp();
    warp_probs<T>(sS, sDP, nullptr, sDS, keyOk, keySeg, qSeg, rowLse, rowDelta,
                  seg_row != nullptr, select, a.sm_bf16, warp, lane);
    for (int c = 0; c < n_chunks; ++c) {  // dq_c += ds K_c
      __syncthreads();
      load_chunk<T>(sK, k, a.sk.t, j0, T_len, c * DC, 0.f);
      stage_acc<T>(sAcc, ws, Dh, c * DC, nullptr, kt == kt_lo);
      __syncthreads();
      warp_ab_acc<T>(sDS, sK, sAcc, warp, lane);
      __syncthreads();
      unstage_acc<T>(ws, sAcc, Dh, c * DC);
    }
  }
  __syncthreads();
  store_rows<T>(dq_bh, D, ws, Dh, q0, T_len, kvl, a.scale, nullptr);
}

template <typename T, bool STREAM>
__global__ void __launch_bounds__(THREADS) flash_bwd_dkv_chunked_kernel(Args a) {
  using G = Geo<T>;
  using L = DkvSmem<T>;
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

  const int kt = blockIdx.x, j0 = kt * BK, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int T_len = a.T, H = a.H, Dh = a.Dh, n_chunks = Dh / DC;
  const long long D = (long long)H * Dh, Tp = (T_len + 63) / 64 * 64;
  const uint8_t* valid_row = a.key_valid + (long long)b * T_len;
  const int* seg_row = a.seg_ids ? a.seg_ids + (long long)b * T_len : nullptr;
  T* dk_bh = static_cast<T*>(a.out0) + (long long)b * T_len * D + (long long)h * Dh;
  T* dv_bh = static_cast<T*>(a.out1) + (long long)b * T_len * D + (long long)h * Dh;
  const long long ws_off = (((long long)b * H + h) * Tp + j0) * Dh;
  float* ws_k = a.ws0 + ws_off;
  float* ws_v = a.ws1 + ws_off;

  // the query tiles this key tile meets: [0, ceil(kvl / 64)), packed stream
  // sweep bounded by the key tile's own [lo, hi) (the mask is symmetric)
  const int kvl = a.kvl[b];
  int qt_lo, qt_hi;
  sweep_range<STREAM>(a, b, kt, kvl, &qt_lo, &qt_hi);
  if (j0 >= kvl || qt_lo >= qt_hi) {  // no valid key, or no query to sweep: 0
    store_rows<T>(dk_bh, D, nullptr, Dh, j0, T_len, kvl, 0.f, nullptr);
    store_rows<T>(dv_bh, D, nullptr, Dh, j0, T_len, kvl, 0.f, nullptr);
    return;
  }

  const T* q = static_cast<const T*>(a.q) + b * a.sq.b + h * a.sq.h;
  const T* k = static_cast<const T*>(a.k) + b * a.sk.b + h * a.sk.h;
  const T* v = static_cast<const T*>(a.v) + b * a.sv.b + h * a.sv.h;
  const T* g = static_cast<const T*>(a.g) + b * a.sg.b + h * a.sg.h;
  const T* o = static_cast<const T*>(a.o) + b * a.so.b + h * a.so.h;
  const float* lse_bh = a.lse_in + ((long long)b * H + h) * T_len;
  const bool select = !STREAM && seg_row != nullptr;

  key_flags(keyOk, keySeg, valid_row, seg_row, j0, T_len);
  for (int qt = qt_lo; qt < qt_hi; ++qt) {
    const int i0 = qt * BQ;
    __syncthreads();  // the previous query tile's rows, p and ds are no longer read
    query_rows(qSeg, rowLse, seg_row, lse_bh, i0, T_len);
    rows_delta<T>(g, a.sg.t, o, a.so.t, i0, T_len, Dh, rowDelta);
    for (int c = 0; c < n_chunks; ++c) {  // s = sum_c Q_c K_c^T, dp = sum_c G_c V_c^T
      __syncthreads();
      load_chunk<T>(sQ, q, a.sq.t, i0, T_len, c * DC, a.scale);
      load_chunk<T>(sK, k, a.sk.t, j0, T_len, c * DC, 0.f);
      load_chunk<T>(sG, g, a.sg.t, i0, T_len, c * DC, 0.f);
      load_chunk<T>(sV, v, a.sv.t, j0, T_len, c * DC, 0.f);
      __syncthreads();
      warp_abt<T>(sQ, sK, sS, c > 0, warp, lane);
      warp_abt<T>(sG, sV, sDP, c > 0, warp, lane);
    }
    __syncwarp();
    warp_probs<T>(sS, sDP, sP, sDS, keyOk, keySeg, qSeg, rowLse, rowDelta, seg_row != nullptr,
                  select, a.sm_bf16, warp, lane);
    for (int c = 0; c < n_chunks; ++c) {  // dv_c += p^T G_c, dk_c += ds^T Q_c
      __syncthreads();  // every query row's p and ds in place; the previous chunk written back
      load_chunk<T>(sQ, q, a.sq.t, i0, T_len, c * DC, a.scale);
      load_chunk<T>(sG, g, a.sg.t, i0, T_len, c * DC, 0.f);
      stage_acc<T>(sAccK, ws_k, Dh, c * DC, nullptr, qt == qt_lo);
      stage_acc<T>(sAccV, ws_v, Dh, c * DC, nullptr, qt == qt_lo);
      __syncthreads();
      if constexpr (G::kBf16) {
        // this warp's 16 keys; p^T as a column-major [16 keys, 16 queries]
        // operand is p's own row-major tile
        using namespace nvcuda;
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> accK[DC / 16], accV[DC / 16];
#pragma unroll
        for (int n = 0; n < DC / 16; ++n) {
          wmma::load_matrix_sync(accK[n], sAccK + warp * 16 * G::LDA + n * 16, G::LDA,
                                 wmma::mem_row_major);
          wmma::load_matrix_sync(accV[n], sAccV + warp * 16 * G::LDA + n * 16, G::LDA,
                                 wmma::mem_row_major);
        }
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> pa, da;
          wmma::load_matrix_sync(pa, sP + kk * 16 * G::LDP + warp * 16, G::LDP);
          wmma::load_matrix_sync(da, sDS + kk * 16 * G::LDP + warp * 16, G::LDP);
#pragma unroll
          for (int n = 0; n < DC / 16; ++n) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> gb, qb;
            wmma::load_matrix_sync(gb, sG + kk * 16 * G::LD + n * 16, G::LD);
            wmma::mma_sync(accV[n], pa, gb, accV[n]);
            wmma::load_matrix_sync(qb, sQ + kk * 16 * G::LD + n * 16, G::LD);
            wmma::mma_sync(accK[n], da, qb, accK[n]);
          }
        }
#pragma unroll
        for (int n = 0; n < DC / 16; ++n) {
          wmma::store_matrix_sync(sAccK + warp * 16 * G::LDA + n * 16, accK[n], G::LDA,
                                  wmma::mem_row_major);
          wmma::store_matrix_sync(sAccV + warp * 16 * G::LDA + n * 16, accV[n], G::LDA,
                                  wmma::mem_row_major);
        }
      } else {
        for (int idx = tid; idx < BK * DC; idx += THREADS) {
          const int c2 = idx / DC, d = idx % DC;
          float sv = 0.f, sk = 0.f;
#pragma unroll 8
          for (int i = 0; i < BQ; ++i) {
            sv += to_f(sP[i * G::LDP + c2]) * to_f(sG[i * G::LD + d]);
            sk += to_f(sDS[i * G::LDP + c2]) * to_f(sQ[i * G::LD + d]);
          }
          sAccV[c2 * G::LDA + d] += sv;
          sAccK[c2 * G::LDA + d] += sk;
        }
      }
      __syncthreads();
      unstage_acc<T>(ws_k, sAccK, Dh, c * DC);
      unstage_acc<T>(ws_v, sAccV, Dh, c * DC);
    }
  }
  __syncthreads();
  store_rows<T>(dk_bh, D, ws_k, Dh, j0, T_len, kvl, 1.f, nullptr);
  store_rows<T>(dv_bh, D, ws_v, Dh, j0, T_len, kvl, 1.f, nullptr);
}

enum Kind { FWD = 0, DQ = 1, DKV = 2 };

template <typename T, bool STREAM>
int launch(Kind kind, const Args& a, int B, cudaStream_t stream) {
  void (*kernel)(Args) = kind == FWD  ? &flash_fwd_chunked_kernel<T, STREAM>
                         : kind == DQ ? &flash_bwd_dq_chunked_kernel<T, STREAM>
                                      : &flash_bwd_dkv_chunked_kernel<T, STREAM>;
  const size_t smem = kind == FWD  ? FwdSmem<T>::kBytes
                      : kind == DQ ? DqSmem<T>::kBytes
                                   : DkvSmem<T>::kBytes;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.T + 63) / 64, a.H, B);
  kernel<<<grid, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

int run(Kind kind, Args& a, const long long* strides, int n_strided, int B, int is_bf16,
        int stream_sweep, void* stream) {
  if (B <= 0 || a.T <= 0 || a.H <= 0) return 0;
  if (a.Dh <= 0 || a.Dh % DC != 0 || !a.kvl) return (int)cudaErrorInvalidValue;
  if (stream_sweep && a.seg_ids && (!a.tile_lo || !a.tile_hi)) return (int)cudaErrorInvalidValue;
  Strides* st[5] = {&a.sq, &a.sk, &a.sv, &a.sg, &a.so};
  for (int i = 0; i < n_strided; ++i)
    *st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return stream_sweep ? launch<bf16, true>(kind, a, B, s) : launch<bf16, false>(kind, a, B, s);
  return stream_sweep ? launch<float, true>(kind, a, B, s) : launch<float, false>(kind, a, B, s);
}

}  // namespace

// C entry points, bound with ctypes (repurpose_tpu_torch/native.py). Each
// takes the tensors' element strides ((batch, token, head) of q, k, v, and
// for the backward g and o, in that order), key_valid, seg_ids (null:
// unpacked), kvl (int32 [B]) and lo / hi (int32 [B, ceil(T / 64)], read only
// with stream_sweep and seg_ids), the float32 workspace(s) [B, H, Tp, Dh]
// (Tp = T rounded up to 64), B, T, H, Dh (a multiple of 64), is_bf16 (q/k/v
// and the outputs bf16, else float32), sm_bf16 (the bf16 softmax interior)
// and stream_sweep (the stream designs' sweep and rounding points, else the
// dense designs'). Each returns cudaGetLastError() after its launch (0 on
// success), or cudaErrorInvalidValue for a Dh that is not a multiple of 64.
extern "C" int flash_fwd_chunked(const void* q, const void* k, const void* v,
                                 const long long* strides, const void* key_valid,
                                 const void* seg_ids, const void* kvl, const void* lo,
                                 const void* hi, void* out, void* lse, void* ws, int B,
                                 int T_len, int H, int Dh, int is_bf16, int sm_bf16,
                                 int stream_sweep, float scale, void* stream) {
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.key_valid = static_cast<const uint8_t*>(key_valid);
  a.seg_ids = static_cast<const int*>(seg_ids);
  a.kvl = static_cast<const int*>(kvl);
  a.tile_lo = static_cast<const int*>(lo);
  a.tile_hi = static_cast<const int*>(hi);
  a.out0 = out;
  a.lse_out = static_cast<float*>(lse);
  a.ws0 = static_cast<float*>(ws);
  a.T = T_len;
  a.H = H;
  a.Dh = Dh;
  a.scale = scale;
  a.sm_bf16 = sm_bf16;
  return run(FWD, a, strides, 3, B, is_bf16, stream_sweep, stream);
}

extern "C" int flash_bwd_dq_chunked(const void* q, const void* k, const void* v, const void* g,
                                    const void* o, const long long* strides,
                                    const void* key_valid, const void* seg_ids, const void* kvl,
                                    const void* lo, const void* hi, const void* lse, void* dq,
                                    void* ws, int B, int T_len, int H, int Dh, int is_bf16,
                                    int sm_bf16, int stream_sweep, float scale, void* stream) {
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.g = g;
  a.o = o;
  a.key_valid = static_cast<const uint8_t*>(key_valid);
  a.seg_ids = static_cast<const int*>(seg_ids);
  a.kvl = static_cast<const int*>(kvl);
  a.tile_lo = static_cast<const int*>(lo);
  a.tile_hi = static_cast<const int*>(hi);
  a.lse_in = static_cast<const float*>(lse);
  a.out0 = dq;
  a.ws0 = static_cast<float*>(ws);
  a.T = T_len;
  a.H = H;
  a.Dh = Dh;
  a.scale = scale;
  a.sm_bf16 = sm_bf16;
  return run(DQ, a, strides, 5, B, is_bf16, stream_sweep, stream);
}

extern "C" int flash_bwd_dkv_chunked(const void* q, const void* k, const void* v, const void* g,
                                     const void* o, const long long* strides,
                                     const void* key_valid, const void* seg_ids,
                                     const void* kvl, const void* lo, const void* hi,
                                     const void* lse, void* dk, void* dv, void* ws_k,
                                     void* ws_v, int B, int T_len, int H, int Dh, int is_bf16,
                                     int sm_bf16, int stream_sweep, float scale, void* stream) {
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.g = g;
  a.o = o;
  a.key_valid = static_cast<const uint8_t*>(key_valid);
  a.seg_ids = static_cast<const int*>(seg_ids);
  a.kvl = static_cast<const int*>(kvl);
  a.tile_lo = static_cast<const int*>(lo);
  a.tile_hi = static_cast<const int*>(hi);
  a.lse_in = static_cast<const float*>(lse);
  a.out0 = dk;
  a.out1 = dv;
  a.ws0 = static_cast<float*>(ws_k);
  a.ws1 = static_cast<float*>(ws_v);
  a.T = T_len;
  a.H = H;
  a.Dh = Dh;
  a.scale = scale;
  a.sm_bf16 = sm_bf16;
  return run(DKV, a, strides, 5, B, is_bf16, stream_sweep, stream);
}
