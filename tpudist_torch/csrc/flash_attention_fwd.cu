// Flash-attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces: tpudist/ops/pallas/flash_attention.py::_fwd_kernel (launched by
// `_fwd`), the TPU kernel behind `flash_attention` / `flash_attention_with_lse`.
// Computes the same function: softmax(q k^T / sqrt(hd)) v with an online
// softmax (f32 running max, sum and accumulator), the top-left causal mask
// (mask value -1e30, s == sk required), kv tiles wholly above the diagonal
// skipped, optional RoPE from (s, hd/2) f32 cos/sin tables with the
// split-halves pair convention (channel i rotates with channel i + hd/2),
// compact GQA k/v (q head i reads kv head i / (h / kv)), and the per-row
// log-sum-exp. Rotated q/k and the probabilities fed to the PV product are
// rounded to the input dtype, as the TPU kernel's casts do; the scores,
// statistics and accumulators stay f32. The output is cast to the input dtype.
//
// Layout: q (b, s, h, hd), k/v (b, sk, kv, hd), o like q, lse (b, h, s) f32,
// all contiguous.
//
// Bound at the serving slice's shape (b1 s512 h16 kv16 hd128, f32, causal,
// no RoPE): the causal half of the two products is
// 4 * h * hd * s(s+1)/2 = 1.076 GFLOP, and q, k, v, o and lse are 16.8 MB
// read and written. Both products run on the tensor cores: f32 as 3xTF32
// (three TF32 products for each f32 one, so 495 / 3 = 165 TFLOP/s from the
// H100 SXM data sheet's TF32 peak), bf16 at 989 TFLOP/s. The f32 operation
// bound is 6.5 us against 5.0 us for the bytes at 3.35 TB/s: bound by
// operations.
//
// Design (FlashAttention-2's, with the f32 products done as PyTorch's
// memory-efficient attention does them). What the first version of this
// kernel left on the table, and what this one does about it:
// - It did f32 FMA on the CUDA cores (67 TFLOP/s). Now both products run on
//   the tensor cores through mma.sync. An f32 operand x is split into
//   hi = rna(x) and lo = rna(x - hi), both TF32 (rna: round to nearest, ties
//   away, to 10 mantissa bits: what cvt.rna.tf32.f32 computes, done here in
//   two integer operations, where ptxas expands the cvt into a longer
//   sequence), and m16n8k8 TF32 products accumulate lo*hi + hi*lo + hi*hi
//   in f32: accurate to f32, where one TF32 product keeps about three
//   digits. bf16 takes m16n8k16 with f32 accumulation.
// - P made a round trip through shared memory. Now scores and accumulators
//   live in registers: a warp owns 16 q rows; row max and sum reduce over
//   the 4 lanes of a quad with shuffles; P goes from the QK^T accumulator
//   fragment straight into the PV A fragment. For bf16 the C->A mapping is
//   direct. For TF32 m16n8k8, C holds key columns (2t, 2t+1) and A wants
//   (t, t+4): the PV sum runs over the keys in any order, so logical k = t is
//   key 2t and k = t + 4 is key 2t + 1, and V's B fragment rows are read in
//   that same order. Q and K fragments come by ldmatrix; with 64-row f32
//   blocks the q tile is split into hi/lo once, at the start.
// - K/V tiles were loaded synchronously. Now they come in through 16-byte
//   cp.async into a double-buffered ring: tile j + 1 loads while tile j
//   computes. Rows are padded by 16 bytes (4 f32 or 8 bf16), which keeps
//   cp.async aligned and the fragment reads free of bank conflicts. Under
//   RoPE the landed K tile is rotated in shared memory in one vectorised
//   pass (rounded to T), and the q tile once, at the start. At f32 hd 128
//   with 128-row blocks (the training shapes) each thread also splits the
//   K/V chunks it copied into hi (in place) and lo (a second ring) as soon
//   as they land, with the RoPE tables read a tile ahead: the split is done
//   once per block instead of once per warp, needs no barrier of its own,
//   and overlaps the other warps' products; one barrier a tile remains.
// - The causal schedule left one wave's blocks idle behind the longest one.
//   The grid's y now walks the q tiles heaviest first (its x walks the
//   (batch, head) pairs), so the longest blocks start in the first wave;
//   warps whose 16 rows lie wholly above a tile's keys skip it, and the
//   mask is applied only where a tile crosses the diagonal. A block is 8
//   warps. When the grid is large (b*h*s/128 blocks fill the SMs) each warp
//   owns 16 of 128 q rows (KS = 1). When it is not, as at the serving shape,
//   the block takes 64 q rows and splits every kv tile between two warps
//   per 16 rows (KS = 2), whose partial (max, sum, accumulator) merge in
//   shared memory at the end: twice the blocks and half the longest warp.
// - Occupancy (it was one 256-thread block an SM). f32 runs one 8-warp
//   block an SM: 198 KB of shared memory at hd 128 (with the lo ring, or
//   at KS = 2 with q's lo parts), 195 KB at hd 256 (16-key warp tiles);
//   its 180-242 registers a thread would not fit a second block either.
//   bf16 at hd 128 fits two (68 KB, 127 registers).
// What it still leaves: wgmma (the only path to the full tensor-core rate:
// mma.sync's TF32 is well below the 495 TFLOP/s peak, and for f32 wgmma
// would also need a K-major V), TMA loads with multicast across a cluster,
// warp specialisation (a producer warp and consumer warpgroups), and
// splitting a long row's keys across blocks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stddef.h>
#include <stdint.h>

#include "mma_common.cuh"

namespace {

constexpr int THREADS = 256;  // 8 warps
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// Tiling of one instantiation. KS: warps that share each 16 q rows,
// splitting every kv tile's keys (1 or 2).
template <typename T, int HD, int KS>
struct Cfg {
  static constexpr bool F32 = sizeof(T) == 4;
  // f32 at hd 128 with 128-row blocks splits each landed K/V tile into
  // hi/lo once per block (hi in place, lo beside it), not once per warp:
  // every thread splits the chunks it copied, so the split needs no
  // barrier of its own
  static constexpr bool PS = F32 && HD == 128 && KS == 1;
  static constexpr int KW = F32 && HD == 256 ? 16 : 32;
  static constexpr int BM = 128 / KS;   // q rows per block
  static constexpr int BN = KW * KS;    // kv rows per tile
  static constexpr int LD = HD + 16 / (int)sizeof(T);   // 16-byte padding
  // without PS, f32 splits the q tile into hi/lo once, at the start, where
  // its lo parts fit beside the rest (hd 128 at KS = 2)
  static constexpr bool QS =
      F32 && !PS && sizeof(T) * LD * (2 * BM + 4 * BN) <= 232448;
  // q, two k/v stages, and with PS their lo parts, with QS q's
  static constexpr size_t SMEM =
      sizeof(T) * (size_t)LD *
      (BM + 4 * BN + (PS ? 4 * BN : 0) + (QS ? BM : 0));
};

__device__ __forceinline__ void load4(const float* p, float (&x)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&x)[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&v.y));
  x[0] = a.x, x[1] = a.y, x[2] = b.x, x[3] = b.y;
}
__device__ __forceinline__ void store4(float* p, const float (&x)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&x)[4]) {
  __nv_bfloat162 v[2] = {__floats2bfloat162_rn(x[0], x[1]),
                         __floats2bfloat162_rn(x[2], x[3])};
  *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(v);
}

// Start copying ROWS rows of HD elements (global row stride `stride`
// elements) into shared memory with row stride LD.
template <typename T, int HD, int LD, int ROWS>
__device__ __forceinline__ void issue_rows(T* dst, const T* __restrict__ src,
                                           size_t stride) {
  constexpr int PER = 16 / sizeof(T);   // elements per 16-byte copy
  constexpr int CH = HD / PER;          // copies per row
#pragma unroll
  for (int idx = threadIdx.x; idx < ROWS * CH; idx += THREADS) {
    const int r = idx / CH, c = idx % CH;
    cp_async16(dst + r * LD + c * PER, src + (size_t)r * stride + c * PER);
  }
}

// Start copying ROWS rows of HD floats into shared memory (row stride LD),
// each thread the chunks that `split_rows` hands it: item it is row r,
// floats i .. i + 3 and i + HD / 2 .. i + HD / 2 + 3.
template <int HD, int LD, int ROWS>
__device__ __forceinline__ void issue_items(float* dst,
                                            const float* __restrict__ src,
                                            size_t stride) {
  constexpr int H2 = HD / 2, Q4 = H2 / 4;
#pragma unroll
  for (int it = 0; it < ROWS * Q4 / THREADS; ++it) {
    const int idx = threadIdx.x + it * THREADS;
    const int r = idx / Q4, i = (idx % Q4) * 4;
    cp_async16(dst + r * LD + i, src + (size_t)r * stride + i);
    cp_async16(dst + r * LD + i + H2, src + (size_t)r * stride + i + H2);
  }
}

// This thread's share of the RoPE tables for ROWS rows at positions
// pos0..: item it is row r, pairs (i .. i + 3, + HD / 2), as the passes
// below walk them.
template <int HD, int ROWS>
struct Tables {
  static constexpr int H2 = HD / 2, Q4 = H2 / 4, N = ROWS * Q4 / THREADS;
  static_assert(ROWS * Q4 % THREADS == 0, "whole items per thread");
  float c[N][4], s[N][4];

  __device__ __forceinline__ void load(const float* __restrict__ cos,
                                       const float* __restrict__ sin,
                                       int pos0) {
#pragma unroll
    for (int it = 0; it < N; ++it) {
      const int idx = threadIdx.x + it * THREADS;
      const size_t at = (size_t)(pos0 + idx / Q4) * H2 + (idx % Q4) * 4;
      load4(cos + at, c[it]);
      load4(sin + at, s[it]);
    }
  }
};

// Rotate ROWS landed rows in place, four pairs at a time, each value
// rounded to T as the TPU kernel's cast does.
template <typename T, int HD, int LD, int ROWS>
__device__ __forceinline__ void rope_rows(T* tile,
                                          const Tables<HD, ROWS>& tb) {
  constexpr int H2 = HD / 2, Q4 = H2 / 4;
#pragma unroll
  for (int it = 0; it < tb.N; ++it) {
    const int idx = threadIdx.x + it * THREADS;
    const int r = idx / Q4, i = (idx % Q4) * 4;
    float x1[4], x2[4];
    T* row = tile + r * LD;
    load4(row + i, x1);
    load4(row + i + H2, x2);
    float y1[4], y2[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float ce = round_to<T>(tb.c[it][e]);
      const float se = round_to<T>(tb.s[it][e]);
      y1[e] = x1[e] * ce - x2[e] * se;
      y2[e] = x2[e] * ce + x1[e] * se;
    }
    store4(row + i, y1);
    store4(row + i + H2, y2);
  }
}

// Split ROWS landed f32 rows in place into their TF32 hi parts, with the lo
// parts to `lo` (same layout); rotated first when `rope`.
template <int HD, int LD, int ROWS>
__device__ __forceinline__ void split_rows(float* tile, float* lo, bool rope,
                                           const Tables<HD, ROWS>& tb) {
  constexpr int H2 = HD / 2, Q4 = H2 / 4;
#pragma unroll
  for (int it = 0; it < tb.N; ++it) {
    const int idx = threadIdx.x + it * THREADS;
    const int r = idx / Q4, i = (idx % Q4) * 4;
    float* row = tile + r * LD;
    float x1[4], x2[4];
    load4(row + i, x1);
    load4(row + i + H2, x2);
    if (rope) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float c = tb.c[it][e], s = tb.s[it][e];
        const float y1 = x1[e] * c - x2[e] * s;
        x2[e] = x2[e] * c + x1[e] * s;
        x1[e] = y1;
      }
    }
    float h1[4], l1[4], h2[4], l2[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      uint32_t hb, lb;
      split(x1[e], hb, lb);
      h1[e] = __uint_as_float(hb), l1[e] = __uint_as_float(lb);
      split(x2[e], hb, lb);
      h2[e] = __uint_as_float(hb), l2[e] = __uint_as_float(lb);
    }
    store4(row + i, h1);
    store4(row + i + H2, h2);
    store4(lo + r * LD + i, l1);
    store4(lo + r * LD + i + H2, l2);
  }
}

// S (16 x 8 NT, this warp's rows and keys) = Q K^T, f32 operands, 3xTF32.
// Fragments come by ldmatrix; with PS, K's hi parts are in sk and its lo
// parts at the same offsets in sklo, else K is split here; with QS the
// same holds for Q in sq and sqlo.
template <int HD, int LD, int NT, bool PS, bool QS>
__device__ __forceinline__ void qk(float (&sc)[NT][4], const float* sq,
                                   const float* sqlo, const float* sk,
                                   const float* sklo, int lane) {
  static_assert(NT % 2 == 0, "K fragments come in pairs of n-tiles");
  const int lr = lane % 8, m1 = (lane / 8) % 2, m2 = lane / 16;
  // Q's matrices: rows +0/+8 (m1), columns +0/+4 (m2); K's: columns +0/+4
  // (m1), rows +0/+8 (m2)
  const int qoff = (lr + 8 * m1) * LD + 4 * m2;
  const int koff = (lr + 8 * m2) * LD + 4 * m1;
#pragma unroll
  for (int kk = 0; kk < HD; kk += 8) {
    uint32_t ahi[4], alo[4];
    ldmatrix_x4(ahi, sq + qoff + kk);
    if constexpr (QS) {
      ldmatrix_x4(alo, sqlo + qoff + kk);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        split(__uint_as_float(ahi[i]), ahi[i], alo[i]);
    }
#pragma unroll
    for (int n = 0; n < NT; n += 2) {
      uint32_t bh[4], bl[4];
      ldmatrix_x4(bh, sk + 8 * n * LD + kk + koff);
      if constexpr (PS) {
        ldmatrix_x4(bl, sklo + 8 * n * LD + kk + koff);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) split(__uint_as_float(bh[i]), bh[i], bl[i]);
      }
      mma_3xtf32(sc[n], ahi, alo, bh[0], bh[1], bl[0], bl[1]);
      mma_3xtf32(sc[n + 1], ahi, alo, bh[2], bh[3], bl[2], bl[3]);
    }
  }
}

// S = Q K^T, bf16 operands.
template <int HD, int LD, int NT, bool PS, bool QS>
__device__ __forceinline__ void qk(float (&sc)[NT][4],
                                   const __nv_bfloat16* sq,
                                   const __nv_bfloat16*,
                                   const __nv_bfloat16* sk,
                                   const __nv_bfloat16*, int lane) {
  const int g = lane / 4, t = lane % 4;
#pragma unroll 4
  for (int kk = 0; kk < HD; kk += 16) {
    const __nv_bfloat16* qa = sq + g * LD + kk + 2 * t;
    const uint32_t a[4] = {ld32(qa), ld32(qa + 8 * LD), ld32(qa + 8),
                           ld32(qa + 8 * LD + 8)};
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const __nv_bfloat16* kb = sk + (8 * n + g) * LD + kk + 2 * t;
      mma_bf16(sc[n], a, ld32(kb), ld32(kb + 8));
    }
  }
}

// acc (16 x HD) += P V, f32: P's k-step n is score tile n with its keys
// relabelled (logical k = t is key 2t, k = t + 4 is key 2t + 1), and V's
// rows are read in the same order; with PS, V's lo parts are in svlo.
template <int HD, int LD, int NT, bool PS>
__device__ __forceinline__ void pv(float (&acc)[HD / 8][4],
                                   const float (&p)[NT][4], const float* sv,
                                   const float* svlo, int lane) {
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    uint32_t ahi[4], alo[4];
    split(p[n][0], ahi[0], alo[0]);
    split(p[n][2], ahi[1], alo[1]);
    split(p[n][1], ahi[2], alo[2]);
    split(p[n][3], ahi[3], alo[3]);
    const int off = (8 * n + 2 * t) * LD + g;
#pragma unroll
    for (int d = 0; d < HD / 8; ++d) {
      const float v0 = sv[off + 8 * d], v1 = sv[off + LD + 8 * d];
      if constexpr (PS) {
        mma_3xtf32(acc[d], ahi, alo, __float_as_uint(v0), __float_as_uint(v1),
                   __float_as_uint(svlo[off + 8 * d]),
                   __float_as_uint(svlo[off + LD + 8 * d]));
      } else {
        mma_3xtf32(acc[d], ahi, alo, v0, v1);
      }
    }
  }
}

// acc += P V, bf16: P (rounded to bf16) packs straight into the A fragment;
// V's B fragments come transposed by ldmatrix.
template <int HD, int LD, int NT, bool PS>
__device__ __forceinline__ void pv(float (&acc)[HD / 8][4],
                                   const float (&p)[NT][4],
                                   const __nv_bfloat16* sv,
                                   const __nv_bfloat16*, int lane) {
  // this lane's row for ldmatrix: matrix lane / 8 is (keys +0 or +8,
  // columns +0 or +8)
  const int mat = lane / 8;
  const __nv_bfloat16* vrow =
      sv + ((mat & 1) * 8 + lane % 8) * LD + (mat >> 1) * 8;
#pragma unroll
  for (int m = 0; m < NT / 2; ++m) {
    const uint32_t a[4] = {pack_bf16(p[2 * m][0], p[2 * m][1]),
                           pack_bf16(p[2 * m][2], p[2 * m][3]),
                           pack_bf16(p[2 * m + 1][0], p[2 * m + 1][1]),
                           pack_bf16(p[2 * m + 1][2], p[2 * m + 1][3])};
#pragma unroll
    for (int d = 0; d < HD / 8; d += 2) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, vrow + 16 * m * LD + 8 * d);
      mma_bf16(acc[d], a, b[0], b[1]);
      mma_bf16(acc[d + 1], a, b[2], b[3]);
    }
  }
}

template <typename T, int HD, int KS>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ cos,
                     const float* __restrict__ sin, T* __restrict__ o,
                     float* __restrict__ lse, int s, int sk, int h, int kv,
                     float scale, int causal, int rope) {
  using C = Cfg<T, HD, KS>;
  constexpr int BM = C::BM, KW = C::KW, BN = C::BN, LD = C::LD;
  constexpr bool PS = C::PS, QS = C::QS;
  constexpr int NT = KW / 8;   // score n-tiles per warp
  constexpr int DT = HD / 8;   // accumulator n-tiles per warp
  static_assert(BM % BN == 0, "a q tile ends on a kv tile boundary");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sq = reinterpret_cast<T*>(smem_raw);
  T* skv = sq + BM * LD;   // stage i: k at skv + 2 i BN LD, v after it
  // with PS: stage i's lo parts at 2 i BN LD; with QS: q's lo parts
  T* slo = skv + 4 * BN * LD;

  const int bh = blockIdx.x;
  const int b = bh / h, head = bh % h;
  const int kvh = head / (h / kv);
  // heaviest q tiles first under the causal mask
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int row0 = qt * BM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  // warps w and w + 4 share an SM sub-partition: at KS = 2 pair the row
  // groups so that each sub-partition gets a light and a heavy one
  const int kh = KS == 2 ? warp / 4 : 0;
  const int rg = KS == 2 ? (kh ? 7 - warp : warp) : warp;
  const int wrow = row0 + rg * 16;   // this warp's first row

  const size_t q_stride = (size_t)h * HD, kv_stride = (size_t)kv * HD;
  const T* qsrc = q + (((size_t)b * s + row0) * h + head) * HD;
  const T* ksrc = k + ((size_t)b * sk * kv + kvh) * HD;
  const T* vsrc = v + ((size_t)b * sk * kv + kvh) * HD;

  const int n_tiles = causal ? (row0 + BM) / BN : sk / BN;

  // scores are kept in the log2 domain: p = 2^(s log2(e) - m)
  const float scale2 = scale * LOG2E;
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
  float acc[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d)
    acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;

  // the q tile's rotation, BN rows at a time, once q has landed
  auto rope_q = [&]() {
#pragma unroll 1
    for (int r = 0; r < BM; r += BN) {
      Tables<HD, BN> qtb;
      qtb.load(cos, sin, row0 + r);
      rope_rows<T, HD, LD, BN>(sq + r * LD, qtb);
    }
  };
  Tables<HD, BN> tb;   // with PS: the next tile's share of the RoPE tables

  issue_rows<T, HD, LD, BM>(sq, qsrc, q_stride);
  if constexpr (PS) {
    issue_items<HD, LD, BN>(skv, ksrc, kv_stride);
    issue_items<HD, LD, BN>(skv + BN * LD, vsrc, kv_stride);
    cp_async_commit();
    if (rope) tb.load(cos, sin, 0);
    cp_async_wait_all();
    split_rows<HD, LD, BN>(skv, slo, rope, tb);
    split_rows<HD, LD, BN>(skv + BN * LD, slo + BN * LD, false, tb);
    __syncthreads();   // q has landed, tile 0 is split
    if (rope) {
      rope_q();
      __syncthreads();
    }
  } else {
    issue_rows<T, HD, LD, BN>(skv, ksrc, kv_stride);
    issue_rows<T, HD, LD, BN>(skv + BN * LD, vsrc, kv_stride);
    cp_async_commit();
  }

  for (int j = 0; j < n_tiles; ++j) {
    T* sk_j = skv + (j & 1) * 2 * BN * LD;
    T* sv_j = sk_j + BN * LD;
    const T* sklo = slo + (j & 1) * 2 * BN * LD;
    T* nk = skv + ((j + 1) & 1) * 2 * BN * LD;   // tile j + 1's stage
    const size_t next_off = (size_t)(j + 1) * BN * kv_stride;
    const bool next = j + 1 < n_tiles;
    if constexpr (PS) {
      // tile j + 1 loads (and its tables) while tile j computes
      if (next) {
        issue_items<HD, LD, BN>(nk, ksrc + next_off, kv_stride);
        issue_items<HD, LD, BN>(nk + BN * LD, vsrc + next_off, kv_stride);
        cp_async_commit();
        if (rope) tb.load(cos, sin, (j + 1) * BN);
      }
    } else {
      cp_async_wait_all();   // tile j (and at j = 0 the q tile) has landed
      __syncthreads();       // ... for every thread; tile j - 1 is consumed
      if (next) {
        issue_rows<T, HD, LD, BN>(nk, ksrc + next_off, kv_stride);
        issue_rows<T, HD, LD, BN>(nk + BN * LD, vsrc + next_off, kv_stride);
        cp_async_commit();
      }
      if constexpr (QS) {
        if (j == 0) {
          // the q tile, rotated and split, BN rows at a time
#pragma unroll 1
          for (int r = 0; r < BM; r += BN) {
            Tables<HD, BN> qtb;
            if (rope) qtb.load(cos, sin, row0 + r);
            split_rows<HD, LD, BN>(sq + r * LD, slo + r * LD, rope, qtb);
          }
        }
      } else {
        if (rope && j == 0) rope_q();
      }
      if (rope) {
        Tables<HD, BN> ktb;
        ktb.load(cos, sin, j * BN);
        rope_rows<T, HD, LD, BN>(sk_j, ktb);
      }
      if (rope || (QS && j == 0)) __syncthreads();
    }
    const int c0 = j * BN + kh * KW;   // this warp's first key
    // a warp whose rows all precede its keys has nothing to add
    if (!causal || c0 <= wrow + 15) {
      float sc[NT][4];
  #pragma unroll
      for (int n = 0; n < NT; ++n)
        sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
      qk<HD, LD, NT, PS, QS>(sc, sq + rg * 16 * LD, slo + rg * 16 * LD,
                             sk_j + kh * KW * LD, sklo + kh * KW * LD, lane);

      const bool mask = causal && c0 + KW - 1 > wrow;
      float mx[2] = {NEG, NEG};
  #pragma unroll
      for (int n = 0; n < NT; ++n)
  #pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sc[n][e] * scale2;
          if (mask && c0 + 8 * n + 2 * t + (e & 1) > wrow + g + (e >> 1) * 8)
            x = NEG;
          sc[n][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float alpha[2];
  #pragma unroll
      for (int r = 0; r < 2; ++r) {
        // the row's scores sit in the 4 lanes of its quad
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        alpha[r] = exp2f(m[r] - m_new);
        m[r] = m_new;
        l[r] *= alpha[r];
      }
  #pragma unroll
      for (int n = 0; n < NT; ++n)
  #pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f(sc[n][e] - m[e >> 1]);   // masked cells -> 0
          l[e >> 1] += p;                               // this lane's part
          sc[n][e] = round_to<T>(p);
        }
  #pragma unroll
      for (int d = 0; d < DT; ++d) {
        acc[d][0] *= alpha[0];
        acc[d][1] *= alpha[0];
        acc[d][2] *= alpha[1];
        acc[d][3] *= alpha[1];
      }
      pv<HD, LD, NT, PS>(acc, sc, sv_j + kh * KW * LD,
                         sklo + (BN + kh * KW) * LD, lane);
    }
    if constexpr (PS) {
      if (next) {
        cp_async_wait_all();   // this thread's chunks of tile j + 1
        split_rows<HD, LD, BN>(nk, slo + ((j + 1) & 1) * 2 * BN * LD, rope,
                               tb);
        split_rows<HD, LD, BN>(nk + BN * LD,
                               slo + ((j + 1) & 1) * 2 * BN * LD + BN * LD,
                               false, tb);
      }
      __syncthreads();   // tile j + 1 is split; tile j is consumed
    }
  }

  if constexpr (KS == 2) {
    // the second warp of each row group hands its (m, l, acc) to the first
    // through the k/v ring, laid out [row group][value][lane]
    constexpr int VALS = 4 + 4 * DT;
    float* buf = reinterpret_cast<float*>(skv) + rg * VALS * 32 + lane;
    __syncthreads();   // every warp is done with the ring
    if (kh == 1) {
      buf[0] = m[0], buf[32] = m[1], buf[64] = l[0], buf[96] = l[1];
#pragma unroll
      for (int d = 0; d < DT; ++d)
#pragma unroll
        for (int e = 0; e < 4; ++e) buf[(4 + 4 * d + e) * 32] = acc[d][e];
    }
    __syncthreads();
    if (kh == 1) return;
    float a0[2], a1[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m1 = buf[32 * r], l1 = buf[64 + 32 * r];
      const float mm = fmaxf(m[r], m1);
      a0[r] = exp2f(m[r] - mm);
      a1[r] = exp2f(m1 - mm);
      m[r] = mm;
      l[r] = l[r] * a0[r] + l1 * a1[r];
    }
#pragma unroll
    for (int d = 0; d < DT; ++d)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[d][e] = acc[d][e] * a0[e >> 1] +
                    buf[(4 + 4 * d + e) * 32] * a1[e >> 1];
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = wrow + g + 8 * r;
    const float inv = 1.f / l[r];
    T* orow = o + (((size_t)b * s + row) * h + head) * HD + 2 * t;
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      const float x0 = acc[d][2 * r] * inv, x1 = acc[d][2 * r + 1] * inv;
      if constexpr (sizeof(T) == 4) {
        *reinterpret_cast<float2*>(orow + 8 * d) = make_float2(x0, x1);
      } else {
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * d) =
            __floats2bfloat162_rn(x0, x1);
      }
    }
    if (t == 0) lse[(size_t)bh * s + row] = m[r] * LN2 + logf(l[r]);
  }
}

template <typename T, int HD, int KS>
cudaError_t launch_ks(const void* q, const void* k, const void* v,
                      const float* cos, const float* sin, void* o, float* lse,
                      int b, int s, int sk, int h, int kv, float scale,
                      int causal, cudaStream_t stream) {
  constexpr size_t smem = Cfg<T, HD, KS>::SMEM;
  static_assert(smem <= 232448, "shared memory beyond the H100's 227 KB");
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, HD, KS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  // as much of the SM's 256 KB as shared memory as it takes, so that up to
  // three bf16 blocks fit
  err = cudaFuncSetAttribute(flash_fwd_kernel<T, HD, KS>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const dim3 grid(b * h, s / Cfg<T, HD, KS>::BM);
  flash_fwd_kernel<T, HD, KS><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), cos, sin, static_cast<T*>(o), lse, s, sk, h,
      kv, scale, causal, cos != nullptr);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* cos, const float* sin, void* o, float* lse,
                   int b, int s, int sk, int h, int kv, float scale,
                   int causal, cudaStream_t stream) {
  // split each tile's keys between two warps when 128-row blocks would not
  // give every SM one
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if ((long long)b * h * (s / 128) < sms)
    return launch_ks<T, HD, 2>(q, k, v, cos, sin, o, lse, b, s, sk, h, kv,
                               scale, causal, stream);
  return launch_ks<T, HD, 1>(q, k, v, cos, sin, o, lse, b, s, sk, h, kv,
                             scale, causal, stream);
}

}  // namespace

extern "C" const char* tpudist_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype: 0 = float32, 1 = bfloat16. cos/sin: null for no RoPE. stream: a
// cudaStream_t. Returns a cudaError_t (0 on a successful launch); shapes the
// kernel does not take return cudaErrorInvalidValue without launching.
extern "C" int tpudist_flash_attention_fwd(
    int dtype, int hd, const void* q, const void* k, const void* v,
    const float* cos, const float* sin, void* o, float* lse, int b, int s,
    int sk, int h, int kv, float scale, int causal, void* stream) {
  if (b < 1 || s < 1 || sk < 1 || kv < 1 || h % kv != 0 || b * h > 65535 ||
      s % 128 != 0 || sk % 128 != 0 || (causal && s != sk) ||
      (cos == nullptr) != (sin == nullptr) || (cos != nullptr && s != sk))
    return (int)cudaErrorInvalidValue;
  // 16-byte copies and loads
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(cos) |
       reinterpret_cast<uintptr_t>(sin) | reinterpret_cast<uintptr_t>(o)) %
          16 != 0)
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && hd == 128)
    return (int)launch<float, 128>(q, k, v, cos, sin, o, lse, b, s, sk, h,
                                   kv, scale, causal, st);
  if (dtype == 0 && hd == 256)
    return (int)launch<float, 256>(q, k, v, cos, sin, o, lse, b, s, sk, h,
                                   kv, scale, causal, st);
  if (dtype == 1 && hd == 128)
    return (int)launch<__nv_bfloat16, 128>(q, k, v, cos, sin, o, lse, b, s,
                                           sk, h, kv, scale, causal, st);
  if (dtype == 1 && hd == 256)
    return (int)launch<__nv_bfloat16, 256>(q, k, v, cos, sin, o, lse, b, s,
                                           sk, h, kv, scale, causal, st);
  return (int)cudaErrorInvalidValue;
}
