// Flash-attention backward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the three backward kernels of tpudist/ops/pallas/flash_attention.py
// (launched by `_bwd`, the custom VJP of `_flash`):
//   * `_dq_kernel`   -> flash_bwd_dq_kernel (tpudist_flash_attention_bwd_dq)
//   * `_dkv_kernel`  -> flash_bwd_dkv_kernel<T, false>
//                       (tpudist_flash_attention_bwd_dkv)
//   * `_dqkv_kernel` -> flash_bwd_dkv_kernel<T, true> +
//                       flash_bwd_dq_reduce_kernel
//                       (tpudist_flash_attention_bwd_dqkv)
// These run at hd 128 on the tensor cores. At hd 256 the CUDA-core kernels
// flash_bwd_dq_fma_kernel and flash_bwd_dkv_fma_kernel<T, WITH_DQ> take
// their places.
// They compute what the TPU kernels compute. For each kept (query row i, key
// row j) pair of a q head and its kv head: the rotated q/k (RoPE from (s,
// hd/2) f32 tables, split-halves pairs, rounded to the input type), the f32
// score s_ij = q_i.k_j * scale with the top-left causal mask, the exact
// softmax p_ij = exp(s_ij - lse_i), dp_ij = do_i.v_j and
// ds_ij = p_ij (dp_ij - delta_i), where delta = rowsum(do * o) - dlse comes
// in from the caller. Then dv_j += p_ij do_i, dk_j += ds_ij q_i (both summed
// over the q heads of the kv group: compact GQA) and dq_i += ds_ij k_j, with
// p and ds rounded to the input type before these products as the TPU
// kernels cast them; dq and dk are scaled and counter-rotated (the transpose
// rotation, f32 tables) on the way out. Scores, statistics and accumulators
// are f32. Key tiles wholly above the causal diagonal are skipped. No
// floating-point atomics: every output element is summed by one thread in a
// fixed order, so two calls on the same inputs give bitwise-equal outputs.
//
// Layout: q/do/o (b, s, h, hd), k/v (b, sk, kv, hd), dq like q, dk/dv like
// k, lse and delta (b, h, s) f32, all contiguous.
//
// Bound at the training slice's shape (b8 s2048 h16 kv16 hd128, causal): one
// product over the kept pairs is 2 * b * h * hd * s(s+1)/2 FLOP = 68.75
// GFLOP. dq needs three (q.k, do.v, ds.k: 206.3 GFLOP), dk/dv four (q.k,
// do.v, p^T.do, ds^T.q: 275.0 GFLOP). On the tensor cores f32 runs as
// 3xTF32 (three TF32 products for each f32 one, so 495 / 3 = 165 TFLOP/s
// from the H100 SXM data sheet's TF32 peak), bf16 at 989. In f32 that is
// 1.250 ms for dq and 1.667 ms for dk/dv; their bytes (q, k, v, do, lse,
// delta in; dq or dk, dv out) take ~0.2 ms at 3.35 TB/s: both are bound by
// operations. The merged kernel at seq 512 (b8 h16 kv16 hd128, causal)
// does all five products once, 21.5 GFLOP: 0.130 ms in f32, bound by
// operations; in bf16 its ~118 MB in and out take 0.035 ms at 3.35 TB/s,
// against 0.022 ms of products: bound by bytes. hd 256 does f32 FMA on the
// CUDA cores (67 TFLOP/s).
//
// Design of the tensor-core kernels at hd 128 (flash_bwd_dq_kernel,
// flash_bwd_dkv_kernel<T, WITH_DQ>). The CUDA-core design kept below for
// hd 256 does every product as f32 FMA, stages tiles synchronously as f32
// with an hd + 1 stride, sends p and ds through shared memory and starts
// the light causal blocks first; at the training shapes that is 3-4x the
// bound. The tensor-core kernels instead:
// - Products run on the tensor cores through mma.sync, as in the forward
//   kernel: f32 as 3xTF32 on m16n8k8 (x ~ hi + lo, both rounded to TF32;
//   lo*hi + hi*lo + hi*hi accumulate in f32, accurate to f32 where one TF32
//   product keeps about three digits), bf16 on m16n8k16 with f32
//   accumulation.
// - dq: a block owns 128 q rows, 8 warps of 16. q and do stay resident; a
//   warp computes S = Q K^T and dP = dO V^T for its rows over a key tile,
//   then p and ds in registers, and dQ += dS K into its 16 x 128
//   accumulator (64 registers a thread), which lives in registers across
//   the key loop. dS goes from the C fragment to the A fragment without
//   shared memory: for bf16 directly; for TF32, C holds columns (2t, 2t + 1)
//   where A wants (t, t + 4), so the keys are relabelled and K's B fragment
//   rows are read in the same order.
// - dk/dv: a block owns 128 key rows, 8 warps of 16; k and v stay resident.
//   A warp computes S^T = K Q^T and dP^T = V dO^T with its key rows as M, so
//   that lse and delta index columns, then dV += P^T dO and dK += dS^T Q
//   with the same C->A reuse. Its two accumulators (128 registers a thread)
//   live in registers across the q tiles of every q head of the kv group.
//   With p and ds kept in registers no warp waits on another's.
// - merged (dk/dv with WITH_DQ): the dk/dv block also forms dq's share of
//   its 128 keys from the same p/ds, where the split pair recomputes them
//   twice. Each warp writes its dS^T C fragments, rounded to T, into a
//   shared dS tile (the streamed tile's q rows x the block's keys). After a
//   barrier the 8 warps multiply it by the resident rotated K, 16 head-dim
//   columns a warp (a 16 x 16 accumulator in f32, 32 x 16 in bf16: 8 or 16
//   registers), and store that f32 partial to workspace slot blockIdx.y,
//   the key tile. A second launch (flash_bwd_dq_reduce_kernel) sums a row's
//   slots in key-tile order, then scales, counter-rotates and casts dq: sk /
//   128 slots, each written before it is read. Under the causal mask the
//   product runs only over the keys of the warps that did not skip the
//   tile, so it reads no dS column left from an earlier tile. Beside the f32
//   ring there is room for one unsplit dS tile (8.5 KB of the 13 KB left),
//   not for hi and lo parts, and the resident K is unsplit as well: the
//   product splits both as their fragments load, and a second barrier a
//   tile guards the dS tile's reuse. bf16 double-buffers the tile and needs
//   one barrier a tile. Within a TF32 k-step, logical k = t is key 2t and
//   k = t + 4 is key 2t + 1, as in dq's dS K: K's fragment rows then fall
//   in distinct banks and dS's two values are adjacent.
// - What streams (k/v tiles in dq; q/do tiles with their RoPE table rows,
//   lse and delta in dk/dv) comes in by 16-byte cp.async into a two-stage
//   ring: tile j + 1 loads while tile j computes, one barrier a tile. Rows
//   are padded 16 bytes, which keeps cp.async aligned and ldmatrix free of
//   bank conflicts. Each thread rotates (RoPE, rounded to T) and, for f32,
//   splits into hi (in place) and lo (a second array) the chunks it copied,
//   as they land: once per block, never per warp, and with no barrier of its
//   own. The resident tiles are rotated once; in f32 they stay unsplit (hi
//   and lo of both would not fit beside the ring) and each warp splits its
//   A fragments, once per k-step for all of a tile's n-tiles.
// - Shared memory: 214 KB in f32 (16-row streamed tiles; 223 KB merged),
//   135 KB in bf16 (32-row tiles; 152 KB merged); one block of 8 warps an
//   SM.
// - Causal balance: dq walks q tiles heaviest first (the last see the most
//   keys), dk/dv key tiles heaviest first (the first see the most q rows);
//   warps whose rows lie wholly on the masked side skip a tile, and the mask
//   is applied only on tiles that cross the diagonal.
// What it still leaves: wgmma (mma.sync stops well below the tensor cores'
// peak), TMA loads and warp specialisation (a producer warp and consumer
// warpgroups), and the smaller f32 streamed tiles that shared memory forces.
//
// hd 256 keeps the CUDA-core design, f32 FMA: 256 threads as 16 row groups
// x 16 column lanes; tiles of 32 rows, held in dynamic shared memory as f32
// with a row stride of hd + 1.
//   * dq: one block per (b*h, q tile), the q and do tiles resident, looping
//     over the key tiles up to the diagonal; the dq accumulator lives in
//     registers.
//   * dk/dv: one block per (b, kv head, key tile), the k and v tiles
//     resident, looping over the rep q heads of the group and over the q
//     tiles from the diagonal on; the group-summed dk/dv accumulators live in
//     registers.
//   * merged: the dk/dv block, which also multiplies each (q tile, key tile)
//     pair's ds tile by its key tile and writes that f32 dq partial to the
//     key tile's workspace slot; the same reduce follows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stddef.h>
#include <stdint.h>

#include <initializer_list>

#include "mma_common.cuh"

namespace {

// 8 warps in the tensor-core kernels; 16 row groups x 16 column lanes in the
// FMA kernels
constexpr int THREADS = 256;
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// The FMA kernels' tiling, at hd 256.
struct Cfg {
  static constexpr int HD = 256;
  static constexpr int TILE = 32;         // q rows = key rows
  static constexpr int PT = TILE / 16;    // tile rows (or columns) a thread owns
  static constexpr int DPT = HD / 16;     // head-dim columns a thread owns
  static constexpr int LD = HD + 1;       // row stride of the q/k/v/do tiles
  static constexpr int LDP = TILE + 1;    // row stride of the p/ds tiles
  static constexpr int H2 = HD / 2;
};

// Rows [row0, row0 + TILE) of head `head` of a (b, seq, nheads, HD) tensor
// into shared memory (row stride LD) as f32, RoPE-rotated at their absolute
// positions and rounded to T when `rope` (as the forward kernel loads them).
template <typename T>
__device__ void load_tile(float* dst, const T* __restrict__ src, int batch,
                          int seq, int nheads, int head, int row0,
                          const float* __restrict__ cos,
                          const float* __restrict__ sin, bool rope) {
  using C = Cfg;
  constexpr int HD = C::HD;
  for (int idx = threadIdx.x; idx < C::TILE * HD; idx += THREADS) {
    const int r = idx / HD, d = idx % HD;
    const int pos = row0 + r;
    const T* row = src + (((size_t)batch * seq + pos) * nheads + head) * HD;
    float x;
    if (rope) {
      const int i = d < C::H2 ? d : d - C::H2;
      const float c = round_to<T>(cos[(size_t)pos * C::H2 + i]);
      const float s = round_to<T>(sin[(size_t)pos * C::H2 + i]);
      const float x1 = to_f(row[i]), x2 = to_f(row[i + C::H2]);
      x = round_to<T>(d < C::H2 ? x1 * c - x2 * s : x2 * c + x1 * s);
    } else {
      x = to_f(row[d]);
    }
    dst[r * C::LD + d] = x;
  }
}

// The thread's PT x PT cells of one (q tile, key tile) pair: p and ds
// (f32), from the q/do tiles (rows rg*PT + r) and the k/v tiles (rows
// cg + 16*c). Rows of the pair start at row0 and col0 in the sequences.
__device__ __forceinline__ void p_and_ds(
    const float* sq, const float* sdo, const float* sk, const float* sv,
    int rg, int cg, int row0, int col0, const float (&lse)[Cfg::PT],
    const float (&delta)[Cfg::PT], float scale, int causal,
    float (&p)[Cfg::PT][Cfg::PT], float (&ds)[Cfg::PT][Cfg::PT]) {
  using C = Cfg;
  float sc[C::PT][C::PT], dp[C::PT][C::PT];
#pragma unroll
  for (int r = 0; r < C::PT; ++r)
#pragma unroll
    for (int c = 0; c < C::PT; ++c) sc[r][c] = dp[r][c] = 0.f;
#pragma unroll 4
  for (int d = 0; d < C::HD; ++d) {
    float qa[C::PT], oa[C::PT], kb[C::PT], vb[C::PT];
#pragma unroll
    for (int r = 0; r < C::PT; ++r) {
      qa[r] = sq[(rg * C::PT + r) * C::LD + d];
      oa[r] = sdo[(rg * C::PT + r) * C::LD + d];
    }
#pragma unroll
    for (int c = 0; c < C::PT; ++c) {
      kb[c] = sk[(cg + 16 * c) * C::LD + d];
      vb[c] = sv[(cg + 16 * c) * C::LD + d];
    }
#pragma unroll
    for (int r = 0; r < C::PT; ++r)
#pragma unroll
      for (int c = 0; c < C::PT; ++c) {
        sc[r][c] = fmaf(qa[r], kb[c], sc[r][c]);
        dp[r][c] = fmaf(oa[r], vb[c], dp[r][c]);
      }
  }
#pragma unroll
  for (int r = 0; r < C::PT; ++r) {
    const int row = row0 + rg * C::PT + r;
#pragma unroll
    for (int c = 0; c < C::PT; ++c) {
      float x = sc[r][c] * scale;
      if (causal && col0 + cg + 16 * c > row) x = NEG;
      p[r][c] = expf(x - lse[r]);   // masked cells -> 0
      ds[r][c] = p[r][c] * (dp[r][c] - delta[r]);
    }
  }
}

// dq/dk epilogue: x1 and x2 are head-dim columns d and d + hd/2 of one row
// at sequence position pos; scale, counter-rotate with the f32 tables, cast
// and store.
template <typename T, int HD>
__device__ __forceinline__ void store_rot_t(T* out, float x1, float x2,
                                            int d, int pos,
                                            const float* __restrict__ cos,
                                            const float* __restrict__ sin,
                                            int rope, float scale) {
  constexpr int H2 = HD / 2;
  x1 *= scale;
  x2 *= scale;
  if (rope) {
    const float c = cos[(size_t)pos * H2 + d];
    const float s = sin[(size_t)pos * H2 + d];
    const float y1 = x1 * c + x2 * s, y2 = x2 * c - x1 * s;
    x1 = y1;
    x2 = y2;
  }
  out[d] = from_f<T>(x1);
  out[d + H2] = from_f<T>(x2);
}

constexpr size_t dq_smem_bytes() {
  using C = Cfg;
  return sizeof(float) * (size_t)(4 * C::TILE * C::LD + C::TILE * C::LDP);
}

constexpr size_t dkv_smem_bytes() {
  using C = Cfg;
  return sizeof(float) * (size_t)(4 * C::TILE * C::LD + 2 * C::TILE * C::LDP);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dq_fma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        const float* __restrict__ cos,
                        const float* __restrict__ sin, T* __restrict__ dq,
                        int s, int sk, int h, int kv, float scale, int causal,
                        int rope) {
  using C = Cfg;
  constexpr int HD = C::HD;
  extern __shared__ float smem[];
  float* sq = smem;                    // rotated q tile
  float* sdo = sq + C::TILE * C::LD;
  float* skt = sdo + C::TILE * C::LD;  // rotated key tile
  float* sv = skt + C::TILE * C::LD;
  float* sds = sv + C::TILE * C::LD;   // ds rounded to T

  const int bh = blockIdx.y;
  const int b = bh / h, head = bh % h;
  const int kvh = head / (h / kv);
  const int row0 = blockIdx.x * C::TILE;
  const int rg = threadIdx.x / 16, cg = threadIdx.x % 16;

  load_tile<T>(sq, q, b, s, h, head, row0, cos, sin, rope);
  load_tile<T>(sdo, dout, b, s, h, head, row0, cos, sin, false);
  float lse_r[C::PT], delta_r[C::PT];
#pragma unroll
  for (int r = 0; r < C::PT; ++r) {
    const size_t at = (size_t)bh * s + row0 + rg * C::PT + r;
    lse_r[r] = lse[at];
    delta_r[r] = delta[at];
  }
  float acc[C::PT][C::DPT];
#pragma unroll
  for (int r = 0; r < C::PT; ++r)
#pragma unroll
    for (int dd = 0; dd < C::DPT; ++dd) acc[r][dd] = 0.f;

  // under the causal mask, q tile i needs key tiles 0..i (the diagonal's)
  const int n_tiles = causal ? blockIdx.x + 1 : sk / C::TILE;
  for (int j = 0; j < n_tiles; ++j) {
    const int col0 = j * C::TILE;
    __syncthreads();   // the previous key tile and its ds are consumed
    load_tile<T>(skt, k, b, sk, kv, kvh, col0, cos, sin, rope);
    load_tile<T>(sv, v, b, sk, kv, kvh, col0, cos, sin, false);
    __syncthreads();
    float p[C::PT][C::PT], ds[C::PT][C::PT];
    p_and_ds(sq, sdo, skt, sv, rg, cg, row0, col0, lse_r, delta_r, scale,
             causal, p, ds);
#pragma unroll
    for (int r = 0; r < C::PT; ++r)
#pragma unroll
      for (int c = 0; c < C::PT; ++c)
        sds[(rg * C::PT + r) * C::LDP + cg + 16 * c] = round_to<T>(ds[r][c]);
    __syncthreads();   // the whole ds tile is written
#pragma unroll 4
    for (int jj = 0; jj < C::TILE; ++jj) {
      float da[C::PT], kb[C::DPT];
#pragma unroll
      for (int r = 0; r < C::PT; ++r) da[r] = sds[(rg * C::PT + r) * C::LDP + jj];
#pragma unroll
      for (int dd = 0; dd < C::DPT; ++dd) kb[dd] = skt[jj * C::LD + cg + 16 * dd];
#pragma unroll
      for (int r = 0; r < C::PT; ++r)
#pragma unroll
        for (int dd = 0; dd < C::DPT; ++dd)
          acc[r][dd] = fmaf(da[r], kb[dd], acc[r][dd]);
    }
  }

#pragma unroll
  for (int r = 0; r < C::PT; ++r) {
    const int row = row0 + rg * C::PT + r;
    T* out = dq + (((size_t)b * s + row) * h + head) * HD;
#pragma unroll
    for (int dd = 0; dd < C::DPT / 2; ++dd)
      store_rot_t<T, HD>(out, acc[r][dd], acc[r][dd + C::DPT / 2],
                         cg + 16 * dd, row, cos, sin, rope, scale);
  }
}

// dk/dv of one (b, kv head, key tile); with WITH_DQ (the merged kernel) also
// the f32 dq partial of every (q head, q tile) pair it visits, into slot
// blockIdx.x of dq_part (n_key_tiles, b*h, s, HD).
template <typename T, bool WITH_DQ>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dkv_fma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         const float* __restrict__ cos,
                         const float* __restrict__ sin, T* __restrict__ dk,
                         T* __restrict__ dv, float* __restrict__ dq_part,
                         int nb, int s, int sk, int h, int kv, float scale,
                         int causal, int rope) {
  using C = Cfg;
  constexpr int HD = C::HD;
  extern __shared__ float smem[];
  float* skt = smem;                   // rotated key tile (resident)
  float* sv = skt + C::TILE * C::LD;   // value tile (resident)
  float* sq = sv + C::TILE * C::LD;    // rotated q tile
  float* sdo = sq + C::TILE * C::LD;
  float* sp = sdo + C::TILE * C::LD;   // p rounded to T
  float* sds = sp + C::TILE * C::LDP;  // ds rounded to T

  const int b = blockIdx.y / kv, g = blockIdx.y % kv;
  const int rep = h / kv;
  const int col0 = blockIdx.x * C::TILE;
  const int rg = threadIdx.x / 16, cg = threadIdx.x % 16;

  load_tile<T>(skt, k, b, sk, kv, g, col0, cos, sin, rope);
  load_tile<T>(sv, v, b, sk, kv, g, col0, cos, sin, false);

  // key rows rg*PT + c, head-dim columns cg + 16*dd
  float dk_acc[C::PT][C::DPT], dv_acc[C::PT][C::DPT];
#pragma unroll
  for (int c = 0; c < C::PT; ++c)
#pragma unroll
    for (int dd = 0; dd < C::DPT; ++dd) dk_acc[c][dd] = dv_acc[c][dd] = 0.f;

  // under the causal mask, q tiles before the diagonal see none of these keys
  const int i_first = causal ? blockIdx.x : 0;
  const int n_q_tiles = s / C::TILE;
  for (int hr = 0; hr < rep; ++hr) {
    const int head = g * rep + hr;
    const int bh = b * h + head;
    for (int i = i_first; i < n_q_tiles; ++i) {
      const int row0 = i * C::TILE;
      __syncthreads();   // the previous q/do/p/ds tiles are consumed
      load_tile<T>(sq, q, b, s, h, head, row0, cos, sin, rope);
      load_tile<T>(sdo, dout, b, s, h, head, row0, cos, sin, false);
      float lse_r[C::PT], delta_r[C::PT];
#pragma unroll
      for (int r = 0; r < C::PT; ++r) {
        const size_t at = (size_t)bh * s + row0 + rg * C::PT + r;
        lse_r[r] = lse[at];
        delta_r[r] = delta[at];
      }
      __syncthreads();
      {
        float p[C::PT][C::PT], ds[C::PT][C::PT];
        p_and_ds(sq, sdo, skt, sv, rg, cg, row0, col0, lse_r, delta_r, scale,
                 causal, p, ds);
#pragma unroll
        for (int r = 0; r < C::PT; ++r)
#pragma unroll
          for (int c = 0; c < C::PT; ++c) {
            const int at = (rg * C::PT + r) * C::LDP + cg + 16 * c;
            sp[at] = round_to<T>(p[r][c]);
            sds[at] = round_to<T>(ds[r][c]);
          }
      }
      __syncthreads();   // the whole p and ds tiles are written
#pragma unroll 2
      for (int ii = 0; ii < C::TILE; ++ii) {
        float pa[C::PT], da[C::PT], oa[C::DPT], qa[C::DPT];
#pragma unroll
        for (int c = 0; c < C::PT; ++c) {
          pa[c] = sp[ii * C::LDP + rg * C::PT + c];
          da[c] = sds[ii * C::LDP + rg * C::PT + c];
        }
#pragma unroll
        for (int dd = 0; dd < C::DPT; ++dd) {
          oa[dd] = sdo[ii * C::LD + cg + 16 * dd];
          qa[dd] = sq[ii * C::LD + cg + 16 * dd];
        }
#pragma unroll
        for (int c = 0; c < C::PT; ++c)
#pragma unroll
          for (int dd = 0; dd < C::DPT; ++dd) {
            dv_acc[c][dd] = fmaf(pa[c], oa[dd], dv_acc[c][dd]);
            dk_acc[c][dd] = fmaf(da[c], qa[dd], dk_acc[c][dd]);
          }
      }
      if (WITH_DQ) {
        // this key tile's share of dq for the q tile's rows rg*PT + r
        float part[C::PT][C::DPT];
#pragma unroll
        for (int r = 0; r < C::PT; ++r)
#pragma unroll
          for (int dd = 0; dd < C::DPT; ++dd) part[r][dd] = 0.f;
#pragma unroll 2
        for (int c = 0; c < C::TILE; ++c) {
          float da[C::PT], kb[C::DPT];
#pragma unroll
          for (int r = 0; r < C::PT; ++r)
            da[r] = sds[(rg * C::PT + r) * C::LDP + c];
#pragma unroll
          for (int dd = 0; dd < C::DPT; ++dd)
            kb[dd] = skt[c * C::LD + cg + 16 * dd];
#pragma unroll
          for (int r = 0; r < C::PT; ++r)
#pragma unroll
            for (int dd = 0; dd < C::DPT; ++dd)
              part[r][dd] = fmaf(da[r], kb[dd], part[r][dd]);
        }
#pragma unroll
        for (int r = 0; r < C::PT; ++r) {
          float* out = dq_part +
                       (((size_t)blockIdx.x * nb * h + bh) * s + row0 +
                        rg * C::PT + r) * HD;
#pragma unroll
          for (int dd = 0; dd < C::DPT; ++dd) out[cg + 16 * dd] = part[r][dd];
        }
      }
    }
  }

#pragma unroll
  for (int c = 0; c < C::PT; ++c) {
    const int pos = col0 + rg * C::PT + c;
    const size_t at = (((size_t)b * sk + pos) * kv + g) * HD;
#pragma unroll
    for (int dd = 0; dd < C::DPT / 2; ++dd)
      store_rot_t<T, HD>(dk + at, dk_acc[c][dd], dk_acc[c][dd + C::DPT / 2],
                         cg + 16 * dd, pos, cos, sin, rope, scale);
#pragma unroll
    for (int dd = 0; dd < C::DPT; ++dd)
      dv[at + cg + 16 * dd] = from_f<T>(dv_acc[c][dd]);
  }
}

// The merged kernels' epilogue: one thread per (b*h, row, d < HD/2) sums the
// dq partials of the key tiles (`tile` rows each) the row needs, in key-tile
// order, then scales, counter-rotates and casts.
template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dq_reduce_kernel(const float* __restrict__ dq_part,
                               const float* __restrict__ cos,
                               const float* __restrict__ sin,
                               T* __restrict__ dq, int nb, int s, int h,
                               int tile, int n_key_tiles, float scale,
                               int causal, int rope) {
  constexpr int H2 = HD / 2;
  const size_t total = (size_t)nb * h * s * H2;
  const size_t idx = (size_t)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= total) return;
  const int d = (int)(idx % H2);
  const size_t rest = idx / H2;
  const int row = (int)(rest % s);
  const int bh = (int)(rest / s);
  const int b = bh / h, head = bh % h;
  // causal (s == sk): a row has partials from key tiles 0..row / tile only
  const int last = causal ? row / tile : n_key_tiles - 1;
  float x1 = 0.f, x2 = 0.f;
  for (int j = 0; j <= last; ++j) {
    const float* part =
        dq_part + (((size_t)j * nb * h + bh) * s + row) * HD;
    x1 += part[d];
    x2 += part[d + H2];
  }
  store_rot_t<T, HD>(dq + (((size_t)b * s + row) * h + head) * HD, x1, x2, d,
                     row, cos, sin, rope, scale);
}

// ---------------------------------------------------------------------------
// The split pair at hd 128 on the tensor cores: flash_bwd_dq_kernel and
// flash_bwd_dkv_kernel.

// Tiling of the tensor-core kernels at hd 128. A block is 8 warps; every
// warp owns 16 rows of the resident tile (q rows in dq, key rows in dk/dv)
// and walks the streamed tiles of the other side.
template <typename T>
struct Tc {
  static constexpr bool F32 = sizeof(T) == 4;
  static constexpr int HD = 128, H2 = HD / 2;
  static constexpr int PER = 16 / (int)sizeof(T);   // elements in 16 bytes
  static constexpr int LD = HD + PER;               // rows padded 16 bytes
  static constexpr int IPR = H2 / PER;              // items per row
  static constexpr int BM = 128;   // dq: resident q rows
  static constexpr int BK = 128;   // dk/dv: resident key rows
  // rows of one streamed tile (keys in dq, q rows in dk/dv): one item per
  // thread; f32 holds hi and lo parts, so its tiles are half as tall
  static constexpr int BS = F32 ? 16 : 32;
  // T arrays in one stage of the ring: two tiles, and for f32 their lo parts
  static constexpr int ARRAYS = F32 ? 4 : 2;
  // one stage: the arrays, then the f32 cos and sin rows of the tile, then
  // (dk/dv) the tile's lse and delta
  static constexpr size_t STAGE = sizeof(T) * (size_t)ARRAYS * BS * LD +
                                  sizeof(float) * (size_t)(2 * BS * H2 + 2 * BS);
  static constexpr size_t SMEM = sizeof(T) * (size_t)2 * BM * LD + 2 * STAGE;
  // the merged kernel's dS tile (a streamed tile's q rows x the block's
  // keys, row stride LDS: conflict-free fragment loads), after the ring;
  // bf16 has room to double-buffer it
  static constexpr int LDS = BK + 8;
  static constexpr int DS_BUFS = F32 ? 1 : 2;
  static constexpr size_t DS_TILE = sizeof(T) * (size_t)BS * LDS;
  static constexpr size_t SMEM_DQKV = SMEM + DS_BUFS * DS_TILE;
  static_assert(BM == BK, "one shared-memory size serves both kernels");
  static_assert(BS * IPR == THREADS, "one item of a streamed tile a thread");
  static_assert(STAGE % 16 == 0, "16-byte aligned stages");
};

// 16 bytes of T as floats, and back (rounded to T).
__device__ __forceinline__ void load16(const float* p, float (&x)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float (&x)[8]) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    x[2 * i] = f.x, x[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void store16(float* p, const float (&x)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ void store16(__nv_bfloat16* p, const float (&x)[8]) {
  uint4 v;
  v.x = pack_bf16(x[0], x[1]), v.y = pack_bf16(x[2], x[3]);
  v.z = pack_bf16(x[4], x[5]), v.w = pack_bf16(x[6], x[7]);
  *reinterpret_cast<uint4*>(p) = v;
}

// Two adjacent columns of an output row.
__device__ __forceinline__ void store2(float* p, float x0, float x1) {
  *reinterpret_cast<float2*>(p) = make_float2(x0, x1);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x0, float x1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x0, x1);
}

// Item `idx` of a tile: row r, elements d .. d + PER - 1 and the same
// + hd/2, the pairs that RoPE rotates together. A thread copies its items
// and then rotates and splits them itself, so that needs no barrier.
template <typename T>
__device__ __forceinline__ void item(int idx, int& r, int& d) {
  r = idx / Tc<T>::IPR;
  d = (idx % Tc<T>::IPR) * Tc<T>::PER;
}

// Start copying item idx of the rows at src (row stride `stride` elements)
// into dst (row stride LD).
template <typename T>
__device__ __forceinline__ void issue_item(T* dst, const T* __restrict__ src,
                                           size_t stride, int idx) {
  using C = Tc<T>;
  int r, d;
  item<T>(idx, r, d);
  cp_async16(dst + r * C::LD + d, src + r * stride + d);
  cp_async16(dst + r * C::LD + d + C::H2, src + r * stride + d + C::H2);
}

// Start copying the RoPE table entries item idx needs, rows pos0 + r of
// the (s, hd/2) f32 tables, into rows of hd/2 at tc and ts.
template <typename T>
__device__ __forceinline__ void issue_tables(float* tc, float* ts,
                                             const float* __restrict__ cos,
                                             const float* __restrict__ sin,
                                             int pos0, int idx) {
  using C = Tc<T>;
  int r, d;
  item<T>(idx, r, d);
  const size_t at = (size_t)(pos0 + r) * C::H2 + d;
#pragma unroll
  for (int c = 0; c < C::PER; c += 4) {
    cp_async16(tc + r * C::H2 + d + c, cos + at + c);
    cp_async16(ts + r * C::H2 + d + c, sin + at + c);
  }
}

// Item idx of a landed tile: rotated with the tables' rows at tc/ts (shared
// or device memory, rows of hd/2) when `rope`, each value rounded to T as
// the TPU kernels' casts do; with SPLIT (f32 only) then split into TF32 hi
// (in place) and lo (to `lo`, same layout).
template <typename T, bool SPLIT>
__device__ __forceinline__ void land_item(T* tile, T* lo, const float* tc,
                                          const float* ts, bool rope,
                                          int idx) {
  using C = Tc<T>;
  static_assert(!SPLIT || C::F32, "only f32 is split");
  int r, d;
  item<T>(idx, r, d);
  T* row = tile + r * C::LD;
  float x1[C::PER], x2[C::PER];
  load16(row + d, x1);
  load16(row + d + C::H2, x2);
  if (rope) {
    float cs[C::PER], sn[C::PER];
#pragma unroll
    for (int c = 0; c < C::PER; c += 4) {
      load16(tc + r * C::H2 + d + c, *reinterpret_cast<float(*)[4]>(cs + c));
      load16(ts + r * C::H2 + d + c, *reinterpret_cast<float(*)[4]>(sn + c));
    }
#pragma unroll
    for (int e = 0; e < C::PER; ++e) {
      const float c = round_to<T>(cs[e]), s = round_to<T>(sn[e]);
      const float y1 = x1[e] * c - x2[e] * s;
      x2[e] = round_to<T>(x2[e] * c + x1[e] * s);
      x1[e] = round_to<T>(y1);
    }
  }
  if constexpr (SPLIT) {
    float h1[C::PER], l1[C::PER], h2[C::PER], l2[C::PER];
#pragma unroll
    for (int e = 0; e < C::PER; ++e) {
      uint32_t hb, lb;
      split(x1[e], hb, lb);
      h1[e] = __uint_as_float(hb), l1[e] = __uint_as_float(lb);
      split(x2[e], hb, lb);
      h2[e] = __uint_as_float(hb), l2[e] = __uint_as_float(lb);
    }
    store16(row + d, h1);
    store16(row + d + C::H2, h2);
    store16(lo + r * C::LD + d, l1);
    store16(lo + r * C::LD + d + C::H2, l2);
  } else {
    if (rope) {
      store16(row + d, x1);
      store16(row + d + C::H2, x2);
    }
  }
}

// sc (16 x 8 NT) += A B^T over hd, f32 operands as 3xTF32. A: this warp's
// 16 rows of a resident tile (raw f32, split here, once per k-step for all
// NT n-tiles); B: 8 NT rows of a streamed tile, split when it landed (hi at
// sb, lo at the same offsets in sblo). Fragments by ldmatrix.
template <int NT>
__device__ __forceinline__ void mma_abt(float (&sc)[NT][4], const float* sa,
                                        const float* sb, const float* sblo,
                                        int lane) {
  constexpr int LD = Tc<float>::LD;
  static_assert(NT % 2 == 0, "B fragments come in pairs of n-tiles");
  const int lr = lane % 8, m1 = (lane / 8) % 2, m2 = lane / 16;
  // A's matrices: rows +0/+8 (m1), columns +0/+4 (m2); B's: columns +0/+4
  // (m1), rows +0/+8 (m2)
  const int aoff = (lr + 8 * m1) * LD + 4 * m2;
  const int boff = (lr + 8 * m2) * LD + 4 * m1;
#pragma unroll
  for (int kk = 0; kk < Tc<float>::HD; kk += 8) {
    uint32_t ahi[4], alo[4];
    ldmatrix_x4(ahi, sa + aoff + kk);
#pragma unroll
    for (int i = 0; i < 4; ++i) split(__uint_as_float(ahi[i]), ahi[i], alo[i]);
#pragma unroll
    for (int n = 0; n < NT; n += 2) {
      uint32_t bh[4], bl[4];
      ldmatrix_x4(bh, sb + 8 * n * LD + kk + boff);
      ldmatrix_x4(bl, sblo + 8 * n * LD + kk + boff);
      mma_3xtf32(sc[n], ahi, alo, bh[0], bh[1], bl[0], bl[1]);
      mma_3xtf32(sc[n + 1], ahi, alo, bh[2], bh[3], bl[2], bl[3]);
    }
  }
}

// sc += A B^T, bf16 operands (A and B as above, no lo parts).
template <int NT>
__device__ __forceinline__ void mma_abt(float (&sc)[NT][4],
                                        const __nv_bfloat16* sa,
                                        const __nv_bfloat16* sb,
                                        const __nv_bfloat16*, int lane) {
  constexpr int LD = Tc<__nv_bfloat16>::LD;
  const int g = lane / 4, t = lane % 4;
#pragma unroll 4
  for (int kk = 0; kk < Tc<__nv_bfloat16>::HD; kk += 16) {
    const __nv_bfloat16* pa = sa + g * LD + kk + 2 * t;
    const uint32_t a[4] = {ld32(pa), ld32(pa + 8 * LD), ld32(pa + 8),
                           ld32(pa + 8 * LD + 8)};
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const __nv_bfloat16* pb = sb + (8 * n + g) * LD + kk + 2 * t;
      mma_bf16(sc[n], a, ld32(pb), ld32(pb + 8));
    }
  }
}

// acc (16 x hd) += P B, f32: P is the C fragments of a 16 x 8 NT product,
// whose columns are this product's k. C holds columns (2t, 2t + 1) where
// the A fragment wants (t, t + 4), and the sum runs over k in any order: so
// k-step n is C tile n with its columns relabelled (logical k = t is column
// 2t, k = t + 4 is 2t + 1), split here, and B's rows (a streamed tile, split
// when it landed) are read in the same order.
template <int NT>
__device__ __forceinline__ void mma_pb(float (&acc)[16][4],
                                       const float (&p)[NT][4],
                                       const float* sb, const float* sblo,
                                       int lane) {
  constexpr int LD = Tc<float>::LD;
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
    for (int d = 0; d < 16; ++d) {
      mma_3xtf32(acc[d], ahi, alo, __float_as_uint(sb[off + 8 * d]),
                 __float_as_uint(sb[off + LD + 8 * d]),
                 __float_as_uint(sblo[off + 8 * d]),
                 __float_as_uint(sblo[off + LD + 8 * d]));
    }
  }
}

// acc += P B, bf16: P (rounded to bf16 here) packs straight into the A
// fragment; B's fragments come transposed by ldmatrix.
template <int NT>
__device__ __forceinline__ void mma_pb(float (&acc)[16][4],
                                       const float (&p)[NT][4],
                                       const __nv_bfloat16* sb,
                                       const __nv_bfloat16*, int lane) {
  constexpr int LD = Tc<__nv_bfloat16>::LD;
  static_assert(NT % 2 == 0, "16-deep k-steps");
  // this lane's row for ldmatrix: matrix lane / 8 is (k +0 or +8, columns
  // +0 or +8)
  const int mat = lane / 8;
  const __nv_bfloat16* brow =
      sb + ((mat & 1) * 8 + lane % 8) * LD + (mat >> 1) * 8;
#pragma unroll
  for (int m = 0; m < NT / 2; ++m) {
    const uint32_t a[4] = {pack_bf16(p[2 * m][0], p[2 * m][1]),
                           pack_bf16(p[2 * m][2], p[2 * m][3]),
                           pack_bf16(p[2 * m + 1][0], p[2 * m + 1][1]),
                           pack_bf16(p[2 * m + 1][2], p[2 * m + 1][3])};
#pragma unroll
    for (int d = 0; d < 16; d += 2) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, brow + 16 * m * LD + 8 * d);
      mma_bf16(acc[d], a, b[0], b[1]);
      mma_bf16(acc[d + 1], a, b[2], b[3]);
    }
  }
}

// part (16 q rows x 16 head-dim columns d0 .. d0 + 15) += dS K over the
// dS tile's first nk keys, f32 as 3xTF32: the merged kernel's dq partial.
// dS (q rows x keys, row stride LDS) and the resident rotated K are raw
// f32, split here as their fragments load. In a k-step of 8 keys, logical
// k = t is key 2t and k = t + 4 is key 2t + 1: dS's two values are adjacent
// (one 8-byte load), and K's rows 2t fall in distinct banks.
__device__ __forceinline__ void mma_dsk(float (&part)[1][2][4],
                                        const float* sds, const float* skr,
                                        int d0, int nk, int lane) {
  constexpr int LD = Tc<float>::LD, LDS = Tc<float>::LDS;
  const int g = lane / 4, t = lane % 4;
  const float* pa = sds + g * LDS + 2 * t;
  const float* pb = skr + 2 * t * LD + d0 + g;
#pragma unroll 2
  for (int kk = 0; kk < nk; kk += 8) {
    const float2 x0 = *reinterpret_cast<const float2*>(pa + kk);
    const float2 x1 = *reinterpret_cast<const float2*>(pa + 8 * LDS + kk);
    uint32_t ahi[4], alo[4];
    split(x0.x, ahi[0], alo[0]);
    split(x1.x, ahi[1], alo[1]);
    split(x0.y, ahi[2], alo[2]);
    split(x1.y, ahi[3], alo[3]);
    const float* b = pb + kk * LD;
#pragma unroll
    for (int j = 0; j < 2; ++j)
      mma_3xtf32(part[0][j], ahi, alo, b[8 * j], b[LD + 8 * j]);
  }
}

// part (32 q rows x 16 head-dim columns d0 .. d0 + 15) += dS K, bf16: dS's
// A fragments by ldmatrix, K's B fragments transposed by ldmatrix, as in
// mma_pb.
__device__ __forceinline__ void mma_dsk(float (&part)[2][2][4],
                                        const __nv_bfloat16* sds,
                                        const __nv_bfloat16* skr, int d0,
                                        int nk, int lane) {
  constexpr int LD = Tc<__nv_bfloat16>::LD, LDS = Tc<__nv_bfloat16>::LDS;
  const int lr = lane % 8, mat = lane / 8;
  // A's matrices: rows +0/+8, keys +0/+8; B's: keys +0/+8, columns +0/+8
  const int row = lr + 8 * (mat & 1), col = 8 * (mat >> 1);
  const __nv_bfloat16* pa = sds + row * LDS + col;
  const __nv_bfloat16* pb = skr + row * LD + col + d0;
#pragma unroll 2
  for (int kk = 0; kk < nk; kk += 16) {
    uint32_t b[4];
    ldmatrix_x4_trans(b, pb + kk * LD);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      uint32_t a[4];
      ldmatrix_x4(a, pa + 16 * mt * LDS + kk);
      mma_bf16(part[mt][0], a, b[0], b[1]);
      mma_bf16(part[mt][1], a, b[2], b[3]);
    }
  }
}

// The epilogue of dq and dk: the two rows (g, g + 8) of this lane's C
// fragments of a 16 x hd accumulator, scaled, counter-rotated with the f32
// tables (the transpose rotation) at the rows' positions, cast and stored.
// Columns c and c + hd/2 are fragments d and d + 8, in the same lane.
template <typename T>
__device__ __forceinline__ void store_rows(const float (&acc)[16][4], T* out0,
                                           size_t row_stride, int pos0,
                                           const float* __restrict__ cos,
                                           const float* __restrict__ sin,
                                           bool rope, float scale, int lane) {
  constexpr int H2 = Tc<T>::H2;
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = g + 8 * r;
    T* out = out0 + row * row_stride;
#pragma unroll
    for (int d = 0; d < 8; ++d) {
      const int col = 8 * d + 2 * t;
      float x1[2], x2[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        x1[e] = acc[d][2 * r + e] * scale;
        x2[e] = acc[d + 8][2 * r + e] * scale;
      }
      if (rope) {
        const size_t at = (size_t)(pos0 + row) * H2 + col;
        const float2 c = *reinterpret_cast<const float2*>(cos + at);
        const float2 s = *reinterpret_cast<const float2*>(sin + at);
        const float cc[2] = {c.x, c.y}, ss[2] = {s.x, s.y};
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float y1 = x1[e] * cc[e] + x2[e] * ss[e];
          x2[e] = x2[e] * cc[e] - x1[e] * ss[e];
          x1[e] = y1;
        }
      }
      store2(out + col, x1[0], x1[1]);
      store2(out + col + H2, x2[0], x2[1]);
    }
  }
}

// dq of one (b*h, 128-row q tile): q and do resident (q rotated once), the
// key tiles streamed through a two-stage cp.async ring, each landed tile
// rotated and (f32) split once by the threads that copied it. A warp owns
// 16 q rows: S = Q K^T and dP = dO V^T (16 x BS), p, ds, then
// dQ += dS K into its 16 x 128 accumulator, which lives in registers across
// the key loop.
template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        const float* __restrict__ cos,
                        const float* __restrict__ sin, T* __restrict__ dq,
                        int s, int sk, int h, int kv, float scale, int causal,
                        int rope) {
  using C = Tc<T>;
  constexpr int LD = C::LD, BM = C::BM, BS = C::BS, H2 = C::H2, HD = C::HD;
  constexpr int NT = BS / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sq = reinterpret_cast<T*>(smem_raw);
  T* sdo = sq + BM * LD;
  unsigned char* ring = reinterpret_cast<unsigned char*>(sdo + BM * LD);
  // stage i: k, v, (f32) k lo, v lo, then the cos and sin rows of its keys
  auto stage = [&](int i) { return reinterpret_cast<T*>(ring + i * C::STAGE); };
  auto tables = [&](int i) {
    return reinterpret_cast<float*>(ring + i * C::STAGE +
                                    sizeof(T) * C::ARRAYS * BS * LD);
  };

  const int bh = blockIdx.x;
  const int b = bh / h, head = bh % h;
  const int kvh = head / (h / kv);
  // heaviest q tiles first under the causal mask
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int row0 = qt * BM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wrow = row0 + 16 * warp;   // this warp's first row

  const size_t q_stride = (size_t)h * HD, kv_stride = (size_t)kv * HD;
  const size_t q_at = (((size_t)b * s + row0) * h + head) * HD;
  const T* ksrc = k + ((size_t)b * sk * kv + kvh) * HD;
  const T* vsrc = v + ((size_t)b * sk * kv + kvh) * HD;

  auto issue_tile = [&](int j) {   // key tile j into stage j & 1
    T* st = stage(j & 1);
    const size_t off = (size_t)j * BS * kv_stride;
    issue_item<T>(st, ksrc + off, kv_stride, threadIdx.x);
    issue_item<T>(st + BS * LD, vsrc + off, kv_stride, threadIdx.x);
    if (rope) {
      float* tb = tables(j & 1);
      issue_tables<T>(tb, tb + BS * H2, cos, sin, j * BS, threadIdx.x);
    }
    cp_async_commit();
  };
  auto land_tile = [&](int j) {    // this thread's items of key tile j
    T* st = stage(j & 1);
    const float* tb = tables(j & 1);
    land_item<T, C::F32>(st, st + 2 * BS * LD, tb, tb + BS * H2, rope,
                         threadIdx.x);
    if constexpr (C::F32)
      land_item<T, true>(st + BS * LD, st + 3 * BS * LD, tb, tb, false,
                         threadIdx.x);
  };

  for (int idx = threadIdx.x; idx < BM * C::IPR; idx += THREADS) {
    issue_item<T>(sq, q + q_at, q_stride, idx);
    issue_item<T>(sdo, dout + q_at, q_stride, idx);
  }
  issue_tile(0);
  // this lane's rows g and g + 8: lse in the log2 domain, delta
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const size_t at = (size_t)bh * s + wrow + g + 8 * r;
    lse2[r] = lse[at] * LOG2E;
    dl[r] = delta[at];
  }
  cp_async_wait_all();
  if (rope) {
    for (int idx = threadIdx.x; idx < BM * C::IPR; idx += THREADS)
      land_item<T, false>(sq, nullptr, cos + (size_t)row0 * H2,
                          sin + (size_t)row0 * H2, true, idx);
  }
  land_tile(0);
  __syncthreads();   // q, do and key tile 0 are ready for every warp

  float acc[16][4];
#pragma unroll
  for (int d = 0; d < 16; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
  const float scale2 = scale * LOG2E;
  // under the causal mask, q tile qt needs keys up to its last row
  const int n_tiles = causal ? (row0 + BM) / BS : sk / BS;
  for (int j = 0; j < n_tiles; ++j) {
    const bool next = j + 1 < n_tiles;
    if (next) issue_tile(j + 1);   // tile j + 1 loads while tile j computes
    const T* skt = stage(j & 1);
    const int c0 = j * BS;
    // a warp whose rows all precede the tile's keys has nothing to add
    if (!causal || c0 <= wrow + 15) {
      float sc[NT][4], dp[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[n][e] = dp[n][e] = 0.f;
      mma_abt<NT>(sc, sq + 16 * warp * LD, skt, skt + 2 * BS * LD, lane);
      mma_abt<NT>(dp, sdo + 16 * warp * LD, skt + BS * LD,
                  skt + 3 * BS * LD, lane);
      // the mask only where the tile crosses the diagonal
      const bool mask = causal && c0 + BS - 1 > wrow;
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = exp2f(fmaf(sc[n][e], scale2, -lse2[e >> 1]));
          if (mask && c0 + 8 * n + 2 * t + (e & 1) > wrow + g + 8 * (e >> 1))
            p = 0.f;
          // ds, rounded to T by the product below
          sc[n][e] = p * (dp[n][e] - dl[e >> 1]);
        }
      mma_pb<NT>(acc, sc, skt, skt + 2 * BS * LD, lane);
    }
    if (next) {
      cp_async_wait_all();   // this thread's copies of tile j + 1
      land_tile(j + 1);
    }
    __syncthreads();   // tile j + 1 is ready; tile j is consumed
  }

  store_rows<T>(acc, dq + (((size_t)b * s + wrow) * h + head) * HD,
                q_stride, wrow, cos, sin, rope, scale, lane);
}

// dk/dv of one (b, kv head, 128-row key tile): k (rotated once) and v
// resident, the (q head, q tile) pairs of the kv group streamed through a
// two-stage cp.async ring with their lse and delta, each landed tile
// rotated and (f32) split once by the threads that copied it. A warp owns
// 16 key rows: S^T = K Q^T and dP^T = V dO^T (16 x BS, keys as M, so that
// lse and delta index columns), p and ds, then dV += P^T dO and
// dK += dS^T Q into its two 16 x 128 accumulators (128 registers), which
// live in registers across the whole group: the compact-GQA group sum.
// With WITH_DQ (the merged kernel) the warps also gather dS in the shared
// dS tile and multiply it by the resident K, 16 head-dim columns a warp:
// each pair's f32 dq partial, into slot blockIdx.y of dq_part
// (sk / 128, nb*h, s, 128).
template <typename T, bool WITH_DQ>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         const float* __restrict__ cos,
                         const float* __restrict__ sin, T* __restrict__ dk,
                         T* __restrict__ dv, float* __restrict__ dq_part,
                         int nb, int s, int sk, int h, int kv, float scale,
                         int causal, int rope) {
  using C = Tc<T>;
  constexpr int LD = C::LD, BK = C::BK, BS = C::BS, H2 = C::H2, HD = C::HD;
  constexpr int NT = BS / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* skr = reinterpret_cast<T*>(smem_raw);   // resident keys, rotated
  T* svr = skr + BK * LD;
  unsigned char* ring = reinterpret_cast<unsigned char*>(svr + BK * LD);
  // stage i: q, do, (f32) q lo, do lo, then the cos and sin rows of its q
  // rows, then their lse and delta
  auto stage = [&](int i) { return reinterpret_cast<T*>(ring + i * C::STAGE); };
  auto tables = [&](int i) {
    return reinterpret_cast<float*>(ring + i * C::STAGE +
                                    sizeof(T) * C::ARRAYS * BS * LD);
  };
  // the merged kernel's dS tile for pair n
  auto ds_tile = [&](int n) {
    return reinterpret_cast<T*>(ring + 2 * C::STAGE +
                                (n % C::DS_BUFS) * C::DS_TILE);
  };

  const int b = blockIdx.x / kv, grp = blockIdx.x % kv;
  const int rep = h / kv;
  // key tiles in launch order: the first ones see the most q rows
  const int col0 = blockIdx.y * BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wkey = col0 + 16 * warp;   // this warp's first key

  const size_t q_stride = (size_t)h * HD, kv_stride = (size_t)kv * HD;
  const size_t kv_at = (((size_t)b * sk + col0) * kv + grp) * HD;
  // under the causal mask, q tiles before the key tile see none of its keys
  const int i_first = causal ? col0 / BS : 0;
  const int per_head = s / BS - i_first;
  const int n_tiles = rep * per_head;

  auto issue_tile = [&](int n) {   // (q head, q tile) pair n, stage n & 1
    const int head = grp * rep + n / per_head;
    const int row0 = (i_first + n % per_head) * BS;
    const size_t at = (((size_t)b * s + row0) * h + head) * HD;
    T* st = stage(n & 1);
    float* tb = tables(n & 1);
    issue_item<T>(st, q + at, q_stride, threadIdx.x);
    issue_item<T>(st + BS * LD, dout + at, q_stride, threadIdx.x);
    if (rope) issue_tables<T>(tb, tb + BS * H2, cos, sin, row0, threadIdx.x);
    const size_t rows = ((size_t)b * h + head) * s + row0;
    float* sl = tb + 2 * BS * H2;
    if (threadIdx.x < BS / 4)
      cp_async16(sl + 4 * threadIdx.x, lse + rows + 4 * threadIdx.x);
    else if (threadIdx.x < BS / 2)
      cp_async16(sl + BS + 4 * (threadIdx.x - BS / 4),
                 delta + rows + 4 * (threadIdx.x - BS / 4));
    cp_async_commit();
  };
  auto land_tile = [&](int n) {    // this thread's items of pair n
    T* st = stage(n & 1);
    const float* tb = tables(n & 1);
    land_item<T, C::F32>(st, st + 2 * BS * LD, tb, tb + BS * H2, rope,
                         threadIdx.x);
    if constexpr (C::F32)
      land_item<T, true>(st + BS * LD, st + 3 * BS * LD, tb, tb, false,
                         threadIdx.x);
  };

  for (int idx = threadIdx.x; idx < BK * C::IPR; idx += THREADS) {
    issue_item<T>(skr, k + kv_at, kv_stride, idx);
    issue_item<T>(svr, v + kv_at, kv_stride, idx);
  }
  issue_tile(0);
  cp_async_wait_all();
  if (rope) {
    for (int idx = threadIdx.x; idx < BK * C::IPR; idx += THREADS)
      land_item<T, false>(skr, nullptr, cos + (size_t)col0 * H2,
                          sin + (size_t)col0 * H2, true, idx);
  }
  land_tile(0);
  __syncthreads();   // k, v and the first q tile are ready for every warp

  float dk_acc[16][4], dv_acc[16][4];
#pragma unroll
  for (int d = 0; d < 16; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[d][e] = dv_acc[d][e] = 0.f;
  const float scale2 = scale * LOG2E;
  for (int n = 0; n < n_tiles; ++n) {
    const bool next = n + 1 < n_tiles;
    if (next) issue_tile(n + 1);   // pair n + 1 loads while pair n computes
    const T* st = stage(n & 1);
    const float* sl = tables(n & 1) + 2 * BS * H2;
    const int head = grp * rep + n / per_head;
    const int row0 = (i_first + n % per_head) * BS;
    T* sds = ds_tile(n);
    // a warp whose keys all follow the tile's rows has nothing to add
    if (!causal || row0 + BS - 1 >= wkey) {
      float sc[NT][4], dp[NT][4];
#pragma unroll
      for (int m = 0; m < NT; ++m)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[m][e] = dp[m][e] = 0.f;
      mma_abt<NT>(sc, skr + 16 * warp * LD, st, st + 2 * BS * LD, lane);
      mma_abt<NT>(dp, svr + 16 * warp * LD, st + BS * LD, st + 3 * BS * LD,
                  lane);
      // the mask only where the tile crosses the diagonal
      const bool mask = causal && row0 < wkey + 15;
#pragma unroll
      for (int m = 0; m < NT; ++m) {
        const int col = 8 * m + 2 * t;   // this lane's q rows col, col + 1
        const float2 l = *reinterpret_cast<const float2*>(sl + col);
        const float2 dd = *reinterpret_cast<const float2*>(sl + BS + col);
        const float lse2[2] = {l.x * LOG2E, l.y * LOG2E}, dl[2] = {dd.x, dd.y};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = exp2f(fmaf(sc[m][e], scale2, -lse2[e & 1]));
          if (mask && wkey + g + 8 * (e >> 1) > row0 + col + (e & 1)) p = 0.f;
          // p and ds, each rounded to T by the products below
          dp[m][e] = p * (dp[m][e] - dl[e & 1]);
          sc[m][e] = p;
        }
      }
      mma_pb<NT>(dv_acc, sc, st + BS * LD, st + 3 * BS * LD, lane);
      mma_pb<NT>(dk_acc, dp, st, st + 2 * BS * LD, lane);
      if constexpr (WITH_DQ) {
        // dS^T's C fragments, rounded to T, into the dS tile: q row
        // 8m + 2t (+1), key 16 warp + g (+8)
        T* w = sds + 16 * warp + g;
#pragma unroll
        for (int m = 0; m < NT; ++m)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            w[(8 * m + 2 * t + (e & 1)) * C::LDS + 8 * (e >> 1)] =
                from_f<T>(dp[m][e]);
      }
    }
    if (next) {
      cp_async_wait_all();   // this thread's copies of pair n + 1
      land_tile(n + 1);
    }
    // pair n + 1 is ready; pair n is consumed and its dS tile written
    __syncthreads();
    if constexpr (WITH_DQ) {
      // under the causal mask only the warps whose keys precede the tile's
      // last row wrote dS; the keys after them are masked for every row
      const int nk = causal ? min(BK, row0 + BS - col0) : BK;
      float part[BS / 16][2][4];
#pragma unroll
      for (int mt = 0; mt < BS / 16; ++mt)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[mt][j][e] = 0.f;
      mma_dsk(part, sds, skr, 16 * warp, nk, lane);
      float* out = dq_part +
                   (((size_t)blockIdx.y * nb * h + (size_t)b * h + head) * s +
                    row0 + g) * HD + 16 * warp + 2 * t;
#pragma unroll
      for (int mt = 0; mt < BS / 16; ++mt)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int r = 0; r < 2; ++r)
            store2(out + (16 * mt + 8 * r) * HD + 8 * j, part[mt][j][2 * r],
                   part[mt][j][2 * r + 1]);
      if constexpr (C::DS_BUFS == 1) __syncthreads();   // dS is consumed
    }
  }

  T* dk0 = dk + (((size_t)b * sk + wkey) * kv + grp) * HD;
  store_rows<T>(dk_acc, dk0, kv_stride, wkey, cos, sin, rope, scale, lane);
  store_rows<T>(dv_acc, dv + (dk0 - dk), kv_stride, wkey, cos, sin, false,
                1.f, lane);
}

template <typename T>
cudaError_t launch_dq_fma(const void* q, const void* k, const void* v,
                          const void* dout, const float* lse,
                          const float* delta, const float* cos,
                          const float* sin, void* dq, int b, int s, int sk,
                          int h, int kv, float scale, int causal,
                          cudaStream_t stream) {
  constexpr size_t smem = dq_smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_fma_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(s / Cfg::TILE, b * h);
  flash_bwd_dq_fma_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta, cos,
      sin, static_cast<T*>(dq), s, sk, h, kv, scale, causal, cos != nullptr);
  return cudaGetLastError();
}

template <typename T, bool WITH_DQ>
cudaError_t launch_dkv_fma(const void* q, const void* k, const void* v,
                           const void* dout, const float* lse,
                           const float* delta, const float* cos,
                           const float* sin, void* dk, void* dv,
                           float* dq_part, int b, int s, int sk, int h,
                           int kv, float scale, int causal,
                           cudaStream_t stream) {
  constexpr size_t smem = dkv_smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_fma_kernel<T, WITH_DQ>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(sk / Cfg::TILE, b * kv);
  flash_bwd_dkv_fma_kernel<T, WITH_DQ><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta, cos,
      sin, static_cast<T*>(dk), static_cast<T*>(dv), dq_part, b, s, sk, h, kv,
      scale, causal, cos != nullptr);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dq_tc(const void* q, const void* k, const void* v,
                         const void* dout, const float* lse,
                         const float* delta, const float* cos,
                         const float* sin, void* dq, int b, int s, int sk,
                         int h, int kv, float scale, int causal,
                         cudaStream_t stream) {
  constexpr size_t smem = Tc<T>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(b * h, s / Tc<T>::BM);
  flash_bwd_dq_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta, cos,
      sin, static_cast<T*>(dq), s, sk, h, kv, scale, causal, cos != nullptr);
  return cudaGetLastError();
}

// dk/dv, and with WITH_DQ the dq partials into dq_part.
template <typename T, bool WITH_DQ>
cudaError_t launch_dkv_tc(const void* q, const void* k, const void* v,
                          const void* dout, const float* lse,
                          const float* delta, const float* cos,
                          const float* sin, void* dk, void* dv,
                          float* dq_part, int b, int s, int sk, int h, int kv,
                          float scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = WITH_DQ ? Tc<T>::SMEM_DQKV : Tc<T>::SMEM;
  static_assert(smem <= 232448, "shared memory beyond the H100's 227 KB");
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, WITH_DQ>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(b * kv, sk / Tc<T>::BK);
  flash_bwd_dkv_kernel<T, WITH_DQ><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta, cos,
      sin, static_cast<T*>(dk), static_cast<T*>(dv), dq_part, b, s, sk, h,
      kv, scale, causal, cos != nullptr);
  return cudaGetLastError();
}

// Rows of one key tile of the merged kernel at head dim hd (its workspace
// holds sk / tile_rows(hd) slots; MERGED_TILE in ops/cuda/flash_attention.py
// sizes it and must agree), which are also the sequence multiples the
// kernels take; 0 for head dims without a kernel.
int tile_rows(int hd) {
  return hd == 128 ? Tc<float>::BK : hd == 256 ? Cfg::TILE : 0;
}

// The merged backward: dk/dv and the dq partials (tensor cores at hd 128,
// CUDA cores at 256), then their ordered sum.
template <typename T>
cudaError_t launch_dqkv(int hd, const void* q, const void* k, const void* v,
                        const void* dout, const float* lse,
                        const float* delta, const float* cos,
                        const float* sin, void* dq, void* dk, void* dv,
                        float* workspace, int b, int s, int sk, int h, int kv,
                        float scale, int causal, cudaStream_t stream) {
  cudaError_t err =
      hd == 128
          ? launch_dkv_tc<T, true>(q, k, v, dout, lse, delta, cos, sin, dk,
                                   dv, workspace, b, s, sk, h, kv, scale,
                                   causal, stream)
          : launch_dkv_fma<T, true>(q, k, v, dout, lse, delta, cos, sin, dk,
                                    dv, workspace, b, s, sk, h, kv, scale,
                                    causal, stream);
  if (err != cudaSuccess) return err;
  const int tile = tile_rows(hd);
  const size_t total = (size_t)b * h * s * (hd / 2);
  const unsigned blocks = (unsigned)((total + THREADS - 1) / THREADS);
  if (hd == 128)
    flash_bwd_dq_reduce_kernel<T, 128><<<blocks, THREADS, 0, stream>>>(
        workspace, cos, sin, static_cast<T*>(dq), b, s, h, tile, sk / tile,
        scale, causal, cos != nullptr);
  else
    flash_bwd_dq_reduce_kernel<T, 256><<<blocks, THREADS, 0, stream>>>(
        workspace, cos, sin, static_cast<T*>(dq), b, s, h, tile, sk / tile,
        scale, causal, cos != nullptr);
  return cudaGetLastError();
}

// Shapes the kernels take (the wrapper's gate is stricter: seq multiples of
// 128 at either head dim); anything else returns cudaErrorInvalidValue
// without launching.
bool valid(int dtype, int hd, int b, int s, int sk, int h, int kv, int causal,
           const float* cos, const float* sin) {
  const int tile = tile_rows(hd);
  return (dtype == 0 || dtype == 1) && tile > 0 && b >= 1 && s >= 1 &&
         sk >= 1 && kv >= 1 && h % kv == 0 && b * h <= 65535 &&
         s % tile == 0 && sk % tile == 0 && (!causal || s == sk) &&
         (cos == nullptr) == (sin == nullptr) && (cos == nullptr || s == sk);
}

// The tensor-core kernels copy by 16-byte cp.async.
cudaError_t aligned16(std::initializer_list<const void*> ptrs) {
  uintptr_t bits = 0;
  for (const void* p : ptrs) bits |= reinterpret_cast<uintptr_t>(p);
  return bits % 16 ? cudaErrorMisalignedAddress : cudaSuccess;
}

// Calls launch(T{}) for dtype 0 = float32, 1 = bfloat16.
template <typename F>
int dispatch(int dtype, F launch) {
  if (dtype == 0) return (int)launch(float{});
  if (dtype == 1) return (int)launch(__nv_bfloat16{});
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" const char* tpudist_flash_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype: 0 = float32, 1 = bfloat16. cos/sin: null for no RoPE. stream: a
// cudaStream_t. Each returns a cudaError_t (0 on a successful launch). At hd
// 128 every kernel runs on the tensor cores, at hd 256 on the CUDA cores.

extern "C" int tpudist_flash_attention_bwd_dq(
    int dtype, int hd, const void* q, const void* k, const void* v,
    const void* dout, const float* lse, const float* delta, const float* cos,
    const float* sin, void* dq, int b, int s, int sk, int h, int kv,
    float scale, int causal, void* stream) {
  if (!valid(dtype, hd, b, s, sk, h, kv, causal, cos, sin))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dispatch(dtype, [&](auto t) {
    using T = decltype(t);
    if (hd == 256)
      return launch_dq_fma<T>(q, k, v, dout, lse, delta, cos, sin, dq, b, s,
                              sk, h, kv, scale, causal, st);
    const cudaError_t err =
        aligned16({q, k, v, dout, lse, delta, cos, sin, dq});
    if (err != cudaSuccess) return err;
    return launch_dq_tc<T>(q, k, v, dout, lse, delta, cos, sin, dq, b, s, sk,
                           h, kv, scale, causal, st);
  });
}

extern "C" int tpudist_flash_attention_bwd_dkv(
    int dtype, int hd, const void* q, const void* k, const void* v,
    const void* dout, const float* lse, const float* delta, const float* cos,
    const float* sin, void* dk, void* dv, int b, int s, int sk, int h, int kv,
    float scale, int causal, void* stream) {
  if (!valid(dtype, hd, b, s, sk, h, kv, causal, cos, sin))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dispatch(dtype, [&](auto t) {
    using T = decltype(t);
    if (hd == 256)
      return launch_dkv_fma<T, false>(q, k, v, dout, lse, delta, cos, sin,
                                      dk, dv, nullptr, b, s, sk, h, kv, scale,
                                      causal, st);
    const cudaError_t err =
        aligned16({q, k, v, dout, lse, delta, cos, sin, dk, dv});
    if (err != cudaSuccess) return err;
    return launch_dkv_tc<T, false>(q, k, v, dout, lse, delta, cos, sin, dk,
                                   dv, nullptr, b, s, sk, h, kv, scale, causal,
                                   st);
  });
}

// workspace: (sk / tile, b*h, s, hd) f32, tile from
// tile_rows(hd); every slot a row needs is written
// before it is read.
extern "C" int tpudist_flash_attention_bwd_dqkv(
    int dtype, int hd, const void* q, const void* k, const void* v,
    const void* dout, const float* lse, const float* delta, const float* cos,
    const float* sin, void* dq, void* dk, void* dv, float* workspace, int b,
    int s, int sk, int h, int kv, float scale, int causal, void* stream) {
  if (!valid(dtype, hd, b, s, sk, h, kv, causal, cos, sin) ||
      workspace == nullptr)
    return (int)cudaErrorInvalidValue;
  if (hd == 128) {
    const cudaError_t err = aligned16(
        {q, k, v, dout, lse, delta, cos, sin, dq, dk, dv, workspace});
    if (err != cudaSuccess) return (int)err;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dispatch(dtype, [&](auto t) {
    return launch_dqkv<decltype(t)>(hd, q, k, v, dout, lse, delta, cos, sin,
                                    dq, dk, dv, workspace, b, s, sk, h, kv,
                                    scale, causal, st);
  });
}
