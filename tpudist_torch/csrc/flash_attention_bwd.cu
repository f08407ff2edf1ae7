// Flash-attention backward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the three backward kernels of tpudist/ops/pallas/flash_attention.py
// (launched by `_bwd`, the custom VJP of `_flash`):
//   * `_dq_kernel`   -> flash_bwd_dq_kernel (tpudist_flash_attention_bwd_dq)
//   * `_dkv_kernel`  -> flash_bwd_dkv_kernel<.., false>
//                       (tpudist_flash_attention_bwd_dkv)
//   * `_dqkv_kernel` -> flash_bwd_dkv_kernel<.., true> + flash_bwd_dq_reduce
//                       (tpudist_flash_attention_bwd_dqkv)
// They compute what the TPU kernels compute. For each kept (query row i, key
// row j) pair of a q head and its kv head: the rotated q/k (RoPE from (s,
// hd/2) f32 tables, split-halves pairs, rounded to the input type), the f32
// score s_ij = q_i.k_j * scale with the top-left causal mask (-1e30), the
// exact softmax p_ij = exp(s_ij - lse_i), dp_ij = do_i.v_j and
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
// Bound at the training slice's shapes (h16 kv16 hd128, f32, causal): every
// kernel does its products as f32 FMA on the CUDA cores, so the operation
// bound divides by the H100's f32 peak outside the tensor cores (67 TFLOP/s,
// SXM data sheet). One product over the kept pairs is
// 2 * b * h * hd * s(s+1)/2 FLOP: 68.7 GFLOP at b8 s2048, 4.30 GFLOP at
// b8 s512. dq needs three (q.k, do.v, ds.k: 3.1 ms at s2048), dk/dv four
// (q.k, do.v, p^T.do, ds^T.q: 4.1 ms), the merged kernel five (0.32 ms at
// s512). Their bytes (q, k, v, do, lse, delta in; dq, dk, dv out) take
// 0.2-0.3 ms at 3.35 TB/s at s2048: all three are bound by operations.
//
// Design, kept simple on purpose: 256 threads as 16 row groups x 16 column
// lanes; tiles of 64 rows at hd 128 and 32 at hd 256 (the shared memory of
// four f32 tiles at hd 256 would not fit otherwise), held in dynamic shared
// memory as f32 with a row stride of hd + 1.
//   * dq: one block per (b*h, q tile), the q and do tiles resident, looping
//     over the key tiles up to the diagonal; the dq accumulator lives in
//     registers (the mirror of the forward kernel's schedule).
//   * dk/dv: one block per (b, kv head, key tile), the k and v tiles
//     resident, looping over the rep q heads of the group and over the q
//     tiles from the diagonal on; the group-summed dk/dv accumulators live in
//     registers.
//   * merged: the dk/dv block, which also multiplies each (q tile, key tile)
//     pair's ds tile by its key tile and writes that f32 dq partial to a
//     per-key-tile workspace slot: one p/ds recompute per pair where the split
//     pair pays two. A second launch sums the slots in key-tile order, then
//     scales, counter-rotates and casts dq.
// What it leaves on the table, for later work: the tensor cores (wgmma), TMA
// or cp.async double buffering, and balance of the uneven causal work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stddef.h>

#include <type_traits>

namespace {

constexpr int THREADS = 256;   // 16 row groups x 16 column lanes
constexpr float NEG = -1e30f;

template <int HD>
struct Cfg {
  static constexpr int TILE = HD <= 128 ? 64 : 32;   // q rows = key rows
  static constexpr int PT = TILE / 16;    // tile rows (or columns) a thread owns
  static constexpr int DPT = HD / 16;     // head-dim columns a thread owns
  static constexpr int LD = HD + 1;       // row stride of the q/k/v/do tiles
  static constexpr int LDP = TILE + 1;    // row stride of the p/ds tiles
  static constexpr int H2 = HD / 2;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// x rounded to T's precision, kept as f32.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// Rows [row0, row0 + TILE) of head `head` of a (b, seq, nheads, HD) tensor
// into shared memory (row stride LD) as f32, RoPE-rotated at their absolute
// positions and rounded to T when `rope` (as the forward kernel loads them).
template <typename T, int HD>
__device__ void load_tile(float* dst, const T* __restrict__ src, int batch,
                          int seq, int nheads, int head, int row0,
                          const float* __restrict__ cos,
                          const float* __restrict__ sin, bool rope) {
  using C = Cfg<HD>;
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
template <int HD>
__device__ __forceinline__ void p_and_ds(
    const float* sq, const float* sdo, const float* sk, const float* sv,
    int rg, int cg, int row0, int col0, const float (&lse)[Cfg<HD>::PT],
    const float (&delta)[Cfg<HD>::PT], float scale, int causal,
    float (&p)[Cfg<HD>::PT][Cfg<HD>::PT],
    float (&ds)[Cfg<HD>::PT][Cfg<HD>::PT]) {
  using C = Cfg<HD>;
  float sc[C::PT][C::PT], dp[C::PT][C::PT];
#pragma unroll
  for (int r = 0; r < C::PT; ++r)
#pragma unroll
    for (int c = 0; c < C::PT; ++c) sc[r][c] = dp[r][c] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
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

// dq/dk epilogue: x1 = acc[dd], x2 = acc[dd + DPT/2] are head-dim columns
// d and d + hd/2 of one row at sequence position pos; scale, counter-rotate
// with the f32 tables, cast and store.
template <typename T, int HD>
__device__ __forceinline__ void store_rot_t(T* out, float x1, float x2,
                                            int d, int pos,
                                            const float* __restrict__ cos,
                                            const float* __restrict__ sin,
                                            int rope, float scale) {
  using C = Cfg<HD>;
  x1 *= scale;
  x2 *= scale;
  if (rope) {
    const float c = cos[(size_t)pos * C::H2 + d];
    const float s = sin[(size_t)pos * C::H2 + d];
    const float y1 = x1 * c + x2 * s, y2 = x2 * c - x1 * s;
    x1 = y1;
    x2 = y2;
  }
  out[d] = from_f<T>(x1);
  out[d + C::H2] = from_f<T>(x2);
}

template <int HD>
constexpr size_t dq_smem_bytes() {
  using C = Cfg<HD>;
  return sizeof(float) * (size_t)(4 * C::TILE * C::LD + C::TILE * C::LDP);
}

template <int HD>
constexpr size_t dkv_smem_bytes() {
  using C = Cfg<HD>;
  return sizeof(float) * (size_t)(4 * C::TILE * C::LD + 2 * C::TILE * C::LDP);
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        const float* __restrict__ cos,
                        const float* __restrict__ sin, T* __restrict__ dq,
                        int s, int sk, int h, int kv, float scale, int causal,
                        int rope) {
  using C = Cfg<HD>;
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

  load_tile<T, HD>(sq, q, b, s, h, head, row0, cos, sin, rope);
  load_tile<T, HD>(sdo, dout, b, s, h, head, row0, cos, sin, false);
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
    load_tile<T, HD>(skt, k, b, sk, kv, kvh, col0, cos, sin, rope);
    load_tile<T, HD>(sv, v, b, sk, kv, kvh, col0, cos, sin, false);
    __syncthreads();
    float p[C::PT][C::PT], ds[C::PT][C::PT];
    p_and_ds<HD>(sq, sdo, skt, sv, rg, cg, row0, col0, lse_r, delta_r, scale,
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
template <typename T, int HD, bool WITH_DQ>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         const float* __restrict__ cos,
                         const float* __restrict__ sin, T* __restrict__ dk,
                         T* __restrict__ dv, float* __restrict__ dq_part,
                         int nb, int s, int sk, int h, int kv, float scale,
                         int causal, int rope) {
  using C = Cfg<HD>;
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

  load_tile<T, HD>(skt, k, b, sk, kv, g, col0, cos, sin, rope);
  load_tile<T, HD>(sv, v, b, sk, kv, g, col0, cos, sin, false);

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
      load_tile<T, HD>(sq, q, b, s, h, head, row0, cos, sin, rope);
      load_tile<T, HD>(sdo, dout, b, s, h, head, row0, cos, sin, false);
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
        p_and_ds<HD>(sq, sdo, skt, sv, rg, cg, row0, col0, lse_r, delta_r,
                     scale, causal, p, ds);
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

// The merged kernel's epilogue: one thread per (b*h, row, d < HD/2) sums the
// dq partials of the key tiles the row needs, in key-tile order, then scales,
// counter-rotates and casts.
template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dq_reduce_kernel(const float* __restrict__ dq_part,
                               const float* __restrict__ cos,
                               const float* __restrict__ sin,
                               T* __restrict__ dq, int nb, int s, int h,
                               int n_key_tiles, float scale, int causal,
                               int rope) {
  using C = Cfg<HD>;
  const size_t total = (size_t)nb * h * s * C::H2;
  const size_t idx = (size_t)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= total) return;
  const int d = (int)(idx % C::H2);
  const size_t rest = idx / C::H2;
  const int row = (int)(rest % s);
  const int bh = (int)(rest / s);
  const int b = bh / h, head = bh % h;
  // causal (s == sk): q tile i has partials from key tiles 0..i only
  const int last = causal ? row / C::TILE : n_key_tiles - 1;
  float x1 = 0.f, x2 = 0.f;
  for (int j = 0; j <= last; ++j) {
    const float* part =
        dq_part + (((size_t)j * nb * h + bh) * s + row) * HD;
    x1 += part[d];
    x2 += part[d + C::H2];
  }
  store_rot_t<T, HD>(dq + (((size_t)b * s + row) * h + head) * HD, x1, x2, d,
                     row, cos, sin, rope, scale);
}

template <typename T, int HD>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      const float* cos, const float* sin, void* dq, int b,
                      int s, int sk, int h, int kv, float scale, int causal,
                      cudaStream_t stream) {
  constexpr size_t smem = dq_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(s / Cfg<HD>::TILE, b * h);
  flash_bwd_dq_kernel<T, HD><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta, cos,
      sin, static_cast<T*>(dq), s, sk, h, kv, scale, causal, cos != nullptr);
  return cudaGetLastError();
}

template <typename T, int HD, bool WITH_DQ>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse, const float* delta,
                       const float* cos, const float* sin, void* dk, void* dv,
                       float* dq_part, int b, int s, int sk, int h, int kv,
                       float scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = dkv_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, HD, WITH_DQ>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(sk / Cfg<HD>::TILE, b * kv);
  flash_bwd_dkv_kernel<T, HD, WITH_DQ><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta, cos,
      sin, static_cast<T*>(dk), static_cast<T*>(dv), dq_part, b, s, sk, h, kv,
      scale, causal, cos != nullptr);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_dqkv(const void* q, const void* k, const void* v,
                        const void* dout, const float* lse,
                        const float* delta, const float* cos,
                        const float* sin, void* dq, void* dk, void* dv,
                        float* workspace, int b, int s, int sk, int h, int kv,
                        float scale, int causal, cudaStream_t stream) {
  cudaError_t err = launch_dkv<T, HD, true>(q, k, v, dout, lse, delta, cos,
                                            sin, dk, dv, workspace, b, s, sk,
                                            h, kv, scale, causal, stream);
  if (err != cudaSuccess) return err;
  const size_t total = (size_t)b * h * s * Cfg<HD>::H2;
  const unsigned blocks = (unsigned)((total + THREADS - 1) / THREADS);
  flash_bwd_dq_reduce_kernel<T, HD><<<blocks, THREADS, 0, stream>>>(
      workspace, cos, sin, static_cast<T*>(dq), b, s, h, sk / Cfg<HD>::TILE,
      scale, causal, cos != nullptr);
  return cudaGetLastError();
}

int tile_rows(int hd) {
  return hd == 128 ? Cfg<128>::TILE : hd == 256 ? Cfg<256>::TILE : 0;
}

// Shapes the kernels take (the wrapper's gate is stricter: seq multiples of
// 128); anything else returns cudaErrorInvalidValue without launching.
bool valid(int dtype, int hd, int b, int s, int sk, int h, int kv, int causal,
           const float* cos, const float* sin) {
  const int tile = tile_rows(hd);
  return (dtype == 0 || dtype == 1) && tile > 0 && b >= 1 && s >= 1 &&
         sk >= 1 && kv >= 1 && h % kv == 0 && b * h <= 65535 &&
         s % tile == 0 && sk % tile == 0 && (!causal || s == sk) &&
         (cos == nullptr) == (sin == nullptr) && (cos == nullptr || s == sk);
}

template <int HD>
using HeadDim = std::integral_constant<int, HD>;

// Calls launch(T{}, HeadDim<HD>{}) for the kernel's (dtype, hd)
// instantiation; dtype 0 = float32, 1 = bfloat16.
template <typename F>
int dispatch(int dtype, int hd, F launch) {
  if (dtype == 0 && hd == 128) return (int)launch(float{}, HeadDim<128>{});
  if (dtype == 0 && hd == 256) return (int)launch(float{}, HeadDim<256>{});
  if (dtype == 1 && hd == 128)
    return (int)launch(__nv_bfloat16{}, HeadDim<128>{});
  if (dtype == 1 && hd == 256)
    return (int)launch(__nv_bfloat16{}, HeadDim<256>{});
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" const char* tpudist_flash_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Rows of one tile at head dim hd (0 for head dims without a kernel): the
// merged kernel's workspace holds sk / tile f32 dq partials of q's shape.
extern "C" int tpudist_flash_attention_bwd_tile(int hd) {
  return tile_rows(hd);
}

// dtype: 0 = float32, 1 = bfloat16. cos/sin: null for no RoPE. stream: a
// cudaStream_t. Each returns a cudaError_t (0 on a successful launch).

extern "C" int tpudist_flash_attention_bwd_dq(
    int dtype, int hd, const void* q, const void* k, const void* v,
    const void* dout, const float* lse, const float* delta, const float* cos,
    const float* sin, void* dq, int b, int s, int sk, int h, int kv,
    float scale, int causal, void* stream) {
  if (!valid(dtype, hd, b, s, sk, h, kv, causal, cos, sin))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dispatch(dtype, hd, [&](auto t, auto hdc) {
    return launch_dq<decltype(t), decltype(hdc)::value>(
        q, k, v, dout, lse, delta, cos, sin, dq, b, s, sk, h, kv, scale,
        causal, st);
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
  return dispatch(dtype, hd, [&](auto t, auto hdc) {
    return launch_dkv<decltype(t), decltype(hdc)::value, false>(
        q, k, v, dout, lse, delta, cos, sin, dk, dv, nullptr, b, s, sk, h,
        kv, scale, causal, st);
  });
}

// workspace: (sk / tile, b*h, s, hd) f32, tile from
// tpudist_flash_attention_bwd_tile(hd); every slot a row needs is written
// before it is read.
extern "C" int tpudist_flash_attention_bwd_dqkv(
    int dtype, int hd, const void* q, const void* k, const void* v,
    const void* dout, const float* lse, const float* delta, const float* cos,
    const float* sin, void* dq, void* dk, void* dv, float* workspace, int b,
    int s, int sk, int h, int kv, float scale, int causal, void* stream) {
  if (!valid(dtype, hd, b, s, sk, h, kv, causal, cos, sin) ||
      workspace == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dispatch(dtype, hd, [&](auto t, auto hdc) {
    return launch_dqkv<decltype(t), decltype(hdc)::value>(
        q, k, v, dout, lse, delta, cos, sin, dq, dk, dv, workspace, b, s, sk,
        h, kv, scale, causal, st);
  });
}
