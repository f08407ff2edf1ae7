// Fused LM-head cross-entropy for Hopper (sm_90a), plain C interface for
// ctypes.
//
// Replaces the two kernels of tpudist/ops/pallas/fused_xent.py:
//   * `_fwd_kernel` -> xent_fwd_kernel + xent_fwd_merge_kernel
//                      (tpudist_fused_xent_fwd)
//   * `_bwd_kernel` -> xent_dl_kernel, xent_dh_kernel, xent_de_kernel, run
//                      over token chunks (tpudist_fused_xent_bwd)
// They compute what the TPU kernels compute, for h (t, d) and the tied
// embedding E (V, d) in f32 or bf16, int64 targets (t,) and f32 per-token
// cotangents ct (t,):
//   forward   logits = h.E^T (f32 sums), lse_i = logsumexp_v logits_iv,
//             loss_i = lse_i - logits_i,target_i;
//   backward  dl_iv = (exp(logits_iv - lse_i) - [v == target_i]) * ct_i,
//             rounded to the operand type, then dh = dl.E and dE = dl^T.h
//             with f32 sums; dh is written in h's type, dE in E's.
// Token rows >= t and vocab columns >= V are never read: every operand load
// is bounds-checked and fills zero, every store is bounds-checked. A target
// outside [0, V) picks no gold logit, as the TPU kernel's masked iota compare.
// Shapes need no alignment: any t, V, d >= 1.
//
// Bound on this card at the training slice's shape (t 16384 = b8 x s2048,
// d 2048, V 32000, f32): one product of the head's size is 2 t V d =
// 2.15 TFLOP. The forward does one, the backward three (the logits
// recompute, dh and dE). On the tensor cores f32 runs as 3xTF32, three TF32
// products for each f32 one: 495 / 3 = 165 TFLOP/s from the H100 SXM data
// sheet's TF32 peak, so 13.0 ms for the forward and 39.1 ms for the
// backward (bf16 at 989 TFLOP/s). The bytes every call must move (h and E
// read, loss/lse or dh/dE written) are ~0.4 GB, ~0.12 ms at 3.35 TB/s: both
// are bound by operations.
//
// Design. Every product of the five kernels runs on one GEMM core (`gemm`):
// - A block of 8 warps computes a 128 x 256 output tile; each warp owns
//   64 x 64 of it (4 m16 x 8 n8 accumulator tiles, 128 f32 registers).
//   (128 x 128 tiles with 64 x 32 warp tiles ran the f32 slice shape 11 %
//   slower: each fragment fed half as many products.)
// - Products are mma.sync on the tensor cores: f32 as 3xTF32 on m16n8k8
//   (x ~ hi + lo, both rounded to TF32; lo*hi + hi*lo + hi*hi accumulate in
//   f32, accurate to f32 where one TF32 product keeps about three digits:
//   tests/test_torch_fused_xent.py holds each product by the split within
//   the f32 tolerances of float64), bf16 on m16n8k16; f32 accumulation.
// - Operands come in k-steps of 32 by 16-byte cp.async into a ring of four
//   stages in dynamic shared memory, one barrier a k-step. A partial chunk
//   at the edge of t, V or d takes the zero-filling form (cp.async's
//   src-size); an operand whose rows are not 16-byte aligned (d % 4 != 0 in
//   f32, d % 8 != 0 in bf16, and V likewise for dl) takes predicated
//   element loads, stored to the same layout, in the same kernel.
// - f32's split. Each warp splits every fragment it loads into hi and lo
//   once, in registers, for all the tiles that use it (an A fragment feeds 8
//   n8 tiles, a B fragment 4 m16 tiles). Splitting each chunk once as it
//   lands, with hi and lo stored side by side, made the kernels bound by
//   shared memory: the split reads the chunk back and writes it twice, and
//   every fragment is then loaded twice; that design ran the f32 slice
//   shape 10-15 % slower (PERF.md, PR 7), while the integer pipe has room
//   for the split's five operations.
// - Layouts. Each operand stays in shared memory as it lies in device
//   memory, padded so that its fragment loads are free of bank conflicts:
//   K-contiguous (rows of 32 k padded 16 bytes; ldmatrix for f32 and bf16)
//   or MN-contiguous (rows of 128 or 256 m or n padded 8 elements; 32-bit
//   loads in f32, ldmatrix.trans in bf16). The logits (forward and
//   xent_dl_kernel) take h and E both K-contiguous, mma's native row.col;
//   dh = dl.E takes dl K-contiguous and E (K = V, N = d) N-contiguous;
//   dE = dl^T.h takes dl M-contiguous and h N-contiguous. xent_dl_kernel
//   writes dl as (tokens, V) in the operand type, which dh reads
//   K-contiguous and dE reads M-contiguous.
// - Shared memory: 216 KB in f32, 120 KB in bf16; one block of 8 warps an
//   SM (ptxas gives the f32 kernels 248-255 registers a thread).
// - Every output element is summed by one thread in a fixed order: there are
//   no float atomics and no split-K across blocks, so two calls on the same
//   inputs give bitwise-equal outputs. The tensor cores round each mma's sum
//   toward zero, so no f32 chain is longer than 2048 k at the slice's shape:
//   the logits' over d, dE's over a token chunk, and f32 dh's over vocab
//   segments, each row's dominant gold term added last (xent_dh_kernel).
//   * forward: one block per (128-token tile, vocab split) sweeps its vocab
//     tiles in order (the TPU grid's sequential vocab axis becomes this loop).
//     Each thread keeps an online (max, sum, gold) per row it holds in the
//     mma fragment layout (two rows per m16 tile, 8 in all) over its own
//     columns, in registers; at the end the four threads of a quad merge by
//     shuffles and the four warps that split the tile's columns merge in
//     shared memory in warp order, and the block writes the split's partial.
//     The vocab is split across blocks so that a small t still fills the 132
//     SMs (t 512 has only four token tiles); a second launch merges the
//     splits in split order.
//   * backward: the TPU kernel keeps a (2048, d) f32 dh accumulator in VMEM
//     (16 MB at d 2048); a block here has 227 KB of shared memory, so dh
//     (a sum over V) and dE (a sum over tokens) cannot share one block's
//     accumulators. Tokens run in chunks of at most kChunk = 2048 rows; per
//     chunk (1) xent_dl_kernel recomputes the logits tiles and writes dl in
//     the operand type to a (chunk, V) scratch, (2) xent_dh_kernel sums
//     dl.E over V inside each (token, d) output tile, (3) xent_de_kernel sums
//     dl^T.h over the chunk's tokens inside each (vocab, d) output tile and
//     adds it to an f32 (V, d) accumulator, chunks in order; the last chunk
//     writes dE in E's type. Four products of the head's size in all (the
//     floor of any head that keeps the logits out of device memory, as the
//     TPU kernel's note counts them). The scratch is bounded by kChunk, not by
//     t: kChunk x V in the operand type (262 MB at V 32000 in f32), plus the
//     f32 (V, d) accumulator when E is bf16 and t > kChunk (262 MB at d 2048).
//     Grids run the token tiles fastest where a block's other operand is
//     the large one (E in the logits), so that it is read once from device
//     memory while the chunk's tokens stay in the L2 cache.
// What it leaves on the table, for later work: wgmma (mma.sync stops near
// two thirds of the tensor cores' peak) with TMA loads and warp
// specialisation (a producer warp, consumer warpgroups), which would also
// free the registers that now cap the f32 kernels' overlap of fragment loads
// with products; and fusing dl into the dh/dE products, which would spare
// the dl scratch's round trip through device memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stddef.h>
#include <stdint.h>

#include <type_traits>

#include "mma_common.cuh"

namespace {

constexpr int THREADS = 256;   // 8 warps: 2 (rows) x 4 (columns)
constexpr int TM = 128, TN = 256;           // output tile rows, columns
constexpr int BK = 32;         // k step
constexpr int WM = 64, WN = 64;             // a warp's part of the tile
constexpr int MT = WM / 16, NT = WN / 8;    // its m16 and n8 tiles
constexpr int WCOLS = TN / WN;              // warps across the columns
constexpr int kChunk = 2048;   // backward token chunk: bounds the dl scratch
constexpr int kSeg = 2048;     // f32 dh: the vocab range of one mma chain
constexpr float NEG = -1e30f;

constexpr int STAGES = 4;      // the ring of k-steps in shared memory

template <typename T>
struct Mma {
  static constexpr bool F32 = sizeof(T) == 4;
  static constexpr int KSTEP = F32 ? 8 : 16;   // the mma's k
};

// One operand's tile of a k-step in shared memory, W rows or columns wide
// (TM for A, TN for B). K-contiguous (KC): W rows (m or n) of BK k;
// MN-contiguous: BK rows (k) of W m or n. Rows are padded so that every
// fragment load is free of bank conflicts and every row stays 16-byte
// aligned.
template <typename T, bool KC, int W>
struct Op {
  static constexpr int PER = 16 / (int)sizeof(T);   // elements in 16 bytes
  static constexpr int LD = KC ? BK + PER : W + 8;
  static constexpr int ROWS = KC ? W : BK;
  static constexpr int CPR = (KC ? BK : W) / PER;   // chunks a row
  static constexpr int CHUNKS_PER_THREAD = ROWS * CPR / THREADS;
  static constexpr size_t BYTES = sizeof(T) * (size_t)ROWS * LD;
  static_assert(ROWS * CPR % THREADS == 0, "whole chunks a thread");
  static_assert(LD * sizeof(T) % 16 == 0, "16-byte aligned rows");
};

template <typename T, bool AKC, bool BKC>
__host__ __device__ constexpr size_t smem_bytes() {
  return STAGES * (Op<T, AKC, TM>::BYTES + Op<T, BKC, TN>::BYTES);
}

// An operand in device memory: element (mn, k) at p[mn * ld + k] when
// K-contiguous, p[k * ld + mn] when MN-contiguous; (mn, k) outside
// [0, mn_lim) x [0, k_lim) reads zero. vec: p and the row stride are
// 16-byte aligned, so chunks go by cp.async.
template <typename T>
struct Src {
  const T* p;
  int ld, mn_lim, k_lim;
  bool vec;
};

// Start the copies of this thread's chunks of the k-step at (mn0, k0) into
// the tile at s: cp.async (zero-filling past the limits) or, for unaligned
// rows, predicated element loads stored to the same layout. skip (K-contiguous
// only, may be null): per tile row, one column k read as zero; the chunk
// that holds it takes the element loads.
template <typename T, bool KC, int W>
__device__ __forceinline__ void issue(T* s, const Src<T>& a, int mn0, int k0,
                                      const int* skip) {
  using O = Op<T, KC, W>;
  using Raw = std::conditional_t<sizeof(T) == 4, uint32_t, uint16_t>;
  const int row_lim = KC ? a.mn_lim : a.k_lim;
  const int col_lim = KC ? a.k_lim : a.mn_lim;
#pragma unroll
  for (int i = 0; i < O::CHUNKS_PER_THREAD; ++i) {
    const int c = threadIdx.x + i * THREADS;
    const int r = c / O::CPR, e = (c % O::CPR) * O::PER;
    const int row = (KC ? mn0 : k0) + r, col = (KC ? k0 : mn0) + e;
    T* dst = s + r * O::LD + e;
    const T* src = a.p + (size_t)row * a.ld + col;
    const int n = row < row_lim ? min(O::PER, max(0, col_lim - col)) : 0;
    const int z = KC && skip ? skip[r] - col : -1;   // the chunk's zero
    if (a.vec && (z < 0 || z >= O::PER)) {
      cp_async16_zfill(dst, n > 0 ? src : a.p, n * (int)sizeof(T));
    } else {
      const Raw* q = reinterpret_cast<const Raw*>(src);
      auto at = [&](int j) { return j < n && j != z ? uint32_t(q[j]) : 0u; };
      uint32_t w[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        w[j] = sizeof(T) == 4 ? at(j) : at(2 * j) | at(2 * j + 1) << 16;
      *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// The A fragment of the m16 tile at rows m of the tile at s, k-step kk.
// f32 (TF32 m16n8k8): a0..a3 = A(g, t), A(g + 8, t), A(g, t + 4),
// A(g + 8, t + 4); bf16 (m16n8k16): pairs at k = 2t and 2t + 8.
template <typename T, bool KC>
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const T* s, int m,
                                       int kk, int lane) {
  using O = Op<T, KC, TM>;
  const int lr = lane % 8, q = lane / 8;
  if constexpr (KC) {
    // matrices: rows +0 / +8 (q % 2), k +0 / +PER (q / 2)
    ldmatrix_x4(a, s + (m + lr + 8 * (q % 2)) * O::LD + kk + O::PER * (q / 2));
  } else if constexpr (Mma<T>::F32) {
    const int g = lane / 4, t = lane % 4;
    const float* p = s + (kk + t) * O::LD + m + g;
    a[0] = __float_as_uint(p[0]);
    a[1] = __float_as_uint(p[8]);
    a[2] = __float_as_uint(p[4 * O::LD]);
    a[3] = __float_as_uint(p[4 * O::LD + 8]);
  } else {
    // transposed matrices: m +0 / +8 (q % 2), k +0 / +8 (q / 2)
    ldmatrix_x4_trans(a, s + (kk + lr + 8 * (q / 2)) * O::LD + m + 8 * (q % 2));
  }
}

// The B fragments of the n8 tiles at n and n + 8: b[0], b[1] for n, b[2],
// b[3] for n + 8. f32: b0, b1 = B(k = t, n = g), B(t + 4, g); bf16: pairs at
// k = 2t and 2t + 8.
template <typename T, bool KC>
__device__ __forceinline__ void frag_b(uint32_t (&b)[4], const T* s, int n,
                                       int kk, int lane) {
  using O = Op<T, KC, TN>;
  const int lr = lane % 8, q = lane / 8;
  if constexpr (KC) {
    // matrices: k +0 / +PER (q % 2), n +0 / +8 (q / 2)
    ldmatrix_x4(b, s + (n + lr + 8 * (q / 2)) * O::LD + kk + O::PER * (q % 2));
  } else if constexpr (Mma<T>::F32) {
    const int g = lane / 4, t = lane % 4;
    const float* p = s + (kk + t) * O::LD + n + g;
    b[0] = __float_as_uint(p[0]);
    b[1] = __float_as_uint(p[4 * O::LD]);
    b[2] = __float_as_uint(p[8]);
    b[3] = __float_as_uint(p[4 * O::LD + 8]);
  } else {
    // transposed matrices: k +0 / +8 (q % 2), n +0 / +8 (q / 2)
    ldmatrix_x4_trans(b, s + (kk + lr + 8 * (q % 2)) * O::LD + n + 8 * (q / 2));
  }
}

// acc += the warp's 64 x 64 part of the k-step's tile product, sa and sb
// the stage's A and B tiles, B's fragments two n8 tiles at a time. f32: the
// warp splits each fragment it loads into TF32 hi and lo once, for all the
// tiles that use it, and every accumulator takes lo*hi, hi*lo, hi*hi in
// that order.
template <typename T, bool AKC, bool BKC>
__device__ __forceinline__ void compute(float (&acc)[MT][NT][4], const T* sa,
                                        const T* sb, int wm, int wn,
                                        int lane) {
#pragma unroll
  for (int kk = 0; kk < BK; kk += Mma<T>::KSTEP) {
    if constexpr (Mma<T>::F32) {
      uint32_t ah[MT][4], al[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        frag_a<T, AKC>(ah[i], sa, wm * WM + 16 * i, kk, lane);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          split(__uint_as_float(ah[i][e]), ah[i][e], al[i][e]);
      }
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t bh[4], bl[4];
        frag_b<T, BKC>(bh, sb, wn * WN + 8 * j, kk, lane);
#pragma unroll
        for (int e = 0; e < 4; ++e) split(__uint_as_float(bh[e]), bh[e], bl[e]);
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int u = 0; u < 2; ++u)
            mma_tf32(acc[i][j + u], al[i], bh[2 * u], bh[2 * u + 1]);
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int u = 0; u < 2; ++u)
            mma_tf32(acc[i][j + u], ah[i], bl[2 * u], bl[2 * u + 1]);
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int u = 0; u < 2; ++u)
            mma_tf32(acc[i][j + u], ah[i], bh[2 * u], bh[2 * u + 1]);
      }
    } else {
      uint32_t a[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        frag_a<T, AKC>(a[i], sa, wm * WM + 16 * i, kk, lane);
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t b[4];
        frag_b<T, BKC>(b, sb, wn * WN + 8 * j, kk, lane);
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int u = 0; u < 2; ++u)
            mma_bf16(acc[i][j + u], a[i], b[2 * u], b[2 * u + 1]);
      }
    }
  }
}

// The GEMM core. acc = the warp's part of the 128 x 256 tile at (m0, n0) of
// A B^T (sum over kbeg <= k < kend in k-step order, kbeg a multiple of BK;
// A (M, K), B (N, K) as they lie in `a`, `b`; skip_a: per row of the tile,
// one k of A read as zero, or null).
// The k-steps stream through the ring at smem, one barrier a step: step
// kt + STAGES - 1 is in flight while step kt computes. Every thread of the
// block must call it; it may be called again on the same ring.
template <typename T, bool AKC, bool BKC>
__device__ __forceinline__ void gemm(float (&acc)[MT][NT][4],
                                     const Src<T>& a, const Src<T>& b,
                                     int m0, int n0, int kbeg, int kend,
                                     unsigned char* smem,
                                     const int* skip_a = nullptr) {
  using OA = Op<T, AKC, TM>;
  using OB = Op<T, BKC, TN>;
  constexpr size_t STAGE = OA::BYTES + OB::BYTES;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / WCOLS, wn = warp % WCOLS;
  auto sa = [&](int kt) {
    return reinterpret_cast<T*>(smem + (kt % STAGES) * STAGE);
  };
  auto sb = [&](int kt) {
    return reinterpret_cast<T*>(smem + (kt % STAGES) * STAGE + OA::BYTES);
  };
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
  const int nk = (kend - kbeg + BK - 1) / BK;
  __syncthreads();   // every warp is done with the ring's previous use
#pragma unroll
  for (int kt = 0; kt < STAGES - 1; ++kt) {
    if (kt < nk) {
      issue<T, AKC, TM>(sa(kt), a, m0, kbeg + kt * BK, skip_a);
      issue<T, BKC, TN>(sb(kt), b, n0, kbeg + kt * BK, nullptr);
    }
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();   // this thread's copies of step kt
    // step kt is ready for every warp; step kt - 1 is consumed, so its
    // stage takes step kt + STAGES - 1
    __syncthreads();
    const int kn = kt + STAGES - 1;
    if (kn < nk) {
      issue<T, AKC, TM>(sa(kn), a, m0, kbeg + kn * BK, skip_a);
      issue<T, BKC, TN>(sb(kn), b, n0, kbeg + kn * BK, nullptr);
    }
    cp_async_commit();
    compute<T, AKC, BKC>(acc, sa(kt), sb(kt), wm, wn, lane);
  }
}

// The output element of accumulator register e of tile (i, j): row
// m0 + rrow(i, e), column n0 + rcol(j, e).
__device__ __forceinline__ int rrow(int i, int e) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  return (warp / WCOLS) * WM + 16 * i + lane / 4 + 8 * (e >> 1);
}
__device__ __forceinline__ int rcol(int j, int e) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  return (warp % WCOLS) * WN + 8 * j + 2 * (lane % 4) + (e & 1);
}

// Two adjacent elements of a row, [0] at p: each stored if its flag is set,
// as one vector store when both are and `vec` (p aligned to the pair).
template <typename T>
__device__ __forceinline__ void store2(T* p, float x0, float x1, bool in0,
                                       bool in1, bool vec) {
  if (in0 && in1 && vec) {
    if constexpr (sizeof(T) == 4)
      *reinterpret_cast<float2*>(p) = make_float2(x0, x1);
    else
      *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x0, x1);
  } else {
    if (in0) p[0] = from_f<T>(x0);
    if (in1) p[1] = from_f<T>(x1);
  }
}

// ------------------------------------------------------------------ forward

// Grid (token tiles, vocab splits). Split `y` sweeps vocab tiles
// [y * tiles_per_split, (y + 1) * tiles_per_split) and writes its (max, sum,
// gold) per token row to part[0 | 1 | 2][y][row].
template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
    xent_fwd_kernel(Src<T> a, Src<T> b, const int64_t* __restrict__ tgt,
                    float* __restrict__ part, int t, int V, int d,
                    int tiles_per_split) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int m0 = blockIdx.x * TM, split = blockIdx.y;
  const int nvt = (V + TN - 1) / TN;
  const int vt0 = split * tiles_per_split;
  const int vt1 = min(nvt, vt0 + tiles_per_split);

  // this thread's rows: two an m16 tile (e = 0 and 2 of its registers)
  int gold[MT][2];
  float st_m[MT][2], st_s[MT][2], st_g[MT][2];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = m0 + rrow(i, 2 * r);
      const int64_t g = row < t ? tgt[row] : -1;
      gold[i][r] = (g >= 0 && g < V) ? (int)g : -1;
      st_m[i][r] = NEG, st_s[i][r] = 0.f, st_g[i][r] = 0.f;
    }

  float acc[MT][NT][4];
  for (int vt = vt0; vt < vt1; ++vt) {
    const int n0 = vt * TN;
    gemm<T, true, true>(acc, a, b, m0, n0, 0, d, smem);
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = NEG;
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (n0 + rcol(j, e) < V) mx = fmaxf(mx, acc[i][j][2 * r + e]);
        const float m_old = st_m[i][r], m_new = fmaxf(m_old, mx);
        float sum = 0.f, g = 0.f;
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = n0 + rcol(j, e);
            const float x = acc[i][j][2 * r + e];
            if (col < V) sum += expf(x - m_new);
            if (col == gold[i][r]) g += x;
          }
        st_s[i][r] = st_s[i][r] * expf(m_old - m_new) + sum;
        st_m[i][r] = m_new;
        st_g[i][r] += g;
      }
  }

  // the quad's four threads hold a row's columns: merge them (every lane
  // ends with the same sums, the merge being symmetric)
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int x = 1; x < 4; x <<= 1) {
        const float m2 = __shfl_xor_sync(0xffffffffu, st_m[i][r], x);
        const float s2 = __shfl_xor_sync(0xffffffffu, st_s[i][r], x);
        const float g2 = __shfl_xor_sync(0xffffffffu, st_g[i][r], x);
        const float m = fmaxf(st_m[i][r], m2);
        st_s[i][r] = st_s[i][r] * expf(st_m[i][r] - m) + s2 * expf(m2 - m);
        st_m[i][r] = m;
        st_g[i][r] += g2;
      }
  // then the four warps that split the tile's columns, in warp order
  static_assert(3 * WCOLS * TM * sizeof(float) <=
                    smem_bytes<T, true, true>(),
                "the merge fits in the ring");
  float* red = reinterpret_cast<float*>(smem);   // [3][WCOLS][TM]
  __syncthreads();   // the ring's last readers are done
  const int wn = (threadIdx.x / 32) % WCOLS;
  if (threadIdx.x % 4 == 0) {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int at = wn * TM + rrow(i, 2 * r);
        red[at] = st_m[i][r];
        red[WCOLS * TM + at] = st_s[i][r];
        red[2 * WCOLS * TM + at] = st_g[i][r];
      }
  }
  __syncthreads();
  if (threadIdx.x < TM) {
    const int r = threadIdx.x, row = m0 + r;
    float m = NEG;
    for (int w = 0; w < WCOLS; ++w) m = fmaxf(m, red[w * TM + r]);
    float s = 0.f, g = 0.f;
    for (int w = 0; w < WCOLS; ++w) {
      s += red[WCOLS * TM + w * TM + r] * expf(red[w * TM + r] - m);
      g += red[2 * WCOLS * TM + w * TM + r];
    }
    if (row < t) {
      const size_t plane = (size_t)gridDim.y * t;
      const size_t at = (size_t)split * t + row;
      part[at] = m;
      part[plane + at] = s;
      part[2 * plane + at] = g;
    }
  }
}

// One thread per token: merge the splits' partials in split order.
__global__ void xent_fwd_merge_kernel(const float* __restrict__ part,
                                      float* __restrict__ loss,
                                      float* __restrict__ lse, int t,
                                      int nsplit) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= t) return;
  const size_t plane = (size_t)nsplit * t;
  float m = NEG;
  for (int sp = 0; sp < nsplit; ++sp) m = fmaxf(m, part[(size_t)sp * t + row]);
  float s = 0.f, g = 0.f;
  for (int sp = 0; sp < nsplit; ++sp) {
    const size_t at = (size_t)sp * t + row;
    s += part[plane + at] * expf(part[at] - m);
    g += part[2 * plane + at];
  }
  const float l = m + logf(s);
  lse[row] = l;
  loss[row] = l - g;
}

// ----------------------------------------------------------------- backward

// Grid (token tiles of the chunk, vocab tiles): recompute the logits tile
// from h (a) and E (b) and write dl = (softmax - onehot) * ct in the operand
// type to dl (rows, V); vec: dl's element pairs are aligned (V even).
template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
    xent_dl_kernel(Src<T> a, Src<T> b, const int64_t* __restrict__ tgt,
                   const float* __restrict__ lse, const float* __restrict__ ct,
                   T* __restrict__ dl, int rows, int V, int d, bool vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int m0 = blockIdx.x * TM, n0 = blockIdx.y * TN;
  float acc[MT][NT][4];
  gemm<T, true, true>(acc, a, b, m0, n0, 0, d, smem);
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = m0 + rrow(i, 2 * r);
      if (row >= rows) continue;
      const float l = lse[row], c = ct[row];
      const int64_t gold = tgt[row];
      T* out = dl + (size_t)row * V;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int col = n0 + rcol(j, 0);
        float x[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = expf(acc[i][j][2 * r + e] - l);
          x[e] = (p - (col + e == gold ? 1.f : 0.f)) * c;
        }
        store2<T>(out + col, x[0], x[1], col < V, col + 1 < V, vec);
      }
    }
}

// Grid (d tiles, token tiles of the chunk): dh (rows, d) = dl (rows, V;
// a, K-contiguous) . E (V, d; b, d-contiguous), the sum over V in vocab
// order inside the block. The tensor cores round each mma's sum toward
// zero, so a long chain drifts toward zero: over all of V (V / 8 x 3 mma)
// after a row's gold term dl[row, target] . E[target], ~V times every
// other term, dh drifted by 1.1e-4 of its largest element at a full-width
// training step's data, and the rest of the sum by ~1e-3 of itself, which
// moved the final norm's gradient by 1.2e-4 (PERF.md, PR 7;
// tests/test_torch_fused_xent.py models it). So f32 sums V in segments of
// kSeg, each its own mma chain, added to dh (f32, the running sum) in
// segment order, and the gold term is left out of the chains and added
// last in f32: 8.3e-7 of the largest element from float64 there, where
// cuBLAS's f32 product is 6.1e-6. bf16 (whose dl keeps 8 bits) sums V in
// one chain. vec: dh's element pairs are aligned (d even).
template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
    xent_dh_kernel(Src<T> a, Src<T> b, const int64_t* __restrict__ tgt,
                   T* __restrict__ dh, int rows, int V, int d, bool vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int gold[TM];
  const int n0 = blockIdx.x * TN, m0 = blockIdx.y * TM;
  if (threadIdx.x < TM) {
    const int row = m0 + threadIdx.x;
    const int64_t g = row < rows ? tgt[row] : -1;
    gold[threadIdx.x] = (g >= 0 && g < V) ? (int)g : -1;
  }
  // (the core's first barrier publishes gold before any copy reads it)
  const int seg = Mma<T>::F32 ? kSeg : V;
  float acc[MT][NT][4];
  for (int k0 = 0; k0 < V; k0 += seg) {
    const int k1 = min(V, k0 + seg);
    gemm<T, true, false>(acc, a, b, m0, n0, k0, k1, smem, gold);
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = m0 + rrow(i, 2 * r);
        if (row >= rows) continue;
        T* out = dh + (size_t)row * d;
        // the running sum (f32 only): the row's loads first, all in flight
        // together, then the adds
        float prev[NT][2] = {};
        if (k0 > 0) {
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int col = n0 + rcol(j, e);
              if (col < d) prev[j][e] = to_f(out[col]);
            }
        }
        const int gv = k1 == V ? gold[rrow(i, 2 * r)] : -1;
        const float g = gv >= 0 ? to_f(a.p[(size_t)row * V + gv]) : 0.f;
        const T* eg = b.p + (size_t)(gv >= 0 ? gv : 0) * d;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int col = n0 + rcol(j, 0);
          float x[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            x[e] = acc[i][j][2 * r + e] + prev[j][e];
            if (gv >= 0 && col + e < d)
              x[e] = fmaf(g, to_f(eg[col + e]), x[e]);
          }
          store2<T>(out + col, x[0], x[1], col < d, col + 1 < d, vec);
        }
      }
  }
}

// Grid (d tiles, vocab tiles): out (V, d) = acc_in + dl^T . h over the
// chunk's rows (dl (rows, V; a, V-contiguous), h (rows, d; b,
// d-contiguous)), in token order inside the block; acc_in may be null (the
// first chunk) and may alias out (an f32 accumulator updated in place: each
// element is read and written by the same thread). vec: out's and acc_in's
// element pairs are aligned (d even).
template <typename T, typename OutT>
__global__ void __launch_bounds__(THREADS, 1)
    xent_de_kernel(Src<T> a, Src<T> b, const float* acc_in, OutT* out,
                   int rows, int V, int d, bool vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n0 = blockIdx.x * TN, m0 = blockIdx.y * TM;
  float acc[MT][NT][4];
  gemm<T, false, false>(acc, a, b, m0, n0, 0, rows, smem);
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int v = m0 + rrow(i, 2 * r);
      if (v >= V) continue;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int col = n0 + rcol(j, 0);
        const size_t at = (size_t)v * d + col;
        const bool in0 = col < d, in1 = col + 1 < d;
        float x0 = acc[i][j][2 * r], x1 = acc[i][j][2 * r + 1];
        if (acc_in) {
          if (in0) x0 += acc_in[at];
          if (in1) x1 += acc_in[at + 1];
        }
        store2<OutT>(out + at, x0, x1, in0, in1, vec);
      }
    }
}

int cdiv(int a, int b) { return (a + b - 1) / b; }

int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess || n <= 0)
    n = 132;
  return n;
}

// Vocab tiles per split: enough splits that the forward grid holds about two
// blocks per SM, never an empty split.
int tiles_per_split(int t, int V) {
  const int ntt = cdiv(t, TM), nvt = cdiv(V, TN);
  int want = (2 * sm_count() + ntt / 2) / ntt;
  want = want < 1 ? 1 : (want > nvt ? nvt : want);
  return cdiv(nvt, want);
}

// An operand whose rows are `ld` elements: 16-byte copies when p and the row
// stride are 16-byte aligned.
template <typename T>
Src<T> src(const T* p, int ld, int mn_lim, int k_lim) {
  const bool vec = reinterpret_cast<uintptr_t>(p) % 16 == 0 &&
                   (size_t)ld * sizeof(T) % 16 == 0;
  return Src<T>{p, ld, mn_lim, k_lim, vec};
}

// Allow the kernel its dynamic shared memory, then launch it.
template <typename K, typename... Args>
cudaError_t launch(K kernel, size_t smem, dim3 grid, cudaStream_t stream,
                   Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, THREADS, smem, stream>>>(args...);
  return cudaGetLastError();
}

template <typename T>
cudaError_t fwd(const void* h_, const void* emb_, const int64_t* tgt,
                float* part, float* loss, float* lse, int t, int V, int d,
                cudaStream_t stream) {
  const T* h = static_cast<const T*>(h_);
  const T* emb = static_cast<const T*>(emb_);
  const int tps = tiles_per_split(t, V);
  const int nsplit = cdiv(cdiv(V, TN), tps);
  cudaError_t err = launch(xent_fwd_kernel<T>, smem_bytes<T, true, true>(),
                           dim3(cdiv(t, TM), nsplit), stream,
                           src(h, d, t, d), src(emb, d, V, d), tgt, part, t,
                           V, d, tps);
  if (err != cudaSuccess) return err;
  xent_fwd_merge_kernel<<<cdiv(t, 256), 256, 0, stream>>>(part, loss, lse, t,
                                                          nsplit);
  return cudaGetLastError();
}

template <typename T>
cudaError_t bwd(const void* h_, const void* emb_, const int64_t* tgt,
                const float* lse, const float* ct, void* dl_, void* dh_,
                float* de_acc, void* de_, int t, int V, int d,
                cudaStream_t stream) {
  const T* h = static_cast<const T*>(h_);
  const T* emb = static_cast<const T*>(emb_);
  T* dl = static_cast<T*>(dl_);
  T* dh = static_cast<T*>(dh_);
  T* de = static_cast<T*>(de_);
  // pairs of dl, dh and dE elements are aligned when the row length is even
  // (the buffers themselves come 16-byte aligned from the allocator)
  const bool dl_vec = V % 2 == 0, d_vec = d % 2 == 0;
  for (int start = 0; start < t; start += kChunk) {
    const int rows = t - start < kChunk ? t - start : kChunk;
    const bool first = start == 0, last = start + rows >= t;
    const size_t off = (size_t)start * d;
    cudaError_t err = launch(
        xent_dl_kernel<T>, smem_bytes<T, true, true>(),
        dim3(cdiv(rows, TM), cdiv(V, TN)), stream, src(h + off, d, rows, d),
        src(emb, d, V, d), tgt + start, lse + start, ct + start, dl, rows, V,
        d, dl_vec);
    if (err != cudaSuccess) return err;
    err = launch(xent_dh_kernel<T>, smem_bytes<T, true, false>(),
                 dim3(cdiv(d, TN), cdiv(rows, TM)), stream,
                 src<T>(dl, V, rows, V), src(emb, d, d, V), tgt + start,
                 dh + off, rows, V, d, d_vec);
    if (err != cudaSuccess) return err;
    const dim3 grid(cdiv(d, TN), cdiv(V, TM));
    const float* prev = first ? nullptr : de_acc;
    const Src<T> sa = src<T>(dl, V, V, rows), sb = src(h + off, d, d, rows);
    err = last ? launch(xent_de_kernel<T, T>, smem_bytes<T, false, false>(),
                        grid, stream, sa, sb, prev, de, rows, V, d, d_vec)
               : launch(xent_de_kernel<T, float>,
                        smem_bytes<T, false, false>(), grid, stream, sa, sb,
                        prev, de_acc, rows, V, d, d_vec);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" const char* tpudist_fused_xent_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Floats of the forward's split partials: 3 x nsplit x t.
extern "C" long long tpudist_fused_xent_fwd_workspace(int t, int V) {
  const int nsplit = cdiv(cdiv(V, TN), tiles_per_split(t, V));
  return 3LL * nsplit * t;
}

// Token rows of the backward's dl scratch: min(t, kChunk).
extern "C" int tpudist_fused_xent_bwd_chunk(int t) {
  return t < kChunk ? t : kChunk;
}

// dtype 0 = f32, 1 = bf16 (h and emb). part: the forward workspace; loss and
// lse (t,) f32.
extern "C" int tpudist_fused_xent_fwd(int dtype, const void* h,
                                      const void* emb, const int64_t* tgt,
                                      float* part, float* loss, float* lse,
                                      int t, int V, int d, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      dtype == 0 ? fwd<float>(h, emb, tgt, part, loss, lse, t, V, d, s)
                 : fwd<__nv_bfloat16>(h, emb, tgt, part, loss, lse, t, V, d,
                                      s);
  return static_cast<int>(err);
}

// dl: (min(t, kChunk), V) scratch in the operand type; dh like h; de like
// emb. de_acc: an f32 (V, d) accumulator for every chunk but the last (for
// f32 pass de itself; unused when t <= kChunk).
extern "C" int tpudist_fused_xent_bwd(int dtype, const void* h,
                                      const void* emb, const int64_t* tgt,
                                      const float* lse, const float* ct,
                                      void* dl, void* dh, float* de_acc,
                                      void* de, int t, int V, int d,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      dtype == 0
          ? bwd<float>(h, emb, tgt, lse, ct, dl, dh, de_acc, de, t, V, d, s)
          : bwd<__nv_bfloat16>(h, emb, tgt, lse, ct, dl, dh, de_acc, de, t, V,
                               d, s);
  return static_cast<int>(err);
}
