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
//
// Bound on this card at the training slice's shape (t 16384 = b8 x s2048,
// d 2048, V 32000, f32): one product of the head's size is 2 t V d =
// 2.15 TFLOP. The forward does one (32.0 ms at the H100's 67 TFLOP/s f32 peak
// outside the tensor cores, SXM data sheet), the backward three (the logits
// recompute, dh and dE: 96.2 ms). The bytes every call must move (h and E
// read, loss/lse or dh/dE written) are ~0.4 GB, ~0.12 ms at 3.35 TB/s: both
// are bound by operations, and every product here is f32 FMA on the CUDA
// cores (no TF32: the tolerances against the plain version are tighter).
//
// Design, kept simple on purpose. One GEMM core (`mainloop`): 256 threads, a
// 128 x 128 output tile, each thread an 8 x 8 register tile (rows and columns
// ty*4 + {0..3} and 64 + ty*4 + {0..3}, the same with tx), k steps of 8
// through two shared-memory buffers, the next step's loads in flight while
// the current one is multiplied. Every output is one f32 FMA chain in k order,
// so the kernels are deterministic: there are no float atomics, and two calls
// on the same inputs give bitwise-equal outputs.
//   * forward: one block per (128-token tile, vocab split) sweeps its vocab
//     tiles in order (the TPU grid's sequential vocab axis becomes this loop).
//     Each thread keeps an online (max, sum, gold) state per row over the
//     columns it owns, in shared memory; the block merges its 16 column lanes
//     in lane order and writes the split's partial. The vocab is split across
//     blocks so that a small t still fills the 132 SMs (t 512 has only four
//     token tiles); a second launch merges the splits in split order.
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
// What it leaves on the table, for later work: the tensor cores (wgmma) for
// bf16, TMA or cp.async pipelines, and fusing dl into the dh/dE products.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;  // 16 row groups x 16 column lanes
constexpr int TILE = 128;     // output tile rows = columns
constexpr int KS = 8;         // k step
constexpr int LDS = TILE + 4; // row stride of a k-major shared tile
constexpr int LANES = 16;
constexpr int kChunk = 2048;  // backward token chunk: bounds the dl scratch
constexpr float NEG = -1e30f;

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
  return __float2bfloat16(x);  // round to nearest even, as torch's .to()
}

// Row (or column) of the 128-wide tile that a thread's i-th register holds.
__device__ __forceinline__ int own(int lane, int i) {
  return (i < 4 ? 0 : 64) + lane * 4 + (i & 3);
}

// One TILE x KS operand tile, loaded to registers and stored to shared memory
// k-major (s[k * LDS + mn]). KMAJOR = false: the operand is (MN rows, K
// columns) with K contiguous, and each thread reads 4 consecutive k of one
// row (the store transposes). KMAJOR = true: the operand is (K rows, MN
// columns) with MN contiguous, and each thread reads 4 consecutive mn of one
// k row. Elements at mn >= mn_lim or k >= k_lim are not read: they are zero.
template <typename T, bool KMAJOR>
struct Tile {
  const T* p;
  int ld, mn_lim, k_lim;
  float v[4];

  __device__ __forceinline__ void load(int mn0, int k0) {
    const int tid = threadIdx.x;
    if (!KMAJOR) {
      const int mn = mn0 + (tid >> 1), k = k0 + (tid & 1) * 4;
      const T* q = p + (size_t)mn * ld + k;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[j] = (mn < mn_lim && k + j < k_lim) ? to_f(q[j]) : 0.f;
    } else {
      const int k = k0 + (tid >> 5), mn = mn0 + (tid & 31) * 4;
      const T* q = p + (size_t)k * ld + mn;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[j] = (k < k_lim && mn + j < mn_lim) ? to_f(q[j]) : 0.f;
    }
  }

  __device__ __forceinline__ void store(float* s) const {
    const int tid = threadIdx.x;
    if (!KMAJOR) {
      const int mn = tid >> 1, k = (tid & 1) * 4;
#pragma unroll
      for (int j = 0; j < 4; ++j) s[(k + j) * LDS + mn] = v[j];
    } else {
      const int k = tid >> 5, mn = (tid & 31) * 4;
      *reinterpret_cast<float4*>(&s[k * LDS + mn]) =
          make_float4(v[0], v[1], v[2], v[3]);
    }
  }
};

struct Smem {
  __align__(16) float a[2][KS * LDS];
  __align__(16) float b[2][KS * LDS];
};

// acc[i][j] = sum over k < K, in k order, of A(m0 + own(ty, i), k) *
// B(n0 + own(tx, j), k). Every thread of the block must call it.
template <class TA, class TB>
__device__ __forceinline__ void mainloop(TA& a, TB& b, int m0, int n0, int K,
                                         Smem& sm, float (&acc)[8][8]) {
  const int ty = threadIdx.x / LANES, tx = threadIdx.x % LANES;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  const int nk = (K + KS - 1) / KS;
  a.load(m0, 0);
  b.load(n0, 0);
  a.store(sm.a[0]);
  b.store(sm.b[0]);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    const bool more = kt + 1 < nk;
    if (more) {
      a.load(m0, (kt + 1) * KS);
      b.load(n0, (kt + 1) * KS);
    }
    const float* sa = sm.a[cur];
    const float* sb = sm.b[cur];
#pragma unroll
    for (int k = 0; k < KS; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&sa[k * LDS + ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&sa[k * LDS + 64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&sb[k * LDS + tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&sb[k * LDS + 64 + tx * 4]);
      const float ar[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float br[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
    if (more) {
      a.store(sm.a[cur ^ 1]);
      b.store(sm.b[cur ^ 1]);
    }
    __syncthreads();
  }
}

// ------------------------------------------------------------------ forward

// Grid (token tiles, vocab splits). Split `y` sweeps vocab tiles
// [y * tiles_per_split, (y + 1) * tiles_per_split) and writes its (max, sum,
// gold) per token row to part[0 | 1 | 2][y][row].
template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
    xent_fwd_kernel(const T* __restrict__ h, const T* __restrict__ emb,
                    const int64_t* __restrict__ tgt, float* __restrict__ part,
                    int t, int V, int d, int tiles_per_split) {
  __shared__ Smem sm;
  // each thread's online state for its 8 rows over its own columns; the row
  // stride of 20 puts the two row groups of a warp (4 rows apart) on
  // disjoint banks
  __shared__ float st_m[TILE][LANES + 4], st_s[TILE][LANES + 4],
      st_g[TILE][LANES + 4];
  __shared__ int st_t[TILE];
  const int ty = threadIdx.x / LANES, tx = threadIdx.x % LANES;
  const int m0 = blockIdx.x * TILE, split = blockIdx.y;
  const int nvt = (V + TILE - 1) / TILE;
  const int vt0 = split * tiles_per_split;
  const int vt1 = min(nvt, vt0 + tiles_per_split);

  if (threadIdx.x < TILE) {
    const int row = m0 + threadIdx.x;
    const int64_t g = row < t ? tgt[row] : -1;
    st_t[threadIdx.x] = (g >= 0 && g < V) ? (int)g : -1;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    st_m[own(ty, i)][tx] = NEG;
    st_s[own(ty, i)][tx] = 0.f;
    st_g[own(ty, i)][tx] = 0.f;
  }
  __syncthreads();

  Tile<T, false> a{h, d, t, d};
  Tile<T, false> b{emb, d, V, d};
  float acc[8][8];
  for (int vt = vt0; vt < vt1; ++vt) {
    const int n0 = vt * TILE;
    mainloop(a, b, m0, n0, d, sm, acc);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = own(ty, i);
      const int gold = st_t[r];
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (n0 + own(tx, j) < V) mx = fmaxf(mx, acc[i][j]);
      const float m_old = st_m[r][tx];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f, g = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = n0 + own(tx, j);
        if (col < V) {
          sum += expf(acc[i][j] - m_new);
          if (col == gold) g += acc[i][j];
        }
      }
      st_s[r][tx] = st_s[r][tx] * expf(m_old - m_new) + sum;
      st_m[r][tx] = m_new;
      st_g[r][tx] += g;
    }
  }
  __syncthreads();

  if (threadIdx.x < TILE) {
    const int r = threadIdx.x, row = m0 + r;
    float m = NEG;
    for (int l = 0; l < LANES; ++l) m = fmaxf(m, st_m[r][l]);
    float s = 0.f, g = 0.f;
    for (int l = 0; l < LANES; ++l) {
      s += st_s[r][l] * expf(st_m[r][l] - m);
      g += st_g[r][l];
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

// Grid (vocab tiles, token tiles of the chunk): recompute the logits tile and
// write dl = (softmax - onehot) * ct in the operand type to dl (rows, V).
template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
    xent_dl_kernel(const T* __restrict__ h, const T* __restrict__ emb,
                   const int64_t* __restrict__ tgt,
                   const float* __restrict__ lse, const float* __restrict__ ct,
                   T* __restrict__ dl, int rows, int V, int d) {
  __shared__ Smem sm;
  const int ty = threadIdx.x / LANES, tx = threadIdx.x % LANES;
  const int n0 = blockIdx.x * TILE, m0 = blockIdx.y * TILE;
  Tile<T, false> a{h, d, rows, d};
  Tile<T, false> b{emb, d, V, d};
  float acc[8][8];
  mainloop(a, b, m0, n0, d, sm, acc);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + own(ty, i);
    if (row >= rows) continue;
    const float l = lse[row], c = ct[row];
    const int64_t gold = tgt[row];
    T* out = dl + (size_t)row * V;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + own(tx, j);
      if (col < V) {
        const float p = expf(acc[i][j] - l);
        out[col] = from_f<T>((p - (col == gold ? 1.f : 0.f)) * c);
      }
    }
  }
}

// Grid (d tiles, token tiles of the chunk): dh (rows, d) = dl (rows, V) . E
// (V, d), the sum over V in vocab order inside the block.
template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
    xent_dh_kernel(const T* __restrict__ dl, const T* __restrict__ emb,
                   T* __restrict__ dh, int rows, int V, int d) {
  __shared__ Smem sm;
  const int ty = threadIdx.x / LANES, tx = threadIdx.x % LANES;
  const int n0 = blockIdx.x * TILE, m0 = blockIdx.y * TILE;
  Tile<T, false> a{dl, V, rows, V};
  Tile<T, true> b{emb, d, d, V};
  float acc[8][8];
  mainloop(a, b, m0, n0, V, sm, acc);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + own(ty, i);
    if (row >= rows) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + own(tx, j);
      if (col < d) dh[(size_t)row * d + col] = from_f<T>(acc[i][j]);
    }
  }
}

// Grid (d tiles, vocab tiles): out (V, d) = acc_in + dl^T . h over the
// chunk's rows, in token order inside the block; acc_in may be null (the
// first chunk) and may alias out (an f32 accumulator updated in place: each
// element is read and written by the same thread).
template <typename T, typename OutT>
__global__ void __launch_bounds__(THREADS, 2)
    xent_de_kernel(const T* __restrict__ dl, const T* __restrict__ h,
                   const float* acc_in, OutT* out, int rows, int V, int d) {
  __shared__ Smem sm;
  const int ty = threadIdx.x / LANES, tx = threadIdx.x % LANES;
  const int n0 = blockIdx.x * TILE, m0 = blockIdx.y * TILE;
  Tile<T, true> a{dl, V, V, rows};
  Tile<T, true> b{h, d, d, rows};
  float acc[8][8];
  mainloop(a, b, m0, n0, rows, sm, acc);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int v = m0 + own(ty, i);
    if (v >= V) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + own(tx, j);
      if (col < d) {
        const size_t at = (size_t)v * d + col;
        const float prev = acc_in ? acc_in[at] : 0.f;
        out[at] = from_f<OutT>(prev + acc[i][j]);
      }
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
// blocks per SM (the kernel's occupancy), never an empty split.
int tiles_per_split(int t, int V) {
  const int ntt = cdiv(t, TILE), nvt = cdiv(V, TILE);
  int want = (2 * sm_count() + ntt / 2) / ntt;
  want = want < 1 ? 1 : (want > nvt ? nvt : want);
  return cdiv(nvt, want);
}

template <typename T>
cudaError_t fwd(const void* h, const void* emb, const int64_t* tgt,
                float* part, float* loss, float* lse, int t, int V, int d,
                cudaStream_t stream) {
  const int tps = tiles_per_split(t, V);
  const int nsplit = cdiv(cdiv(V, TILE), tps);
  xent_fwd_kernel<T><<<dim3(cdiv(t, TILE), nsplit), THREADS, 0, stream>>>(
      static_cast<const T*>(h), static_cast<const T*>(emb), tgt, part, t, V,
      d, tps);
  cudaError_t err = cudaGetLastError();
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
  for (int start = 0; start < t; start += kChunk) {
    const int rows = t - start < kChunk ? t - start : kChunk;
    const bool first = start == 0, last = start + rows >= t;
    const size_t off = (size_t)start * d;
    xent_dl_kernel<T><<<dim3(cdiv(V, TILE), cdiv(rows, TILE)), THREADS, 0,
                        stream>>>(h + off, emb, tgt + start, lse + start,
                                  ct + start, dl, rows, V, d);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    xent_dh_kernel<T><<<dim3(cdiv(d, TILE), cdiv(rows, TILE)), THREADS, 0,
                        stream>>>(dl, emb, dh + off, rows, V, d);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const dim3 grid(cdiv(d, TILE), cdiv(V, TILE));
    const float* prev = first ? nullptr : de_acc;
    if (last)
      xent_de_kernel<T, T><<<grid, THREADS, 0, stream>>>(dl, h + off, prev,
                                                         de, rows, V, d);
    else
      xent_de_kernel<T, float><<<grid, THREADS, 0, stream>>>(
          dl, h + off, prev, de_acc, rows, V, d);
    err = cudaGetLastError();
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
  const int nsplit = cdiv(cdiv(V, TILE), tiles_per_split(t, V));
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
