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
// 4 * h * hd * s(s+1)/2 = 1.07 GFLOP, and q, k, v and o are 16.8 MB read and
// written. This kernel does its arithmetic as f32 FMA on the CUDA cores, so
// the operation bound divides by the H100's f32 peak outside the tensor cores
// (67 TFLOP/s, SXM data sheet): 16 us, against 5.0 us for the bytes at
// 3.35 TB/s. It is bound by operations.
//
// Design, kept simple on purpose: one block of 256 threads per (b*h,
// 64-row q tile); the q tile and one 64-row k/v tile live in dynamic shared
// memory as f32 (213 KB at hd 256, so the block asks for more than the
// default 48 KB); a loop over kv tiles up to the diagonal. Each thread owns
// 4 rows x 4 score columns and 4 rows x hd/16 accumulator columns; row
// statistics are reduced across the 16 lanes of a row group with warp
// shuffles. What it leaves on the table: the tensor cores (wgmma would move
// the bf16 bound to 989 TFLOP/s and TF32 is refused here for f32 accuracy),
// TMA or cp.async double buffering of the k/v tiles (loads and math do not
// overlap), and occupancy (one block per SM at these shared-memory sizes).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stddef.h>

namespace {

constexpr int BLOCK_M = 64;   // q rows per block
constexpr int BLOCK_N = 64;   // kv rows per tile
constexpr int THREADS = 256;  // 16 row groups x 16 column lanes
constexpr int RPT = BLOCK_M / 16;   // rows per thread
constexpr int CPT = BLOCK_N / 16;   // score columns per thread
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
  return __float2bfloat16(x);
}

// x rounded to T's precision, kept as f32.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

template <int HD>
constexpr size_t smem_bytes() {
  // q and k rows are read down a column by 16 lanes at once: a row stride
  // of HD + 1 floats puts those lanes in 16 different banks
  return sizeof(float) * (size_t)(BLOCK_M * (HD + 1) + BLOCK_N * (HD + 1) +
                                  BLOCK_N * HD + BLOCK_M * (BLOCK_N + 1));
}

// Rows [row0, row0 + 64) of head `head` of a (b, seq, nheads, HD) tensor into
// shared memory (row stride ld) as f32, RoPE-rotated at their absolute
// positions when `rope`.
template <typename T, int HD>
__device__ void load_tile(float* dst, int ld, const T* __restrict__ src,
                          int batch, int seq, int nheads, int head, int row0,
                          const float* __restrict__ cos,
                          const float* __restrict__ sin, bool rope) {
  constexpr int H2 = HD / 2;
  for (int idx = threadIdx.x; idx < 64 * HD; idx += THREADS) {
    const int r = idx / HD, d = idx % HD;
    const int pos = row0 + r;
    const T* row = src + (((size_t)batch * seq + pos) * nheads + head) * HD;
    float x;
    if (rope) {
      const int i = d < H2 ? d : d - H2;
      const float c = round_to<T>(cos[(size_t)pos * H2 + i]);
      const float s = round_to<T>(sin[(size_t)pos * H2 + i]);
      const float x1 = to_f(row[i]), x2 = to_f(row[i + H2]);
      x = round_to<T>(d < H2 ? x1 * c - x2 * s : x2 * c + x1 * s);
    } else {
      x = to_f(row[d]);
    }
    dst[r * ld + d] = x;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ cos,
                     const float* __restrict__ sin, T* __restrict__ o,
                     float* __restrict__ lse, int s, int sk, int h, int kv,
                     float scale, int causal, int rope) {
  constexpr int LDQ = HD + 1;
  constexpr int LDV = HD;
  constexpr int LDP = BLOCK_N + 1;
  constexpr int DPT = HD / 16;   // accumulator columns per thread

  extern __shared__ float smem[];
  float* sq = smem;
  float* skt = sq + BLOCK_M * LDQ;
  float* sv = skt + BLOCK_N * LDQ;
  float* sp = sv + BLOCK_N * LDV;

  const int bh = blockIdx.y;
  const int b = bh / h, head = bh % h;
  const int kvh = head / (h / kv);
  const int row0 = blockIdx.x * BLOCK_M;
  const int rg = threadIdx.x / 16;   // owns rows rg*RPT .. rg*RPT+RPT-1
  const int cg = threadIdx.x % 16;   // owns columns cg + 16*c

  load_tile<T, HD>(sq, LDQ, q, b, s, h, head, row0, cos, sin, rope);

  float m[RPT], l[RPT], acc[RPT][DPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    m[r] = NEG;
    l[r] = 0.f;
#pragma unroll
    for (int dd = 0; dd < DPT; ++dd) acc[r][dd] = 0.f;
  }

  // under the causal mask, q tile i needs kv tiles 0..i (the diagonal's)
  const int n_tiles =
      causal ? (row0 + BLOCK_M - 1) / BLOCK_N + 1 : sk / BLOCK_N;
  for (int j = 0; j < n_tiles; ++j) {
    const int col0 = j * BLOCK_N;
    __syncthreads();   // the previous tile's k/v/p are consumed
    load_tile<T, HD>(skt, LDQ, k, b, sk, kv, kvh, col0, cos, sin, rope);
    load_tile<T, HD>(sv, LDV, v, b, sk, kv, kvh, col0, cos, sin, false);
    __syncthreads();

    float sc[RPT][CPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r)
#pragma unroll
      for (int c = 0; c < CPT; ++c) sc[r][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qa[RPT], kb[CPT];
#pragma unroll
      for (int r = 0; r < RPT; ++r) qa[r] = sq[(rg * RPT + r) * LDQ + d];
#pragma unroll
      for (int c = 0; c < CPT; ++c) kb[c] = skt[(cg + 16 * c) * LDQ + d];
#pragma unroll
      for (int r = 0; r < RPT; ++r)
#pragma unroll
        for (int c = 0; c < CPT; ++c) sc[r][c] = fmaf(qa[r], kb[c], sc[r][c]);
    }

#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int row = row0 + rg * RPT + r;
      float mx = NEG;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        float x = sc[r][c] * scale;
        if (causal && col0 + cg + 16 * c > row) x = NEG;
        sc[r][c] = x;
        mx = fmaxf(mx, x);
      }
      // the row's 64 scores sit in the 16 lanes of this row group
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[r], mx);
      const float alpha = expf(m[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float p = expf(sc[r][c] - m_new);   // masked cells -> 0
        sum += p;
        sp[(rg * RPT + r) * LDP + cg + 16 * c] = round_to<T>(p);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[r] = l[r] * alpha + sum;
      m[r] = m_new;
#pragma unroll
      for (int dd = 0; dd < DPT; ++dd) acc[r][dd] *= alpha;
    }
    __syncthreads();   // the whole p tile is written

#pragma unroll 4
    for (int jj = 0; jj < BLOCK_N; ++jj) {
      float pa[RPT], vb[DPT];
#pragma unroll
      for (int r = 0; r < RPT; ++r) pa[r] = sp[(rg * RPT + r) * LDP + jj];
#pragma unroll
      for (int dd = 0; dd < DPT; ++dd) vb[dd] = sv[jj * LDV + cg + 16 * dd];
#pragma unroll
      for (int r = 0; r < RPT; ++r)
#pragma unroll
        for (int dd = 0; dd < DPT; ++dd)
          acc[r][dd] = fmaf(pa[r], vb[dd], acc[r][dd]);
    }
  }

#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int row = row0 + rg * RPT + r;
    T* orow = o + (((size_t)b * s + row) * h + head) * HD;
#pragma unroll
    for (int dd = 0; dd < DPT; ++dd)
      orow[cg + 16 * dd] = from_f<T>(acc[r][dd] / l[r]);
    if (cg == 0) lse[(size_t)bh * s + row] = m[r] + logf(l[r]);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* cos, const float* sin, void* o, float* lse,
                   int b, int s, int sk, int h, int kv, float scale,
                   int causal, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(s / BLOCK_M, b * h);
  flash_fwd_kernel<T, HD><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), cos, sin, static_cast<T*>(o), lse, s, sk, h,
      kv, scale, causal, cos != nullptr);
  return cudaGetLastError();
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
      s % BLOCK_M != 0 || sk % BLOCK_N != 0 || (causal && s != sk) ||
      (cos == nullptr) != (sin == nullptr) || (cos != nullptr && s != sk))
    return (int)cudaErrorInvalidValue;
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
