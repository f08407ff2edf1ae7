// The rate the H100's tensor cores reach through mma.sync, the instruction
// the flash-attention forward issues: every warp runs independent
// accumulator chains of one instruction shape back to back, with no loads.
// `chip_smoke.py --profile` prints it beside the data sheet's peaks (TF32
// 495, bf16 989 TFLOP/s dense, reached only through wgmma), so that a
// kernel's time can be read against the rate its instruction can give.
// Plain C interface for ctypes.

#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int CHAINS = 8;   // independent accumulators a warp

// KIND 0: m16n8k8 TF32, 1: m16n8k16 bf16; f32 accumulate.
template <int KIND>
__global__ void mma_loop(float* out, int iters) {
  float d[CHAINS][4] = {};
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = threadIdx.x * 7u + i;
  b[0] = threadIdx.x;
  b[1] = threadIdx.x * 3u;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int n = 0; n < CHAINS; ++n) {
      if (KIND == 0)
        asm volatile(
            "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(d[n][0]), "+f"(d[n][1]), "+f"(d[n][2]), "+f"(d[n][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
              "r"(b[1]));
      else
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(d[n][0]), "+f"(d[n][1]), "+f"(d[n][2]), "+f"(d[n][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
              "r"(b[1]));
    }
  }
  float sum = 0.f;
  for (int n = 0; n < CHAINS; ++n)
    sum += d[n][0] + d[n][1] + d[n][2] + d[n][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = sum;   // keeps the loop live
}

}  // namespace

// kind 0: TF32 m16n8k8, 1: bf16 m16n8k16. Runs `blocks` blocks of 8 warps
// on the current device's default stream, `iters` rounds each, after one
// warm-up launch. Writes the rate in TFLOP/s to *tflops; returns a
// cudaError_t.
extern "C" int tpudist_mma_peak(int kind, int blocks, int iters,
                                float* tflops) {
  if ((kind != 0 && kind != 1) || blocks < 1 || iters < 1)
    return (int)cudaErrorInvalidValue;
  constexpr int THREADS = 256;
  float* out = nullptr;
  cudaEvent_t e0 = nullptr, e1 = nullptr;
  cudaError_t err = cudaMalloc(&out, sizeof(float) * blocks * THREADS);
  if (err == cudaSuccess) err = cudaEventCreate(&e0);
  if (err == cudaSuccess) err = cudaEventCreate(&e1);
  float ms = 0.f;
  for (int rep = 0; rep < 2 && err == cudaSuccess; ++rep) {
    err = cudaEventRecord(e0);
    if (kind == 0)
      mma_loop<0><<<blocks, THREADS>>>(out, iters);
    else
      mma_loop<1><<<blocks, THREADS>>>(out, iters);
    if (err == cudaSuccess) err = cudaGetLastError();
    if (err == cudaSuccess) err = cudaEventRecord(e1);
    if (err == cudaSuccess) err = cudaEventSynchronize(e1);
    if (err == cudaSuccess) err = cudaEventElapsedTime(&ms, e0, e1);
  }
  if (err == cudaSuccess) {
    const double flops = (kind == 0 ? 2.0 * 16 * 8 * 8 : 2.0 * 16 * 8 * 16) *
                         CHAINS * (double)iters * (THREADS / 32) * blocks;
    *tflops = (float)(flops / (ms * 1e-3) / 1e12);
  }
  if (e0) cudaEventDestroy(e0);
  if (e1) cudaEventDestroy(e1);
  if (out) cudaFree(out);
  return (int)err;
}
