// The rate at which one H100 retires `mma.sync` tensor-core instructions,
// the instruction both hand-written kernels of this package use: each warp
// issues 8 independent m16n8k8 TF32 (or m16n8k16 bf16) products per loop
// trip into f32 accumulators, with no loads, so that nothing but the
// tensor cores bounds it.  It yields the ceiling the kernels' mma count
// is held against (`python -m repro_torch.kernels.mma_rate`); `wgmma`,
// which the data sheet's 495 TFLOP/s TF32 peak assumes, is not measured.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NACC = 8;  // independent accumulators per warp

template <bool BF16>
__global__ void mma_loop(float* out, long long* cycles, int iters) {
  float c[NACC][4] = {};
  const uint32_t a[4] = {threadIdx.x, 1u, 2u, 3u};
  const uint32_t b1 = 7u;
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < NACC; ++j) {
      const uint32_t b0 = threadIdx.x * 3u + j;
      if constexpr (BF16)
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
            : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
      else
        asm volatile(
            "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
            : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
    }
  }
  const long long t1 = clock64();
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < NACC; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
  if (threadIdx.x == 0) cycles[blockIdx.x] = t1 - t0;
}

}  // namespace

// One block of `threads` per SM (blocks = the SM count), each warp running
// `iters` trips of NACC products; out: blocks * threads floats, cycles:
// blocks SM clock counts.  Returns a cudaError_t (0 = launched).
extern "C" int mma_rate_launch(void* out, void* cycles, int blocks,
                               int threads, int iters, int bf16,
                               void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    mma_loop<true><<<blocks, threads, 0, s>>>(
        static_cast<float*>(out), static_cast<long long*>(cycles), iters);
  else
    mma_loop<false><<<blocks, threads, 0, s>>>(
        static_cast<float*>(out), static_cast<long long*>(cycles), iters);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mma_per_trip() { return NACC; }
