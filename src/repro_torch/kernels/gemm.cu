// Batch-invariant f32 linear layer for Hopper (sm_90a) on the tensor cores:
// y = x @ w (+ b), x (M, K), w (K, N), y (M, N), all row-major f32.
//
// Replaces cuBLAS's f32 GEMM on the DiT path (the JAX package leaves these
// products to XLA).  cuBLAS picks its kernel, tile and reduction split by
// M, so a row of x multiplied in a batch of another size comes out with
// other bits (up to 2.9e-4 max abs at the DiT-XL/2 shapes on the H100).
// The serving contract — a row's bits do not depend on the batch it rides
// in (per-row noise, split_run, merge_runs, joins, regroups, coalesces) —
// needs a product whose row r depends on row r of x and on w alone.
//
// Invariant by construction: one constant block tile (64 x 64, k-steps of
// 16), no split of K, nothing chosen by M.  Each output element is summed
// over K in one order — k-tile by k-tile, 8 products at a time, each 8 as
// the three TF32 products below — and the ragged M, N and K edges are
// loaded as zeros, so a tail tile computes the rows it holds exactly as a
// full tile does.  Fragments of a tile that lie wholly past M skip their
// products (warp-uniform), which changes no row below M.
//
// What bounds it: one B = 8 DiT-XL/2 forward (4 requests under CFG) runs
// ~1.83 TFLOP of these products.  Each f32 product is three TF32 products
// (3xTF32), 5.5 TFLOP of tensor-core work: ~11.1 ms at the card's 495
// TFLOP/s TF32 rate, against ~0.3 GB of operands, so the token products
// are bound by operations.  The adaLN products (M = 2B rows) move 32 MB of
// w for 0.25 GFLOP: bound by bytes.
//
// Design:
// - mma.sync m16n8k8 TF32 with the 3xTF32 split of flash_attention.cu:
//   v = big + small, both TF32, and each product accumulates small*big +
//   big*small + big*big in that order in f32 registers (plain TF32 keeps
//   11 bits and misses the 5e-5 parity limit).  `mma.sync` and not
//   `wgmma`: a simple kernel first; tf32 `wgmma` is the later redesign.
// - A block of 4 warps owns a 64 x 64 output tile; each warp 32 x 32, as
//   2 x 4 fragments, and splits each operand fragment once per k-step of 8.
//   The small tile spreads the DiT's N = 1152 products evenly over the
//   card's 132 SMs (576 blocks at M = 2048, 5 resident per SM).  Any tile
//   gives a row the same bits: the k order does not depend on it.
// - A ring of 4 stages in shared memory holds the next k-tiles of x
//   (64 x 16) and w (16 x 64), filled by 16-byte cp.async copies (zero
//   fill past an edge) while the warps compute on the oldest stage.  Rows
//   are padded (x by 4 floats, w by 8) so that a warp's fragment loads hit
//   32 banks.  39 KB of shared memory: 5 blocks per SM.
// - The bias, when given, is added to the finished sum, as x @ w + b does.
// - No atomics, no allocation, no synchronisation: it launches on the
//   caller's stream and can be captured into a CUDA graph.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64, BN = 64, BK = 16, STAGES = 4;
constexpr int WM = 32, WN = 32;                      // warp tile
constexpr int WARPS_N = BN / WN;                     // 2
constexpr int THREADS = 32 * (BM / WM) * WARPS_N;    // 128
constexpr int MT = WM / 16, NT = WN / 8;             // 2 x 4 fragments
constexpr int AS = BK + 4;                           // x tile row stride
constexpr int BS = BN + 8;                           // w tile row stride
constexpr int A_TILE = BM * AS, B_TILE = BK * BS;
constexpr int STAGE = A_TILE + B_TILE;
constexpr int SMEM = STAGES * STAGE * (int)sizeof(float);

// f32 -> tf32, rounded to nearest with ties away from zero, in f32 bits.
__device__ __forceinline__ uint32_t tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

// v = big + small, both tf32 (flash_attention.cu's split: big rounded as
// cvt.rna rounds any non-NaN, in two integer operations).
__device__ __forceinline__ void split(float v, uint32_t& big,
                                      uint32_t& small) {
  big = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  small = tf32(v - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp16(float* dst, const float* src, bool in) {
  const unsigned sa = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(sa),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// The k-tile at k0 of this block's rows of x and columns of w into one
// stage; chunks past an edge are zero-filled (K and N are multiples of 4,
// so a 16-byte chunk is wholly inside or wholly outside).
__device__ __forceinline__ void load_stage(float* st, const float* x,
                                           const float* w, int M, int N,
                                           int K, int m0, int n0, int k0) {
  float* as = st;
  float* bs = st + A_TILE;
#pragma unroll
  for (int i = 0; i < BM * BK / 4 / THREADS; ++i) {
    const int c = threadIdx.x + i * THREADS;
    const int r = c / (BK / 4), col = (c % (BK / 4)) * 4;
    const int gr = m0 + r, gk = k0 + col;
    const bool in = gr < M && gk < K;
    cp16(as + r * AS + col, in ? x + (long long)gr * K + gk : x, in);
  }
#pragma unroll
  for (int i = 0; i < BK * BN / 4 / THREADS; ++i) {
    const int c = threadIdx.x + i * THREADS;
    const int r = c / (BN / 4), col = (c % (BN / 4)) * 4;
    const int gk = k0 + r, gn = n0 + col;
    const bool in = gk < K && gn < N;
    cp16(bs + r * BS + col, in ? w + (long long)gk * N + gn : w, in);
  }
}

__global__ void __launch_bounds__(THREADS, 5)
    gemm_3xtf32(const float* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ bias, float* __restrict__ y, int M,
                int N, int K) {
  extern __shared__ __align__(16) float sm[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int kt_n = (K + BK - 1) / BK;
  // this warp's fragments that hold a row below M
  const int rows = M - (m0 + wm * WM);
  const int live = rows <= 0 ? 0 : min(MT, (rows + 15) / 16);

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < kt_n) load_stage(sm + s * STAGE, x, w, M, N, K, m0, n0, s * BK);
    cp_commit();
  }
  for (int kt = 0; kt < kt_n; ++kt) {
    cp_wait<STAGES - 2>();
    __syncthreads();  // tile kt has landed; every warp is done with kt - 1
    const int nxt = kt + STAGES - 1;
    if (nxt < kt_n)
      load_stage(sm + (nxt % STAGES) * STAGE, x, w, M, N, K, m0, n0,
                 nxt * BK);
    cp_commit();
    const float* as = sm + (kt % STAGES) * STAGE;
    const float* bs = as + A_TILE;
    if (live == 0) continue;
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
      // B fragment (k t / t+4, n g), split once for the warp's 4 row tiles
      uint32_t bb[NT][2], bl[NT][2];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float* p = bs + (kk * 8 + t) * BS + wn * WN + nt * 8 + g;
        split(p[0], bb[nt][0], bl[nt][0]);
        split(p[4 * BS], bb[nt][1], bl[nt][1]);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if (mt < live) {
          // A fragment (row g / g+8, k t / t+4)
          const float* p = as + (wm * WM + mt * 16 + g) * AS + kk * 8 + t;
          uint32_t ab[4], al[4];
          split(p[0], ab[0], al[0]);
          split(p[8 * AS], ab[1], al[1]);
          split(p[4], ab[2], al[2]);
          split(p[8 * AS + 4], ab[3], al[3]);
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            mma_tf32(acc[mt][nt], al, bb[nt][0], bb[nt][1]);
            mma_tf32(acc[mt][nt], ab, bl[nt][0], bl[nt][1]);
            mma_tf32(acc[mt][nt], ab, bb[nt][0], bb[nt][1]);
          }
        }
      }
    }
  }
  cp_wait<0>();

  // C fragment: (row g, cols 2t, 2t+1) and (row g+8, the same cols)
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int r0 = m0 + wm * WM + mt * 16 + g;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int c = n0 + wn * WN + nt * 8 + 2 * t;
      if (c >= N) continue;  // N is even: c < N means c + 1 < N
      float2 bv = make_float2(0.f, 0.f);
      if (bias != nullptr) bv = make_float2(bias[c], bias[c + 1]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 8 * h;
        if (r >= M) continue;
        float2 v = make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
        if (bias != nullptr) {
          v.x += bv.x;
          v.y += bv.y;
        }
        *reinterpret_cast<float2*>(y + (long long)r * N + c) = v;
      }
    }
  }
}

}  // namespace

// y (M, N) = x (M, K) @ w (K, N) (+ bias (N,) when not null), f32,
// row-major, contiguous, 16-byte-aligned pointers, K and N multiples of 4.
// Returns a cudaError_t (0 = launched).  The caller checks shapes, dtypes,
// devices and alignment; nothing here allocates or synchronizes.
extern "C" int linear_f32(const void* x, const void* w, const void* bias,
                          void* y, int M, int N, int K, void* stream) {
  if (M < 0 || N < 4 || K < 4 || N % 4 || K % 4)
    return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      gemm_3xtf32, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(gemm_3xtf32,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  gemm_3xtf32<<<grid, THREADS, SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<float*>(y), M, N, K);
  return (int)cudaGetLastError();
}

extern "C" const char* linear_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
