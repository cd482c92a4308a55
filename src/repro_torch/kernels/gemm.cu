// Batch-invariant f32 linear layer for Hopper (sm_90a):
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
// Two kernels, each chosen by the call site and never by M:
//
// gemm_tokens_wgmma — the token products (M = B·256 rows: q/k/v/o, the MLP,
// the patch embedding, the output projection).  Bound by operations: one
// B = 8 DiT-XL/2 forward runs ~1.83 TFLOP of them, 5.5 TFLOP of TF32
// tensor-core work as 3xTF32 (~11.1 ms at the card's 495 TFLOP/s), against
// ~0.3 GB of operands.
// - 3xTF32 on `wgmma`: v = big + small, both TF32; each k8 slice of the
//   product accumulates small_x·big_w, big_x·small_w, big_x·big_w in that
//   order into f32 registers (plain TF32 keeps 11 bits and misses the 5e-5
//   parity limit).  `mma.sync` tops out near 296 TFLOP/s TF32 on this card
//   (`mma_rate`); only `wgmma` reaches the 495.
// - The `wgmma` accumulator loses a little at every k8 step, and over a
//   whole K that loss grew with K (4.95e-5 of the output's scale at K 6144
//   against an f64 product).  So an accumulator runs PROMOTE k-tiles (128
//   of K) from zero, then waits for its last group and is added into a
//   second f32 register sum with plain adds, run after run in ascending k
//   (DeepSeek-V3's promotion of Hopper partial sums, arXiv:2412.19437
//   §3.3.2): what the accumulator loses is bounded by one run's length,
//   not by K.
// - `wgmma` reads a TF32 B operand from shared memory K-major only, and the
//   weights are (K, N).  So w is split once, outside the kernel, into
//   w_big_t and w_small_t, each (N, K) (`gemm.prepare`): the split of w
//   leaves the inner loop, and the weights never change while a pipeline
//   serves.  x is split in registers, once per element, by the consumer
//   that reads it (A from registers, the RS form of `wgmma`).
// - Warp-specialised and persistent: one producer thread keeps TMA loads
//   of the x tile (128 rows x 32 f32, 128 B rows, 128 B swizzle) and the
//   matching w_big_t / w_small_t tiles (BN rows x 32) in flight in a ring
//   of STAGES stages with full/empty mbarriers; two consumer warpgroups
//   each own 64 rows x BN of the output tile and issue 12 `wgmma`s
//   (m64nBNk8) per k-tile, one group in flight while the next k-tile's x
//   fragments are split.  A block walks output tiles (m fastest) with a
//   stride of the grid, so a tile's loads overlap the last tile's
//   epilogue.  The TMA descriptors are built on the host per call
//   (`cuTensorMapEncodeTiled` through the runtime's driver entry point, no
//   -lcuda) and passed by value as __grid_constant__ parameters, so a
//   captured launch records them.
// - Invariant by construction: BN, the k-tile of 32, STAGES, PROMOTE and
//   the k order are constants of the instance, which the caller picks by (K, N)
//   alone; no split of K, no atomics; the ragged M, N and K edges are
//   zero-filled by TMA, so a tail tile computes the rows it holds exactly
//   as a full tile does.  The order in which a block visits tiles depends
//   on M; a tile's arithmetic does not.
//
// gemm_requests_ffma — the request-row products (M = 2B rows: the adaLN
// modulation, the time MLP, the final modulation).  Bound by bytes: the
// adaLN weight is 1152 x 6912 x 4 B = 31.9 MB against 8 rows.
// - w is read as stored, once, 16 bytes a thread along N; each block owns
//   NB columns (NB = 8, 16 or 32, so that the DiT's N = 1152, 2304 and 6912
//   give 144, 144 and 216 blocks on 132 SMs) and 16 rows of x, staged in
//   shared memory transposed (k-major) so that a thread reads a k's 16
//   rows with four 16-byte loads.
// - The 256 threads split K into KS = 256 / (NB / 4) fixed slices; each
//   sums its slice in ascending k with f32 FMAs (more exact than 3xTF32;
//   the bound is bytes), and the slices' partial sums meet in a fixed
//   pairwise tree in shared memory.  The bias is added to the finished
//   sum.  Rows past M are zeros in shared memory; the quads of rows wholly
//   past M are not computed (a row's sum does not involve the others).
//
// No allocation, no synchronisation with the host: both launch on the
// caller's stream and can be captured into a CUDA graph.
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// Shared helpers
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// f32 -> tf32, rounded to nearest with ties away from zero, in f32 bits.
__device__ __forceinline__ uint32_t tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

// v = big + small, both tf32: big rounded as cvt.rna rounds any non-NaN,
// in two integer operations (ref.tf32_split is the plain twin).
__device__ __forceinline__ void split(float v, uint32_t& big,
                                      uint32_t& small) {
  big = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  small = tf32(v - __uint_as_float(big));
}

// ---------------------------------------------------------------------------
// mbarriers and TMA
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Wait until the barrier's phase differs from `parity`.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// One 2-D tile of a tensor map into shared memory; completion counts its
// bytes on `bar`.  c0 is the inner (k) coordinate, c1 the row.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// ---------------------------------------------------------------------------
// wgmma: m64nNk8, f32 += tf32 (A from registers) x tf32 (B K-major in
// shared memory, 128 B swizzle)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// Keep the compiler from moving reads or writes of a register across the
// asynchronous products (CUTLASS's warpgroup_fence_operand).
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Descriptor of a K-major, 128 B-swizzled tile: rows of 128 B (32 f32 of
// k), 8-row groups 1024 B apart; the tile starts 1024 B-aligned.  The k8
// slice kk starts 32·kk bytes into the row (the swizzle is applied to the
// address bits, so the start address advances by kk·2 in 16 B units).
__device__ __forceinline__ uint64_t kmajor_desc(const void* tile) {
  const uint64_t addr = smem_u32(tile);
  return ((addr & 0x3ffff) >> 4) | (uint64_t(1) << 16) |
         (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}

#define ACC8 "%0, %1, %2, %3, %4, %5, %6, %7"
#define ACC16 ACC8 ", %8, %9, %10, %11, %12, %13, %14, %15"
#define ACC24 ACC16 ", %16, %17, %18, %19, %20, %21, %22, %23"
#define ACC32 ACC24 ", %24, %25, %26, %27, %28, %29, %30, %31"
#define ACC40 ACC32 ", %32, %33, %34, %35, %36, %37, %38, %39"
#define ACC48 ACC40 ", %40, %41, %42, %43, %44, %45, %46, %47"
#define ACC56 ACC48 ", %48, %49, %50, %51, %52, %53, %54, %55"
#define ACC64 ACC56 ", %56, %57, %58, %59, %60, %61, %62, %63"
#define ACC72 ACC64 ", %64, %65, %66, %67, %68, %69, %70, %71"
#define ACC80 ACC72 ", %72, %73, %74, %75, %76, %77, %78, %79"
#define ACC88 ACC80 ", %80, %81, %82, %83, %84, %85, %86, %87"
#define ACC96 ACC88 ", %88, %89, %90, %91, %92, %93, %94, %95"
#define ACC104 ACC96 ", %96, %97, %98, %99, %100, %101, %102, %103"
#define ACC112 ACC104 ", %104, %105, %106, %107, %108, %109, %110, %111"
#define ACC120 ACC112 ", %112, %113, %114, %115, %116, %117, %118, %119"
#define ACC128 ACC120 ", %120, %121, %122, %123, %124, %125, %126, %127"
#define OUT8(i)                                                        \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),          \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define OUT16(i) OUT8(i), OUT8(i + 8)
#define OUT32(i) OUT16(i), OUT16(i + 16)
#define OUT64(i) OUT32(i), OUT32(i + 32)

template <int N>
struct Wgmma;

// Wgmma<N>::run(d, a, desc, acc): d (N/2 f32 per thread) = a (the thread's
// four tf32 of its warp's 16 x 8 slice of A) x the N x 8 B tile at desc,
// plus d when acc is 1 (0: d's old value is not read).  ACC lists d's
// operands, A the four a operands, DESC and ACCUMULATE the next two.
#define DEFINE_WGMMA(N, ACC, A, DESC, ACCUMULATE, ...)                       \
  template <>                                                                \
  struct Wgmma<N> {                                                          \
    static __device__ __forceinline__ void run(float (&d)[N / 2],           \
                                               const uint32_t(&a)[4],       \
                                               uint64_t desc, uint32_t acc) {\
      asm volatile("{.reg .pred p; setp.ne.b32 p, " ACCUMULATE ", 0;\n"     \
                   "wgmma.mma_async.sync.aligned.m64n" #N                   \
                   "k8.f32.tf32.tf32 {" ACC "}, {" A "}, " DESC             \
                   ", p, 1, 1;}\n"                                           \
                   : __VA_ARGS__                                             \
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]),            \
                     "l"(desc), "r"(acc));                                   \
    }                                                                        \
  };

DEFINE_WGMMA(16, ACC8, "%8, %9, %10, %11", "%12", "%13", OUT8(0))
DEFINE_WGMMA(64, ACC32, "%32, %33, %34, %35", "%36", "%37", OUT32(0))
DEFINE_WGMMA(96, ACC48, "%48, %49, %50, %51", "%52", "%53", OUT32(0),
             OUT16(32))
DEFINE_WGMMA(128, ACC64, "%64, %65, %66, %67", "%68", "%69", OUT64(0))
DEFINE_WGMMA(144, ACC72, "%72, %73, %74, %75", "%76", "%77", OUT64(0),
             OUT8(64))
DEFINE_WGMMA(192, ACC96, "%96, %97, %98, %99", "%100", "%101", OUT64(0),
             OUT32(64))
DEFINE_WGMMA(256, ACC128, "%128, %129, %130, %131", "%132", "%133",
             OUT64(0), OUT64(64))

// ---------------------------------------------------------------------------
// The token-row kernel
// ---------------------------------------------------------------------------

constexpr int BM = 128;               // two consumer warpgroups x 64 rows
constexpr int BK = 32;                // 128 B of f32 per tile row
constexpr int TOKEN_THREADS = 384;    // consumers (warpgroups 0, 1), producer
constexpr int X_TILE = BM * BK * 4;   // bytes
// k-tiles a `wgmma` accumulator runs before its sum is promoted into the f32
// register sum (128 of K)
constexpr int PROMOTE = 4;
static_assert(PROMOTE >= 2 && PROMOTE % 2 == 0,
              "runs end on the second k-tile of a pair");

template <int BN>
struct TokenTile {
  static constexpr int W_TILE = BN * BK * 4;
  static constexpr int STAGE = X_TILE + 2 * W_TILE;
  // as many stages as fit beside the barriers, at most 6
  static constexpr int STAGES =
      (220 * 1024) / STAGE > 6 ? 6 : (220 * 1024) / STAGE;
  static constexpr int SMEM = STAGES * STAGE + 2 * STAGES * 8 + 1024;
  static_assert(W_TILE % 1024 == 0, "tiles must stay 1024 B-aligned");
  static_assert(STAGES >= 2, "too wide a tile");
};

// One k-tile of one consumer warpgroup: split its x fragments (rows g and
// g + 8 of the warp's 16, k = t and t + 4 of each k8 slice; the x tile is
// 128 B-swizzled: 16 B chunk c of row r sits at chunk c ^ (r & 7)), then
// the 12 products in the fixed order, committed as one group.  On the
// first k-tile of a run (`fresh`) the first product overwrites acc, so
// that nothing but `wgmma` writes the accumulator's registers.
template <int BN>
__device__ __forceinline__ void consume_ktile(float (&acc)[BN / 2],
                                              uint32_t (&ab)[4][4],
                                              uint32_t (&as)[4][4],
                                              const char* stage, int row,
                                              int g, int t, bool fresh) {
  const char* xr0 = stage + row * 128;
  const char* xr1 = xr0 + 8 * 128;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int c0 = ((2 * kk) ^ g) * 16 + t * 4;
    const int c1 = ((2 * kk + 1) ^ g) * 16 + t * 4;
    split(*reinterpret_cast<const float*>(xr0 + c0), ab[kk][0], as[kk][0]);
    split(*reinterpret_cast<const float*>(xr1 + c0), ab[kk][1], as[kk][1]);
    split(*reinterpret_cast<const float*>(xr0 + c1), ab[kk][2], as[kk][2]);
    split(*reinterpret_cast<const float*>(xr1 + c1), ab[kk][3], as[kk][3]);
  }
  const uint64_t dbig = kmajor_desc(stage + X_TILE);
  const uint64_t dsmall = kmajor_desc(stage + X_TILE + TokenTile<BN>::W_TILE);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    Wgmma<BN>::run(acc, as[kk], dbig + 2 * kk, kk == 0 && fresh ? 0u : 1u);
    Wgmma<BN>::run(acc, ab[kk], dsmall + 2 * kk, 1u);
    Wgmma<BN>::run(acc, ab[kk], dbig + 2 * kk, 1u);
  }
  wgmma_commit();
}

template <int BN>
__global__ void __launch_bounds__(TOKEN_THREADS, 1)
    gemm_tokens_wgmma(const __grid_constant__ CUtensorMap tx,
                      const __grid_constant__ CUtensorMap tbig,
                      const __grid_constant__ CUtensorMap tsmall,
                      const float* __restrict__ bias, float* __restrict__ y,
                      int M, int N, int K) {
  using T = TokenTile<BN>;
  constexpr int STAGES = T::STAGES;
  extern __shared__ char smem_raw[];
  char* smem = reinterpret_cast<char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * T::STAGE);
  uint64_t* empty = full + STAGES;

  const int mt_n = (M + BM - 1) / BM, nt_n = (N + BN - 1) / BN;
  const int tiles = mt_n * nt_n, kt_n = (K + BK - 1) / BK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == 256) {
      int stage = 0;
      uint32_t phase = 1;  // the ring starts empty
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile % mt_n) * BM, n0 = (tile / mt_n) * BN;
        for (int kt = 0; kt < kt_n; ++kt) {
          mbar_wait(&empty[stage], phase);
          char* st = smem + stage * T::STAGE;
          mbar_expect_tx(&full[stage], T::STAGE);
          tma_load(st, &tx, &full[stage], kt * BK, m0);
          tma_load(st + X_TILE, &tbig, &full[stage], kt * BK, n0);
          tma_load(st + X_TILE + T::W_TILE, &tsmall, &full[stage], kt * BK,
                   n0);
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
    const int g = lane >> 2, t = lane & 3;
    const int row = wg * 64 + warp * 16 + g;  // of the tile
    int stage = 0;
    uint32_t phase = 0;
    uint32_t ab0[4][4], as0[4][4], ab1[4][4], as1[4][4];
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = (tile % mt_n) * BM, n0 = (tile / mt_n) * BN;
      // acc: the products of the current run of PROMOTE k-tiles; sum: the
      // runs added in ascending order with f32 adds
      float acc[BN / 2], sum[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        acc[i] = 0.f;
        sum[i] = 0.f;
      }
      fence_regs(acc);
      int prev = -1;
      // k-tiles in pairs, so that the group in flight reads one register
      // set of x fragments while the next k-tile fills the other
      for (int kt = 0; kt < kt_n; kt += 2) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (kt + h < kt_n) {
            mbar_wait(&full[stage], phase);
            const char* st = smem + stage * T::STAGE;
            const bool fresh = (kt + h) % PROMOTE == 0;
            if (h == 0)
              consume_ktile<BN>(acc, ab0, as0, st, row, g, t, fresh);
            else
              consume_ktile<BN>(acc, ab1, as1, st, row, g, t, fresh);
            if ((kt + h + 1) % PROMOTE == 0 || kt + h + 1 == kt_n) {
              // end of a run: wait for its last group, release both
              // stages, promote the run into sum
              wgmma_wait<0>();
              fence_regs(acc);
              if (lane == 0) {
                if (prev >= 0) mbar_arrive(&empty[prev]);
                mbar_arrive(&empty[stage]);
              }
              prev = -1;
#pragma unroll
              for (int i = 0; i < BN / 2; ++i) sum[i] += acc[i];
            } else {
              wgmma_wait<1>();  // the group before this one is done
              if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
              prev = stage;
            }
            if (++stage == STAGES) {
              stage = 0;
              phase ^= 1;
            }
          }
        }
      }
      // the last k-tile ended a run, so nothing is in flight; said here
      // for the compiler, which cannot see it and would wait before the
      // next tile's acc is written
      wgmma_wait<0>();

      // C fragment: per n8 slice j, (row g, cols 2t, 2t + 1) and row g + 8
      const int r0 = m0 + row;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int c = n0 + 8 * j + 2 * t;
        if (c >= N) continue;  // N is even: c < N means c + 1 < N
        float2 bv = make_float2(0.f, 0.f);
        if (bias != nullptr) bv = make_float2(bias[c], bias[c + 1]);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = r0 + 8 * h;
          if (r >= M) continue;
          float2 v = make_float2(sum[4 * j + 2 * h], sum[4 * j + 2 * h + 1]);
          if (bias != nullptr) {
            v.x += bv.x;
            v.y += bv.y;
          }
          *reinterpret_cast<float2*>(y + (long long)r * N + c) = v;
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The request-row kernel
// ---------------------------------------------------------------------------

constexpr int REQ_THREADS = 256;
constexpr int REQ_ROWS = 16;
constexpr int REQ_UNROLL = 6;  // w loads in flight per thread

template <int NB>
__global__ void __launch_bounds__(REQ_THREADS)
    gemm_requests_ffma(const float* __restrict__ x,
                       const float* __restrict__ w,
                       const float* __restrict__ bias, float* __restrict__ y,
                       int M, int N, int K, int kslice) {
  constexpr int CG = NB / 4;               // float4 columns of the block
  constexpr int KS = REQ_THREADS / CG;     // k slices
  extern __shared__ float4 rsm[];
  float* xs = reinterpret_cast<float*>(rsm);  // (K, 16): k-major rows of x
  const int m0 = blockIdx.y * REQ_ROWS;
  const int rows = min(REQ_ROWS, M - m0);

  // x's 16 rows, transposed; rows past M are zeros.  Eight 16-byte loads
  // in flight per thread before any store; neighbouring threads take
  // neighbouring rows, so that a warp's stores fill distinct banks.
  const int k4n = K / 4, total = REQ_ROWS * k4n;
  for (int base = threadIdx.x; base < total; base += 8 * REQ_THREADS) {
    float4 v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int i = base + u * REQ_THREADS, r = i % REQ_ROWS;
      v[u] = i < total && r < rows
                 ? __ldg(reinterpret_cast<const float4*>(x) +
                         (long long)(m0 + r) * k4n + i / REQ_ROWS)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int i = base + u * REQ_THREADS;
      if (i < total) {
        float* d = xs + 4 * (i / REQ_ROWS) * REQ_ROWS + i % REQ_ROWS;
        d[0] = v[u].x;
        d[REQ_ROWS] = v[u].y;
        d[2 * REQ_ROWS] = v[u].z;
        d[3 * REQ_ROWS] = v[u].w;
      }
    }
  }
  __syncthreads();

  const int cg = threadIdx.x % CG, s = threadIdx.x / CG;
  const int n = blockIdx.x * NB + cg * 4;
  const int k_lo = min(K, s * kslice), k_hi = min(K, k_lo + kslice);
  // quads of rows that hold a row below M (block-uniform): a row's sum
  // does not involve the others, so rows past M are simply not computed
  const int quads = (rows + 3) / 4;
  float4 acc[REQ_ROWS];
#pragma unroll
  for (int r = 0; r < REQ_ROWS; ++r) acc[r] = make_float4(0.f, 0.f, 0.f, 0.f);
  if (n < N) {
    for (int k = k_lo; k < k_hi; k += REQ_UNROLL) {
      float4 wv[REQ_UNROLL];
#pragma unroll
      for (int u = 0; u < REQ_UNROLL; ++u)
        wv[u] = k + u < k_hi ? __ldg(reinterpret_cast<const float4*>(
                                   w + (long long)(k + u) * N + n))
                             : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int u = 0; u < REQ_UNROLL; ++u) {
        if (k + u < k_hi) {
          const float4* xk =
              reinterpret_cast<const float4*>(xs + (k + u) * REQ_ROWS);
#pragma unroll
          for (int q = 0; q < REQ_ROWS / 4; ++q) {
            if (q < quads) {
              const float4 xv = xk[q];
              const float xr[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                float4& a = acc[4 * q + i];
                a.x = fmaf(xr[i], wv[u].x, a.x);
                a.y = fmaf(xr[i], wv[u].y, a.y);
                a.z = fmaf(xr[i], wv[u].z, a.z);
                a.w = fmaf(xr[i], wv[u].w, a.w);
              }
            }
          }
        }
      }
    }
  }
  __syncthreads();  // x is read; its space takes the partial sums

  // part[r][s][cg]: slice s's partial sums of row r, met in a fixed
  // pairwise tree; a warp's lanes hold neighbouring (s, cg), so each
  // access fills distinct banks
  float4* part = rsm;
#pragma unroll
  for (int r = 0; r < REQ_ROWS; ++r)
    if (r < 4 * quads) part[(r * KS + s) * CG + cg] = acc[r];
  for (int h = KS / 2; h >= 1; h /= 2) {
    __syncthreads();
    if (s < h) {
#pragma unroll
      for (int r = 0; r < REQ_ROWS; ++r) {
        if (r < 4 * quads) {
          float4& a = part[(r * KS + s) * CG + cg];
          const float4 b = part[(r * KS + s + h) * CG + cg];
          a.x += b.x;
          a.y += b.y;
          a.z += b.z;
          a.w += b.w;
        }
      }
    }
  }
  __syncthreads();
  if (threadIdx.x < REQ_ROWS * CG) {
    const int r = threadIdx.x / CG, c = threadIdx.x % CG;
    const int col = blockIdx.x * NB + c * 4;
    if (r < rows && col < N) {
      float4 v = part[r * KS * CG + c];
      if (bias != nullptr) {
        const float4 bv = *reinterpret_cast<const float4*>(bias + col);
        v.x += bv.x;
        v.y += bv.y;
        v.z += bv.z;
        v.w += bv.w;
      }
      *reinterpret_cast<float4*>(y + (long long)(m0 + r) * N + col) = v;
    }
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

constexpr int ERR_ENCODE = 100000;  // + the CUresult of a failed encode
constexpr int ERR_NO_INSTANCE = 200000;

int sm_count() {
  static int sms[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (sms[dev] == 0)
    cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
  return sms[dev];
}

PFN_cuTensorMapEncodeTiled_v12000 encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// A (rows, cols) row-major f32 matrix as a map of (box_rows, 32) tiles,
// 128 B-swizzled, out-of-bounds elements read as zeros.
int encode(CUtensorMap* map, const void* ptr, int rows, int cols,
           int box_rows) {
  auto fn = encoder();
  if (fn == nullptr) return ERR_ENCODE;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 4};
  const cuuint32_t box[2] = {(cuuint32_t)BK, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                        const_cast<void*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_ENCODE + (int)r;
}

template <int BN>
int launch_tokens(const void* x, const void* wbig, const void* wsmall,
                  const void* bias, void* y, int M, int N, int K,
                  cudaStream_t stream) {
  using T = TokenTile<BN>;
  CUtensorMap tx, tb, ts;
  int rc = encode(&tx, x, M, K, BM);
  if (rc == 0) rc = encode(&tb, wbig, N, K, BN);
  if (rc == 0) rc = encode(&ts, wsmall, N, K, BN);
  if (rc != 0) return rc;
  static bool ready = false;
  if (!ready) {
    const cudaError_t e = cudaFuncSetAttribute(
        gemm_tokens_wgmma<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        T::SMEM);
    if (e != cudaSuccess) return (int)e;
    ready = true;
  }
  const long long tiles =
      (long long)((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  const int grid = (int)(tiles < sms ? tiles : sms);
  gemm_tokens_wgmma<BN><<<grid, TOKEN_THREADS, T::SMEM, stream>>>(
      tx, tb, ts, static_cast<const float*>(bias), static_cast<float*>(y), M,
      N, K);
  return (int)cudaGetLastError();
}

template <int NB>
int launch_requests(const void* x, const void* w, const void* bias, void* y,
                    int M, int N, int K, cudaStream_t stream) {
  constexpr int KS = REQ_THREADS / (NB / 4);
  const int kslice = (K + KS - 1) / KS;
  const int part = KS * REQ_ROWS * NB * 4;
  const int xs = K * REQ_ROWS * 4;
  const int smem = xs > part ? xs : part;
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  static int allowed = 0;  // the dynamic shared memory allowed so far
  if (smem > allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        gemm_requests_ffma<NB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
    allowed = smem;
  }
  const dim3 grid((N + NB - 1) / NB, (M + REQ_ROWS - 1) / REQ_ROWS);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  gemm_requests_ffma<NB><<<grid, REQ_THREADS, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<float*>(y), M, N, K,
      kslice);
  return (int)cudaGetLastError();
}

}  // namespace

// The tile widths built.  The plan (gemm.py) names one per (K, N); a build
// with -DGEMM_ALL_TILES adds the candidates that gemm_ab times.
#ifdef GEMM_ALL_TILES
#define TOKEN_TILES(X) X(16) X(64) X(96) X(128) X(144) X(192) X(256)
#else
#define TOKEN_TILES(X) X(16) X(64) X(96) X(128) X(144)
#endif

// y (M, N) = x (M, K) @ w (K, N) (+ bias (N,) when not null), f32,
// row-major, contiguous, 16-byte-aligned pointers, K and N multiples of 4;
// w given as its split halves w_big_t and w_small_t, each (N, K)
// (gemm.prepare).  bn is the tile width the plan picked for (K, N).
// Returns 0 when launched, else a cudaError_t, ERR_ENCODE + a CUresult, or
// ERR_NO_INSTANCE (linear_error_string says which).  The caller checks
// shapes, dtypes, devices and alignment; nothing here allocates or
// synchronizes.
extern "C" int linear_tokens_f32(const void* x, const void* wbig_t,
                                 const void* wsmall_t, const void* bias,
                                 void* y, int M, int N, int K, int bn,
                                 void* stream) {
  if (M < 0 || N < 4 || K < 4 || N % 4 || K % 4)
    return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TOKEN_CASE(W) \
  if (bn == W) return launch_tokens<W>(x, wbig_t, wsmall_t, bias, y, M, N, K, s);
  TOKEN_TILES(TOKEN_CASE)
#undef TOKEN_CASE
  return ERR_NO_INSTANCE;
}

// The same product for request rows: w (K, N) as stored; nb (8, 16 or 32)
// is the column slice the plan picked for N.
extern "C" int linear_requests_f32(const void* x, const void* w,
                                   const void* bias, void* y, int M, int N,
                                   int K, int nb, void* stream) {
  if (M < 0 || N < 4 || K < 4 || N % 4 || K % 4)
    return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nb == 8) return launch_requests<8>(x, w, bias, y, M, N, K, s);
  if (nb == 16) return launch_requests<16>(x, w, bias, y, M, N, K, s);
  if (nb == 32) return launch_requests<32>(x, w, bias, y, M, N, K, s);
  return ERR_NO_INSTANCE;
}

extern "C" const char* linear_error_string(int code) {
  if (code == ERR_NO_INSTANCE) return "no kernel instance for that tile";
  if (code >= ERR_ENCODE)
    return "cuTensorMapEncodeTiled failed (or the driver has no entry "
           "point for it)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
