// RG-LRU scan for Hopper (sm_90a): the gated linear recurrence of
// Griffin / RecurrentGemma's recurrent block, as a chunked scan.
//
// Replaces no TPU kernel: the JAX package computes this with
// `jax.lax.associative_scan` (src/repro/models/rglru.py, `apply_full`),
// which XLA fuses into the layer on the TPU.  In plain PyTorch on the card
// the same scan is either L sequential steps of a few launches each or a
// log-depth chain of passes over (B, L, W) f32 tensors.
//
// Function, per channel (b, w), from h = h0[b, w] (0 without h0):
//   r = sigmoid(ga), i = sigmoid(gx)
//   log_a = -c * softplus(a_param[w]) * r
//   gated = sqrt(max(1 - exp(2 log_a), 1e-12)) * i * xr
//   h = exp(log_a) * h + gated,  y = h * gate
// with softplus(v) = log1p(exp(-|v|)) + max(v, 0) (jnp.logaddexp(v, 0)).
// y (B, L, W) and the last h (B, W) are written; the h of earlier steps is
// not.  With h0 and L = 1 this is the decode step.
//
// What bounds it: at RecurrentGemma-2B's prefill (B 2, L 3072, W 2560, f32)
// the function reads xr, ga, gx and gate and writes y, 5 x 62.9 MB, ~20
// operations a step: bound by bytes (0.094 ms at 3.35 TB/s).  The
// recurrence is sequential along L, so one thread per channel puts only
// B x W = 5120 threads to work, too few warps to keep the loads in flight
// that the card's memory rate needs.
//
// Design: L is cut into chunks of CHUNK steps, a compile-time constant
// (never chosen from B, L or W, so a row's bits do not depend on the batch
// it rides in), and the scan runs in three launches:
//   1. rglru_summary: one thread per (b, chunk, w) for every chunk but the
//      last reads the chunk's xr, ga and gx and writes its product of a
//      (sum_a) and its end state from h = 0 (sum_h), (B, chunks - 1, W).
//   2. rglru_carry: one thread per (b, w) walks the chunks in order,
//      carry = sum_a * carry + sum_h from h0, and writes each carry over
//      the sum_h it came from: sum_h[c] becomes the state entering chunk
//      c + 1.
//   3. rglru_output: one thread per (b, chunk, w) starts from its carry
//      (h0 for the first chunk), re-reads the chunk's four inputs, runs
//      the same steps as pass 1 and writes y; the last chunk writes hT.
// When L <= CHUNK only pass 3 runs, from h0: one launch, as a decode step
// needs.  Passes 1 and 3 read their inputs again (8 reads of 62.9 MB where
// the bound counts 5), but at the prefill they run B x 96 x W = 491520
// threads on every SM.  On an H100 at the prefill, chunks of 32 beat 64
// and 128 (more, shorter blocks: a shorter tail; `python3 -m
// repro_torch.kernels.rglru_ab <earlier rglru.cu> --chunks 64 128` times
// them); the carry pass's walk grows with L / CHUNK (95 steps there).
// Adjacent threads take adjacent w, so every step's loads and stores are
// coalesced along W; inputs are read through their (B, L) strides with a
// unit stride along W.  A thread issues the loads of UNROLL steps
// together, then computes them; the many warps an SM holds keep the loads
// in flight.  The order of every sum is fixed, so repeats are bitwise.
// The grid is one-dimensional, so B, L and W meet no limit but its
// 2^31 - 1 blocks.

#include <atomic>
#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int CHUNK = 32;
constexpr int UNROLL = 8;
static_assert(CHUNK % UNROLL == 0, "a chunk is whole groups of steps");

// launches of rglru_summary, rglru_carry and rglru_output since the library
// was loaded, each counted once its launch reported no error
std::atomic<long long> launched[3];

struct Args {
  const float* xr;
  const float* ga;
  const float* gx;
  const float* gate;
  const float* a_param;
  const float* h0;
  float* y;
  float* hT;
  float* sum_a;  // (B, chunks - 1, W): product of a over a chunk
  float* sum_h;  // (B, chunks - 1, W): chunk end state, then the carries
  int B, L, W, chunks, tiles;
  float c;
  long long sxb, sxl, sab, sal, sgb, sgl, sqb, sql, shb;
};

__device__ __forceinline__ float sigmoid_f(float v) {
  return 1.f / (1.f + expf(-v));
}

__device__ __forceinline__ float softplus_f(float v) {
  return log1pf(expf(-fabsf(v))) + fmaxf(v, 0.f);
}

// One step's coefficients: h = a * h + g.  Passes 1 and 3 both take them
// from here, so the state pass 3 starts from is the one pass 1 summed.
__device__ __forceinline__ void coefficients(float neg_c_sp, float x,
                                             float ga, float gx, float& a,
                                             float& g) {
  const float r = sigmoid_f(ga);
  const float i = sigmoid_f(gx);
  const float log_a = neg_c_sp * r;
  const float a2 = expf(2.f * log_a);
  g = sqrtf(fmaxf(1.f - a2, 1e-12f)) * i * x;
  a = expf(log_a);
}

// Block index → (b, chunk, w) over `chunks` chunks a row; false past W.
__device__ __forceinline__ bool place(const Args& p, int chunks, int& b,
                                      int& ch, int& w) {
  const unsigned blk = blockIdx.x;
  const unsigned rest = blk / p.tiles;
  w = (blk % p.tiles) * THREADS + threadIdx.x;
  ch = rest % chunks;
  b = rest / chunks;
  return w < p.W;
}

__global__ void __launch_bounds__(THREADS) rglru_summary(const Args p) {
  int b, ch, w;
  if (!place(p, p.chunks - 1, b, ch, w)) return;
  const float neg_c_sp = -p.c * softplus_f(p.a_param[w]);
  const long long t0 = (long long)ch * CHUNK;
  const float* px = p.xr + b * p.sxb + t0 * p.sxl + w;
  const float* pa = p.ga + b * p.sab + t0 * p.sal + w;
  const float* pi = p.gx + b * p.sgb + t0 * p.sgl + w;
  float prod = 1.f, h = 0.f;
  // every chunk but the last is whole: no step is masked
#pragma unroll 1
  for (int s = 0; s < CHUNK; s += UNROLL) {
    float x[UNROLL], ga[UNROLL], gx[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      x[u] = __ldg(px + (s + u) * p.sxl);
      ga[u] = __ldg(pa + (s + u) * p.sal);
      gx[u] = __ldg(pi + (s + u) * p.sgl);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      float a, g;
      coefficients(neg_c_sp, x[u], ga[u], gx[u], a, g);
      h = a * h + g;
      prod *= a;
    }
  }
  const long long o = ((long long)b * (p.chunks - 1) + ch) * p.W + w;
  p.sum_a[o] = prod;
  p.sum_h[o] = h;
}

__global__ void __launch_bounds__(THREADS) rglru_carry(const Args p) {
  int b, ch, w;
  if (!place(p, 1, b, ch, w)) return;
  const int n = p.chunks - 1;
  float h = p.h0 ? p.h0[b * p.shb + w] : 0.f;
  const long long o = (long long)b * n * p.W + w;
#pragma unroll 1
  for (int c0 = 0; c0 < n; c0 += UNROLL) {
    float a[UNROLL], s[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (c0 + u < n) {
        a[u] = p.sum_a[o + (long long)(c0 + u) * p.W];
        s[u] = p.sum_h[o + (long long)(c0 + u) * p.W];
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (c0 + u < n) {
        h = a[u] * h + s[u];
        p.sum_h[o + (long long)(c0 + u) * p.W] = h;
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS) rglru_output(const Args p) {
  int b, ch, w;
  if (!place(p, p.chunks, b, ch, w)) return;
  const float neg_c_sp = -p.c * softplus_f(p.a_param[w]);
  float h = ch ? __ldg(p.sum_h + ((long long)b * (p.chunks - 1) + ch - 1)
                                     * p.W + w)
               : p.h0 ? p.h0[b * p.shb + w] : 0.f;
  const long long t0 = (long long)ch * CHUNK;
  const int steps = min(CHUNK, p.L - ch * CHUNK);
  const float* px = p.xr + b * p.sxb + t0 * p.sxl + w;
  const float* pa = p.ga + b * p.sab + t0 * p.sal + w;
  const float* pi = p.gx + b * p.sgb + t0 * p.sgl + w;
  const float* pq = p.gate + b * p.sqb + t0 * p.sql + w;
  float* py = p.y + ((long long)b * p.L + t0) * p.W + w;
#pragma unroll 1
  for (int s = 0; s < steps; s += UNROLL) {
    float x[UNROLL], ga[UNROLL], gx[UNROLL], q[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (s + u < steps) {
        x[u] = __ldg(px + (s + u) * p.sxl);
        ga[u] = __ldg(pa + (s + u) * p.sal);
        gx[u] = __ldg(pi + (s + u) * p.sgl);
        q[u] = __ldg(pq + (s + u) * p.sql);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (s + u < steps) {
        float a, g;
        coefficients(neg_c_sp, x[u], ga[u], gx[u], a, g);
        h = a * h + g;
        py[(long long)(s + u) * p.W] = h * q[u];
      }
    }
  }
  if (ch == p.chunks - 1) p.hT[(long long)b * p.W + w] = h;
}

}  // namespace

extern "C" int rglru_chunk() { return CHUNK; }

extern "C" int rglru_scan_f32(
    const void* xr, const void* ga, const void* gx, const void* gate,
    const void* a_param, const void* h0, void* y, void* hT, void* sum_a,
    void* sum_h, int B, int L, int W, float c, long long sxb, long long sxl,
    long long sab, long long sal, long long sgb, long long sgl,
    long long sqb, long long sql, long long shb, void* stream) {
  if (B < 1 || L < 1 || W < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = (W + THREADS - 1) / THREADS;
  const long long chunks = (L + (long long)CHUNK - 1) / CHUNK;
  if ((long long)B * chunks * tiles > INT_MAX ||
      (chunks > 1 && (sum_a == nullptr || sum_h == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args args{static_cast<const float*>(xr),
                  static_cast<const float*>(ga),
                  static_cast<const float*>(gx),
                  static_cast<const float*>(gate),
                  static_cast<const float*>(a_param),
                  static_cast<const float*>(h0),
                  static_cast<float*>(y),
                  static_cast<float*>(hT),
                  static_cast<float*>(sum_a),
                  static_cast<float*>(sum_h),
                  B, L, W, static_cast<int>(chunks), static_cast<int>(tiles),
                  c, sxb, sxl, sab, sal, sgb, sgl, sqb, sql, shb};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t rc;
  if (chunks > 1) {
    rglru_summary<<<static_cast<unsigned>(B * (chunks - 1) * tiles), THREADS,
                    0, s>>>(args);
    rc = cudaGetLastError();
    if (rc != cudaSuccess) return static_cast<int>(rc);
    ++launched[0];
    rglru_carry<<<static_cast<unsigned>(B * tiles), THREADS, 0, s>>>(args);
    rc = cudaGetLastError();
    if (rc != cudaSuccess) return static_cast<int>(rc);
    ++launched[1];
  }
  rglru_output<<<static_cast<unsigned>(B * chunks * tiles), THREADS, 0, s>>>(
      args);
  rc = cudaGetLastError();
  if (rc == cudaSuccess) ++launched[2];
  return static_cast<int>(rc);
}

// the three passes' launch counts, in launch order, into out[0..2]
extern "C" void rglru_launched(long long* out) {
  for (int i = 0; i < 3; ++i) out[i] = launched[i].load();
}

extern "C" const char* rglru_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
