// Mamba-1 selective scan (kernel B7) for Hopper, sm_90a.
//
// Replaces: src/repro/kernels/selective_scan.py, selective_scan_pallas
// (body _scan_kernel).
//
// Computes, per batch row b and channel d, over the state index n < N,
//     h_t = exp(dt_t * a[d, :]) * h_{t-1} + (dt_t * xi_t) * B_t
//     y_t = C_t . h_t
// from h_0 = h0[b, d, :], and returns y (B, S, D) in f32 (before the D
// skip term and the gate) and the last state h_S (B, D, N) in f32.  xi
// and dt are (B, S, D), B and C (B, S, N), all f32 or all bf16 (widened
// to f32 in the kernel); a (D, N) and h0 (B, D, N) are f32.  All
// arithmetic is f32.  Any S >= 1 and any D: the ragged D edge is masked.
//
// Bound on this card: operations, on the SFU.  Per (b, t, d, n) the scan
// does one exp and about four FP32 operations; per (b, t, d) it moves two
// input elements and one f32 output.  At Falcon-Mamba-7B's layer shape
// (B 4, S 1024, D 8192, N 16, bf16 in) that is 5.4e8 exps (0.128 ms at
// 16 per clock per SM, 132 SMs, 1.98 GHz) against 0.27 GB of traffic
// (0.080 ms at 3.35 TB/s).  The walk over S is serial, so with one
// thread per channel the card holds B * D threads, and the time is the
// latency of S dependent steps unless B * D fills it.
//
// Design, simple first.  The TPU kernel carries the state across a
// sequential grid axis and runs an associative scan inside each chunk.
// Blocks on Hopper run in no order, so nothing carries between them:
// here one thread owns one channel d of one batch row for the whole
// sequence, with h[N] and a[d, :] in registers (templated on N <= 16),
// and walks S in chunks of kChunk steps.  For each chunk the block
// stages B_t and C_t (kChunk x N, shared by all its channels) in shared
// memory, and each thread holds its kChunk values of xi and dt in
// registers.  Reads of xi and dt and writes of y are coalesced:
// neighbouring threads own neighbouring channels.  The loads are
// software-pipelined: a chunk's xi, dt, B and C are requested before the
// previous chunk is computed, so their latency hides behind its kChunk
// steps; loaded at the top of the chunk they feed, each chunk waits a
// full memory latency, which at Falcon's layer shape on an H100 doubled
// the time with bf16 inputs (PERF.md).  The decay is expf (full precision,
// <= 2 ulp) so the kernel agrees with its plain PyTorch version to
// rounding.  Later work: splitting S into chunks scanned in parallel
// with a second pass for the carry, and more threads per channel (the N
// states split across lanes) to fill the SMs at small B.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 128;  // channels per block
constexpr int kChunk = 8;      // time steps staged at once
constexpr int kMaxN = 16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
    selective_scan_kernel(const T* __restrict__ xi, const T* __restrict__ dt,
                          const T* __restrict__ bmat,
                          const T* __restrict__ cmat,
                          const float* __restrict__ a,
                          const float* __restrict__ h0, float* __restrict__ y,
                          float* __restrict__ h_out, int S, int D) {
  static_assert(kChunk * N <= kThreads,
                "each thread stages at most one B and one C value a chunk");
  __shared__ float sb[kChunk * N];
  __shared__ float sc[kChunk * N];
  const int bi = blockIdx.y;
  const int d = blockIdx.x * kThreads + threadIdx.x;
  const bool live = d < D;

  float h[N], av[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    av[n] = live ? a[(size_t)d * N + n] : 0.f;
    h[n] = live ? h0[((size_t)bi * D + d) * N + n] : 0.f;
  }

  const size_t row0 = (size_t)bi * S;  // first time step of this batch row
  // The next chunk's operands, in flight while the current one is computed.
  float xn[kChunk], dn[kChunk], bn = 0.f, cn = 0.f;
  auto load = [&](int t0) {
    const int len = min(kChunk, S - t0);
#pragma unroll
    for (int tt = 0; tt < kChunk; ++tt) {
      const bool ok = live && tt < len;
      const size_t off = (row0 + t0 + tt) * D + d;
      xn[tt] = ok ? to_f32(xi[off]) : 0.f;
      dn[tt] = ok ? to_f32(dt[off]) : 0.f;
    }
    if (threadIdx.x < len * N) {
      const size_t g = (row0 + t0) * N + threadIdx.x;
      bn = to_f32(bmat[g]);
      cn = to_f32(cmat[g]);
    }
  };

  load(0);
  for (int t0 = 0; t0 < S; t0 += kChunk) {
    const int len = min(kChunk, S - t0);
    float xv[kChunk], dv[kChunk];
#pragma unroll
    for (int tt = 0; tt < kChunk; ++tt) {
      xv[tt] = xn[tt];
      dv[tt] = dn[tt];
    }
    __syncthreads();  // every thread is done with the last chunk's B, C
    if (threadIdx.x < len * N) {
      sb[threadIdx.x] = bn;
      sc[threadIdx.x] = cn;
    }
    __syncthreads();
    if (t0 + kChunk < S) load(t0 + kChunk);
    if (!live) continue;
#pragma unroll
    for (int tt = 0; tt < kChunk; ++tt) {
      if (tt < len) {
        const float del = dv[tt];
        const float dx = del * xv[tt];
        float acc = 0.f;
#pragma unroll
        for (int n = 0; n < N; ++n) {
          h[n] = expf(del * av[n]) * h[n] + dx * sb[tt * N + n];
          acc += sc[tt * N + n] * h[n];
        }
        y[(row0 + t0 + tt) * D + d] = acc;
      }
    }
  }
  if (live) {
#pragma unroll
    for (int n = 0; n < N; ++n) h_out[((size_t)bi * D + d) * N + n] = h[n];
  }
}

template <typename T, int N>
int launch_n(const void* xi, const void* dt, const void* b, const void* c,
             const void* a, const void* h0, void* y, void* h_out, int B,
             int S, int D, cudaStream_t stream) {
  const dim3 grid((D + kThreads - 1) / kThreads, B);
  selective_scan_kernel<T, N><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(xi), static_cast<const T*>(dt),
      static_cast<const T*>(b), static_cast<const T*>(c),
      static_cast<const float*>(a), static_cast<const float*>(h0),
      static_cast<float*>(y), static_cast<float*>(h_out), S, D);
  return cudaGetLastError();
}

template <typename T>
int launch_t(const void* xi, const void* dt, const void* b, const void* c,
             const void* a, const void* h0, void* y, void* h_out, int B,
             int S, int D, int N, cudaStream_t stream) {
  switch (N) {
#define SCAN_CASE(K) \
  case K:            \
    return launch_n<T, K>(xi, dt, b, c, a, h0, y, h_out, B, S, D, stream);
    SCAN_CASE(1) SCAN_CASE(2) SCAN_CASE(3) SCAN_CASE(4)
    SCAN_CASE(5) SCAN_CASE(6) SCAN_CASE(7) SCAN_CASE(8)
    SCAN_CASE(9) SCAN_CASE(10) SCAN_CASE(11) SCAN_CASE(12)
    SCAN_CASE(13) SCAN_CASE(14) SCAN_CASE(15) SCAN_CASE(16)
#undef SCAN_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// bf16: 0 = f32 inputs, 1 = bf16 inputs.  Returns a cudaError_t code.
extern "C" int selective_scan_launch(const void* xi, const void* dt,
                                     const void* b, const void* c,
                                     const void* a, const void* h0, void* y,
                                     void* h_out, int B, int S, int D, int N,
                                     int bf16, void* stream) {
  if (B < 1 || S < 1 || D < 1 || N < 1 || N > kMaxN || B > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_t<__nv_bfloat16>(xi, dt, b, c, a, h0, y, h_out, B, S, D,
                                   N, s);
  return launch_t<float>(xi, dt, b, c, a, h0, y, h_out, B, S, D, N, s);
}

extern "C" const char* selective_scan_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
