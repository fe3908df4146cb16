// Mamba-1 selective scan (kernel B7) for Hopper, sm_90a.
//
// Replaces: src/repro/kernels/selective_scan.py, selective_scan_pallas
// (body _scan_kernel).
//
// Computes, per batch row b and channel d, over the state index n < N,
//     h_t = exp(dt_t * a[d, :]) * h_{t-1} + (dt_t * xi_t) * B_t
//     y_t = C_t . h_t
// from h_0 = h0[b, d, :], and returns the last state h_S (B, D, N) in f32
// and, in one of two modes:
//   * unfused (selective_scan_launch), the TPU kernel's function: y
//     (B, S, D) in f32, before the D skip term and the gate;
//   * fused (selective_scan_fused_launch), the Mamba block's: dt is
//     softplus(dt_raw + dt_bias), and the output is
//     ((y + D * xi) rounded to T) * silu(z), rounded to T.
// xi, dt (or dt_raw), z are (B, S, D), B and C (B, S, N), dt_bias (D),
// all f32 or all bf16 (widened to f32 in the kernel); a (D, N), h0
// (B, D, N) and the D skip (D) are f32.  All arithmetic is f32.  B, C and
// z are read through their batch and row strides (views of the block's
// projections, no copies); xi and dt are contiguous.  Any S >= 1 and any
// D: the ragged D edge and the last chunk of S are masked.
//
// Bound on this card: operations, on the SFU.  Per (b, t, d, n) the scan
// does one exp and about six FP32 operations; per (b, t, d) it moves two
// or three input elements and one output.  At Falcon-Mamba-7B's layer
// shape (B 4, S 1024, D 8192, N 16, bf16 in) that is 5.4e8 exps (0.128
// ms at 16 per clock per SM, 132 SMs, 1.98 GHz) against 0.27 GB of
// traffic (0.080 ms at 3.35 TB/s).  The fused mode adds three
// transcendentals per (b, t, d) (softplus's exp and log1p, silu's exp).
//
// Design.  The TPU kernel carries the state across a sequential grid
// axis and runs an associative scan inside each chunk; Hopper's blocks
// run in no order, so one block walks the whole sequence of its
// channels.  The walk over S is serial, so the card must be filled
// across channels and states: a 128-thread block holds 32 channels, and
// each of its four warps one group of ceil(N/4) states of all 32 (lane =
// channel), with those states and that slice of a[d, :], pre-scaled by
// log2(e), in registers.  The card then holds B * D * 4 threads (~31
// warps an SM at Falcon's shape; one thread per channel gave ~8, too few
// to hide the SFU and FMA latency).  The decay is one MUFU.EX2 of
// dt * a2 (ex2.approx.ftz: <= 2 ulp, results below 2^-126 flushed to 0)
// instead of expf's ~8 instructions; the error model in
// kernels/selective_scan.py accounts for the argument's two roundings.
// S is walked in chunks of kChunk steps: the block stages the chunk's dt
// and dt * xi (and, fused, dt after its softplus, and xi) for its 32
// channels, each warp reading 32 neighbouring channels of one step
// (coalesced), and the chunk's B_t and C_t, in shared memory, where a
// warp reads its states of B_t and C_t as one broadcast float4.  The next
// chunk's operands are requested before the current chunk is computed,
// through running pointers (32-bit offsets inside a chunk), so their
// latency hides behind it.  Each warp stores its states' share of y_t in
// shared memory, and y_t = (p0 + p1) + (p2 + p3) is added in that fixed
// order (two launches give the same bits) by the thread that writes it,
// coalesced.  The fused epilogue rounds where the eager PyTorch block
// rounds (dt_raw + dt_bias, softplus, y + D * xi, silu, the product),
// with the same functions (expf, log1pf, IEEE division), so it matches
// that glue bit for bit given the same y.
//
// Measured on an H100 (PERF.md; tools/scan_variants.py): four lanes of
// one warp per channel, with a shuffle reduce-scatter of y, ran no
// faster.  The kernel takes about twice the SFU's time: the staging and
// memory half of each chunk and its recurrence overlap only in part,
// and the fused glue's full-precision expf, log1pf and division take
// about a quarter of the fused mode's time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 128;                    // threads per block
constexpr int kChannels = 32;                    // channels per block
constexpr int kGroups = kThreads / kChannels;    // state groups (warps)
constexpr int kChunk = 8;                        // time steps staged at once
constexpr int kPerThread = kChunk / kGroups;     // (t, d) a thread stages
constexpr int kMaxN = 16;
constexpr int kMinBlocks = 8;                    // 8 x 128 threads an SM
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kChannels == 32 && kGroups == 4 && kChunk % kGroups == 0,
              "a warp is one state group of 32 channels");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// v rounded to T and widened back: where the eager block stores a T tensor
template <typename T>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// F.softplus (beta 1, threshold 20) as PyTorch evaluates it in f32
__device__ __forceinline__ float softplus_f32(float v) {
  return v > 20.f ? v : log1pf(expf(v));
}

// F.silu as PyTorch evaluates it in f32: x / (1 + exp(-x))
__device__ __forceinline__ float silu_f32(float v) {
  return __fdiv_rn(v, __fadd_rn(1.f, expf(-v)));
}

// 2^v on the SFU, one MUFU.EX2
__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// K consecutive floats of shared memory, as wide vectors where aligned
template <int K>
__device__ __forceinline__ void read_states(const float* src, float (&v)[K]) {
  if constexpr (K % 4 == 0) {
#pragma unroll
    for (int i = 0; i < K / 4; ++i) {
      const float4 f = reinterpret_cast<const float4*>(src)[i];
      v[4 * i] = f.x;
      v[4 * i + 1] = f.y;
      v[4 * i + 2] = f.z;
      v[4 * i + 3] = f.w;
    }
  } else if constexpr (K % 2 == 0) {
#pragma unroll
    for (int i = 0; i < K / 2; ++i) {
      const float2 f = reinterpret_cast<const float2*>(src)[i];
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < K; ++i) v[i] = src[i];
  }
}

struct ScanArgs {
  const void* xi;
  const void* dt;        // dt, or dt_raw in the fused mode
  const void* b;
  const void* c;
  const float* a;
  const float* h0;
  const void* dt_bias;   // fused only
  const float* d_skip;   // fused only
  const void* z;         // fused only
  void* out;             // y (f32), or the gated output (T) when fused
  float* h_out;
  long long b_batch, b_row, c_batch, c_row, z_batch, z_row;  // elements
  int S, D;
};

template <typename T, int N, bool kFused>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    selective_scan_kernel(const ScanArgs p) {
  constexpr int kSpl = (N + kGroups - 1) / kGroups;  // states a warp owns
  constexpr int kNp = kSpl * kGroups;                // N padded
  constexpr int kBC = (kChunk * kNp + kThreads - 1) / kThreads;
  __shared__ __align__(16) float sb[kChunk * kNp];
  __shared__ __align__(16) float sc[kChunk * kNp];
  __shared__ float sd[kChunk][kChannels];       // dt
  __shared__ float sdx[kChunk][kChannels];      // dt * xi
  __shared__ float sx[kChunk][kChannels];       // xi, for the fused D skip
  __shared__ float sp[kGroups][kChunk][kChannels];  // y per state group

  const T* __restrict__ xi = static_cast<const T*>(p.xi);
  const T* __restrict__ dt = static_cast<const T*>(p.dt);
  const T* __restrict__ bmat = static_cast<const T*>(p.b);
  const T* __restrict__ cmat = static_cast<const T*>(p.c);
  const int S = p.S, D = p.D;
  const int bi = blockIdx.y, tid = threadIdx.x;
  // warp q owns state group q of the block's channels; lane ch owns
  // channel d0 + ch in every role (staging steps q + k * kGroups too)
  const int q = tid / kChannels, ch = tid % kChannels;
  const int d = blockIdx.x * kChannels + ch;
  const bool live = d < D;

  float h[kSpl], a2[kSpl];
#pragma unroll
  for (int j = 0; j < kSpl; ++j) {
    const int n = q * kSpl + j;
    const bool ok = live && n < N;
    a2[j] = ok ? p.a[(size_t)d * N + n] * kLog2e : 0.f;
    h[j] = ok ? p.h0[((size_t)bi * D + d) * N + n] : 0.f;
  }
  float bias = 0.f, dskip = 0.f;
  if constexpr (kFused) {
    if (live) {
      bias = to_f32(static_cast<const T*>(p.dt_bias)[d]);
      dskip = p.d_skip[d];
    }
  }

  // Running pointers at this thread's first staged step (q) of the chunk
  // being loaded; its others are k * kGroups steps further.  Offsets
  // inside a chunk are 32-bit (the launch checks that they fit).
  const size_t first = ((size_t)bi * S + q) * D + d;
  const T* xp = xi + first;
  const T* dp = dt + first;
  const T* zp = nullptr;
  if constexpr (kFused)
    zp = static_cast<const T*>(p.z) + bi * p.z_batch + q * p.z_row + d;
  const int xstep = kGroups * D, zstep = kGroups * (int)p.z_row;
  const int brow = (int)p.b_row, crow = (int)p.c_row;
  // B and C: element e = tid + k * kThreads of a chunk is step e / kNp,
  // state e % kNp
  const T* bp = bmat + bi * p.b_batch;
  const T* cp = cmat + bi * p.c_batch;
  // The next chunk's operands, in flight while the current one is computed.
  float xn[kPerThread], dn[kPerThread], zn[kPerThread], bn[kBC], cn[kBC];
  auto load = [&](int rem) {  // rem: steps of the sequence from the chunk on
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const bool ok = live && q + k * kGroups < rem;
      xn[k] = ok ? to_f32(xp[k * xstep]) : 0.f;
      dn[k] = ok ? to_f32(dp[k * xstep]) : 0.f;
      if constexpr (kFused) zn[k] = ok ? to_f32(zp[k * zstep]) : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kBC; ++k) {
      const int e = tid + k * kThreads, t = e / kNp, n = e % kNp;
      const bool ok = e < kChunk * kNp && n < N && t < rem;
      bn[k] = ok ? to_f32(bp[t * brow + n]) : 0.f;
      cn[k] = ok ? to_f32(cp[t * crow + n]) : 0.f;
    }
  };
  // the output at this thread's first staged step of the chunk computed
  const size_t ostep = (size_t)kChunk * D;
  size_t off = first;

  float sg[kPerThread];  // fused: silu(z) rounded to T, per staged (t, d)
  load(S);
  for (int t0 = 0; t0 < S; t0 += kChunk) {
    const int rem = S - t0;
    __syncthreads();  // the last chunk's scan and write-out are done
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const int tt = q + k * kGroups;
      float del = dn[k];
      if constexpr (kFused) {
        // the eager block's roundings: dt_raw + dt_bias to T, softplus
        // in f32 to T; past the sequence's end dt stays 0 (h unchanged)
        const float v = round_to<T>(__fadd_rn(dn[k], bias));
        del = live && tt < rem ? round_to<T>(softplus_f32(v)) : 0.f;
        sg[k] = round_to<T>(silu_f32(zn[k]));
      }
      sd[tt][ch] = del;
      sdx[tt][ch] = __fmul_rn(del, xn[k]);
      if constexpr (kFused) sx[tt][ch] = xn[k];
    }
#pragma unroll
    for (int k = 0; k < kBC; ++k) {
      const int e = tid + k * kThreads;
      if (e < kChunk * kNp) {
        sb[e] = bn[k];
        sc[e] = cn[k];
      }
    }
    __syncthreads();
    if (rem > kChunk) {
      xp += ostep;
      dp += ostep;
      if constexpr (kFused) zp += (long long)kChunk * p.z_row;
      bp += kChunk * brow;
      cp += kChunk * crow;
      load(rem - kChunk);
    }

    // The recurrence over this warp's states.  B_t and C_t are the same
    // for the whole warp (broadcast reads).  Steps past S (and padded
    // states, dead channels) have dt, dt * xi, B and C 0: decay 1 and
    // drive 0 leave h as it is.
#pragma unroll
    for (int tt = 0; tt < kChunk; ++tt) {
      const float del = sd[tt][ch], dx = sdx[tt][ch];
      float bv[kSpl], cv[kSpl];
      read_states<kSpl>(&sb[tt * kNp + q * kSpl], bv);
      read_states<kSpl>(&sc[tt * kNp + q * kSpl], cv);
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < kSpl; ++j) {
        h[j] = fmaf(ex2(del * a2[j]), h[j], dx * bv[j]);
        s = fmaf(cv[j], h[j], s);
      }
      sp[q][tt][ch] = s;
    }
    __syncthreads();
    // y over the four state groups, always as (p0 + p1) + (p2 + p3):
    // two launches give the same bits
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const int tt = q + k * kGroups;
      if (!live || tt >= rem) continue;
      const float y = __fadd_rn(__fadd_rn(sp[0][tt][ch], sp[1][tt][ch]),
                                __fadd_rn(sp[2][tt][ch], sp[3][tt][ch]));
      if constexpr (kFused) {
        // (y + D * xi) in f32, to T; times silu(z), to T
        const float v =
            round_to<T>(__fadd_rn(y, __fmul_rn(dskip, sx[tt][ch])));
        static_cast<T*>(p.out)[off + k * xstep] =
            from_f32<T>(__fmul_rn(v, sg[k]));
      } else {
        static_cast<float*>(p.out)[off + k * xstep] = y;
      }
    }
    off += ostep;
  }
#pragma unroll
  for (int j = 0; j < kSpl; ++j) {
    const int n = q * kSpl + j;
    if (live && n < N) p.h_out[((size_t)bi * D + d) * N + n] = h[j];
  }
}

// Launches the kernel, or with blocks_per_sm stores how many of its
// blocks an SM holds instead.
template <typename T, int N, bool kFused>
int launch_n(const ScanArgs& args, int B, cudaStream_t stream,
             int* blocks_per_sm) {
  const auto kernel = selective_scan_kernel<T, N, kFused>;
  if (blocks_per_sm != nullptr)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm,
                                                         kernel, kThreads, 0);
  const dim3 grid((args.D + kChannels - 1) / kChannels, B);
  kernel<<<grid, kThreads, 0, stream>>>(args);
  return cudaGetLastError();
}

template <typename T, bool kFused>
int launch_t(const ScanArgs& args, int B, int N, cudaStream_t stream,
             int* blocks_per_sm) {
  switch (N) {
#define SCAN_CASE(K) \
  case K:            \
    return launch_n<T, K, kFused>(args, B, stream, blocks_per_sm);
    SCAN_CASE(1) SCAN_CASE(2) SCAN_CASE(3) SCAN_CASE(4)
    SCAN_CASE(5) SCAN_CASE(6) SCAN_CASE(7) SCAN_CASE(8)
    SCAN_CASE(9) SCAN_CASE(10) SCAN_CASE(11) SCAN_CASE(12)
    SCAN_CASE(13) SCAN_CASE(14) SCAN_CASE(15) SCAN_CASE(16)
#undef SCAN_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

template <bool kFused>
int launch(const ScanArgs& args, int B, int N, int bf16, void* stream,
           int* blocks_per_sm = nullptr) {
  if (B < 1 || args.S < 1 || args.D < 1 || N < 1 || N > kMaxN || B > 65535)
    return cudaErrorInvalidValue;
  // offsets inside a chunk are 32-bit
  const long long limit = (1LL << 31) / kChunk;
  if (args.D >= limit || args.b_row >= limit || args.c_row >= limit ||
      args.z_row >= limit)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_t<__nv_bfloat16, kFused>(args, B, N, s, blocks_per_sm);
  return launch_t<float, kFused>(args, B, N, s, blocks_per_sm);
}

}  // namespace

// The TPU kernel's function: y (B, S, D) f32 and h_final.  xi, dt, b, c
// contiguous.  bf16: 0 = f32 inputs, 1 = bf16 inputs.  Returns a
// cudaError_t code.
extern "C" int selective_scan_launch(const void* xi, const void* dt,
                                     const void* b, const void* c,
                                     const void* a, const void* h0, void* y,
                                     void* h_out, int B, int S, int D, int N,
                                     int bf16, void* stream) {
  ScanArgs args{xi, dt, b, c, static_cast<const float*>(a),
                static_cast<const float*>(h0), nullptr, nullptr, nullptr, y,
                static_cast<float*>(h_out), (long long)S * N, N,
                (long long)S * N, N, 0, 0, S, D};
  return launch<false>(args, B, N, bf16, stream);
}

// The Mamba block's scan: softplus(dt_raw + dt_bias) as dt, out (B, S, D)
// in the inputs' type = ((y + d_skip * xi) to T) * silu(z), to T; and
// h_final.  b, c and z by their batch and row strides (elements), each
// row unit-stride; xi and dt_raw contiguous.
extern "C" int selective_scan_fused_launch(
    const void* xi, const void* dt_raw, const void* b, const void* c,
    const void* a, const void* h0, const void* dt_bias, const void* d_skip,
    const void* z, void* out, void* h_out, long long b_batch,
    long long b_row, long long c_batch, long long c_row, long long z_batch,
    long long z_row, int B, int S, int D, int N, int bf16, void* stream) {
  ScanArgs args{xi, dt_raw, b, c, static_cast<const float*>(a),
                static_cast<const float*>(h0), dt_bias,
                static_cast<const float*>(d_skip), z, out,
                static_cast<float*>(h_out), b_batch, b_row, c_batch, c_row,
                z_batch, z_row, S, D};
  return launch<true>(args, B, N, bf16, stream);
}

// Blocks of the (N, bf16, fused) instantiation that one SM holds, into
// *blocks.  Returns a cudaError_t code.
extern "C" int selective_scan_occupancy(int N, int bf16, int fused,
                                        int* blocks) {
  ScanArgs args{};
  args.S = args.D = 1;
  if (fused) return launch<true>(args, 1, N, bf16, nullptr, blocks);
  return launch<false>(args, 1, N, bf16, nullptr, blocks);
}

extern "C" const char* selective_scan_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
