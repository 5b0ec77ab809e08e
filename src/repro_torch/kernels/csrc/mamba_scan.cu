// Selective state-space scan (the Mamba recurrence) for Hopper (sm_90a),
// f32 and bf16 inputs, f32 state and arithmetic.
//
// Replaces the TPU kernel `_scan_kernel` (src/repro/kernels/mamba_scan.py,
// driven by `mamba_scan` there and `ops.mamba_scan`); in the port it is
// the scan of `layers.selective_scan`, the counterpart of the JAX
// `layers.selective_scan`, so it also takes an initial state h0 and
// writes the final state (the prefill's SSM cache).
//
// What it computes, for each batch row b and channel d, over t = 0..S-1:
//   dt_t = softplus(dt_raw[b,t,d])                 (max(v,0) + log1p(exp(-|v|)))
//   h[n] = exp(dt_t · A[d,n]) · h[n] + (dt_t · x[b,t,d]) · B[b,t,n]
//   y[b,t,d] = sum_n h[n] · C[b,t,n] + D[d] · x[b,t,d]
// with h starting at h0[b,d,:] (zeros when h0 is null); h_final[b,d,:] is
// h after step S-1.  y is written in the inputs' type, h_final in f32.
//
// What bounds it on this card: at the serve shapes neither bytes nor
// FLOPs, but latency.  The bytes are one read of x, dt, B, C and one
// write of y (~13.7 MB at (1, 256, 8192, 16) bf16, ~4 us at 3.35 TB/s);
// the work is S·Din·N exponentials (on the SFU) and ~6 FLOPs per
// (t, d, n).  The recurrence is sequential in t: each step of a channel
// waits on the one before, and at Bt = 1 there are few channels (8,192
// for falcon-mamba-7B, 5,120 for zamba2-2.7B) to spread over 132 SMs.
// The first version gave each channel one thread, which loaded x and dt
// at every step; this one splits a channel's N states over N / 8 lanes
// (16,384 and 40,960 threads at those shapes) and stages each chunk's x
// and dt ahead, so that no step waits on device memory (PERF.md has both
// versions' times).
//
// Design: the TPU kernel tiles channels into (bd, N) state slabs carried in
// VMEM across an in-order grid axis over sequence chunks.  Here each
// (b, d) is owned by N / 8 consecutive lanes of one warp (one lane for
// N <= 8), each keeping 8 of its N f32 states and its part of A's row in
// registers across all S steps; y_t is their sum, reduced by shuffles.
// Nothing is carried between blocks and the sequence is not padded (a
// padded step would still decay the state: softplus(0) = ln 2).  Each
// chunk of TC steps is staged in shared memory before it is walked: x and
// softplus(dt) for the block's 64 channels (coalesced along Din) and B_t,
// C_t, which every channel shares; all of a chunk's loads are in flight
// together, so a step never waits on device memory.  y is written
// coalesced along Din; A and D are read once per thread, h0 once,
// h_final written once.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int CH = 64;       // channels per block: 128 blocks at Din = 8192
constexpr int TC = 32;       // time steps staged per chunk
constexpr int NL_MAX = 8;    // states per lane: N = 16, 64 split over 2, 8 lanes

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// JAX's softplus (logaddexp(v, 0)), without torch's threshold cut-off
__device__ __forceinline__ float softplus(float v) {
  return fmaxf(v, 0.f) + log1pf(expf(-fabsf(v)));
}

struct ScanArgs {
  const void* x;
  const void* dt;
  const void* B;
  const void* C;
  const float* A;
  const float* D;
  const float* h0;
  void* y;
  float* h_final;
  int S, Din;
  long long xsb, xst, dsb, dst, bsb, bst, csb, cst;
};

// LANES = N / NL consecutive threads of a warp share one channel, each
// holding NL of its N states; y is their sum, reduced by shuffles.
template <typename T, int N>
__global__ void __launch_bounds__(CH * (N > NL_MAX ? N / NL_MAX : 1))
scan_kernel(ScanArgs a) {
  constexpr int NL = N < NL_MAX ? N : NL_MAX;
  constexpr int LANES = N / NL;
  constexpr int THREADS = CH * LANES;
  static_assert(TC * N % THREADS == 0 && TC * CH % THREADS == 0, "staging loops");
  __shared__ float bs[TC][N];
  __shared__ float cs[TC][N];
  __shared__ float xs[TC][CH];
  __shared__ float ds[TC][CH];

  const int b = blockIdx.y;
  const int c0 = blockIdx.x * CH;
  const int c = threadIdx.x / LANES, lane = threadIdx.x % LANES;
  const int d = c0 + c;
  const bool live = d < a.Din;
  const T* x = static_cast<const T*>(a.x) + b * a.xsb + c0;
  const T* dt = static_cast<const T*>(a.dt) + b * a.dsb + c0;
  const T* Bp = static_cast<const T*>(a.B) + b * a.bsb;
  const T* Cp = static_cast<const T*>(a.C) + b * a.csb;
  T* y = static_cast<T*>(a.y) + static_cast<long long>(b) * a.S * a.Din + d;
  const long long state = (static_cast<long long>(b) * a.Din + d) * N + lane * NL;

  float A[NL], h[NL];
  const float Dd = live ? a.D[d] : 0.f;
#pragma unroll
  for (int n = 0; n < NL; ++n) {
    A[n] = live ? a.A[static_cast<long long>(d) * N + lane * NL + n] : 0.f;
    h[n] = (live && a.h0) ? a.h0[state + n] : 0.f;
  }

  for (int t0 = 0; t0 < a.S; t0 += TC) {
    const int nt = min(TC, a.S - t0);
    __syncthreads();                 // every thread is done with the last chunk
    // stage the chunk: all its loads in flight at once, so each step does
    // not wait on device memory
#pragma unroll
    for (int k = 0; k < TC * N / THREADS; ++k) {
      const int i = k * THREADS + threadIdx.x;
      const int t = i / N, n = i % N;
      if (t < nt) {
        bs[t][n] = to_f(Bp[(t0 + t) * a.bst + n]);
        cs[t][n] = to_f(Cp[(t0 + t) * a.cst + n]);
      }
    }
#pragma unroll
    for (int k = 0; k < TC * CH / THREADS; ++k) {
      const int i = k * THREADS + threadIdx.x;
      const int t = i / CH, cc = i % CH;
      if (t < nt) {
        const bool in = c0 + cc < a.Din;
        xs[t][cc] = in ? to_f(x[(t0 + t) * a.xst + cc]) : 0.f;
        ds[t][cc] = in ? softplus(to_f(dt[(t0 + t) * a.dst + cc])) : 0.f;
      }
    }
    __syncthreads();
    // unrolled so that the next steps' exps, which do not depend on h,
    // overlap this step's updates: only h's FMA chain is sequential
#pragma unroll 4
    for (int t = 0; t < nt; ++t) {
      const float xv = xs[t][c], dv = ds[t][c];
      const float dx = dv * xv;
      float acc = 0.f;
#pragma unroll
      for (int n = 0; n < NL; ++n) {
        h[n] = expf(dv * A[n]) * h[n] + dx * bs[t][lane * NL + n];
        acc = fmaf(h[n], cs[t][lane * NL + n], acc);
      }
#pragma unroll
      for (int o = 1; o < LANES; o <<= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
      if (live && lane == 0) y[(t0 + t) * static_cast<long long>(a.Din)] = from_f<T>(acc + Dd * xv);
    }
  }
  if (live) {
#pragma unroll
    for (int n = 0; n < NL; ++n) a.h_final[state + n] = h[n];
  }
}

template <typename T, int N>
int launch(const ScanArgs& a, int Bt, cudaStream_t stream) {
  constexpr int THREADS = CH * (N > NL_MAX ? N / NL_MAX : 1);
  const dim3 grid((a.Din + CH - 1) / CH, Bt);
  scan_kernel<T, N><<<grid, THREADS, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int N, const ScanArgs& a, int Bt, cudaStream_t stream) {
  switch (N) {
    case 4: return launch<T, 4>(a, Bt, stream);
    case 8: return launch<T, 8>(a, Bt, stream);
    case 16: return launch<T, 16>(a, Bt, stream);
    case 64: return launch<T, 64>(a, Bt, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x, dt (Bt,S,Din) with unit stride on Din; B, C (Bt,S,N) with unit stride
// on N; strides in elements for the batch and time axes.  A (Din,N), D
// (Din,), h0 (Bt,Din,N) or null, y (Bt,S,Din) and h_final (Bt,Din,N):
// contiguous; A, D, h0 and h_final f32.  dtype of x, dt, B, C and y:
// 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the launch
// (0 on success).
extern "C" int mamba_scan(int dtype, int N, const void* x, const void* dt, const void* B,
                          const void* C, const float* A, const float* D, const float* h0,
                          void* y, float* h_final, int Bt, int S, int Din, long long xsb,
                          long long xst, long long dsb, long long dst, long long bsb,
                          long long bst, long long csb, long long cst, void* stream) {
  if (Bt <= 0 || Bt > 65535 || S < 0 || Din <= 0) return static_cast<int>(cudaErrorInvalidValue);
  ScanArgs a;
  a.x = x;
  a.dt = dt;
  a.B = B;
  a.C = C;
  a.A = A;
  a.D = D;
  a.h0 = h0;
  a.y = y;
  a.h_final = h_final;
  a.S = S;
  a.Din = Din;
  a.xsb = xsb;
  a.xst = xst;
  a.dsb = dsb;
  a.dst = dst;
  a.bsb = bsb;
  a.bst = bst;
  a.csb = csb;
  a.cst = cst;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(N, a, Bt, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(N, a, Bt, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
