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
// What bounds it on an NVIDIA H100 80GB HBM3 (132 SMs, 1.98 GHz, 700 W):
// one exp per (t, d, n), S·Din·N in all (33.5 M at falcon-mamba-7B's
// prefill (1, 256, 8192, 16), 83.9 M at zamba2-2.7B's (1, 256, 5120, 64)),
// on the SFU (MUFU) at 16 a clock per SM: 8.5 and 20.4 us with the
// softplus exps.  Bytes (13.7 MB in bf16 at falcon's shape, 4.1 us at
// 3.35 TB/s) and the ~6 FLOPs per (t, d, n) (3.1 us) lie below.  The
// recurrence is sequential in t, but Bt·Din·N chains run side by side
// (131,072 and 327,680 at those shapes) and with four states a lane a
// step's chain is one FMA, so the kernel is held by throughput, not by
// its chain.  Beside the SFU two other throughputs bind: the
// shared-memory pipe, which serves a warp one 32-bit word a lane a cycle
// for the whole SM whatever the broadcast, and the issue slots.  The
// design:
//
// - Fill the card, few words a state.  NL = 4 of a channel's N states a
//   lane, N / 4 consecutive lanes a channel, 128 threads a block (64 at N
//   = 4, where one lane owns a channel), CH = 128 / (N / 4) channels a
//   block, at most 64.  At falcon's shape: 256 blocks of 4 warps, 1-2 a
//   SM, 4-8 warps; at zamba2's: 640 blocks, 4-5 a SM, 16-20 warps.
//   Registers (at most 96, `MIN_BLOCKS`) and shared memory (40 KiB a
//   block in bf16 at both) let every block be resident at once.  Two
//   states a lane would give falcon's shape twice the warps (12-16 a SM),
//   but each state then costs more shared-memory words and instructions;
//   on the card that layout was no faster at falcon's shape (PERF.md,
//   section 6), so it is not kept.
// - Stage ahead, one barrier a chunk.  Time is cut into chunks of TC
//   steps.  A chunk's rows of x and dt (the block's channels) and of B_t,
//   C_t (shared by every channel) are copied by cp.async into a ring of
//   two raw chunks, two chunks ahead of the walk.  After the barrier that
//   ends chunk k - 1, each thread converts its share of chunk k + 1 into
//   the second of two work buffers while chunk k is walked from the
//   first: (softplus(dt), dt·x) pairs, the accurate softplus once per
//   (t, d), D·x, and B_t, C_t as one word per state.  A warp done
//   converting walks on; no barrier waits for the conversion.  Where a row
//   is not aligned for 16-byte copies (a bf16 slice at an odd element, N =
//   4 in bf16), the entry point picks the kernel that stages by plain loads.
// - Few shared-memory words a state.  For bf16, (B_n, C_n) is one word
//   (two bf16 halves), read by a lane as one 16-byte load for its four
//   states; each half becomes f32 by one integer op.  f32 inputs keep B_n
//   and C_n as two f32 words (two 16-byte loads).
// - One FMUL and one MUFU a decay: A is scaled by log2(e) once, at load,
//   and each decay is ex2.approx of dt·A' (`exp2_fast`).
// - y by shuffles.  Every G = min(N / 4, 8) steps a lane holds G partial
//   sums of h·C; a reduce-scatter over the channel's lanes (G - 1
//   shuffles, then one butterfly a doubling of lanes past 8) leaves each
//   step's sum on one lane, which adds D·x and writes y.  No atomics and
//   nothing shared between blocks: two launches give identical bits.  One
//   launch a call.  The sequence is never padded (a padded step would
//   still decay the state: softplus(0) = ln 2).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attn_common.cuh"

namespace {

using attn::cp_async16;
using attn::cp_async_commit;
using attn::cp_async_wait;
using attn::exp2_fast;
using attn::from_f;
using attn::FULL;
using attn::LOG2E;
using attn::to_f;

constexpr int TC = 32;           // time steps a chunk
constexpr int NL = 4;            // states a lane
constexpr int BLOCK = 128;       // threads a block, 64 where one lane owns a channel
constexpr int MIN_BLOCKS = 5;    // resident blocks a SM the registers must allow

// The launch shape for inputs of type T and state dim N, and the shared
// memory.
template <typename T, int N>
struct Shape {
  static_assert(N % NL == 0, "whole lanes a channel");
  static constexpr int LANES = N / NL;                                  // lanes a channel
  static constexpr int CH = BLOCK / LANES < 64 ? BLOCK / LANES : 64;    // channels a block
  static constexpr int THREADS = CH * LANES;
  static constexpr int G = LANES < 8 ? LANES : 8;   // steps whose y are summed together
  static constexpr int SPREAD = LANES / G;          // lanes that end with each step's y
  // 32-bit words of B_t and C_t a lane reads a step: (B_n, C_n) as one bf16
  // pair for bf16 inputs, B_n and C_n apart for f32
  static constexpr int BCW = sizeof(T) == 2 ? NL : 2 * NL;
  // one raw chunk, in elements: x and dt rows of the block's channels, B and C rows
  static constexpr int RAW = TC * (2 * CH + 2 * N);
  // one converted chunk, in floats: (softplus(dt), dt·x) pairs, D·x, B/C words
  static constexpr int WORK = 3 * TC * CH + TC * LANES * BCW;
  // two work buffers, then a ring of two raw chunks
  static constexpr int SMEM = 2 * WORK * 4 + 2 * RAW * int(sizeof(T));
};

// JAX's softplus (logaddexp(v, 0)), without torch's threshold cut-off
__device__ __forceinline__ float softplus(float v) {
  return fmaxf(v, 0.f) + log1pf(expf(-fabsf(v)));
}

// Rows [0, nt) of COLS elements, row r at src + r·rs, into dst (rows of
// COLS); columns from `valid` on are zero-filled and not read.  VEC: by
// 16-byte cp.async (`rows_aligned` holds); else plain loads, finished when
// this returns.
template <bool VEC, int COLS, int THREADS, typename T>
__device__ __forceinline__ void stage(T* dst, const T* src, long long rs, int nt, int valid,
                                      int tid) {
  if constexpr (VEC) {
    constexpr int VE = 16 / int(sizeof(T));
    constexpr int PER = COLS / VE;                        // copies a row
    constexpr int ITEMS = (TC * PER + THREADS - 1) / THREADS;
    static_assert(COLS % VE == 0, "a row is whole 16-byte copies");
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const int i = k * THREADS + tid;
      const int r = i / PER, j = i % PER * VE;
      if (r < nt) {
        const bool in = j < valid;
        cp_async16(dst + r * COLS + j, in ? src + r * rs + j : src, in ? 16 : 0);
      }
    }
  } else {
    for (int i = tid; i < nt * COLS; i += THREADS) {
      const int r = i / COLS, j = i % COLS;
      dst[i] = j < valid ? src[r * rs + j] : from_f<T>(0.f);
    }
  }
}

// A lane's B_t and C_t words for one step (its NL states each), written
// from raw rows b and c (pack) and read back as f32 (unpack).  bf16: word
// j holds B_j in its low half and C_j in its high half; f32: B_0..B_NL-1,
// then C_0..C_NL-1.
__device__ __forceinline__ void pack_bc(float* o, const float* b, const float* c) {
#pragma unroll
  for (int j = 0; j < NL; ++j) o[j] = b[j], o[NL + j] = c[j];
}
__device__ __forceinline__ void pack_bc(float* o, const __nv_bfloat16* b,
                                        const __nv_bfloat16* c) {
  const uint32_t* bw = reinterpret_cast<const uint32_t*>(b);
  const uint32_t* cw = reinterpret_cast<const uint32_t*>(c);
  uint32_t* ow = reinterpret_cast<uint32_t*>(o);
#pragma unroll
  for (int k = 0; k < NL / 2; ++k) {
    const uint32_t u = bw[k], v = cw[k];
    ow[2 * k] = __byte_perm(u, v, 0x5410);       // (B_2k, C_2k)
    ow[2 * k + 1] = __byte_perm(u, v, 0x7632);   // (B_2k+1, C_2k+1)
  }
}

template <typename T>
__device__ __forceinline__ void unpack_bc(float (&bv)[NL], float (&cv)[NL], const float* q) {
  static_assert(NL == 4, "one 16-byte load a lane (two for f32)");
  if constexpr (sizeof(T) == 2) {
    const uint4 u = *reinterpret_cast<const uint4*>(q);
    const uint32_t w[NL] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int j = 0; j < NL; ++j) {
      bv[j] = __uint_as_float(w[j] << 16);
      cv[j] = __uint_as_float(w[j] & 0xffff0000u);
    }
  } else {
    const float4 u = *reinterpret_cast<const float4*>(q);
    const float4 v = *reinterpret_cast<const float4*>(q + 4);
    bv[0] = u.x, bv[1] = u.y, bv[2] = u.z, bv[3] = u.w;
    cv[0] = v.x, cv[1] = v.y, cv[2] = v.z, cv[3] = v.w;
  }
}

// G steps of one lane's walk from step t (PARTIAL: only the first nv
// advance the state), leaving the lane's partial sums of h·C in acc.  Per
// step: its (softplus(dt), dt·x) pair and its B_t, C_t words from shared
// memory, one FMUL and one ex2 a decay; the exps do not depend on h, so
// only h's FMA chain is sequential.
template <typename T, int N, bool PARTIAL>
__device__ __forceinline__ void walk(float (&acc)[Shape<T, N>::G], float (&h)[NL],
                                     const float (&A2)[NL], const float2* xd, const float* bc,
                                     int t, int nv, int c, int lane) {
  using Sh = Shape<T, N>;
#pragma unroll
  for (int g = 0; g < Sh::G; ++g) {
    acc[g] = 0.f;
    if (PARTIAL && g >= nv) continue;
    const float2 v = xd[(t + g) * Sh::CH + c];
    float bv[NL], cv[NL];
    unpack_bc<T>(bv, cv, bc + ((t + g) * Sh::LANES + lane) * Sh::BCW);
#pragma unroll
    for (int j = 0; j < NL; ++j) {
      h[j] = fmaf(exp2_fast(v.x * A2[j]), h[j], v.y * bv[j]);
      acc[g] = fmaf(h[j], cv[j], acc[g]);
    }
  }
}

// The G partial sums summed over the channel's LANES lanes: a
// reduce-scatter from the widest offset (each level halves the values a
// lane holds; G - 1 shuffles in all), then butterflies over the last
// SPREAD = LANES / G lanes.  Step lane / SPREAD's sum ends on each lane.
// Every shuffle is outside any branch.
template <int LANES, int G>
__device__ __forceinline__ float sum_lanes(float (&acc)[G], int lane) {
  constexpr int SPREAD = LANES / G;
#pragma unroll
  for (int half = G / 2; half >= 1; half >>= 1) {
    const int o = half * SPREAD;
    const bool up = lane & o;
#pragma unroll
    for (int i = 0; i < half; ++i) {
      const float send = up ? acc[i] : acc[i + half];
      const float keep = up ? acc[i + half] : acc[i];
      acc[i] = keep + __shfl_xor_sync(FULL, send, o);
    }
  }
#pragma unroll
  for (int o = SPREAD / 2; o >= 1; o >>= 1) acc[0] += __shfl_xor_sync(FULL, acc[0], o);
  return acc[0];
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

// Thread tid = c·LANES + lane owns states lane·NL .. lane·NL + NL - 1 of
// channel c0 + c; grid (ceil(Din / CH), Bt).  Chunk k is walked from work
// buffer k % 2 while chunk k + 1 is converted into the other and chunk k +
// 2 is in flight: one barrier a chunk.
template <typename T, int N, bool VEC>
__global__ void __launch_bounds__(Shape<T, N>::THREADS, MIN_BLOCKS) scan_kernel(ScanArgs a) {
  using Sh = Shape<T, N>;
  constexpr int LANES = Sh::LANES, CH = Sh::CH, THREADS = Sh::THREADS, G = Sh::G;
  constexpr int RAW = Sh::RAW, WORK = Sh::WORK;
  extern __shared__ __align__(16) unsigned char smem[];
  // 2 × work [(softplus(dt), dt·x) TC×CH | D·x TC×CH | B/C words TC×LANES×BCW],
  // then 2 × raw [x TC×CH | dt TC×CH | B TC×N | C TC×N]
  float* work = reinterpret_cast<float*>(smem);
  T* ring = reinterpret_cast<T*>(work + 2 * WORK);

  const int tid = threadIdx.x;
  const int b = blockIdx.y, c0 = blockIdx.x * CH;
  const int c = tid / LANES, lane = tid % LANES;
  const int d = c0 + c;
  const bool live = d < a.Din;
  const int valid = min(CH, a.Din - c0);
  const T* x = static_cast<const T*>(a.x) + b * a.xsb + c0;
  const T* dt = static_cast<const T*>(a.dt) + b * a.dsb + c0;
  const T* Bp = static_cast<const T*>(a.B) + b * a.bsb;
  const T* Cp = static_cast<const T*>(a.C) + b * a.csb;
  const long long state = (static_cast<long long>(b) * a.Din + d) * N + lane * NL;

  float A2[NL], h[NL];       // A·log2(e), so that exp(dt·A) = exp2(dt·A2)
#pragma unroll
  for (int k = 0; k < NL; ++k) {
    A2[k] = live ? a.A[static_cast<long long>(d) * N + lane * NL + k] * LOG2E : 0.f;
    h[k] = (live && a.h0) ? a.h0[state + k] : 0.f;
  }
  // a thread converts column tid % CH of every chunk (THREADS is a multiple of CH)
  const float Dc = tid % CH < valid ? a.D[c0 + tid % CH] : 0.f;

  const int n_chunks = (a.S + TC - 1) / TC;
  // chunk k's copies into ring slot k % 2 as one commit group (empty past the end)
  auto prefetch = [&](int k) {
    if (k < n_chunks) {
      const int t0 = k * TC, nt = min(TC, a.S - t0);
      T* r = ring + (k & 1) * RAW;
      stage<VEC, CH, THREADS>(r, x + t0 * a.xst, a.xst, nt, valid, tid);
      stage<VEC, CH, THREADS>(r + TC * CH, dt + t0 * a.dst, a.dst, nt, valid, tid);
      stage<VEC, N, THREADS>(r + 2 * TC * CH, Bp + t0 * a.bst, a.bst, nt, N, tid);
      stage<VEC, N, THREADS>(r + 2 * TC * CH + TC * N, Cp + t0 * a.cst, a.cst, nt, N, tid);
    }
    cp_async_commit();
  };
  // chunk k from ring slot k % 2 into work buffer k % 2: (softplus(dt),
  // dt·x) pairs, D·x, and each lane's B/C words
  auto convert = [&](int k) {
    const int nt = min(TC, a.S - k * TC);
    const T* xr = ring + (k & 1) * RAW;
    const T* dr = xr + TC * CH;
    const T* br = dr + TC * CH;
    const T* cr = br + TC * N;
    float* w = work + (k & 1) * WORK;
    float2* xd = reinterpret_cast<float2*>(w);
    float* Dx = w + 2 * TC * CH;
    float* bc = w + 3 * TC * CH;
#pragma unroll 4
    for (int m = 0; m < TC * CH / THREADS; ++m) {
      const int i = m * THREADS + tid;   // i = t·CH + tid % CH
      if (i < nt * CH) {
        const float xv = to_f(xr[i]), dv = softplus(to_f(dr[i]));
        xd[i] = make_float2(dv, dv * xv);
        Dx[i] = Dc * xv;
      }
    }
#pragma unroll 4
    for (int m = 0; m < (TC * LANES + THREADS - 1) / THREADS; ++m) {
      const int i = m * THREADS + tid;   // i = t·LANES + l
      if (i < nt * LANES) {
        const int t = i / LANES, l = i % LANES;
        pack_bc(bc + i * Sh::BCW, br + t * N + l * NL, cr + t * N + l * NL);
      }
    }
  };

  prefetch(0);
  prefetch(1);
  cp_async_wait<1>();
  __syncthreads();   // chunk 0 staged by every thread
  if (n_chunks > 0) convert(0);
  // each G steps end with step idx's y on this lane (one of SPREAD lanes stores it)
  const int idx = lane / Sh::SPREAD;
  const bool stores = live && lane % Sh::SPREAD == 0;
  T* yl = static_cast<T*>(a.y) + (static_cast<long long>(b) * a.S + idx) * a.Din + d;
  for (int k = 0; k < n_chunks; ++k) {
    const int t0 = k * TC, nt = min(TC, a.S - t0);
    cp_async_wait<0>();
    __syncthreads();   // chunk k converted, chunk k + 1 staged, chunk k - 1 walked by every thread
    prefetch(k + 2);   // into chunk k's slot
    if (k + 1 < n_chunks) convert(k + 1);

    const float* w = work + (k & 1) * WORK;
    const float2* xd = reinterpret_cast<const float2*>(w);
    const float* Dx = w + 2 * TC * CH + idx * CH + c;   // D·x of step idx of each G
    const float* bc = w + 3 * TC * CH;
    T* yc = yl + static_cast<long long>(t0) * a.Din;
    float acc[G];
    if (nt == TC) {   // a whole chunk: every group known to the compiler
#pragma unroll
      for (int t = 0; t < TC; t += G) {
        walk<T, N, false>(acc, h, A2, xd, bc, t, G, c, lane);
        const float yv = sum_lanes<LANES, G>(acc, lane);
        if (stores) yc[t * a.Din] = from_f<T>(yv + Dx[t * CH]);
      }
    } else {
      for (int t = 0; t < nt; t += G) {
        walk<T, N, true>(acc, h, A2, xd, bc, t, nt - t, c, lane);
        const float yv = sum_lanes<LANES, G>(acc, lane);
        if (stores && t + idx < nt) yc[t * a.Din] = from_f<T>(yv + Dx[t * CH]);
      }
    }
  }
  cp_async_wait<0>();   // no copy outlives the block (the groups past the end are empty)
  if (live) {
#pragma unroll
    for (int k = 0; k < NL; ++k) a.h_final[state + k] = h[k];
  }
}

template <typename T, int N, bool VEC>
int launch(const ScanArgs& a, int Bt, cudaStream_t stream) {
  using Sh = Shape<T, N>;
  constexpr int smem = Sh::SMEM;
  static bool configured = false;   // once per instantiation: above 48 KB needs the opt-in
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(scan_kernel<T, N, VEC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(scan_kernel<T, N, VEC>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const dim3 grid((a.Din + Sh::CH - 1) / Sh::CH, Bt);
  scan_kernel<T, N, VEC><<<grid, Sh::THREADS, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// 16-byte copies fit when every row start of x, dt (at the block's first
// channel), B and C is 16-byte aligned and Din is whole copies, so that no
// copy straddles its end (rows of CH channels and of N states being whole
// copies is checked where the kernel is chosen).
template <typename T>
bool rows_aligned(const ScanArgs& a) {
  constexpr int VE = 16 / int(sizeof(T));
  auto row = [](const void* p, long long sb, long long st) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0 && sb % VE == 0 && st % VE == 0;
  };
  return a.Din % VE == 0 && row(a.x, a.xsb, a.xst) && row(a.dt, a.dsb, a.dst) &&
         row(a.B, a.bsb, a.bst) && row(a.C, a.csb, a.cst);
}

template <typename T, int N>
int dispatch_copies(const ScanArgs& a, int Bt, cudaStream_t stream) {
  constexpr int VE = 16 / int(sizeof(T));
  if constexpr (N % VE == 0 && Shape<T, N>::CH % VE == 0) {
    if (rows_aligned<T>(a)) return launch<T, N, true>(a, Bt, stream);
  }
  return launch<T, N, false>(a, Bt, stream);
}

template <typename T>
int dispatch(int N, const ScanArgs& a, int Bt, cudaStream_t stream) {
  switch (N) {
    case 4: return dispatch_copies<T, 4>(a, Bt, stream);
    case 8: return dispatch_copies<T, 8>(a, Bt, stream);
    case 16: return dispatch_copies<T, 16>(a, Bt, stream);
    case 64: return dispatch_copies<T, 64>(a, Bt, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x, dt (Bt,S,Din) with unit stride on Din; B, C (Bt,S,N) with unit stride
// on N; strides in elements for the batch and time axes.  A (Din,N), D
// (Din,), h0 (Bt,Din,N) or null, y (Bt,S,Din) and h_final (Bt,Din,N):
// contiguous; A, D, h0 and h_final f32.  dtype of x, dt, B, C and y:
// 0 = float32, 1 = bfloat16.  Returns cudaErrorInvalidValue for an N
// other than 4, 8, 16 or 64, else cudaGetLastError() after the launch (0 on
// success).
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
