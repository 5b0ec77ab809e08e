// Flash-attention forward for Hopper (sm_90a), f32 and bf16.
//
// Replaces the TPU kernel `_fa_kernel` (src/repro/kernels/flash_attention.py,
// driven by `flash_attention_bhsd` and `ops.flash_attention`); in the port it
// carries the prefill attention of the dense LM, the counterpart of
// `layers.blocked_attention`.
//
// What it computes: o = softmax(mask(scale · q kᵀ)) v per (batch, query head),
// with GQA (query head h reads KV head h / (Hq / Hkv), nothing repeated in
// memory), keys at or past kv_len masked, and, when causal, the top-left
// aligned mask key <= q_offset + q_pos of `layers._attn_mask`.  Optionally
// also writes lse = m + log(l) (B, Hq, S) in f32 for a later backward.
//
// What bounds it on this card: at the prefill shapes (S = T = 256, D = 64)
// the work is ~1 MB of q/k/v/o against ~0.12 GFLOP, so the card's memory
// bound (~0.3 us) is above its bf16 tensor-core bound (~0.1 us).  This
// first version is far from either: it runs its products as f32 FMAs on
// the CUDA cores, and the serve shape gives it only ~14 warps per SM, so it
// is bound by instruction latency (PERF.md has its time beside both bounds).
//
// Design: one block of 8 warps per (q tile of 16 rows, query head, batch);
// each warp holds 2 query rows (at the serve shape, more warps of fewer
// rows hide more latency than 4 warps of 4 rows did).  The block walks the
// KV tiles of 32 keys up to its causal limit in a loop -- that loop takes
// the place of the TPU's sequential innermost grid axis, so no state crosses
// blocks.  Each KV tile is staged once in shared memory (f32, K rows padded
// for conflict-free reads) by the whole block with coalesced loads, then
// every warp folds it into its rows' online-softmax state.  K and V are read
// in place through the caller's strides (no copy, no padding of D to 128 as
// the TPU wrapper needed).  Scores, m, l and the accumulator are f32
// CUDA-core FMAs: the f32 path never touches TF32.
#include "attn_common.cuh"

namespace {

constexpr int NW = 8;          // warps per block
constexpr int R = 2;           // query rows per warp
constexpr int BQ = NW * R;     // query rows per block
constexpr int BK = 32;         // keys per tile (one per lane)

struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  int S, T, Hq, Hkv;
  long long qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, osb, oss, osh;
  int causal, q_offset, kv_len;
  float scale;
};

template <typename T, int D>
__global__ void __launch_bounds__(NW * 32) flash_fwd_kernel(FlashArgs a) {
  using namespace attn;
  constexpr int KS = D + 4;   // padded K row: conflict-free 16-byte reads by key
  __shared__ __align__(16) float qs[BQ * D];
  __shared__ __align__(16) float ks[BK * KS];
  __shared__ __align__(16) float vs[BK * D];

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int hk = h / (a.Hq / a.Hkv);
  const T* q = static_cast<const T*>(a.q) + b * a.qsb + h * a.qsh;
  const T* k = static_cast<const T*>(a.k) + b * a.ksb + hk * a.ksh;
  const T* v = static_cast<const T*>(a.v) + b * a.vsb + hk * a.vsh;

  // q tile, scaled and rounded to T as `layers._flash_core` does
  for (int i = threadIdx.x; i < BQ * D; i += NW * 32) {
    const int r = i / D, d = i % D, row = q0 + r;
    qs[i] = row < a.S ? to_f(from_f<T>(to_f(q[row * a.qss + d]) * a.scale)) : 0.f;
  }
  __syncthreads();

  // keys this block needs (the union of its warps' causal limits), and
  // the keys each warp needs; a warp past its limit only helps load
  const int row0 = q0 + warp * R;
  const int nrows = min(R, a.S - row0);
  int kmax_blk = min(a.T, a.kv_len), kmax = kmax_blk;
  if (a.causal) {
    kmax_blk = min(kmax_blk, a.q_offset + min(q0 + BQ, a.S));
    kmax = min(kmax, a.q_offset + row0 + nrows);
  }

  RowState<R, D> st;
  st.init();
  const float* wq = qs + warp * R * D;
  for (int t0 = 0; t0 < kmax_blk; t0 += BK) {
    // stage the tile in shared memory in f32: every load of the tile is
    // issued at once, by the whole block, coalesced
    const int n_blk = min(BK, kmax_blk - t0);
    __syncthreads();
    for (int i = threadIdx.x; i < BK * D / 4; i += NW * 32) {
      const int r = i / (D / 4), c = 4 * (i % (D / 4));
      const bool live = r < n_blk;
      const float4 kx = live ? load4(k + (t0 + r) * a.kss + c) : make_float4(0.f, 0.f, 0.f, 0.f);
      const float4 vx = live ? load4(v + (t0 + r) * a.vss + c) : make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<float4*>(ks + r * KS + c) = kx;
      *reinterpret_cast<float4*>(vs + r * D + c) = vx;
    }
    __syncthreads();
    // a warp with no rows, or past its causal limit, folds in no keys (no
    // branch around tile_update's shuffles)
    const int n = nrows > 0 ? max(0, min(BK, kmax - t0)) : 0;
    if (a.causal)
      tile_update<R, D>(st, wq, ks, vs, KS, D, t0, n, CausalMask{a.q_offset + row0});
    else
      tile_update<R, D>(st, wq, ks, vs, KS, D, t0, n, NoMask{});
  }
  if (nrows <= 0) return;

  T* o = static_cast<T*>(a.o) + b * a.osb + h * a.osh;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (r < nrows) {
      const int row = row0 + r;
      const float l_safe = fmaxf(st.l[r], 1e-37f);
#pragma unroll
      for (int sl = 0; sl < RowState<R, D>::SLOTS; ++sl) {
        const int d = lane + 32 * sl;
        if (d < D) o[row * a.oss + d] = from_f<T>(st.acc[r][sl] / l_safe);
      }
      if (a.lse != nullptr && lane == 0)
        a.lse[((long long)b * a.Hq + h) * a.S + row] = st.m[r] + logf(l_safe);
    }
  }
}

template <typename T, int D>
int launch(const FlashArgs& a, int B, cudaStream_t stream) {
  const dim3 grid((a.S + BQ - 1) / BQ, a.Hq, B);
  flash_fwd_kernel<T, D><<<grid, NW * 32, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int D, const FlashArgs& a, int B, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(a, B, stream);
    case 32: return launch<T, 32>(a, B, stream);
    case 48: return launch<T, 48>(a, B, stream);
    case 64: return launch<T, 64>(a, B, stream);
    case 80: return launch<T, 80>(a, B, stream);
    case 128: return launch<T, 128>(a, B, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q (B,S,Hq,D), k/v (B,T,Hkv,D), o like q, all with unit stride on D;
// strides in elements.  dtype: 0 = float32, 1 = bfloat16.  lse may be null.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int flash_attention_fwd(int dtype, int D, const void* q, const void* k, const void* v,
                                   void* o, float* lse, int B, int S, int T, int Hq, int Hkv,
                                   long long qsb, long long qss, long long qsh, long long ksb,
                                   long long kss, long long ksh, long long vsb, long long vss,
                                   long long vsh, long long osb, long long oss, long long osh,
                                   int causal, int q_offset, int kv_len, float scale,
                                   void* stream) {
  if (B <= 0 || S <= 0 || T <= 0 || Hkv <= 0 || Hq % Hkv != 0 || q_offset < 0 || kv_len < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  FlashArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.lse = lse;
  a.S = S;
  a.T = T;
  a.Hq = Hq;
  a.Hkv = Hkv;
  a.qsb = qsb;
  a.qss = qss;
  a.qsh = qsh;
  a.ksb = ksb;
  a.kss = kss;
  a.ksh = ksh;
  a.vsb = vsb;
  a.vss = vss;
  a.vsh = vsh;
  a.osb = osb;
  a.oss = oss;
  a.osh = osh;
  a.causal = causal;
  a.q_offset = q_offset;
  a.kv_len = kv_len;
  a.scale = scale;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(D, a, B, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(D, a, B, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
