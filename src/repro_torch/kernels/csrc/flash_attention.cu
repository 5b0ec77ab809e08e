// Flash-attention forward for Hopper (sm_90a), f32 and bf16.
//
// Replaces the TPU kernel `_fa_kernel` (src/repro/kernels/flash_attention.py,
// driven by `flash_attention_bhsd` and `ops.flash_attention`); in the port it
// carries the prefill attention of the dense LM and of the hybrid's shared
// block, the counterpart of `layers.blocked_attention`, and the forward of
// the autograd `FlashAttention` in every train step.
//
// What it computes: o = softmax(mask(scale · q kᵀ)) v per (batch, query head),
// with GQA (query head h reads KV head h / (Hq / Hkv), nothing repeated in
// memory), keys at or past kv_len masked, and, when causal, the top-left
// aligned mask key <= q_offset + q_pos of `layers._attn_mask`.  Optionally
// also writes lse = m + log(l) (B, Hq, S) in f32, natural log, for the
// backward.  q is scaled and rounded to the input type first, as
// `layers._flash_core` does.
//
// What bounds it on this card: at qwen2-0.5B's prefill (S = T = 256, D =
// 64) the work is ~1 MB of q/k/v/o against ~0.12 GFLOP, so the memory
// bound (~0.3 us) is above the bf16 tensor-core bound (~0.1 us); at the
// training shape (B = 4, S = T = 512) ~8.4 MB against ~1.9 GFLOP, about
// even (~2.5 us and ~1.9 us).  Neither is near: at these sizes each
// block's chain of dependent tiles (load, Q Kᵀ, softmax, P V) sets the
// time, so the bf16 path runs its products on the tensor cores and keeps
// the next tile's loads in flight behind the current one.
//
// bf16 path (tensor cores: mma.sync.m16n8k16, bf16 operands, f32
// accumulators): one block of 4 warps per (query head, batch, tile of 64
// query rows), heaviest causal tiles first; each warp owns 16 rows.  (At
// the serve shape that is 56 blocks on 132 SMs, yet fewer rows a block,
// and a KV head's group of query heads packed into the rows of one block,
// were measured slower or no faster: PERF.md.)  Each warp holds its 16 rows
// of q, scaled and rounded to bf16 once, as A fragments in registers for
// the whole walk over the keys.  K/V tiles of 64 keys are double-buffered
// by cp.async (ragged edges zero-filled) into rows padded by 16 bytes; per
// tile S = Q Kᵀ takes K through plain ldmatrix, the online softmax runs on
// the accumulators (each row's max reduced over its quad of lanes by
// shuffles outside any branch; the row sum kept per lane and reduced once
// at the end), P is rounded to bf16 once and repacked from the
// accumulators into A fragments, and O += P V takes V through
// ldmatrix.trans.  Only a tile that crosses kv_len or the causal diagonal
// of the warp's first row tests keys one by one.
//
// f32 path (CUDA cores, never TF32: its tolerance is 2e-5): one block of
// 8 warps per (q tile of 16 rows, query head, batch), each warp holding 2
// query rows; each KV tile of 32 keys is staged in shared memory in f32 by
// the whole block, and every warp folds it into its rows' online-softmax
// state (`attn::tile_update`).
#include <cmath>

#include "attn_common.cuh"

namespace {

using bf16 = __nv_bfloat16;

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

// -- f32: CUDA cores ----------------------------------------------------------

constexpr int NW = 8;          // warps per block
constexpr int R = 2;           // query rows per warp
constexpr int BQ = NW * R;     // query rows per block
constexpr int BK = 32;         // keys per tile (one per lane)

template <int D>
__global__ void __launch_bounds__(NW * 32) flash_fwd_f32_kernel(FlashArgs a) {
  using namespace attn;
  constexpr int KS = D + 4;   // padded K row: conflict-free 16-byte reads by key
  __shared__ __align__(16) float qs[BQ * D];
  __shared__ __align__(16) float ks[BK * KS];
  __shared__ __align__(16) float vs[BK * D];

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int hk = h / (a.Hq / a.Hkv);
  const float* q = static_cast<const float*>(a.q) + b * a.qsb + h * a.qsh;
  const float* k = static_cast<const float*>(a.k) + b * a.ksb + hk * a.ksh;
  const float* v = static_cast<const float*>(a.v) + b * a.vsb + hk * a.vsh;

  for (int i = threadIdx.x; i < BQ * D; i += NW * 32) {
    const int r = i / D, d = i % D, row = q0 + r;
    qs[i] = row < a.S ? q[row * a.qss + d] * a.scale : 0.f;
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
    // stage the tile in shared memory: every load of the tile is issued
    // at once, by the whole block, coalesced
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

  float* o = static_cast<float*>(a.o) + b * a.osb + h * a.osh;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (r < nrows) {
      const int row = row0 + r;
      const float l_safe = fmaxf(st.l[r], 1e-37f);
#pragma unroll
      for (int sl = 0; sl < RowState<R, D>::SLOTS; ++sl) {
        const int d = lane + 32 * sl;
        if (d < D) o[row * a.oss + d] = st.acc[r][sl] / l_safe;
      }
      if (a.lse != nullptr && lane == 0)
        a.lse[((long long)b * a.Hq + h) * a.S + row] = st.m[r] + logf(l_safe);
    }
  }
}

// -- bf16: tensor cores -------------------------------------------------------

constexpr int TW = 4;          // warps per block, 16 query rows each
constexpr int TBQ = 16 * TW;   // query rows per block
constexpr int TBK = 64;        // keys per K/V tile

template <int D>
struct FwdTc {
  static constexpr int LD = attn::TC_LD<D>;
  static constexpr int BYTES = (TBQ + 2 * 2 * TBK) * LD * 2;   // Q | K, V [2 stages]
};

// The pair of bf16 in u, each times s and rounded to bf16 again.
__device__ __forceinline__ uint32_t scale_bf16x2(uint32_t u, float s) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
  return attn::pack_bf16(f.x * s, f.y * s);
}

// One block: TBQ query rows of query head blockIdx.x, batch blockIdx.y.
template <int D>
__global__ void __launch_bounds__(TW * 32) flash_fwd_tc_kernel(FlashArgs a) {
  using namespace attn;
  constexpr int LD = FwdTc<D>::LD, NT = TW * 32;
  extern __shared__ __align__(16) unsigned char smem_fwd[];
  bf16* qs = reinterpret_cast<bf16*>(smem_fwd);   // [TBQ][LD]
  bf16* ks = qs + TBQ * LD;                       // [2][TBK][LD]
  bf16* vs = ks + 2 * TBK * LD;                   // [2][TBK][LD]

  // row tiles on the slowest grid axis, the last (heaviest causal) first
  const int h = blockIdx.x, b = blockIdx.y, i0 = (gridDim.z - 1 - blockIdx.z) * TBQ;
  const int hk = h / (a.Hq / a.Hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;

  // keys any row of the block sees
  const int kend = min(a.T, a.kv_len);
  const int kmax = a.causal ? min(kend, a.q_offset + min(i0 + TBQ, a.S)) : kend;
  const int n_kt = kmax > 0 ? (kmax + TBK - 1) / TBK : 0;

  stage_tc<D, NT>(qs, static_cast<const bf16*>(a.q) + b * a.qsb + h * a.qsh + i0 * a.qss, a.qss,
                  TBQ, min(TBQ, a.S - i0));
  cp_async_commit();
  const bf16* kg = static_cast<const bf16*>(a.k) + b * a.ksb + hk * a.ksh;
  const bf16* vg = static_cast<const bf16*>(a.v) + b * a.vsb + hk * a.vsh;
  auto load_kt = [&](int j) {
    const int t0 = j * TBK, n = min(TBK, kmax - t0), buf = j & 1;
    stage_tc<D, NT>(ks + buf * TBK * LD, kg + t0 * a.kss, a.kss, TBK, n);
    stage_tc<D, NT>(vs + buf * TBK * LD, vg + t0 * a.vss, a.vss, TBK, n);
  };
  if (n_kt > 0) load_kt(0);
  cp_async_commit();
  cp_async_wait<1>();                            // q has landed (this thread's part)
  __syncthreads();                               // ... and every thread's

  // the warp's 16 rows of q, scaled and rounded to bf16, as A fragments
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    ldsm_x4(qf[kc], qs + (warp * 16 + (lane & 15)) * LD + kc * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int i = 0; i < 4; ++i) qf[kc][i] = scale_bf16x2(qf[kc][i], a.scale);
  }

  // this thread's rows: rows[0] = row_first + g and rows[1] = rows[0] + 8
  const int row_first = i0 + warp * 16;
  const int rows[2] = {row_first + g, row_first + g + 8};
  float o[D / 8][4], m_run[2] = {NEG_BIG, NEG_BIG}, l_run[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.f;

  for (int j = 0; j < n_kt; ++j) {
    if (j + 1 < n_kt) load_kt(j + 1);
    cp_async_commit();
    cp_async_wait<1>();                          // tile j has landed (this thread's part)
    __syncthreads();                             // ... and every thread's
    const int t0 = j * TBK;
    const bf16* kb = ks + (j & 1) * TBK * LD;
    const bf16* vb = vs + (j & 1) * TBK * LD;

    // S = Q Kᵀ: the warp's 16 rows against TBK keys, K stored n-major
    float s[TBK / 8][4];
#pragma unroll
    for (int i = 0; i < TBK / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
#pragma unroll
      for (int np = 0; np < TBK / 16; ++np) {
        uint32_t bk[4];
        ldsm_x4(bk, kb + (np * 16 + (lane & 7) + (lane >> 4) * 8) * LD + kc * 16 +
                        ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * np], qf[kc], bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], qf[kc], bk[2], bk[3]);
      }
    }
    // masked keys to -inf (p = 0), only in a tile that crosses kv_len or
    // the causal diagonal of the warp's first row
    const int klast = t0 + TBK - 1;
    if (klast >= kend || (a.causal && klast > a.q_offset + row_first)) {
#pragma unroll
      for (int nt = 0; nt < TBK / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = t0 + nt * 8 + 2 * t4 + (e & 1);
          if (key >= kend || (a.causal && key > a.q_offset + rows[e >> 1]))
            s[nt][e] = -INFINITY;
        }
    }
    // online softmax; the shuffles stay outside any branch
    float corr[2], ml2[2], ls[2] = {0.f, 0.f};
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < TBK / 8; ++nt) mx = fmaxf(mx, fmaxf(s[nt][2 * hf], s[nt][2 * hf + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
      const float m_new = fmaxf(m_run[hf], mx);
      corr[hf] = exp2_fast((m_run[hf] - m_new) * LOG2E);
      m_run[hf] = m_new;
      ml2[hf] = m_new * LOG2E;
    }
#pragma unroll
    for (int nt = 0; nt < TBK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2_fast(fmaf(s[nt][e], LOG2E, -ml2[e >> 1]));
        s[nt][e] = p;
        ls[e >> 1] += p;
      }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) l_run[hf] = l_run[hf] * corr[hf] + ls[hf];
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[i][e] *= corr[e >> 1];

    // O += P V: P from the accumulators, V stored k-major
#pragma unroll
    for (int kk = 0; kk < TBK / 16; ++kk) {
      uint32_t pa[4];
      acc_to_a(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t bv[4];
        ldsm_x4_t(bv, vb + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + dp * 16 +
                          (lane >> 4) * 8);
        mma_bf16(o[2 * dp], pa, bv[0], bv[1]);
        mma_bf16(o[2 * dp + 1], pa, bv[2], bv[3]);
      }
    }
    __syncthreads();                             // buffer j & 1 is free for tile j + 2
  }

  // element (2·hf, 2·hf + 1) of tile dt: row rows[hf], dims 8·dt + 2·t4 + {0, 1}
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    l_run[hf] += __shfl_xor_sync(FULL, l_run[hf], 1);
    l_run[hf] += __shfl_xor_sync(FULL, l_run[hf], 2);
  }
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    if (rows[hf] >= a.S) continue;
    const float l_safe = fmaxf(l_run[hf], 1e-37f);
    bf16* orow = static_cast<bf16*>(a.o) + b * a.osb + rows[hf] * a.oss + h * a.osh;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
      *reinterpret_cast<__nv_bfloat162*>(orow + dt * 8 + 2 * t4) =
          __floats2bfloat162_rn(o[dt][2 * hf] / l_safe, o[dt][2 * hf + 1] / l_safe);
    if (a.lse != nullptr && t4 == 0)
      a.lse[((long long)b * a.Hq + h) * a.S + rows[hf]] = m_run[hf] + logf(l_safe);
  }
}

template <int D>
int launch(int dtype, const FlashArgs& a, int B, cudaStream_t stream) {
  if (dtype == 0) {
    flash_fwd_f32_kernel<D><<<dim3((a.S + BQ - 1) / BQ, a.Hq, B), NW * 32, 0, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  // above 48 KB a block's shared memory must be granted once per kernel
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, FwdTc<D>::BYTES);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  flash_fwd_tc_kernel<D><<<dim3(a.Hq, B, (a.S + TBQ - 1) / TBQ), TW * 32, FwdTc<D>::BYTES,
                           stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(int dtype, int D, const FlashArgs& a, int B, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<16>(dtype, a, B, stream);
    case 32: return launch<32>(dtype, a, B, stream);
    case 48: return launch<48>(dtype, a, B, stream);
    case 64: return launch<64>(dtype, a, B, stream);
    case 80: return launch<80>(dtype, a, B, stream);
    case 128: return launch<128>(dtype, a, B, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q (B,S,Hq,D), k/v (B,T,Hkv,D), o like q, all with unit stride on D and
// 16-byte aligned rows; strides in elements.  dtype: 0 = float32, 1 =
// bfloat16.  lse may be null.  Returns cudaGetLastError() after the launch
// (0 on success).
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
  return dispatch(dtype, D, a, B, static_cast<cudaStream_t>(stream));
}
