// Flash-attention backward for Hopper (sm_90a), f32 and bf16.
//
// Replaces the TPU kernel `_bwd_kernel` (src/repro/kernels/flash_attention_bwd.py,
// driven by `ops.flash_attention_bwd`); in the port it is the backward of
// `layers.blocked_attention`, the counterpart of the custom VJP `_flash_bwd`.
//
// What it computes, per (batch, query head), from q, k, v, o, do and the
// forward's lse (B, Hq, S) f32:
//   delta = rowsum(do · o)                       (f32)
//   p     = exp(scale · q kᵀ − lse), masked to 0  (q unscaled and unrounded, in f32)
//   dv    = Σ pᵀ do,   ds = p ⊙ (do vᵀ − delta) · scale,
//   dk    = Σ dsᵀ q,   dq = Σ ds k
// with GQA (query head h reads KV head h / (Hq / Hkv)) and, when causal,
// the top-left aligned mask key <= q_offset + q_pos of `layers._attn_mask`.
// dk and dv come out in Hkv heads, summed over each head's group of query
// heads in f32 and rounded once.
//
// What bounds it on this card: at the training shape (B = 4, S = T = 512,
// Hq = 14, Hkv = 2, D = 64, causal) the work is ~17 MB of inputs and
// outputs against ~4.7 GFLOP (10·D per visible query-key pair), so the
// memory bound (~5.0 us) is just above the bf16 tensor-core bound
// (~4.8 us).  The bf16 path therefore runs its five products on the
// tensor cores; the f32 path keeps f32 FMAs on the CUDA cores (never
// TF32: its tolerance, 2e-5, and the card-vs-CPU f32 train-step parity
// rule out rounded operands).  PERF.md has both paths' times.
//
// The trap in the TPU kernel: `_bwd_kernel` accumulates dq by
// read-modify-write of its output block across the KV grid axis, and dk/dv
// in VMEM scratch across the q axis; both rely on the TPU running its grid
// in order.  Here blocks run at once and in any order, so the work is
// split into launches, none of which writes what another block writes (no
// atomics, deterministic), and each KV head's dk and dv are summed over
// its group of query heads in f32 and rounded once.  Inputs are read in
// place through the caller's strides (unit stride on D, 16-byte aligned
// rows); there is no padding, so the ragged edges are zero-filled loads
// and bounds checks, not the +1e30 lse pad rows of the TPU wrapper.
//
// bf16 path (tensor cores: mma.sync.m16n8k16, bf16 operands, f32
// accumulators; 4 warps a block, 16 rows a warp), two or three launches:
//   1. dq: one block per (query head, batch, tile of 64 rows), heaviest
//      causal tiles first.  It first forms delta = rowsum(do · o) of its
//      rows and writes it for launch 2.  K and V tiles of 64 keys are
//      double-buffered by cp.async; S = Q Kᵀ, dP = dO Vᵀ, then dQ += dS K
//      with dS taken from the accumulators.
//   2. dk, dv: one block per (query head, batch, tile of 64 keys),
//      heaviest causal tiles first.  K and V stay in shared memory; the
//      block walks the tiles of BR rows that see its keys, the next tile's
//      Q, dO, lse and delta loaded by cp.async while this one is
//      contracted.  Each warp forms Sᵀ = K Qᵀ and dPᵀ = V dOᵀ for its 16
//      keys, so Pᵀ and dSᵀ come out of the accumulators in the layout of
//      the A operand of dV += Pᵀ dO and dK += dSᵀ Q and never touch shared
//      memory.  With a group of 1 the block writes dk and dv; otherwise it
//      writes f32 partials for launch 3.  (One query head a block was the
//      fastest of the group splits measured at the training shape, the
//      whole group in one block the slowest: PERF.md.)
//   3. group sum (groups above 1): the partials summed in head order.
//   The one change to the arithmetic: P and dS are rounded to bf16 once,
//   as operands of dV, dK and dQ (as every Hopper flash backward does);
//   S and dP are exact products of the bf16 inputs, summed in f32.
//
// f32 path (CUDA cores, 8 warps a block, tiles of 32), four launches:
//   1. delta, each row read 16 bytes a lane.
//   2. dk, dv per query head: one block per (batch, query head, tile of 32
//      keys), looping over the tiles of 32 query rows that can see it;
//      each thread keeps D/8 dims of one key's dk and dv in registers and
//      writes them once, in f32, to a (B, T, Hq, D) scratch.
//   3. dq: one block per (batch, query head, tile of 32 rows), heaviest
//      causal tiles first, looping over the KV tiles its rows can see.
//   4. group sum: the scratch summed in head order.
//   2 and 3 form the 32×32 tiles of p and ds with the same routine
//   (`score_tile`: lane j owns key j, each warp 4 rows) into shared memory,
//   then contract them on the CUDA cores.
#include "attn_common.cuh"

namespace {

constexpr int NW = 8;             // warps per block
constexpr int NT = NW * 32;       // threads per block
constexpr int R = 32;             // query rows per tile
constexpr int BK = 32;            // keys per tile (one per lane in score_tile)
constexpr int RW = R / NW;        // rows per warp in score_tile
constexpr int PS = BK + 1;        // padded row of the p / ds tiles
constexpr int TPK = NT / BK;      // threads per key (dk/dv) or per row (dq): 8

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;
  float* delta;
  void* dq;
  void* dk;
  void* dv;
  float* dk_part;   // (B, T, Hq, D) f32 scratch: each query head's dk (group sum)
  float* dv_part;   // the same for dv
  int S, T, Hq, Hkv;
  long long qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, osb, oss, osh;
  long long dosb, doss, dosh, dqsb, dqss, dqsh, dksb, dkss, dksh, dvsb, dvss, dvsh;
  int causal, q_offset;
  float scale;
};

// Shared memory of kernels 2 and 3, in floats.
template <int D>
struct Smem {
  static constexpr int KS = D + 4;   // padded row: conflict-free 16-byte reads by key
  static constexpr int FLOATS = 2 * R * KS + 2 * BK * KS + 2 * R * PS + 2 * R;
  static constexpr int BYTES = FLOATS * 4;
  float *qs, *dos, *ks, *vs, *ps, *dss, *lse, *delta;
  __device__ explicit Smem(float* base) {
    qs = base;
    dos = qs + R * KS;
    ks = dos + R * KS;
    vs = ks + BK * KS;
    ps = vs + BK * KS;
    dss = ps + R * PS;
    lse = dss + R * PS;
    delta = lse + R;
  }
};

// Copy rows [0, n) of a (rows, D) tile at `src` (row stride `rs`) into
// shared memory as f32 with row stride KS; rows [n, rows) become 0.
template <int D, typename T>
__device__ __forceinline__ void stage(float* dst, const T* src, long long rs, int rows, int n) {
  constexpr int KS = D + 4;
  for (int i = threadIdx.x; i < rows * D / 4; i += NT) {
    const int r = i / (D / 4), c = 4 * (i % (D / 4));
    const float4 x = r < n ? attn::load4(src + r * rs + c) : make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(dst + r * KS + c) = x;
  }
}

// q/do rows [i0, i0 + n) of one head, with their lse and delta.
template <int D, typename T>
__device__ __forceinline__ void stage_rows(const Smem<D>& sm, const BwdArgs& a, int b, int h,
                                           int i0, int n) {
  const T* q = static_cast<const T*>(a.q) + b * a.qsb + h * a.qsh + i0 * a.qss;
  const T* dout = static_cast<const T*>(a.dout) + b * a.dosb + h * a.dosh + i0 * a.doss;
  stage<D>(sm.qs, q, a.qss, R, n);
  stage<D>(sm.dos, dout, a.doss, R, n);
  if (threadIdx.x < R) {
    const long long row = ((long long)b * a.Hq + h) * a.S + i0 + threadIdx.x;
    const bool live = threadIdx.x < n;
    sm.lse[threadIdx.x] = live ? a.lse[row] : 0.f;
    sm.delta[threadIdx.x] = live ? a.delta[row] : 0.f;
  }
}

// k/v keys [t0, t0 + n) of one KV head.
template <int D, typename T>
__device__ __forceinline__ void stage_keys(const Smem<D>& sm, const BwdArgs& a, int b, int hk,
                                           int t0, int n) {
  const T* k = static_cast<const T*>(a.k) + b * a.ksb + hk * a.ksh + t0 * a.kss;
  const T* v = static_cast<const T*>(a.v) + b * a.vsb + hk * a.vsh + t0 * a.vss;
  stage<D>(sm.ks, k, a.kss, BK, n);
  stage<D>(sm.vs, v, a.vss, BK, n);
}

// p and ds of the staged tiles: query rows i0 + [0, nrows) against keys
// t0 + [0, nkeys).  Lane j owns key j; warp w owns rows w·RW + [0, RW).
// Entries outside the tile or the mask are 0.
template <int D>
__device__ __forceinline__ void score_tile(const Smem<D>& sm, const BwdArgs& a, int i0,
                                           int nrows, int t0, int nkeys) {
  constexpr int KS = Smem<D>::KS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float s[RW], dp[RW];
#pragma unroll
  for (int r = 0; r < RW; ++r) s[r] = dp[r] = 0.f;
  const float* kr = sm.ks + lane * KS;
  const float* vr = sm.vs + lane * KS;
  const float* qw = sm.qs + warp * RW * KS;
  const float* dw = sm.dos + warp * RW * KS;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    const float4 kx = *reinterpret_cast<const float4*>(kr + d);
    const float4 vx = *reinterpret_cast<const float4*>(vr + d);
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      const float4 qx = *reinterpret_cast<const float4*>(qw + r * KS + d);
      const float4 gx = *reinterpret_cast<const float4*>(dw + r * KS + d);
      s[r] = fmaf(qx.x, kx.x, s[r]);
      s[r] = fmaf(qx.y, kx.y, s[r]);
      s[r] = fmaf(qx.z, kx.z, s[r]);
      s[r] = fmaf(qx.w, kx.w, s[r]);
      dp[r] = fmaf(gx.x, vx.x, dp[r]);
      dp[r] = fmaf(gx.y, vx.y, dp[r]);
      dp[r] = fmaf(gx.z, vx.z, dp[r]);
      dp[r] = fmaf(gx.w, vx.w, dp[r]);
    }
  }
  const int key = t0 + lane;
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    const int row = warp * RW + r;
    const bool ok = row < nrows && lane < nkeys && (!a.causal || key <= a.q_offset + i0 + row);
    const float p = ok ? expf(a.scale * s[r] - sm.lse[row]) : 0.f;
    sm.ps[row * PS + lane] = p;
    sm.dss[row * PS + lane] = p * (dp[r] - sm.delta[row]) * a.scale;
  }
}

// 16 bytes of x and y: their dot product in f32.
__device__ __forceinline__ float dot16(const float* x, const float* y) {
  const float4 a = *reinterpret_cast<const float4*>(x), b = *reinterpret_cast<const float4*>(y);
  return fmaf(a.x, b.x, fmaf(a.y, b.y, fmaf(a.z, b.z, a.w * b.w)));
}
__device__ __forceinline__ float dot16(const __nv_bfloat16* x, const __nv_bfloat16* y) {
  const uint4 a = *reinterpret_cast<const uint4*>(x), b = *reinterpret_cast<const uint4*>(y);
  const __nv_bfloat162* pa = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* pb = reinterpret_cast<const __nv_bfloat162*>(&b);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 fa = __bfloat1622float2(pa[i]), fb = __bfloat1622float2(pb[i]);
    s = fmaf(fa.x, fb.x, fmaf(fa.y, fb.y, s));
  }
  return s;
}

// Lanes per row of the delta pass: the row's 16-byte chunks, rounded up
// to a power of two.
template <typename T, int D>
__host__ __device__ constexpr int delta_lanes() {
  constexpr int CH = D * sizeof(T) / 16;
  return CH <= 2 ? 2 : CH <= 4 ? 4 : CH <= 8 ? 8 : CH <= 16 ? 16 : 32;
}

// f32 1. delta[b, h, s] = Σ_d do · o: each row (b, s, h) read by TPR lanes,
// 16 bytes each, and reduced by shuffles.
template <typename T, int D>
__global__ void __launch_bounds__(NT) bwd_delta_kernel(BwdArgs a, int B) {
  constexpr int V = 16 / sizeof(T), CH = D / V, TPR = delta_lanes<T, D>();
  const long long w = ((long long)blockIdx.x * NT + threadIdx.x) / TPR;
  const int c = threadIdx.x % TPR;
  const bool live = w < (long long)B * a.S * a.Hq;
  float acc = 0.f;
  if (live && c < CH) {
    const int h = w % a.Hq, s = (w / a.Hq) % a.S, b = w / ((long long)a.Hq * a.S);
    acc = dot16(static_cast<const T*>(a.dout) + b * a.dosb + s * a.doss + h * a.dosh + c * V,
                static_cast<const T*>(a.o) + b * a.osb + s * a.oss + h * a.osh + c * V);
  }
#pragma unroll
  for (int off = TPR / 2; off; off >>= 1) acc += __shfl_xor_sync(attn::FULL, acc, off);
  if (live && c == 0) {
    const int h = w % a.Hq, s = (w / a.Hq) % a.S;
    const long long b = w / ((long long)a.Hq * a.S);
    a.delta[(b * a.Hq + h) * a.S + s] = acc;
  }
}

// f32 2. dk, dv of one tile of BK keys against one query head, to the scratch.
template <typename T, int D>
__global__ void __launch_bounds__(NT) bwd_dkdv_kernel(BwdArgs a) {
  constexpr int KS = Smem<D>::KS, DC = D / TPK;
  extern __shared__ float4 smem_raw[];
  const Smem<D> sm(reinterpret_cast<float*>(smem_raw));
  const int b = blockIdx.z, h = blockIdx.y, t0 = blockIdx.x * BK;
  const int nkeys = min(BK, a.T - t0);
  const int hk = h / (a.Hq / a.Hkv);
  const int j = threadIdx.x / TPK, c = threadIdx.x % TPK;   // this thread: key j, dims c + 8i

  stage_keys<D, T>(sm, a, b, hk, t0, nkeys);
  float dk[DC], dv[DC];
#pragma unroll
  for (int i = 0; i < DC; ++i) dk[i] = dv[i] = 0.f;

  const int i_start = a.causal ? max(0, t0 - a.q_offset) : 0;   // first row that sees key t0
  for (int i0 = i_start; i0 < a.S; i0 += R) {
    const int nrows = min(R, a.S - i0);
    __syncthreads();                         // the last update is done with the tiles
    stage_rows<D, T>(sm, a, b, h, i0, nrows);
    __syncthreads();
    score_tile<D>(sm, a, i0, nrows, t0, nkeys);
    __syncthreads();
    for (int r = 0; r < nrows; ++r) {
      const float p = sm.ps[r * PS + j], ds = sm.dss[r * PS + j];
      const float* dor = sm.dos + r * KS + c;
      const float* qr = sm.qs + r * KS + c;
#pragma unroll
      for (int i = 0; i < DC; ++i) {
        dv[i] = fmaf(p, dor[TPK * i], dv[i]);
        dk[i] = fmaf(ds, qr[TPK * i], dk[i]);
      }
    }
  }
  if (j >= nkeys) return;
  const long long off = (((long long)b * a.T + t0 + j) * a.Hq + h) * D + c;
#pragma unroll
  for (int i = 0; i < DC; ++i) {
    a.dk_part[off + TPK * i] = dk[i];
    a.dv_part[off + TPK * i] = dv[i];
  }
}

// 4 (f32), 3 (bf16). dk, dv = the scratch summed over each KV head's group
// of query heads; one thread per output element (b, t, KV head, d), d fastest.
template <typename T, int D>
__global__ void __launch_bounds__(NT) bwd_group_sum_kernel(BwdArgs a, int B) {
  const long long e = (long long)blockIdx.x * NT + threadIdx.x;
  if (e >= (long long)B * a.T * a.Hkv * D) return;
  const int d = e % D, hk = (e / D) % a.Hkv;
  const long long bt = e / ((long long)D * a.Hkv);
  const int t = bt % a.T, b = bt / a.T;
  const int group = a.Hq / a.Hkv;
  const long long src = (bt * a.Hq + (long long)hk * group) * D + d;
  float sk = 0.f, sv = 0.f;
  for (int g = 0; g < group; ++g) {
    sk += a.dk_part[src + (long long)g * D];
    sv += a.dv_part[src + (long long)g * D];
  }
  static_cast<T*>(a.dk)[b * a.dksb + t * a.dkss + hk * a.dksh + d] = attn::from_f<T>(sk);
  static_cast<T*>(a.dv)[b * a.dvsb + t * a.dvss + hk * a.dvsh + d] = attn::from_f<T>(sv);
}

// f32 3. dq of one tile of R rows of one query head.
template <typename T, int D>
__global__ void __launch_bounds__(NT) bwd_dq_kernel(BwdArgs a) {
  constexpr int KS = Smem<D>::KS, DC = D / TPK;
  extern __shared__ float4 smem_raw[];
  const Smem<D> sm(reinterpret_cast<float*>(smem_raw));
  const int b = blockIdx.z, h = blockIdx.y;
  const int i0 = (gridDim.x - 1 - blockIdx.x) * R;   // last (heaviest causal) tiles first
  const int nrows = min(R, a.S - i0);
  const int hk = h / (a.Hq / a.Hkv);
  const int r = threadIdx.x / TPK, c = threadIdx.x % TPK;   // this thread: row r, dims c + 8i

  stage_rows<D, T>(sm, a, b, h, i0, nrows);
  float dq[DC];
#pragma unroll
  for (int i = 0; i < DC; ++i) dq[i] = 0.f;

  const int kmax = a.causal ? min(a.T, a.q_offset + i0 + nrows) : a.T;   // keys any row sees
  for (int t0 = 0; t0 < kmax; t0 += BK) {
    const int nkeys = min(BK, kmax - t0);
    __syncthreads();                         // the last update is done with the tiles
    stage_keys<D, T>(sm, a, b, hk, t0, nkeys);
    __syncthreads();
    score_tile<D>(sm, a, i0, nrows, t0, nkeys);
    __syncthreads();
    const float* dsr = sm.dss + r * PS;
    for (int jj = 0; jj < nkeys; ++jj) {
      const float ds = dsr[jj];
      const float* kr = sm.ks + jj * KS + c;
#pragma unroll
      for (int i = 0; i < DC; ++i) dq[i] = fmaf(ds, kr[TPK * i], dq[i]);
    }
  }
  if (r >= nrows) return;
  T* dqp = static_cast<T*>(a.dq) + b * a.dqsb + h * a.dqsh + (i0 + r) * a.dqss;
#pragma unroll
  for (int i = 0; i < DC; ++i) dqp[c + TPK * i] = attn::from_f<T>(dq[i]);
}

// -- the bf16 path: tensor cores ---------------------------------------------

using bf16 = __nv_bfloat16;
using attn::exp2_fast;
using attn::LOG2E;
constexpr int TW = 4;            // warps per block
constexpr int TT = TW * 32;      // threads per block
constexpr int TBK = 16 * TW;     // keys per dk/dv block, 16 per warp
constexpr int TBQ = 16 * TW;     // query rows per dq block, 16 per warp
constexpr int TKQ = 64;          // keys per tile of the dq pass

template <int D>
struct Tc {
  static constexpr int LD = attn::TC_LD<D>;      // bf16 row in shared memory
  static constexpr int BR = D <= 64 ? 64 : 32;   // query rows per dk/dv tile (registers)
  // dk/dv: K, V | Q, dO [2 stages] | lse, delta [2 stages]
  static constexpr int DKDV_BYTES = (2 * TBK * LD + 2 * 2 * BR * LD) * 2 + 2 * 2 * BR * 4;
  // dq: Q, dO | K, V [2 stages]
  static constexpr int DQ_BYTES = (2 * TBQ * LD + 2 * 2 * TKQ * LD) * 2;
};

// Pᵀ and dSᵀ / scale in place of Sᵀ and dPᵀ (dk/dv pass; the caller
// applies the scale to dk once): element e of tile nt is
// key key0 + 8·(e / 2), row i0 + 8·nt + 2·t4 + e % 2.  MASK: some element
// may lie past S or T or above the causal diagonal.
template <bool MASK, int NTL>
__device__ __forceinline__ void dkdv_probs(float (&st)[NTL][4], float (&dpt)[NTL][4],
                                           const BwdArgs& a, const float* lb, const float* eb,
                                           int i0, int key0, int t4, float sl2) {
#pragma unroll
  for (int nt = 0; nt < NTL; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int rl = nt * 8 + 2 * t4 + (e & 1), row = i0 + rl, key = key0 + (e >> 1) * 8;
      const bool ok =
          !MASK || (row < a.S && key < a.T && (!a.causal || key <= a.q_offset + row));
      const float p = ok ? exp2_fast(st[nt][e] * sl2 - lb[rl] * LOG2E) : 0.f;
      dpt[nt][e] = p * (dpt[nt][e] - eb[rl]);
      st[nt][e] = p;
    }
  }
}

// dS / scale in place of S (dq pass; the caller applies the scale to dq
// once): element e of tile nt is row rows[e / 2],
// key t0 + 8·nt + 2·t4 + e % 2; lse2 is lse in log2 units.
template <bool MASK, int NTL>
__device__ __forceinline__ void dq_dscores(float (&s)[NTL][4], const float (&dp)[NTL][4],
                                           const BwdArgs& a, const int (&rows)[2],
                                           const float (&lse2)[2], const float (&del)[2],
                                           int t0, int kmax, int t4, float sl2) {
#pragma unroll
  for (int nt = 0; nt < NTL; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = rows[e >> 1], key = t0 + nt * 8 + 2 * t4 + (e & 1);
      const bool ok =
          !MASK || (row < a.S && key < kmax && (!a.causal || key <= a.q_offset + row));
      const float p = ok ? exp2_fast(s[nt][e] * sl2 - lse2[e >> 1]) : 0.f;
      s[nt][e] = p * (dp[nt][e] - del[e >> 1]);
    }
  }
}

// bf16 2. dk, dv of one tile of TBK keys against one query head.
template <int D>
__global__ void __launch_bounds__(TT) bwd_dkdv_tc_kernel(BwdArgs a) {
  using namespace attn;
  constexpr int LD = Tc<D>::LD, BR = Tc<D>::BR;
  extern __shared__ __align__(16) unsigned char smem_tc[];
  bf16* ks = reinterpret_cast<bf16*>(smem_tc);
  bf16* vs = ks + TBK * LD;
  bf16* qs = vs + TBK * LD;                                      // [2][BR][LD]
  bf16* dos = qs + 2 * BR * LD;                                  // [2][BR][LD]
  float* lse_s = reinterpret_cast<float*>(dos + 2 * BR * LD);    // [2][BR]
  float* dl_s = lse_s + 2 * BR;                                  // [2][BR]

  // key tiles on the slowest grid axis: the heaviest causal tiles (the
  // first) are scheduled first, all heads and batch rows together
  const int h = blockIdx.x, b = blockIdx.y, t0 = blockIdx.z * TBK;
  const int G = a.Hq / a.Hkv, hk = h / G;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int i_start = a.causal ? max(0, t0 - a.q_offset) : 0;   // first row that sees key t0
  const int n_tiles = i_start < a.S ? (a.S - i_start + BR - 1) / BR : 0;

  const int nkeys = min(TBK, a.T - t0);
  stage_tc<D, TT>(ks, static_cast<const bf16*>(a.k) + b * a.ksb + hk * a.ksh + t0 * a.kss,
                  a.kss, TBK, nkeys);
  stage_tc<D, TT>(vs, static_cast<const bf16*>(a.v) + b * a.vsb + hk * a.vsh + t0 * a.vss,
                  a.vss, TBK, nkeys);
  auto load_tile = [&](int j) {
    const int i0 = i_start + j * BR, buf = j & 1;
    const int n = min(BR, a.S - i0);
    stage_tc<D, TT>(qs + buf * BR * LD,
                    static_cast<const bf16*>(a.q) + b * a.qsb + h * a.qsh + i0 * a.qss, a.qss,
                    BR, n);
    stage_tc<D, TT>(dos + buf * BR * LD,
                    static_cast<const bf16*>(a.dout) + b * a.dosb + h * a.dosh + i0 * a.doss,
                    a.doss, BR, n);
    if (threadIdx.x < BR) {
      const bool live = threadIdx.x < n;
      const long long row = ((long long)b * a.Hq + h) * a.S + i0 + (live ? threadIdx.x : 0);
      cp_async4(lse_s + buf * BR + threadIdx.x, a.lse + row, live ? 4 : 0);
      cp_async4(dl_s + buf * BR + threadIdx.x, a.delta + row, live ? 4 : 0);
    }
  };

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[i][e] = dv[i][e] = 0.f;

  if (n_tiles > 0) load_tile(0);
  cp_async_commit();
  const float sl2 = a.scale * LOG2E;
  const int key0 = t0 + warp * 16 + g;          // this thread's keys: key0 and key0 + 8
  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) load_tile(j + 1);
    cp_async_commit();
    cp_async_wait<1>();                          // tile j has landed (this thread's part)
    __syncthreads();                             // ... and every thread's
    const int i0 = i_start + j * BR, buf = j & 1;
    const bf16* qb = qs + buf * BR * LD;
    const bf16* db = dos + buf * BR * LD;
    const float* lb = lse_s + buf * BR;
    const float* eb = dl_s + buf * BR;

    // Sᵀ = K Qᵀ and dPᵀ = V dOᵀ: this warp's 16 keys against BR rows
    float st[BR / 8][4], dpt[BR / 8][4];
#pragma unroll
    for (int i = 0; i < BR / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[i][e] = dpt[i][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      uint32_t ka[4], va[4];
      const int aoff = (warp * 16 + (lane & 15)) * LD + kc * 16 + (lane >> 4) * 8;
      ldsm_x4(ka, ks + aoff);
      ldsm_x4(va, vs + aoff);
#pragma unroll
      for (int np = 0; np < BR / 16; ++np) {
        uint32_t bq[4], bd[4];
        const int boff = (np * 16 + (lane & 7) + (lane >> 4) * 8) * LD + kc * 16 +
                         ((lane >> 3) & 1) * 8;
        ldsm_x4(bq, qb + boff);
        ldsm_x4(bd, db + boff);
        mma_bf16(st[2 * np], ka, bq[0], bq[1]);
        mma_bf16(st[2 * np + 1], ka, bq[2], bq[3]);
        mma_bf16(dpt[2 * np], va, bd[0], bd[1]);
        mma_bf16(dpt[2 * np + 1], va, bd[2], bd[3]);
      }
    }
    // Pᵀ and dSᵀ; no mask where the warp's 16 keys are all below T and
    // seen by every row of the tile
    const int klast = t0 + warp * 16 + 15;
    if (i0 + BR <= a.S && klast < a.T && (!a.causal || klast <= a.q_offset + i0))
      dkdv_probs<false>(st, dpt, a, lb, eb, i0, key0, t4, sl2);
    else
      dkdv_probs<true>(st, dpt, a, lb, eb, i0, key0, t4, sl2);
    // dV += Pᵀ dO, dK += dSᵀ Q: A from the registers, B stored k-major
#pragma unroll
    for (int kk = 0; kk < BR / 16; ++kk) {
      uint32_t pa[4], sa[4];
      acc_to_a(pa, st[2 * kk], st[2 * kk + 1]);
      acc_to_a(sa, dpt[2 * kk], dpt[2 * kk + 1]);
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t bd[4], bq[4];
        const int boff = (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + dp * 16 +
                         (lane >> 4) * 8;
        ldsm_x4_t(bd, db + boff);
        ldsm_x4_t(bq, qb + boff);
        mma_bf16(dv[2 * dp], pa, bd[0], bd[1]);
        mma_bf16(dv[2 * dp + 1], pa, bd[2], bd[3]);
        mma_bf16(dk[2 * dp], sa, bq[0], bq[1]);
        mma_bf16(dk[2 * dp + 1], sa, bq[2], bq[3]);
      }
    }
    __syncthreads();                             // buffer j & 1 is free for tile j + 2
  }

  // element (2·hf, 2·hf + 1) of tile dt: key key0 + 8·hf, dims 8·dt + 2·t4 + {0, 1}
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int key = key0 + 8 * hf, d = dt * 8 + 2 * t4;
      if (key >= a.T) continue;
      if (G == 1) {
        *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(a.dk) + b * a.dksb +
                                           key * a.dkss + hk * a.dksh + d) =
            __floats2bfloat162_rn(a.scale * dk[dt][2 * hf], a.scale * dk[dt][2 * hf + 1]);
        *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(a.dv) + b * a.dvsb +
                                           key * a.dvss + hk * a.dvsh + d) =
            __floats2bfloat162_rn(dv[dt][2 * hf], dv[dt][2 * hf + 1]);
      } else {
        const long long off = (((long long)b * a.T + key) * a.Hq + h) * D + d;
        *reinterpret_cast<float2*>(a.dk_part + off) =
            make_float2(a.scale * dk[dt][2 * hf], a.scale * dk[dt][2 * hf + 1]);
        *reinterpret_cast<float2*>(a.dv_part + off) = make_float2(dv[dt][2 * hf], dv[dt][2 * hf + 1]);
      }
    }
  }
}

// bf16 1. dq of one tile of TBQ rows of one query head (and its delta).
template <int D>
__global__ void __launch_bounds__(TT) bwd_dq_tc_kernel(BwdArgs a) {
  using namespace attn;
  constexpr int LD = Tc<D>::LD;
  extern __shared__ __align__(16) unsigned char smem_tc[];
  bf16* qs = reinterpret_cast<bf16*>(smem_tc);
  bf16* dos = qs + TBQ * LD;
  bf16* ks = dos + TBQ * LD;      // [2][TKQ][LD]
  bf16* vs = ks + 2 * TKQ * LD;   // [2][TKQ][LD]

  // row tiles on the slowest grid axis, the last (heaviest causal) first
  const int h = blockIdx.x, b = blockIdx.y;
  const int i0 = (gridDim.z - 1 - blockIdx.z) * TBQ;
  const int nrows = min(TBQ, a.S - i0);
  const int hk = h / (a.Hq / a.Hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int kmax = a.causal ? min(a.T, a.q_offset + i0 + nrows) : a.T;   // keys any row sees
  const int n_kt = (kmax + TKQ - 1) / TKQ;
  const bf16* kg = static_cast<const bf16*>(a.k) + b * a.ksb + hk * a.ksh;
  const bf16* vg = static_cast<const bf16*>(a.v) + b * a.vsb + hk * a.vsh;

  stage_tc<D, TT>(qs, static_cast<const bf16*>(a.q) + b * a.qsb + h * a.qsh + i0 * a.qss,
                  a.qss, TBQ, nrows);
  stage_tc<D, TT>(dos,
                  static_cast<const bf16*>(a.dout) + b * a.dosb + h * a.dosh + i0 * a.doss,
                  a.doss, TBQ, nrows);
  auto load_kt = [&](int j) {
    const int t0 = j * TKQ, n = min(TKQ, kmax - t0), buf = j & 1;
    stage_tc<D, TT>(ks + buf * TKQ * LD, kg + t0 * a.kss, a.kss, TKQ, n);
    stage_tc<D, TT>(vs + buf * TKQ * LD, vg + t0 * a.vss, a.vss, TKQ, n);
  };
  if (n_kt > 0) load_kt(0);
  cp_async_commit();

  // delta = rowsum(do · o) of the warp's 16 rows, two lanes a row, 16
  // bytes at a time; written for the dk/dv pass, which runs next
  const long long lrow = ((long long)b * a.Hq + h) * a.S;
  float delta_rr = 0.f;
  {
    constexpr int HALF = D / 16;           // 16-byte chunks per lane
    const int row = i0 + warp * 16 + (lane >> 1), c0 = (lane & 1) * HALF * 8;
    if (row < a.S) {
      const bf16* orow = static_cast<const bf16*>(a.o) + b * a.osb + h * a.osh + row * a.oss;
      const bf16* drow =
          static_cast<const bf16*>(a.dout) + b * a.dosb + h * a.dosh + row * a.doss;
#pragma unroll
      for (int c = 0; c < HALF; ++c) delta_rr += dot16(drow + c0 + 8 * c, orow + c0 + 8 * c);
    }
    delta_rr += __shfl_xor_sync(FULL, delta_rr, 1);
    if ((lane & 1) == 0 && row < a.S) a.delta[lrow + row] = delta_rr;
  }

  // this thread's rows: r0 = warp·16 + g and r0 + 8 of the tile
  const float sl2 = a.scale * LOG2E;
  int rows[2];
  float lse2[2], del[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    rows[hf] = i0 + warp * 16 + g + 8 * hf;
    lse2[hf] = rows[hf] < a.S ? a.lse[lrow + rows[hf]] * LOG2E : 0.f;
    del[hf] = __shfl_sync(FULL, delta_rr, 2 * (g + 8 * hf));
  }

  float dq[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[i][e] = 0.f;

  for (int j = 0; j < n_kt; ++j) {
    if (j + 1 < n_kt) load_kt(j + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int t0 = j * TKQ;
    const bf16* kb = ks + (j & 1) * TKQ * LD;
    const bf16* vb = vs + (j & 1) * TKQ * LD;

    // S = Q Kᵀ and dP = dO Vᵀ: this warp's 16 rows against TKQ keys
    float s[TKQ / 8][4], dp[TKQ / 8][4];
#pragma unroll
    for (int i = 0; i < TKQ / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = dp[i][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      uint32_t qa[4], da[4];
      const int aoff = (warp * 16 + (lane & 15)) * LD + kc * 16 + (lane >> 4) * 8;
      ldsm_x4(qa, qs + aoff);
      ldsm_x4(da, dos + aoff);
#pragma unroll
      for (int np = 0; np < TKQ / 16; ++np) {
        uint32_t bk[4], bv[4];
        const int boff = (np * 16 + (lane & 7) + (lane >> 4) * 8) * LD + kc * 16 +
                         ((lane >> 3) & 1) * 8;
        ldsm_x4(bk, kb + boff);
        ldsm_x4(bv, vb + boff);
        mma_bf16(s[2 * np], qa, bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], qa, bk[2], bk[3]);
        mma_bf16(dp[2 * np], da, bv[0], bv[1]);
        mma_bf16(dp[2 * np + 1], da, bv[2], bv[3]);
      }
    }
    // dS in place of S; no mask where the warp's 16 rows are all below S
    // and see every key of the tile
    const int row_first = i0 + warp * 16, klast = t0 + TKQ - 1;
    if (row_first + 16 <= a.S && klast < kmax && (!a.causal || klast <= a.q_offset + row_first))
      dq_dscores<false>(s, dp, a, rows, lse2, del, t0, kmax, t4, sl2);
    else
      dq_dscores<true>(s, dp, a, rows, lse2, del, t0, kmax, t4, sl2);
    // dQ += dS K: A from the registers, B = K stored k-major
#pragma unroll
    for (int kk = 0; kk < TKQ / 16; ++kk) {
      uint32_t sa[4];
      acc_to_a(sa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int dc = 0; dc < D / 16; ++dc) {
        uint32_t bk[4];
        ldsm_x4_t(bk, kb + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + dc * 16 +
                          (lane >> 4) * 8);
        mma_bf16(dq[2 * dc], sa, bk[0], bk[1]);
        mma_bf16(dq[2 * dc + 1], sa, bk[2], bk[3]);
      }
    }
    __syncthreads();                             // buffer j & 1 is free for tile j + 2
  }

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    if (rows[hf] >= a.S) continue;
    bf16* dqp = static_cast<bf16*>(a.dq) + b * a.dqsb + h * a.dqsh + rows[hf] * a.dqss;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
      *reinterpret_cast<__nv_bfloat162*>(dqp + dt * 8 + 2 * t4) =
          __floats2bfloat162_rn(a.scale * dq[dt][2 * hf], a.scale * dq[dt][2 * hf + 1]);
  }
}

template <typename T, int D>
int launch_delta(const BwdArgs& a, int B, cudaStream_t stream) {
  const long long threads = (long long)B * a.S * a.Hq * delta_lanes<T, D>();
  bwd_delta_kernel<T, D><<<static_cast<unsigned>((threads + NT - 1) / NT), NT, 0, stream>>>(a, B);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_group_sum(const BwdArgs& a, int B, cudaStream_t stream) {
  const long long elems = (long long)B * a.T * a.Hkv * D;
  bwd_group_sum_kernel<T, D><<<static_cast<unsigned>((elems + NT - 1) / NT), NT, 0, stream>>>(a, B);
  return static_cast<int>(cudaGetLastError());
}

// f32: CUDA cores.
template <int D>
int launch_f32(const BwdArgs& a, int B, cudaStream_t stream) {
  constexpr int bytes = Smem<D>::BYTES;
  // above 48 KB a block's shared memory must be granted once per kernel
  static const cudaError_t attr_dkdv = cudaFuncSetAttribute(
      bwd_dkdv_kernel<float, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  static const cudaError_t attr_dq = cudaFuncSetAttribute(
      bwd_dq_kernel<float, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr_dkdv != cudaSuccess) return static_cast<int>(attr_dkdv);
  if (attr_dq != cudaSuccess) return static_cast<int>(attr_dq);
  int rc = launch_delta<float, D>(a, B, stream);
  if (rc != 0) return rc;
  bwd_dkdv_kernel<float, D><<<dim3((a.T + BK - 1) / BK, a.Hq, B), NT, bytes, stream>>>(a);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  bwd_dq_kernel<float, D><<<dim3((a.S + R - 1) / R, a.Hq, B), NT, bytes, stream>>>(a);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  return launch_group_sum<float, D>(a, B, stream);
}

// bf16: tensor cores.
template <int D>
int launch_bf16(const BwdArgs& a, int B, cudaStream_t stream) {
  static const cudaError_t attr_dkdv = cudaFuncSetAttribute(
      bwd_dkdv_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, Tc<D>::DKDV_BYTES);
  static const cudaError_t attr_dq = cudaFuncSetAttribute(
      bwd_dq_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, Tc<D>::DQ_BYTES);
  if (attr_dkdv != cudaSuccess) return static_cast<int>(attr_dkdv);
  if (attr_dq != cudaSuccess) return static_cast<int>(attr_dq);
  // dq first: it also writes delta, which dk/dv reads
  bwd_dq_tc_kernel<D><<<dim3(a.Hq, B, (a.S + TBQ - 1) / TBQ), TT, Tc<D>::DQ_BYTES, stream>>>(a);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  bwd_dkdv_tc_kernel<D><<<dim3(a.Hq, B, (a.T + TBK - 1) / TBK), TT, Tc<D>::DKDV_BYTES,
                          stream>>>(a);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0 || a.Hq == a.Hkv) return rc;
  return launch_group_sum<bf16, D>(a, B, stream);
}

template <int D>
int launch(int dtype, const BwdArgs& a, int B, cudaStream_t stream) {
  if (dtype == 0) return launch_f32<D>(a, B, stream);
  if (dtype == 1) return launch_bf16<D>(a, B, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

int dispatch(int dtype, int D, const BwdArgs& a, int B, cudaStream_t stream) {
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

// q, o, do, dq (B,S,Hq,D); k, v, dk, dv (B,T,Hkv,D); all with unit stride
// on D and 16-byte aligned rows, strides in elements.  lse and delta
// (B,Hq,S) f32, contiguous; delta and dkv_part (2, B, T, Hq, D) f32,
// contiguous, are scratch that this call fills (dkv_part may be null for
// bf16 with Hq = Hkv).  dtype: 0 = float32, 1 = bfloat16.  Returns the
// first cudaGetLastError() that is not 0 (0 on success).
extern "C" int flash_attention_bwd(
    int dtype, int D, const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, float* dkv_part, void* dq, void* dk,
    void* dv, int B,
    int S, int T, int Hq, int Hkv, long long qsb, long long qss, long long qsh, long long ksb,
    long long kss, long long ksh, long long vsb, long long vss, long long vsh, long long osb,
    long long oss, long long osh, long long dosb, long long doss, long long dosh, long long dqsb,
    long long dqss, long long dqsh, long long dksb, long long dkss, long long dksh,
    long long dvsb, long long dvss, long long dvsh, int causal, int q_offset, float scale,
    void* stream) {
  if (B <= 0 || S <= 0 || T <= 0 || Hkv <= 0 || Hq % Hkv != 0 || q_offset < 0 ||
      ((dtype == 0 || Hq != Hkv) && dkv_part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  BwdArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.dout = dout;
  a.lse = lse;
  a.delta = delta;
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.dk_part = dkv_part;
  a.dv_part = dkv_part == nullptr ? nullptr : dkv_part + (long long)B * T * Hq * D;
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
  a.dosb = dosb;
  a.doss = doss;
  a.dosh = dosh;
  a.dqsb = dqsb;
  a.dqss = dqss;
  a.dqsh = dqsh;
  a.dksb = dksb;
  a.dkss = dkss;
  a.dksh = dksh;
  a.dvsb = dvsb;
  a.dvss = dvss;
  a.dvsh = dvsh;
  a.causal = causal;
  a.q_offset = q_offset;
  a.scale = scale;
  return dispatch(dtype, D, a, B, static_cast<cudaStream_t>(stream));
}
