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
// (~4.8 us).  This first version runs every product as f32 FMAs on the
// CUDA cores, reading its operands from shared memory, so it is bound by
// shared-memory bandwidth and the f32 rate, far above either bound
// (PERF.md has its time beside both).
//
// The trap in the TPU kernel: `_bwd_kernel` accumulates dq by
// read-modify-write of its output block across the KV grid axis, and dk/dv
// in VMEM scratch across the q axis; both rely on the TPU running its grid
// in order.  Here blocks run at once and in any order, so the work is
// split into four launches, none of which writes what another block
// writes (no atomics, deterministic):
//   1. delta:  one warp per (batch, row, query head).
//   2. dk, dv per query head: one block per (batch, query head, tile of 32
//      keys).  The block stages its K/V tile in shared memory once, then
//      loops over the tiles of 32 query rows that can see it (when causal,
//      from row key_start − q_offset on).  Each thread keeps D/8 dims of
//      one key's dk and dv in registers and writes them once, in f32, to
//      a (B, T, Hq, D) scratch.  One block per KV head, looping over the
//      group's query heads, would sum the group in place, but gives only
//      B·Hkv·T/32 blocks (128 at the training shape, one per SM) whose
//      causal work differs 16-fold; one block per query head gives 7 times
//      as many.
//   3. dq:     one block per (batch, query head, tile of 32 rows), heaviest
//      causal tiles first.  The block loops over the KV tiles its rows can
//      see; each thread keeps D/8 dims of one row's dq in registers.
//   4. group sum: dk, dv = the scratch summed over each group, in head
//      order, in f32, rounded once.
// Both 2 and 3 form the 32×32 tiles of p and ds with the same routine
// (`score_tile`: lane j owns key j, each warp 4 rows) into shared memory,
// then contract them on the CUDA cores.  Inputs are read in place through
// the caller's strides (unit stride on D); there is no padding, so the
// ragged edges are bounds checks, not the +1e30 lse pad rows of the TPU
// wrapper.
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
  float* dk_part;   // (B, T, Hq, D) f32 scratch: each query head's dk
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

// 1. delta[b, h, s] = Σ_d do · o, one warp per (b, s, h).
template <typename T, int D>
__global__ void __launch_bounds__(NT) bwd_delta_kernel(BwdArgs a, int B) {
  const long long w = (long long)blockIdx.x * NW + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (w >= (long long)B * a.S * a.Hq) return;
  const int h = w % a.Hq, s = (w / a.Hq) % a.S, b = w / ((long long)a.Hq * a.S);
  const T* o = static_cast<const T*>(a.o) + b * a.osb + s * a.oss + h * a.osh;
  const T* dout = static_cast<const T*>(a.dout) + b * a.dosb + s * a.doss + h * a.dosh;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32) acc = fmaf(attn::to_f(dout[d]), attn::to_f(o[d]), acc);
  acc = attn::warp_sum(acc);
  if (lane == 0) a.delta[((long long)b * a.Hq + h) * a.S + s] = acc;
}

// 2. dk, dv of one tile of BK keys against one query head, to the scratch.
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

// 4. dk, dv = the scratch summed over each KV head's group; one thread
// per output element (b, t, KV head, d), d fastest.
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

// 3. dq of one tile of R rows of one query head.
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

template <typename T, int D>
int launch(const BwdArgs& a, int B, cudaStream_t stream) {
  constexpr int bytes = Smem<D>::BYTES;
  // above 48 KB a block's shared memory must be granted once per kernel
  static const cudaError_t attr_dkdv = cudaFuncSetAttribute(
      bwd_dkdv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  static const cudaError_t attr_dq = cudaFuncSetAttribute(
      bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr_dkdv != cudaSuccess) return static_cast<int>(attr_dkdv);
  if (attr_dq != cudaSuccess) return static_cast<int>(attr_dq);

  const long long rows = (long long)B * a.S * a.Hq;
  bwd_delta_kernel<T, D><<<static_cast<unsigned>((rows + NW - 1) / NW), NT, 0, stream>>>(a, B);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  bwd_dkdv_kernel<T, D><<<dim3((a.T + BK - 1) / BK, a.Hq, B), NT, bytes, stream>>>(a);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  bwd_dq_kernel<T, D><<<dim3((a.S + R - 1) / R, a.Hq, B), NT, bytes, stream>>>(a);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  const long long elems = (long long)B * a.T * a.Hkv * D;
  bwd_group_sum_kernel<T, D><<<static_cast<unsigned>((elems + NT - 1) / NT), NT, 0, stream>>>(a, B);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int D, const BwdArgs& a, int B, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32>(a, B, stream);
    case 48: return launch<T, 48>(a, B, stream);
    case 64: return launch<T, 64>(a, B, stream);
    case 80: return launch<T, 80>(a, B, stream);
    case 96: return launch<T, 96>(a, B, stream);
    case 128: return launch<T, 128>(a, B, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, o, do, dq (B,S,Hq,D); k, v, dk, dv (B,T,Hkv,D); all with unit stride
// on D, strides in elements.  lse and delta (B,Hq,S) f32, contiguous;
// delta and dkv_part (2, B, T, Hq, D) f32, contiguous, are scratch that
// this call fills.  dtype: 0 = float32,
// 1 = bfloat16.  Returns the first cudaGetLastError() that is not 0 (0 on
// success).
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
  if (B <= 0 || S <= 0 || T <= 0 || Hkv <= 0 || Hq % Hkv != 0 || q_offset < 0)
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
  a.dv_part = dkv_part + (long long)B * T * Hq * D;
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
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(D, a, B, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(D, a, B, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
