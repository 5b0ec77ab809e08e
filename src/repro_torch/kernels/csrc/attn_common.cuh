// Shared device code of the two attention kernels: element conversion,
// warp reductions, and the online-softmax update of one warp's query rows
// against one tile of up to 32 keys.
//
// Layout of the work inside a warp: lane j owns key (t0 + j) of the tile
// while scores are formed (it reads that key's whole row, so each K row is
// read once per tile and reused for every query row the warp holds), and
// lane j owns output dims {j, j + 32, ...} while P·V is accumulated (each V
// row is read whole by the warp).  The tile is read where the caller keeps
// it: in device memory (decode) or staged in shared memory (flash).
// Scores, the running max m, the running sum l and the accumulator stay in
// f32 for both input types.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace attn {

constexpr float NEG_BIG = -1e30f;   // finite mask value: exp(m_old - m_new) stays 1, never NaN
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Four consecutive elements; the wrapper guarantees 16-byte (f32) or
// 8-byte (bf16) alignment of every row start and D % 16 == 0.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o; o >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

// Online-softmax state of R query rows held by one warp.
template <int R, int D>
struct RowState {
  static constexpr int SLOTS = (D + 31) / 32;
  float m[R], l[R], acc[R][SLOTS];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      m[r] = NEG_BIG;
      l[r] = 0.f;
#pragma unroll
      for (int s = 0; s < SLOTS; ++s) acc[r][s] = 0.f;
    }
  }
};

// Every key of the tile is visible to every row (decode).
struct NoMask {
  __device__ __forceinline__ bool operator()(int, int) const { return true; }
};

// Top-left aligned causal mask: row r of the warp sits at absolute query
// position first_pos + r and sees keys at or before it.
struct CausalMask {
  int first_pos;
  __device__ __forceinline__ bool operator()(int r, int key) const {
    return key <= first_pos + r;
  }
};

// Fold keys [t0, t0 + n) (n <= 32, warp-uniform) into the state of the
// warp's first `nrows` rows (warp-uniform).  qs holds the R query rows,
// pre-scaled, in f32, row stride D.  kt / vt point at key t0 of this head;
// kstride / vstride are the element strides between consecutive keys.
template <int R, int D, typename T, typename Mask>
__device__ __forceinline__ void tile_update(RowState<R, D>& st, const float* qs, int nrows,
                                            const T* kt, const T* vt, long long kstride,
                                            long long vstride, int t0, int n, Mask allowed) {
  constexpr int SLOTS = RowState<R, D>::SLOTS;
  const int lane = threadIdx.x & 31;

  float s[R];
#pragma unroll
  for (int r = 0; r < R; ++r) s[r] = 0.f;
  if (lane < n) {
    const T* kr = kt + lane * kstride;
#pragma unroll
    for (int d = 0; d < D; d += 4) {
      const float4 kv = load4(kr + d);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(qs + r * D + d);
        s[r] = fmaf(qv.x, kv.x, s[r]);
        s[r] = fmaf(qv.y, kv.y, s[r]);
        s[r] = fmaf(qv.z, kv.z, s[r]);
        s[r] = fmaf(qv.w, kv.w, s[r]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (r < nrows) {
      const bool ok = lane < n && allowed(r, t0 + lane);
      const float sr = ok ? s[r] : NEG_BIG;
      const float m_new = fmaxf(st.m[r], warp_max(sr));
      const float p = ok ? expf(sr - m_new) : 0.f;
      const float corr = expf(st.m[r] - m_new);
      st.l[r] = st.l[r] * corr + warp_sum(p);
      st.m[r] = m_new;
      s[r] = p;
#pragma unroll
      for (int sl = 0; sl < SLOTS; ++sl) st.acc[r][sl] *= corr;
    }
  }

  // unrolled so that several V rows are in flight at once
#pragma unroll 8
  for (int j = 0; j < n; ++j) {
    const T* vr = vt + j * vstride;
    float vv[SLOTS];
#pragma unroll
    for (int sl = 0; sl < SLOTS; ++sl) {
      const int d = lane + 32 * sl;
      vv[sl] = d < D ? to_f(vr[d]) : 0.f;
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r < nrows) {
        const float pj = __shfl_sync(FULL, s[r], j);
#pragma unroll
        for (int sl = 0; sl < SLOTS; ++sl) st.acc[r][sl] = fmaf(pj, vv[sl], st.acc[r][sl]);
      }
    }
  }
}

}  // namespace attn
