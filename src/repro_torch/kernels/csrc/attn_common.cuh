// Shared device code of the attention kernels: element conversion, warp
// reductions, the online-softmax update of one warp's query rows against
// one tile of up to 32 keys (the CUDA-core paths), and Hopper's
// asynchronous copy and bf16 tensor-core instructions (cp.async, ldmatrix,
// mma.sync) as inline PTX with the padded bf16 tile they read (the
// tensor-core paths of the forward and the backward).
//
// Layout of the work inside a warp: lane j owns key (t0 + j) of the tile
// while scores are formed (it reads that key's whole row, so each K row is
// read once per tile and reused for every query row the warp holds), and
// lane j owns output dims {j, j + 32, ...} while P·V is accumulated (each V
// row is read whole by the warp).  Both callers stage the tile in shared
// memory first.
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

// Four consecutive elements; the wrapper guarantees 16-byte alignment of
// every row start and D % 16 == 0.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// -- asynchronous copies (sm_80+) -------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from device to shared memory; src_bytes = 0 writes zeros and
// reads nothing (the ragged edge of a tile).  Both addresses 16-aligned.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// 4 bytes, the same way (per-row f32 values such as lse and delta).
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// -- bf16 tensor-core fragments (mma.sync.m16n8k16, f32 accumulators) --------
//
// In a warp, lane = 4·g + t (g = lane / 4, t = lane % 4).  A 16×16 A tile
// is 4 registers of two bf16: (row g, cols 2t..2t+1), (g + 8, 2t..),
// (g, 2t + 8..), (g + 8, 2t + 8..).  A 16(k)×8(n) B tile is 2 registers:
// (k 2t..2t+1, col g), (k 2t + 8.., col g).  A 16×8 f32 accumulator is 4
// floats: (row g, cols 2t, 2t + 1), (row g + 8, cols 2t, 2t + 1).  So two
// accumulators side by side (16×16) are, once rounded to bf16 in pairs,
// the A fragment of the next product: no trip through shared memory.

// Four 8×8 bf16 matrices from shared memory; lanes 8i..8i+7 give the row
// addresses of matrix i, and register i receives matrix i in the
// fragment layout above (each row 16 bytes, 16-aligned).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// The same, each matrix transposed on the way (for a B operand stored
// k-major, or an A operand stored m-minor).
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a · b over one 16×8×16 step, bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to one register of two bf16 (lo in the low half).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A fragment of a 16×16 tile held as two 16×8 accumulators.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                         const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// 2^x by the SFU (ex2.approx, relative error ~2^-22; 2^-inf = 0).
constexpr float LOG2E = 1.4426950408889634f;
__device__ __forceinline__ float exp2_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Row stride, in elements, of a bf16 tile with D columns in shared memory:
// a 16-byte pad, so the 8 rows an ldmatrix reads hit 8 bank groups.
template <int D>
constexpr int TC_LD = D + 8;

// Rows [0, rows) of a (·, D) bf16 matrix at src (row stride rs) into
// shared memory (row stride TC_LD<D>) by cp.async, 16 bytes a thread, by
// the NT threads of the block; rows at or past n are zero-filled.  src
// must be a row of the tensor (row 0 is read only when n > 0).
template <int D, int NT>
__device__ __forceinline__ void stage_tc(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                         long long rs, int rows, int n) {
  constexpr int CH = D / 8, LD = TC_LD<D>;
  for (int i = threadIdx.x; i < rows * CH; i += NT) {
    const int r = i / CH, c = 8 * (i % CH);
    const bool live = r < n;
    cp_async16(dst + r * LD + c, live ? src + r * rs + c : src, live ? 16 : 0);
  }
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

// Fold keys [t0, t0 + n) (0 <= n <= 32, warp-uniform) into the state of
// the warp's R rows.  qs holds the R query rows, pre-scaled, in f32, row
// stride D.  kt / vt point at key t0 of this head; kstride / vstride are
// the element strides between consecutive keys, and all 32 rows of the
// tile must be readable (rows at or past n are masked out of the scores
// and, with weight 0, out of P·V, so they must be finite).  Every row is
// updated, so a row the caller does not own must hold finite values (zeros).
// There is no branch around the shuffles: under a branch the compiler
// cannot prove warp-uniform, each `__shfl_sync` becomes a slow
// convergence loop.
template <int R, int D, typename T, typename Mask>
__device__ __forceinline__ void tile_update(RowState<R, D>& st, const float* qs, const T* kt,
                                            const T* vt, int kstride, int vstride, int t0,
                                            int n, Mask allowed) {
  constexpr int SLOTS = RowState<R, D>::SLOTS;
  const int lane = threadIdx.x & 31;

  float s[R];
#pragma unroll
  for (int r = 0; r < R; ++r) s[r] = 0.f;
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

#pragma unroll
  for (int r = 0; r < R; ++r) {
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

  // all 32 keys (p = 0 past n), unrolled so that several V rows are in flight
#pragma unroll 8
  for (int j = 0; j < 32; ++j) {
    const T* vr = vt + j * vstride;
    float vv[SLOTS];
#pragma unroll
    for (int sl = 0; sl < SLOTS; ++sl) {
      const int d = lane + 32 * sl;
      vv[sl] = d < D ? to_f(vr[d]) : 0.f;
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float pj = __shfl_sync(FULL, s[r], j);
#pragma unroll
      for (int sl = 0; sl < SLOTS; ++sl) st.acc[r][sl] = fmaf(pj, vv[sl], st.acc[r][sl]);
    }
  }
}

}  // namespace attn
