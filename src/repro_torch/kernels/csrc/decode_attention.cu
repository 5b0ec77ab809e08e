// Single-token GQA decode attention for Hopper (sm_90a), f32 and bf16.
//
// Replaces the TPU kernel `_dec_kernel` (src/repro/kernels/decode_attention.py,
// driven by `decode_attention_bhd` and `ops.decode_attention`); in the port it
// carries the decode attention of the dense LM, the counterpart of
// `layers.decode_attention`.
//
// What it computes: for each batch row b and query head h, one query against
// the cache rows t < length[b] of KV head h / (Hq / Hkv):
// o = softmax(q kᵀ / sqrt(D)) v.  The length is an int32 tensor on the
// device, of shape () (stride 0) or (B,) (stride 1); the kernel reads it
// itself, so a decode step needs no host sync and no rebuild.
//
// What bounds it on this card: bytes.  Every live cache row is read once,
// 2 · len · Hkv · D · sizeof(T) bytes per batch row, against 4 · len · Hq · D
// FLOPs -- about Hq / Hkv / sizeof(T) FLOPs per byte, far under the ~295 the
// card needs to be compute bound.  This first version is far from that
// bound: at the serve shape (B = 4, Hkv = 2) its grid is 8 blocks on 132
// SMs, so it is bound by latency; splitting the length over more blocks
// (with a merge pass) is the next step (PERF.md has its time).
//
// Design: one block per (KV head, batch row) whose rows are that head's
// group of Hq / Hkv query heads, so each cache tile is read once per group,
// not once per query head.  The cache is read in place as (B, T, Hkv, D)
// through its strides (a transpose per step would copy the whole cache).  The
// block's 8 warps split the live tiles of 32 keys round-robin (tiles that
// start at or past the length are never visited) and each keeps an f32
// online-softmax state (m, l, acc) for every row of the group; the partial
// states are merged through shared memory at the end.  This in-block split
// takes the place of the TPU's sequential KV grid axis.
#include "attn_common.cuh"

namespace {

constexpr int NW = 8;    // warps per block
constexpr int BK = 32;   // keys per tile (one per lane)

struct DecodeArgs {
  const void* q;
  const void* k;
  const void* v;
  const int* lengths;
  void* o;
  int len_stride, T, Hq, Hkv;
  long long qsb, qsh, ksb, kst, ksh, vsb, vst, vsh, osb, osh;
  float scale;
};

template <typename T, int D, int R>
__global__ void __launch_bounds__(NW * 32) decode_kernel(DecodeArgs a) {
  using namespace attn;
  extern __shared__ __align__(16) float smem[];

  const int hk = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int G = a.Hq / a.Hkv;
  const T* q = static_cast<const T*>(a.q) + b * a.qsb + hk * G * a.qsh;
  const T* k = static_cast<const T*>(a.k) + b * a.ksb + hk * a.ksh;
  const T* v = static_cast<const T*>(a.v) + b * a.vsb + hk * a.vsh;

  // shared memory: qs[R][D] | m[NW][G] | l[NW][G] | acc[NW][G][D]
  float* qs = smem;
  float* cm = qs + R * D;
  float* cl = cm + NW * G;
  float* ca = cl + NW * G;

  for (int i = threadIdx.x; i < R * D; i += NW * 32) {
    const int g = i / D, d = i % D;
    qs[i] = g < G ? to_f(q[g * a.qsh + d]) * a.scale : 0.f;
  }
  __syncthreads();

  const int length = max(0, min(a.T, a.lengths[b * a.len_stride]));
  RowState<R, D> st;
  st.init();
  for (int t0 = warp * BK; t0 < length; t0 += NW * BK) {
    const int n = min(BK, length - t0);
    tile_update<R, D>(st, qs, G, k + t0 * a.kst, v + t0 * a.vst, a.kst, a.vst, t0, n, NoMask{});
  }

#pragma unroll
  for (int g = 0; g < R; ++g) {
    if (g < G) {
      if (lane == 0) {
        cm[warp * G + g] = st.m[g];
        cl[warp * G + g] = st.l[g];
      }
#pragma unroll
      for (int sl = 0; sl < RowState<R, D>::SLOTS; ++sl) {
        const int d = lane + 32 * sl;
        if (d < D) ca[(warp * G + g) * D + d] = st.acc[g][sl];
      }
    }
  }
  __syncthreads();

  T* o = static_cast<T*>(a.o) + b * a.osb + hk * G * a.osh;
  for (int i = threadIdx.x; i < G * D; i += NW * 32) {
    const int g = i / D, d = i % D;
    float m = NEG_BIG;
#pragma unroll
    for (int w = 0; w < NW; ++w) m = fmaxf(m, cm[w * G + g]);
    float l = 0.f, acc = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float c = expf(cm[w * G + g] - m);
      l = fmaf(cl[w * G + g], c, l);
      acc = fmaf(ca[(w * G + g) * D + d], c, acc);
    }
    o[g * a.osh + d] = from_f<T>(acc / fmaxf(l, 1e-30f));
  }
}

template <int D, int R>
constexpr size_t smem_bytes(int G) {
  return sizeof(float) * (R * D + 2 * NW * G + NW * G * D);
}

template <typename T, int D, int R>
int launch(const DecodeArgs& a, int B, cudaStream_t stream) {
  // allow the most this instantiation can ask for (G = R), once per
  // process: the call is not stream-ordered, so it stays out of the
  // launch path (and out of CUDA-graph capture)
  static const cudaError_t attr = cudaFuncSetAttribute(
      decode_kernel<T, D, R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes<D, R>(R)));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const size_t smem = smem_bytes<D, R>(a.Hq / a.Hkv);
  decode_kernel<T, D, R><<<dim3(a.Hkv, B), NW * 32, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// R, the rows each warp's state holds, is the group size rounded up to 4, 8 or 16.
template <typename T, int D>
int dispatch_group(const DecodeArgs& a, int B, cudaStream_t stream) {
  const int G = a.Hq / a.Hkv;
  if (G <= 4) return launch<T, D, 4>(a, B, stream);
  if (G <= 8) return launch<T, D, 8>(a, B, stream);
  if (G <= 16) return launch<T, D, 16>(a, B, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int dispatch(int D, const DecodeArgs& a, int B, cudaStream_t stream) {
  switch (D) {
    case 32: return dispatch_group<T, 32>(a, B, stream);
    case 48: return dispatch_group<T, 48>(a, B, stream);
    case 64: return dispatch_group<T, 64>(a, B, stream);
    case 80: return dispatch_group<T, 80>(a, B, stream);
    case 96: return dispatch_group<T, 96>(a, B, stream);
    case 128: return dispatch_group<T, 128>(a, B, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q (B,1,Hq,D), caches (B,T,Hkv,D), o like q, all with unit stride on D;
// strides in elements.  lengths: int32 on the device, len_stride 0 for one
// shared length, 1 for one per batch row.  dtype: 0 = float32, 1 = bfloat16.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int decode_attention(int dtype, int D, const void* q, const void* k, const void* v,
                                const int* lengths, int len_stride, void* o, int B, int T,
                                int Hq, int Hkv, long long qsb, long long qsh, long long ksb,
                                long long kst, long long ksh, long long vsb, long long vst,
                                long long vsh, long long osb, long long osh, float scale,
                                void* stream) {
  if (B <= 0 || T <= 0 || Hkv <= 0 || Hq % Hkv != 0 || (len_stride != 0 && len_stride != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  DecodeArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.lengths = lengths;
  a.o = o;
  a.len_stride = len_stride;
  a.T = T;
  a.Hq = Hq;
  a.Hkv = Hkv;
  a.qsb = qsb;
  a.qsh = qsh;
  a.ksb = ksb;
  a.kst = kst;
  a.ksh = ksh;
  a.vsb = vsb;
  a.vst = vst;
  a.vsh = vsh;
  a.osb = osb;
  a.osh = osh;
  a.scale = scale;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(D, a, B, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(D, a, B, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
