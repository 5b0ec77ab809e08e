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
// card needs to be compute bound.  At the serve shapes the cache is small
// (~0.6 MB at qwen2-0.5B's), so what the kernel can win is latency: enough
// blocks to keep every SM loading, and loads that are in flight while the
// previous tile is folded in.
//
// Design (flash-decode): the grid is (KV head, batch row, split).  The
// wrapper picks the split count from the shapes alone (enough blocks for
// every SM, at most one per tile of 32 keys, at most 16, the largest
// thread-block cluster the card takes), so a call is the same inside a
// CUDA graph.  Each block reads the live length and takes a contiguous
// share of the live tiles; a block whose share is empty holds an empty
// state.  Inside a block, WR warps split the group's rows, RW each (the
// least of 1, 2, 4 with 4·RW >= the group, so group 1 holds one row a warp
// and no empty ones), and the WT = 4 / WR streams of them take alternate
// tiles.  K and V tiles are staged in shared memory by the whole block
// with cp.async, 16 bytes a thread, double-buffered: the next step's tiles
// load while this one's are folded into each warp's f32 online-softmax
// state (`attn::tile_update`).  The streams' states are merged through
// shared memory.  With one split the block writes o.  With more, the
// splits of one (KV head, batch row) form a thread-block cluster: each
// block stores its state of row g into the shared memory of block
// g % n_split (distributed shared memory), and after one cluster barrier
// each block merges its rows' splits in split order and writes them.  One
// launch, no scratch in device memory, a deterministic result.
#include <cooperative_groups.h>

#include "attn_common.cuh"

namespace {

constexpr int NW = 4;    // warps per block
constexpr int BK = 32;   // keys per tile (one per lane)

struct DecodeArgs {
  const void* q;
  const void* k;
  const void* v;
  const int* lengths;
  void* o;
  int len_stride, T, Hq, Hkv, n_split;
  long long qsb, qsh, ksb, kst, ksh, vsb, vst, vsh, osb, osh;
  float scale;
};

template <typename T, int D>
struct Tile {
  static constexpr int LD = D + 16 / sizeof(T);   // padded row, 16-byte aligned
  static constexpr int ELEMS = BK * LD;             // one K or V tile
  static constexpr int BYTES = ELEMS * sizeof(T);
  // streams per block at most: f32 at D = 128 would ask for 270 KB
  static constexpr int WT_MAX = 2 * 2 * NW * BYTES <= 160 * 1024 ? NW : NW / 2;
};

// Shared memory: stages [2][WT][K, V] | q [NW·RW][D] f32 | m, l [WT][G] |
// acc [WT][G][D] | with a cluster, the states this block merges:
// recv [ceil(G / n_split)][n_split][D + 2] f32 (acc, then m and l).
template <typename T, int D, int RW>
constexpr size_t smem_bytes(int wt, int g, int recv) {
  return 2 * 2 * wt * Tile<T, D>::BYTES +
         sizeof(float) * (NW * RW * D + 2 * wt * g + wt * g * D + recv * (D + 2));
}

// Thread-block cluster barrier in two halves (sm_90): arrive, then wait for
// every thread of the cluster to have arrived.  The released arrive and
// the wait order this block's stores before other blocks' loads.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

template <typename T, int D, int RW, bool CLUSTER>
__global__ void __launch_bounds__(NW * 32) decode_split_kernel(DecodeArgs a, int WT) {
  using namespace attn;
  using Tl = Tile<T, D>;
  constexpr int LD = Tl::LD, CH = D * sizeof(T) / 16;   // 16-byte chunks per row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // this block exists: the others may store into its shared memory once
  // everyone has arrived (waited for below, after the tiles)
  if constexpr (CLUSTER) cluster_arrive_relaxed();

  const int hk = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int G = a.Hq / a.Hkv;
  const int WR = (G + RW - 1) / RW;
  const int rg = warp % WR, ts = warp / WR;    // this warp's rows and its tile stream
  const bool busy = ts < WT;
  const int row0 = rg * RW, nrows = min(RW, G - row0);

  T* kv = reinterpret_cast<T*>(smem_raw);
  float* qs = reinterpret_cast<float*>(smem_raw + 2 * 2 * WT * Tl::BYTES);
  float* cm = qs + NW * RW * D;
  float* cl = cm + WT * G;
  float* ca = cl + WT * G;
  float* recv = ca + WT * G * D;

  const T* q = static_cast<const T*>(a.q) + b * a.qsb + hk * G * a.qsh;
  const T* k = static_cast<const T*>(a.k) + b * a.ksb + hk * a.ksh;
  const T* v = static_cast<const T*>(a.v) + b * a.vsb + hk * a.vsh;

  // this split's share of the live tiles
  const int length = max(0, min(a.T, a.lengths[b * a.len_stride]));
  const int n_tiles = (length + BK - 1) / BK;
  const int per = (n_tiles + a.n_split - 1) / a.n_split;
  const int tile_lo = min(n_tiles, split * per), tile_hi = min(n_tiles, tile_lo + per);
  const int n_steps = (tile_hi - tile_lo + WT - 1) / WT;

  // step s: tiles tile_lo + s·WT + [0, WT) into buffer s & 1; rows past
  // the length or the share are zero-filled (and masked by tile_update)
  auto stage = [&](int s) {
    T* buf = kv + (s & 1) * WT * 2 * Tl::ELEMS;
    for (int i = threadIdx.x; i < WT * 2 * BK * CH; i += NW * 32) {
      const int c = i % CH, r = (i / CH) % BK, which = (i / (CH * BK)) & 1;
      const int tt = i / (CH * BK * 2);
      const int key = (tile_lo + s * WT + tt) * BK + r;
      const bool live = key < length && key < tile_hi * BK;
      const T* base = which ? v : k;
      const T* src = live ? base + key * (which ? a.vst : a.kst) + c * (16 / sizeof(T)) : base;
      cp_async16(buf + (2 * tt + which) * Tl::ELEMS + r * LD + c * (16 / sizeof(T)), src,
                 live ? 16 : 0);
    }
  };

  if (n_steps > 0) stage(0);
  cp_async_commit();
  for (int i = threadIdx.x; i < NW * RW * D; i += NW * 32) {
    const int g = i / D, d = i % D;
    qs[i] = g < G ? to_f(q[g * a.qsh + d]) * a.scale : 0.f;
  }

  RowState<RW, D> st;
  st.init();
  for (int s = 0; s < n_steps; ++s) {
    if (s + 1 < n_steps) stage(s + 1);
    cp_async_commit();
    cp_async_wait<1>();                      // step s has landed (this thread's part)
    __syncthreads();                         // ... and every thread's, and qs
    // every warp folds a tile in, with no keys where it has none (no
    // branch around tile_update's shuffles)
    const int sts = busy ? ts : 0, tile = tile_lo + s * WT + sts;
    const T* kt = kv + ((s & 1) * WT + sts) * 2 * Tl::ELEMS;
    const int n = busy && tile < tile_hi ? min(BK, length - tile * BK) : 0;
    tile_update<RW, D>(st, qs + row0 * D, kt, kt + Tl::ELEMS, LD, LD, tile * BK, n, NoMask{});
    __syncthreads();                         // buffer s & 1 is free for step s + 2
  }

  // each stream's state of its rows into shared memory
  if (busy) {
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      if (r < nrows) {
        const int g = row0 + r;
        if (lane == 0) {
          cm[ts * G + g] = st.m[r];
          cl[ts * G + g] = st.l[r];
        }
#pragma unroll
        for (int sl = 0; sl < RowState<RW, D>::SLOTS; ++sl) {
          const int d = lane + 32 * sl;
          if (d < D) ca[(ts * G + g) * D + d] = st.acc[r][sl];
        }
      }
    }
  }
  __syncthreads();

  // the streams merged in order.  Alone, the block writes o; in a cluster,
  // row g's state goes to block g % n_split, which merges that row's
  // splits in split order: one launch, no scratch in device memory, a
  // deterministic result
  T* o = static_cast<T*>(a.o) + b * a.osb + hk * G * a.osh;
  if constexpr (CLUSTER) cluster_wait();     // every block of the cluster has started
  for (int i = threadIdx.x; i < G * D; i += NW * 32) {
    const int g = i / D, d = i % D;
    float m = NEG_BIG;
    for (int w = 0; w < WT; ++w) m = fmaxf(m, cm[w * G + g]);
    float l = 0.f, acc = 0.f;
    for (int w = 0; w < WT; ++w) {
      const float c = expf(cm[w * G + g] - m);
      l = fmaf(cl[w * G + g], c, l);
      acc = fmaf(ca[(w * G + g) * D + d], c, acc);
    }
    if constexpr (CLUSTER) {
      namespace cg = cooperative_groups;
      float* dst = cg::this_cluster().map_shared_rank(recv, g % a.n_split) +
                   ((g / a.n_split) * a.n_split + split) * (D + 2);
      dst[d] = acc;
      if (d == 0) {
        dst[D] = m;
        dst[D + 1] = l;
      }
    } else {
      o[g * a.osh + d] = from_f<T>(acc / fmaxf(l, 1e-30f));
    }
  }
  if constexpr (CLUSTER) {
    cluster_arrive();                        // this block's states are stored ...
    cluster_wait();                          // ... and every block's
    const int ns = a.n_split, mine = split < G ? (G - 1 - split) / ns + 1 : 0;
    for (int i = threadIdx.x; i < mine * D; i += NW * 32) {
      const int j = i / D, d = i % D, g = split + j * ns;
      const float* p = recv + j * ns * (D + 2);
      float m = NEG_BIG;
      for (int s = 0; s < ns; ++s) m = fmaxf(m, p[s * (D + 2) + D]);
      float l = 0.f, acc = 0.f;
      for (int s = 0; s < ns; ++s) {
        const float c = expf(p[s * (D + 2) + D] - m);
        l = fmaf(p[s * (D + 2) + D + 1], c, l);
        acc = fmaf(p[s * (D + 2) + d], c, acc);
      }
      o[g * a.osh + d] = from_f<T>(acc / fmaxf(l, 1e-30f));
    }
  }
}

// Allow the most shared memory a kernel can ask for (WT = WT_MAX, WT·G <=
// NW·RW, ceil(G / n_split)·n_split < NW·RW + 16), and clusters above the
// portable 8.
template <typename T, int D, int RW, bool CLUSTER>
cudaError_t allow() {
  using Tl = Tile<T, D>;
  const cudaError_t e = cudaFuncSetAttribute(
      decode_split_kernel<T, D, RW, CLUSTER>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes<T, D, RW>(Tl::WT_MAX, NW * RW / Tl::WT_MAX,
                                            CLUSTER ? NW * RW + 15 : 0)));
  if (e != cudaSuccess || !CLUSTER) return e;
  return cudaFuncSetAttribute(decode_split_kernel<T, D, RW, CLUSTER>,
                              cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

template <typename T, int D, int RW>
int launch(const DecodeArgs& a, int B, cudaStream_t stream) {
  using Tl = Tile<T, D>;
  // once per process: these calls are not stream-ordered, so they stay out
  // of the launch path (and out of CUDA-graph capture)
  static const cudaError_t attr_one = allow<T, D, RW, false>();
  static const cudaError_t attr_cluster = allow<T, D, RW, true>();
  if (attr_one != cudaSuccess) return static_cast<int>(attr_one);
  if (attr_cluster != cudaSuccess) return static_cast<int>(attr_cluster);
  const int G = a.Hq / a.Hkv, WR = (G + RW - 1) / RW;
  const int WT = NW / WR < Tl::WT_MAX ? NW / WR : Tl::WT_MAX;
  const int recv = a.n_split > 1 ? (G + a.n_split - 1) / a.n_split * a.n_split : 0;
  const size_t smem = smem_bytes<T, D, RW>(WT, G, recv);
  if (a.n_split == 1) {
    decode_split_kernel<T, D, RW, false><<<dim3(a.Hkv, B), NW * 32, smem, stream>>>(a, WT);
    return static_cast<int>(cudaGetLastError());
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.Hkv, B, a.n_split);
  cfg.blockDim = dim3(NW * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = a.n_split;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  const cudaError_t rc = cudaLaunchKernelEx(&cfg, decode_split_kernel<T, D, RW, true>, a, WT);
  return static_cast<int>(rc != cudaSuccess ? rc : cudaGetLastError());
}

// RW, the rows each warp holds: the least of 1, 2, 4 with 4·RW >= the group.
template <typename T, int D>
int dispatch_rows(const DecodeArgs& a, int B, cudaStream_t stream) {
  const int G = a.Hq / a.Hkv;
  if (G <= NW) return launch<T, D, 1>(a, B, stream);
  if (G <= 2 * NW) return launch<T, D, 2>(a, B, stream);
  if (G <= 4 * NW) return launch<T, D, 4>(a, B, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int dispatch(int D, const DecodeArgs& a, int B, cudaStream_t stream) {
  switch (D) {
    case 16: return dispatch_rows<T, 16>(a, B, stream);
    case 32: return dispatch_rows<T, 32>(a, B, stream);
    case 48: return dispatch_rows<T, 48>(a, B, stream);
    case 64: return dispatch_rows<T, 64>(a, B, stream);
    case 80: return dispatch_rows<T, 80>(a, B, stream);
    case 128: return dispatch_rows<T, 128>(a, B, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q (B,1,Hq,D), caches (B,T,Hkv,D), o like q, all with unit stride on D
// and 16-byte aligned rows; strides in elements.  lengths: int32 on the
// device, len_stride 0 for one shared length, 1 for one per batch row.
// n_split: blocks per (KV head, batch row), one cluster, 1 <= n_split <= 16.
// dtype: 0 = float32, 1 = bfloat16.  Returns the first cudaGetLastError()
// that is not 0 (0 on success).
extern "C" int decode_attention(int dtype, int D, const void* q, const void* k, const void* v,
                                const int* lengths, int len_stride, void* o, int n_split,
                                int B, int T, int Hq, int Hkv, long long qsb,
                                long long qsh, long long ksb, long long kst, long long ksh,
                                long long vsb, long long vst, long long vsh, long long osb,
                                long long osh, float scale, void* stream) {
  if (B <= 0 || T <= 0 || Hkv <= 0 || Hq % Hkv != 0 || (len_stride != 0 && len_stride != 1) ||
      n_split < 1 || n_split > 16)
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
  a.n_split = n_split;
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
