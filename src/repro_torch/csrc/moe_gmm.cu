// Grouped matmul over expert-sorted rows for Hopper (MoE expert FFN):
//   y[i*BT:(i+1)*BT, :] = x[i*BT:(i+1)*BT, :] @ w[block_to_expert[i]]
// x [T_pad, D] (rows through a stride, columns contiguous), w [E, D, F]
// (experts and rows through strides, F contiguous), block_to_expert
// [T_pad/BT] int32 in [0, E); y [T_pad, F] contiguous, in x's type. float32
// or bfloat16, float32 accumulation.
//
// Replaces the TPU kernel repro/kernels/moe_gmm.py::_gmm_kernel. The TPU grid
// is (row block, F block, D block) with the D axis sequential, the sum carried
// in VMEM scratch, and block_to_expert scalar-prefetched so that the weight
// BlockSpec's index map picks the expert's tile. Here one block owns a (row
// block, F tile) pair, loads its own expert id from block_to_expert, and
// loops over D itself; nothing is carried between blocks.
//
// Tiles: BT rows (8..128, the layout's block_t) by BN = 64 columns, D in
// steps of BK = 64 (32 at BT = 128, to stay in 48 KB of static shared
// memory). Each step stages the x tile and the w[e] tile in shared memory as
// float32; 16 threads span the 64 columns (4 each, one float4 of the w tile
// per k) and min(BT, 16) thread rows span the BT rows, so a thread keeps a
// (BT/16 or 1) x 4 micro-tile of sums in registers and accumulates with
// float32 FMA (no TF32, no tensor cores: f32 within 2e-4 of the plain
// version). The next step's tiles are loaded from device memory into
// registers (16-byte loads) while the current step computes. Nothing is
// masked: the wrapper checks T_pad % BT == 0, D % 64 == 0 and F % 64 == 0.
//
// Bound: at the serving shapes (moonshot_v1_16b, D 2048 / F 1408 and back,
// a few rows per expert) the kernel is bound by the bytes of the experts'
// weights, each distinct expert's D*F read once: 69 MB (12 experts, 0.021 ms
// at 3.35 TB/s) for a decode step with 2 slots and ~352 MB (~61 of 64
// experts, 0.105 ms) for a prefill of 32 tokens, against 2*rows*D*F
// operations far below the bf16 ridge. The design keeps every weight byte
// read once per F tile per row block: a block of rows of one expert reads
// its expert's tile once, and the layout keeps each expert's rows in as few
// BT-row blocks as possible. Blocks past the layout's last used one repeat
// that block's expert over zero rows; their weight reads hit L2.
#include "common.cuh"

namespace {

constexpr int kBN = 64;

template <int BT> struct Tile {
  static constexpr int TY = BT < 16 ? BT : 16;      // thread rows
  static constexpr int kThreads = 16 * TY;
  static constexpr int TM = BT / TY;                // rows per thread
  static constexpr int BK = BT > 64 ? 32 : 64;
};

// 16 bytes of T as float32
__device__ __forceinline__ void unpack(const uint4& u, float* out, float) {
  const float4 f = *reinterpret_cast<const float4*>(&u);
  out[0] = f.x; out[1] = f.y; out[2] = f.z; out[3] = f.w;
}
__device__ __forceinline__ void unpack(const uint4& u, float* out, __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    out[2 * j] = f.x;
    out[2 * j + 1] = f.y;
  }
}

template <typename T, int BT>
__global__ void __launch_bounds__(Tile<BT>::kThreads)
gmm_kernel(const T* __restrict__ x, const T* __restrict__ w, const int* __restrict__ bmap,
           T* __restrict__ y, int E, int D, int F, int64_t sx, int64_t swe, int64_t swd) {
  using Tl = Tile<BT>;
  constexpr int TY = Tl::TY, TM = Tl::TM, BK = Tl::BK, kThreads = Tl::kThreads;
  constexpr int V = 16 / sizeof(T);                 // elements per 16-byte load
  constexpr int XVEC = BT * BK / V, WVEC = BK * kBN / V;
  constexpr int XV = (XVEC + kThreads - 1) / kThreads;
  constexpr int WV = (WVEC + kThreads - 1) / kThreads;
  __shared__ float xs[BT][BK + 1];                  // +1: no bank conflict across rows
  __shared__ __align__(16) float ws[BK][kBN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int blk = blockIdx.x;
  const int n0 = blockIdx.y * kBN;
  const int e = bmap[blk];
  if (e < 0 || e >= E) __trap();                   // the layout's contract: bmap in [0, E)
  const T* xb = x + static_cast<int64_t>(blk) * BT * sx;
  const T* wb = w + static_cast<int64_t>(e) * swe + n0;

  uint4 xr[XV], wr[WV];
  auto load = [&](int k0) {
#pragma unroll
    for (int v = 0; v < XV; ++v) {
      const int idx = tid + v * kThreads;
      if (XVEC % kThreads == 0 || idx < XVEC) {
        const int r = idx / (BK / V), c = idx % (BK / V) * V;
        xr[v] = *reinterpret_cast<const uint4*>(xb + r * sx + k0 + c);
      }
    }
#pragma unroll
    for (int v = 0; v < WV; ++v) {
      const int idx = tid + v * kThreads;
      if (WVEC % kThreads == 0 || idx < WVEC) {
        const int r = idx / (kBN / V), c = idx % (kBN / V) * V;
        wr[v] = *reinterpret_cast<const uint4*>(wb + (k0 + r) * swd + c);
      }
    }
  };
  auto stage = [&]() {
    float f[V];
#pragma unroll
    for (int v = 0; v < XV; ++v) {
      const int idx = tid + v * kThreads;
      if (XVEC % kThreads == 0 || idx < XVEC) {
        const int r = idx / (BK / V), c = idx % (BK / V) * V;
        unpack(xr[v], f, T());
#pragma unroll
        for (int j = 0; j < V; ++j) xs[r][c + j] = f[j];
      }
    }
#pragma unroll
    for (int v = 0; v < WV; ++v) {
      const int idx = tid + v * kThreads;
      if (WVEC % kThreads == 0 || idx < WVEC) {
        const int r = idx / (kBN / V), c = idx % (kBN / V) * V;
        unpack(wr[v], f, T());
#pragma unroll
        for (int j = 0; j < V; ++j) ws[r][c + j] = f[j];
      }
    }
  };

  float acc[TM][4];
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[r][j] = 0.f;

  load(0);
  for (int k0 = 0; k0 < D; k0 += BK) {
    stage();
    __syncthreads();
    if (k0 + BK < D) load(k0 + BK);                 // in flight while this step computes
#pragma unroll 16
    for (int kk = 0; kk < BK; ++kk) {
      const float4 b = *reinterpret_cast<const float4*>(&ws[kk][tx * 4]);
#pragma unroll
      for (int r = 0; r < TM; ++r) {
        const float a = xs[ty + r * TY][kk];
        acc[r][0] = fmaf(a, b.x, acc[r][0]);
        acc[r][1] = fmaf(a, b.y, acc[r][1]);
        acc[r][2] = fmaf(a, b.z, acc[r][2]);
        acc[r][3] = fmaf(a, b.w, acc[r][3]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < TM; ++r) {
    T* yr = y + (static_cast<int64_t>(blk) * BT + ty + r * TY) * F + n0 + tx * 4;
#pragma unroll
    for (int j = 0; j < 4; ++j) yr[j] = rt::from_float<T>(acc[r][j]);
  }
}

template <typename T, int BT>
int launch(const void* x, const void* w, const int* bmap, void* y, int nt, int E, int D, int F,
           int64_t sx, int64_t swe, int64_t swd, cudaStream_t stream) {
  const dim3 grid(nt, F / kBN);
  gmm_kernel<T, BT><<<grid, Tile<BT>::kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), bmap, static_cast<T*>(y), E, D, F,
      sx, swe, swd);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_bt(int bt, const void* x, const void* w, const int* bmap, void* y, int nt, int E,
                int D, int F, int64_t sx, int64_t swe, int64_t swd, cudaStream_t s) {
  switch (bt) {
    case 8: return launch<T, 8>(x, w, bmap, y, nt, E, D, F, sx, swe, swd, s);
    case 16: return launch<T, 16>(x, w, bmap, y, nt, E, D, F, sx, swe, swd, s);
    case 32: return launch<T, 32>(x, w, bmap, y, nt, E, D, F, sx, swe, swd, s);
    case 64: return launch<T, 64>(x, w, bmap, y, nt, E, D, F, sx, swe, swd, s);
    case 128: return launch<T, 128>(x, w, bmap, y, nt, E, D, F, sx, swe, swd, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes. nt = T_pad / block_t row blocks;
// strides in elements: sx between rows of x, swe between experts and swd
// between rows of w. Returns the cudaError_t of the launch.
extern "C" int grouped_matmul_fwd(const void* x, const void* w, const void* bmap, void* y,
                                  int dtype, int block_t, int nt, int E, int D, int F,
                                  int64_t sx, int64_t swe, int64_t swd, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* b = static_cast<const int*>(bmap);
  if (dtype == rt::kFloat32)
    return dispatch_bt<float>(block_t, x, w, b, y, nt, E, D, F, sx, swe, swd, s);
  if (dtype == rt::kBFloat16)
    return dispatch_bt<__nv_bfloat16>(block_t, x, w, b, y, nt, E, D, F, sx, swe, swd, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
