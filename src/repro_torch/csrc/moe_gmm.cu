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
// block, 64-column F tile) pair, loads its own expert id from block_to_expert,
// and loops over D itself; nothing is carried between blocks.
//
// Bound: at the serving shapes (moonshot_v1_16b, D 2048 / F 1408 and back,
// a few rows per expert) the kernel is bound by the bytes of the experts'
// weights, each distinct expert's D*F read once: ~64 MB (11 experts, 0.019 ms
// at 3.35 TB/s) for a decode step with 2 slots and ~352 MB (~61 of 64
// experts, 0.105 ms) for a prefill of 32 tokens, against 2*rows*D*F
// operations far below the bf16 ridge. So what matters is the weight bytes in
// flight per SM, not the multiply. Every weight byte is read once per row
// block: a block of rows of one expert reads its expert's tile once, and the
// layout keeps each expert's rows in as few BT-row blocks as it can. Blocks
// past the layout's last used one repeat that block's expert over zero rows;
// their weight reads hit L2.
//
// bfloat16 (the serving path): tensor cores, with A and B swapped so that the
// weights are the M side, y^T[F tile, rows] = w[e][:, F tile]^T x[rows]^T.
// The 64-column F tile is M = 64 (four warps, 16 columns each) and the BT rows
// are N (BT/8 n8 tiles of mma.sync.m16n8k16), so an 8-row decode block fills
// its tiles without padding. w is F-contiguous, so its fragments come from
// shared memory by ldmatrix.trans; x's by plain ldmatrix. (64 D x 64 F)
// weight tiles and the matching (BT x 64 D) x tiles stream through a ring of
// 4 stages filled by 16-byte cp.async.cg, 3 steps in flight while one
// computes: at decode (308 blocks of 41 KB, all resident, ~2.3 per SM) ~55 KB
// of weights in flight per SM. Shared rows are padded by 16 bytes so that the
// 8 rows of an ldmatrix hit distinct banks.
//
// float32: kept for exactness (float32 FMA, no TF32, within 2e-4 of the plain
// version); not on the serving path. BT rows by 64 columns, D in steps of
// BK = 64 (32 at BT = 128, to stay in 48 KB of static shared memory); both
// tiles staged in shared memory, 16 threads span the 64 columns (a float4 of
// the w tile per k) and min(BT, 16) thread rows the BT rows; the next step's
// tiles are loaded into registers while the current step computes.
//
// Nothing is masked: the wrapper checks T_pad % BT == 0, D % 64 == 0,
// F % 64 == 0 and 16-byte alignment of x's rows and w's rows.
//
// B4b, the backward (grouped_matmul_dx, grouped_matmul_dw below), has three
// routes (kernels/moe_gmm.py::bwd_route): float32 and bf16 at block_t 8-32
// here; bf16 at block_t 64 and 128, every training microbatch, on wgmma fed
// by TMA in csrc/moe_gmm_bwd.cu, whose note gives B4b's bounds.
#include "common.cuh"

namespace {

constexpr int kBN = 64;

template <int BT> struct Tile {
  static constexpr int TY = BT < 16 ? BT : 16;      // thread rows
  static constexpr int kThreads = 16 * TY;
  static constexpr int TM = BT / TY;                // rows per thread
  static constexpr int BK = BT > 64 ? 32 : 64;
};

// 16 bytes of float32
__device__ __forceinline__ void unpack(const uint4& u, float* out, float) {
  const float4 f = *reinterpret_cast<const float4*>(&u);
  out[0] = f.x; out[1] = f.y; out[2] = f.z; out[3] = f.w;
}

// TW = false: y = x @ w[e], the sum over D (w's rows), F columns of output.
// TW = true (B4b's dx): y = x @ w[e]^T with x = dy [T_pad, F'] and w [E, D', F']:
// the sum runs over w's columns (the kernel's D is F') and the output has w's
// rows as columns (the kernel's F is D'); w's tile is read in its own layout
// and transposed in shared memory.
template <typename T, int BT, bool TW>
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
  const T* wb = w + static_cast<int64_t>(e) * swe + (TW ? n0 * swd : n0);

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
        if constexpr (TW) {     // w row r (an output column), D steps k0 + c ...
          const int r = idx % kBN, c = idx / kBN * V;
          wr[v] = *reinterpret_cast<const uint4*>(wb + r * swd + k0 + c);
        } else {
          const int r = idx / (kBN / V), c = idx % (kBN / V) * V;
          wr[v] = *reinterpret_cast<const uint4*>(wb + (k0 + r) * swd + c);
        }
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
        unpack(wr[v], f, T());
        if constexpr (TW) {     // ... stored transposed: ws[D step][output column]
          const int r = idx % kBN, c = idx / kBN * V;
#pragma unroll
          for (int j = 0; j < V; ++j) ws[c + j][r] = f[j];
        } else {
          const int r = idx / (kBN / V), c = idx % (kBN / V) * V;
#pragma unroll
          for (int j = 0; j < V; ++j) ws[r][c + j] = f[j];
        }
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

template <typename T, int BT, bool TW>
int launch(const void* x, const void* w, const int* bmap, void* y, int nt, int E, int D, int F,
           int64_t sx, int64_t swe, int64_t swd, cudaStream_t stream) {
  const dim3 grid(nt, F / kBN);
  gmm_kernel<T, BT, TW><<<grid, Tile<BT>::kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), bmap, static_cast<T*>(y), E, D, F,
      sx, swe, swd);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool TW>
int dispatch_bt(int bt, const void* x, const void* w, const int* bmap, void* y, int nt, int E,
                int D, int F, int64_t sx, int64_t swe, int64_t swd, cudaStream_t s) {
  switch (bt) {
    case 8: return launch<T, 8, TW>(x, w, bmap, y, nt, E, D, F, sx, swe, swd, s);
    case 16: return launch<T, 16, TW>(x, w, bmap, y, nt, E, D, F, sx, swe, swd, s);
    case 32: return launch<T, 32, TW>(x, w, bmap, y, nt, E, D, F, sx, swe, swd, s);
    case 64: return launch<T, 64, TW>(x, w, bmap, y, nt, E, D, F, sx, swe, swd, s);
    case 128: return launch<T, 128, TW>(x, w, bmap, y, nt, E, D, F, sx, swe, swd, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}


// ---- bfloat16: tensor cores, weights as the M side ----

constexpr int kTcBK = 64;              // D per pipeline stage
constexpr int kTcLd = kTcBK + 8;       // shared row length (kBN == kTcBK): +16 bytes
constexpr int kTcThreads = 128;        // four warps, 16 F columns each

constexpr int kTcStages = 4;           // cp.async ring: 3 steps in flight while one computes

template <int BT> struct TcTile {
  static constexpr int kStageElems = (kTcBK + BT) * kTcLd;    // w [64 D][72], x [BT][72]
  static constexpr int kSmem = kTcStages * kStageElems * static_cast<int>(sizeof(__nv_bfloat16));
};

// TW as in gmm_kernel: dx = dy @ w[e]^T, the weights still the M side
// (dx^T = w[e] dy^T), w's tile read row-major in its own layout, so its
// fragments come by plain ldmatrix where the forward's come by .trans.
template <int BT, bool TW>
__global__ void __launch_bounds__(kTcThreads)
gmm_tc_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
              const int* __restrict__ bmap, __nv_bfloat16* __restrict__ y, int E, int D, int F,
              int64_t sx, int64_t swe, int64_t swd) {
  using Tl = TcTile<BT>;
  constexpr int NT = BT / 8;
  extern __shared__ __align__(16) unsigned char gmm_smem[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(gmm_smem);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int blk = blockIdx.x;
  const int n0 = blockIdx.y * kBN;
  const int e = bmap[blk];
  if (e < 0 || e >= E) __trap();                   // the layout's contract: bmap in [0, E)
  const __nv_bfloat16* xb = x + static_cast<int64_t>(blk) * BT * sx;
  const __nv_bfloat16* wb = w + static_cast<int64_t>(e) * swe + (TW ? n0 * swd : n0);
  const int KT = D / kTcBK;

  auto load = [&](int kt) {                        // D step kt into its ring slot
    __nv_bfloat16* ws = smem + (kt % kTcStages) * Tl::kStageElems;
    __nv_bfloat16* xs = ws + kTcBK * kTcLd;
    const int k0 = kt * kTcBK;
#pragma unroll
    for (int i = 0; i < kTcBK * 8 / kTcThreads; ++i) {    // 8 chunks of 16 bytes a row
      const int c = tid + i * kTcThreads;
      const int r = c / 8, col = c % 8 * 8;
      if constexpr (TW)        // ws[output column][D step]
        rt::cp_async16(ws + r * kTcLd + col, wb + static_cast<int64_t>(r) * swd + k0 + col);
      else                     // ws[D step][output column]
        rt::cp_async16(ws + r * kTcLd + col, wb + static_cast<int64_t>(k0 + r) * swd + col);
    }
#pragma unroll
    for (int i = 0; i < (BT * 8 + kTcThreads - 1) / kTcThreads; ++i) {
      const int c = tid + i * kTcThreads;
      const int r = c / 8, col = c % 8 * 8;
      if (BT * 8 % kTcThreads == 0 || c < BT * 8)
        rt::cp_async16(xs + r * kTcLd + col, xb + r * sx + k0 + col);
    }
  };

  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;

#pragma unroll
  for (int s = 0; s < kTcStages - 1; ++s) {
    if (s < KT) load(s);
    rt::cp_async_commit();
  }
  const int j8 = lane / 8, r8 = lane % 8;
  for (int kt = 0; kt < KT; ++kt) {
    rt::cp_async_wait<kTcStages - 2>();              // step kt has landed
    __syncthreads();                               // ... for every thread; kt-1's slot is free
    if (kt + kTcStages - 1 < KT) load(kt + kTcStages - 1);
    rt::cp_async_commit();
    const __nv_bfloat16* ws = smem + (kt % kTcStages) * Tl::kStageElems;
    const __nv_bfloat16* xs = ws + kTcBK * kTcLd;
#pragma unroll
    for (int ks = 0; ks < kTcBK / 16; ++ks) {
      // A = w^T: 16 F columns x 16 D rows; matrices (f lo, d lo), (f hi, d lo),
      // (f lo, d hi), (f hi, d hi), stored d-major
      uint32_t a[4];
      if constexpr (TW)
        rt::ldsm_x4(a, ws + (warp * 16 + r8 + (j8 % 2) * 8) * kTcLd + ks * 16 + (j8 / 2) * 8);
      else
        rt::ldsm_x4_trans(a, ws + (ks * 16 + r8 + (j8 / 2) * 8) * kTcLd + warp * 16 + (j8 % 2) * 8);
      if constexpr (NT == 1) {
        uint32_t b[2];                             // B = x^T: 16 D x 8 rows, stored row-major
        rt::ldsm_x2(b, xs + r8 * kTcLd + ks * 16 + (j8 % 2) * 8);
        rt::mma_bf16_16816(acc[0], a, b);
      } else {
#pragma unroll
        for (int nt = 0; nt < NT; nt += 2) {       // two n8 tiles per ldmatrix
          uint32_t b[4];
          rt::ldsm_x4(b, xs + ((nt + j8 / 2) * 8 + r8) * kTcLd + ks * 16 + (j8 % 2) * 8);
          rt::mma_bf16_16816(acc[nt], a, b);
          rt::mma_bf16_16816(acc[nt + 1], a, b + 2);
        }
      }
    }
  }
  rt::cp_async_wait<0>();

  // acc[nt] holds y^T rows (F) g, g+8 x columns (rows of y) 2t, 2t+1 of tile nt
  const int g = lane / 4, t = lane % 4;
  const int f = n0 + warp * 16 + g;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    __nv_bfloat16* y0 = y + (static_cast<int64_t>(blk) * BT + nt * 8 + 2 * t) * F + f;
    y0[0] = __float2bfloat16(acc[nt][0]);
    y0[F] = __float2bfloat16(acc[nt][1]);
    y0[8] = __float2bfloat16(acc[nt][2]);
    y0[F + 8] = __float2bfloat16(acc[nt][3]);
  }
}

template <int BT, bool TW>
int launch_tc(const void* x, const void* w, const int* bmap, void* y, int nt, int E, int D,
              int F, int64_t sx, int64_t swe, int64_t swd, cudaStream_t stream) {
  constexpr int smem = TcTile<BT>::kSmem;
  auto kernel = gmm_tc_kernel<BT, TW>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(nt, F / kBN);
  kernel<<<grid, kTcThreads, smem, stream>>>(static_cast<const __nv_bfloat16*>(x),
                                             static_cast<const __nv_bfloat16*>(w), bmap,
                                             static_cast<__nv_bfloat16*>(y), E, D, F, sx, swe,
                                             swd);
  return static_cast<int>(cudaGetLastError());
}

template <bool TW>
int dispatch_bt_tc(int bt, const void* x, const void* w, const int* bmap, void* y, int nt, int E,
                   int D, int F, int64_t sx, int64_t swe, int64_t swd, cudaStream_t s) {
  switch (bt) {
    case 8: return launch_tc<8, TW>(x, w, bmap, y, nt, E, D, F, sx, swe, swd, s);
    case 16: return launch_tc<16, TW>(x, w, bmap, y, nt, E, D, F, sx, swe, swd, s);
    case 32: return launch_tc<32, TW>(x, w, bmap, y, nt, E, D, F, sx, swe, swd, s);
    default: break;
  }
  if constexpr (!TW) {   // B4b's dx at block_t 64 and 128 is csrc/moe_gmm_bwd.cu's
    if (bt == 64) return launch_tc<64, TW>(x, w, bmap, y, nt, E, D, F, sx, swe, swd, s);
    if (bt == 128) return launch_tc<128, TW>(x, w, bmap, y, nt, E, D, F, sx, swe, swd, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// ---- B4b's dW: dw[e] = sum over the row blocks i of expert e of x[blk i]^T dy[blk i] ----
//
// One block of threads per (expert, 64-row D tile, 64-column F tile), the
// tile's only writer: it lists its expert's row blocks in shared memory (warp
// 0 scans block_to_expert with ballots, in order: no host round trip, any
// order of the map), then runs the product over those blocks' rows packed one
// after the other, in steps of rows that need not align with blocks (packed
// row p is row p % BT of the list's block p / BT; rows past the list are
// zeros). The sums run in float32 in that fixed order; an expert with no rows
// gets zeros. Rows of padding blocks are zero in the layout, so they add
// nothing.

// warp 0 lists the blocks of expert e in ascending order; returns their count
__device__ __forceinline__ int list_blocks(const int* __restrict__ bmap, int nt, int e,
                                           int* list, int* count) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int n = 0;
    for (int i0 = 0; i0 < nt; i0 += 32) {
      const int i = i0 + lane;
      const bool mine = i < nt && bmap[i] == e;
      const unsigned m = __ballot_sync(0xffffffffu, mine);
      if (mine) list[n + __popc(m & ((1u << lane) - 1u))] = i;
      n += __popc(m);
    }
    if (lane == 0) *count = n;
  }
  __syncthreads();
  return *count;
}

// float32: 256 threads, each 4 D rows x 4 F columns, RK rows a step staged
// in shared memory
constexpr int kDwRK = 32;

__global__ void __launch_bounds__(256)
gmm_dw_kernel(const float* __restrict__ x, const float* __restrict__ dy,
              const int* __restrict__ bmap, float* __restrict__ dw, int lbt, int nt, int D,
              int F, int64_t sx, int64_t sdy) {
  extern __shared__ int dw_list[];
  __shared__ __align__(16) float xs[kDwRK][kBN];
  __shared__ __align__(16) float ys[kDwRK][kBN];
  __shared__ int count;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int f0 = blockIdx.x * kBN, d0 = blockIdx.y * kBN, e = blockIdx.z;
  const int rows = list_blocks(bmap, nt, e, dw_list, &count) << lbt;
  const int bt = 1 << lbt;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < rows; k0 += kDwRK) {
#pragma unroll
    for (int v = 0; v < kDwRK * kBN / 4 / 256; ++v) {
      const int idx = tid + v * 256;
      const int r = idx / (kBN / 4), c = idx % (kBN / 4) * 4;
      const int p = k0 + r;
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f), g = a;
      if (p < rows) {
        const int64_t row = static_cast<int64_t>(dw_list[p >> lbt]) * bt + (p & (bt - 1));
        a = *reinterpret_cast<const float4*>(x + row * sx + d0 + c);
        g = *reinterpret_cast<const float4*>(dy + row * sdy + f0 + c);
      }
      *reinterpret_cast<float4*>(&xs[r][c]) = a;
      *reinterpret_cast<float4*>(&ys[r][c]) = g;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kDwRK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&xs[kk][ty * 4]);
      const float4 g = *reinterpret_cast<const float4*>(&ys[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w}, gv[4] = {g.x, g.y, g.z, g.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], gv[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* out = dw + (static_cast<int64_t>(e) * D + d0 + ty * 4) * F + f0 + tx * 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    *reinterpret_cast<float4*>(out + static_cast<int64_t>(i) * F) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
}

// bfloat16: tensor cores, four warps of 16 D rows x 64 F columns each; A =
// x^T (x's tile stored [rows][D], fragments by ldmatrix.trans), B = dy (stored
// [rows][F], fragments by ldmatrix.trans); 64-row steps through a 4-stage
// cp.async ring as in the forward
constexpr int kDwStageElems = 2 * kTcBK * kTcLd;                  // x [64][72], dy [64][72]
constexpr int kDwSmem = kTcStages * kDwStageElems * static_cast<int>(sizeof(__nv_bfloat16));

__global__ void __launch_bounds__(kTcThreads)
gmm_dw_tc_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ dy,
                 const int* __restrict__ bmap, __nv_bfloat16* __restrict__ dw, int lbt, int nt,
                 int D, int F, int64_t sx, int64_t sdy) {
  extern __shared__ __align__(16) unsigned char dw_smem[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(dw_smem);
  int* list = reinterpret_cast<int*>(dw_smem + kDwSmem);
  __shared__ int count;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int f0 = blockIdx.x * kBN, d0 = blockIdx.y * kBN, e = blockIdx.z;
  const int rows = list_blocks(bmap, nt, e, list, &count) << lbt;
  const int bt = 1 << lbt;
  const int KT = (rows + kTcBK - 1) / kTcBK;

  auto load = [&](int kt) {                        // rows kt*64 ... into their ring slot
    __nv_bfloat16* xs = smem + (kt % kTcStages) * kDwStageElems;
    __nv_bfloat16* ys = xs + kTcBK * kTcLd;
#pragma unroll
    for (int i = 0; i < kTcBK * 8 / kTcThreads; ++i) {    // 8 chunks of 16 bytes a row
      const int c = tid + i * kTcThreads;
      const int r = c / 8, col = c % 8 * 8;
      const int p = kt * kTcBK + r;
      const bool in = p < rows;
      const int64_t row = in ? static_cast<int64_t>(list[p >> lbt]) * bt + (p & (bt - 1)) : 0;
      rt::cp_async16(xs + r * kTcLd + col, x + row * sx + d0 + col, in);
      rt::cp_async16(ys + r * kTcLd + col, dy + row * sdy + f0 + col, in);
    }
  };

  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;

#pragma unroll
  for (int s = 0; s < kTcStages - 1; ++s) {
    if (s < KT) load(s);
    rt::cp_async_commit();
  }
  const int j8 = lane / 8, r8 = lane % 8;
  for (int kt = 0; kt < KT; ++kt) {
    rt::cp_async_wait<kTcStages - 2>();              // step kt has landed
    __syncthreads();                               // ... for every thread; kt-1's slot is free
    if (kt + kTcStages - 1 < KT) load(kt + kTcStages - 1);
    rt::cp_async_commit();
    const __nv_bfloat16* xs = smem + (kt % kTcStages) * kDwStageElems;
    const __nv_bfloat16* ys = xs + kTcBK * kTcLd;
#pragma unroll
    for (int ks = 0; ks < kTcBK / 16; ++ks) {
      // A = x^T: 16 D x 16 rows, stored row-major [rows][D]
      uint32_t a[4];
      rt::ldsm_x4_trans(a, xs + (ks * 16 + r8 + (j8 / 2) * 8) * kTcLd + warp * 16 + (j8 % 2) * 8);
#pragma unroll
      for (int nt8 = 0; nt8 < 8; nt8 += 2) {       // B = dy: 16 rows x 8 F, two n8 tiles
        uint32_t b[4];
        rt::ldsm_x4_trans(b, ys + (ks * 16 + (j8 % 2) * 8 + r8) * kTcLd + (nt8 + j8 / 2) * 8);
        rt::mma_bf16_16816(acc[nt8], a, b);
        rt::mma_bf16_16816(acc[nt8 + 1], a, b + 2);
      }
    }
  }
  rt::cp_async_wait<0>();

  // acc[j] holds dw rows (D) g, g+8 x columns (F) 2t, 2t+1 of n8 tile j
  const int g = lane / 4, t = lane % 4;
  __nv_bfloat16* out = dw + (static_cast<int64_t>(e) * D + d0 + warp * 16 + g) * F + f0 + 2 * t;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    *reinterpret_cast<uint32_t*>(out + j * 8) = rt::pack_bf16(acc[j][0], acc[j][1]);
    *reinterpret_cast<uint32_t*>(out + 8 * static_cast<int64_t>(F) + j * 8) =
        rt::pack_bf16(acc[j][2], acc[j][3]);
  }
}

int launch_dw(int dtype, const void* x, const void* dy, const int* bmap, void* dw, int bt,
              int nt, int E, int D, int F, int64_t sx, int64_t sdy, cudaStream_t stream) {
  int lbt = 0;
  while ((1 << lbt) < bt) ++lbt;
  const dim3 grid(F / kBN, D / kBN, E);
  const int list_bytes = nt * static_cast<int>(sizeof(int));
  if (dtype == rt::kFloat32) {
    cudaError_t err = cudaFuncSetAttribute(gmm_dw_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           list_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    gmm_dw_kernel<<<grid, 256, list_bytes, stream>>>(
        static_cast<const float*>(x), static_cast<const float*>(dy), bmap,
        static_cast<float*>(dw), lbt, nt, D, F, sx, sdy);
  } else {
    if (bt > 32) return static_cast<int>(cudaErrorInvalidValue);   // csrc/moe_gmm_bwd.cu's
    const int smem = kDwSmem + list_bytes;
    cudaError_t err = cudaFuncSetAttribute(gmm_dw_tc_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    gmm_dw_tc_kernel<<<grid, kTcThreads, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(dy), bmap,
        static_cast<__nv_bfloat16*>(dw), lbt, nt, D, F, sx, sdy);
  }
  return static_cast<int>(cudaGetLastError());
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
    return dispatch_bt<float, false>(block_t, x, w, b, y, nt, E, D, F, sx, swe, swd, s);
  if (dtype == rt::kBFloat16)
    return dispatch_bt_tc<false>(block_t, x, w, b, y, nt, E, D, F, sx, swe, swd, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// B4b's dx: dx[i*BT:(i+1)*BT] = dy[i*BT:(i+1)*BT] @ w[block_to_expert[i]]^T,
// dy [T_pad, F] (rows through sdy), w [E, D, F] read in place, dx [T_pad, D]
// contiguous. The forward's kernels with w's tile taken transposed (TW); bf16
// only at block_t 8-32 (64 and 128: csrc/moe_gmm_bwd.cu).
extern "C" int grouped_matmul_dx(const void* dy, const void* w, const void* bmap, void* dx,
                                 int dtype, int block_t, int nt, int E, int D, int F,
                                 int64_t sdy, int64_t swe, int64_t swd, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* b = static_cast<const int*>(bmap);
  // the kernels' D is the summed extent (F here) and their F the output's (D)
  if (dtype == rt::kFloat32)
    return dispatch_bt<float, true>(block_t, dy, w, b, dx, nt, E, F, D, sdy, swe, swd, s);
  if (dtype == rt::kBFloat16)
    return dispatch_bt_tc<true>(block_t, dy, w, b, dx, nt, E, F, D, sdy, swe, swd, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// B4b's dW: dw [E, D, F] contiguous, in x's type, from x [T_pad, D] and dy
// [T_pad, F] (rows through sx and sdy). Every expert's tile is written, zeros
// where it has no rows. bf16 only at block_t 8-32 (64 and 128:
// csrc/moe_gmm_bwd.cu).
extern "C" int grouped_matmul_dw(const void* x, const void* dy, const void* bmap, void* dw,
                                 int dtype, int block_t, int nt, int E, int D, int F,
                                 int64_t sx, int64_t sdy, void* stream) {
  if (dtype != rt::kFloat32 && dtype != rt::kBFloat16)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_dw(dtype, x, dy, static_cast<const int*>(bmap), dw, block_t, nt, E, D, F, sx,
                   sdy, static_cast<cudaStream_t>(stream));
}
