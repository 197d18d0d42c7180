// B4b's bfloat16 route at block_t 64 and 128 (every training microbatch): the
// backward of the grouped matmul y[blk i] = x[blk i] @ w[e_i] on Hopper's
// warpgroup MMA (wgmma.mma_async, bf16 operands, float32 sums in registers),
// its tiles brought by the Tensor Memory Accelerator (TMA) into a ring of
// shared-memory stages guarded by mbarriers (the helpers are in common.cuh).
//
//   dx[blk i] = dy[blk i] @ w[e_i]^T     dy [T_pad, F], w [E, D, F], dx [T_pad, D]
//   dw[e]     = sum over e's rows of x^T dy          x [T_pad, D], dw [E, D, F]
//
// Replaces no TPU kernel: the JAX model differentiates its expert einsums
// (repro/models/moe.py:88-91) by autodiff. csrc/moe_gmm.cu keeps B4's forward
// and B4b's other routes (float32 FMA; bf16 mma.sync at block_t 8-32).
//
// Bound, at moonshot_v1_16b's training microbatch (T_pad 32 768, block_t 128,
// D 2048, F 1408, 64 experts, 24 576 rows kept, 219 of 256 row blocks used):
// the bytes at 3.35 TB/s, 0.174 ms for dx (dy's used rows and each used
// expert's weights read, all of dx written) and 0.168 ms for dW (x's and dy's
// used rows read, 369 MB of dw written), against 2 * kept * D * F operations
// (0.144 ms at 989 TFLOP/s). Both are products over short, ragged groups, so
// what the design must do is keep the tensor cores fed from L2: large tiles
// (each operand byte re-read from L2 few times), loads that never wait for the
// math, and no work on the layout's trailing all-padding blocks.
//
// Shape of both kernels: persistent, one block of threads per SM walking the
// output tiles t = blockIdx.x, + gridDim.x, ...; NWG consumer warpgroups (64
// output rows each, a 64 x 256 float32 sum in 128 registers a thread) and one
// producer warp, whose lane 0 keeps a 3-stage ring of 48 KB full (every load a
// 64 x 64 bf16 box of 8 KB, 128-byte rows swizzled by 128 bytes, as wgmma
// reads them). The producer runs ahead across tiles, so one tile's loads
// overlap the previous tile's epilogue. Each stage is 4 wgmma.m64n256k16 a
// warpgroup; the warpgroup keeps one group in flight while it waits for the
// next stage. The epilogue rounds the sums to bf16 into a 32 KB output tile
// in shared memory, which the TMA stores while the warpgroup computes its next
// tile: at dW's shapes the 369 MB of dw take as long as the products, so the
// stores must not stall the tensor cores (first written from registers, 4
// bytes a lane scattered over 8 rows, they ran at ~0.9 TB/s).
//
// dx: a tile is one row block (M = block_t, NWG = block_t / 64) by 256 of D.
// A = dy's rows (K = F contiguous: K-major) through a 2D map over [T_pad, F];
// B = w[e]'s 256 rows of D by 64 of F, K-major in its own [E, D, F] layout,
// through a 3D map: no transposed copy of w. dy's row block is read D / 256
// times (8 at D 2048), each expert's weights once per row block. Row blocks at
// or past used_blocks (the layout's trailing padding) get zeros and no loads.
//
// dW: a tile is (expert, 128 of D, 256 of F), its only writer (no atomics on
// dw: two calls are bit-equal). Each block counts every expert's row blocks
// in block_to_expert[:used_blocks] first (any order of the map, on the card,
// no host round trip); a tile's K runs over its expert's rows in 64-row
// steps, in ascending block order, which the producer warp finds by ballots
// over the map as it goes (no table that grows with T_pad). A = x^T: x's box
// [64 rows][64 of D] is MN-major (D contiguous), which wgmma takes for bf16
// through its transpose bit; B = dy's boxes [64 rows][4 x 64 of F], MN-major
// too. An expert with no rows gets zeros. Skipping the blocks past
// used_blocks changes no bit: they are padding, whose x rows are zero, and
// they would come last in their expert's sum. used_blocks promises that x and
// dy are zero on those rows (kernels/moe_gmm.py), so dx's zeros there are what
// the product would give.
//
// Edges: D and F are multiples of 64 but not of the tiles; boxes wholly past
// the edge are neither loaded (the ring's stale bytes there feed only sums
// that are not stored) nor stored. TMA descriptors come from
// cuTensorMapEncodeTiled, a libcuda function that the CUDA runtime hands
// out through cudaGetDriverEntryPoint, so the library needs no -lcuda.
#include <cuda.h>  // CUtensorMap and its enums (types only)

#include "common.cuh"

namespace {

constexpr int kBK = 64;                  // K a stage: 64 bf16, one 128-byte row
constexpr int kBox = 64 * 64 * 2;        // bytes of one 64 x 64 box
constexpr int kN = 256;                  // output columns a tile
constexpr int kNBox = kN / 64;           // B's boxes a stage
constexpr int kStages = 3;
constexpr int kSwizzleRow = 1024;        // 8 rows of 128 bytes: a swizzle atom

template <int NWG> struct Ring {
  static constexpr int kA = NWG * kBox;                 // A: NWG boxes of 64 x 64
  static constexpr int kStage = kA + kNBox * kBox;      // + B: 4 boxes
  static constexpr int kBytes = kStages * kStage;
  static constexpr int kOut = kNBox * kBox;             // a warpgroup's output tile
  static constexpr int kThreads = NWG * 128 + 32;       // + the producer warp
  // shared memory: room to align to 1024 bytes, the ring, the output tiles,
  // the ring's barriers
  static constexpr int kSmem = 1024 + kBytes + NWG * kOut + 2 * kStages * 8;
};

__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  const uint32_t a = rt::smem_u32(p);
  return p + ((1024 - (a & 1023)) & 1023);
}

// the barriers' initial state: full[s] completes on the producer's arrival and
// the stage's bytes; empty[s] on one arrival of each consumer warpgroup
__device__ __forceinline__ void init_ring(uint64_t* full, uint64_t* empty, int nwg) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      rt::mbar_init(full + s, 1);
      rt::mbar_init(empty + s, nwg);
    }
    rt::mbar_fence_init();
  }
}

// One k-step of a consumer warpgroup: wait for stage `it`, issue its 4 k16
// products, keep them in flight, retire the previous step's and free its stage.
template <int TA, int TB>
__device__ __forceinline__ void consume(float* acc, uint64_t* full, uint64_t* empty, int it,
                                        bool first, uint64_t da, uint64_t db, int step_a,
                                        int step_b, bool leader) {
  const int s = it % kStages;
  rt::mbar_wait(full + s, (it / kStages) & 1);
  rt::fence_regs<128>(acc);
  rt::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk)
    rt::wgmma_m64n256k16<TA, TB>(acc, da + kk * step_a, db + kk * step_b, !first || kk > 0);
  rt::wgmma_commit();
  rt::fence_regs<128>(acc);
  if (!first) {
    rt::wgmma_wait<1>();
    rt::fence_regs<128>(acc);
    if (leader) rt::mbar_arrive(empty + (it - 1) % kStages);
  }
}

// the last step of a tile retired and its stage freed
__device__ __forceinline__ void drain(float* acc, uint64_t* empty, int it, bool leader) {
  rt::wgmma_wait<0>();
  rt::fence_regs<128>(acc);
  if (leader) rt::mbar_arrive(empty + (it - 1) % kStages);
}

// A warpgroup's 64 x 256 tile (zeros when acc is null), rounded to bf16, to
// the output at (column c0, row r0) of `map`: written into the warpgroup's
// output tile in shared memory (4 boxes of 64 x 64, 128-byte rows swizzled as
// the map's: conflict-free, the XOR spreading a warp's 8 rows over the banks),
// then stored by the TMA, box by box while a box starts below `cols`. The
// store runs on while the warpgroup computes its next tile; the next call
// first waits until it has read the tile. `wg` names the warpgroup's barrier.
__device__ __forceinline__ void store_tile(const float* acc, unsigned char* tile,
                                           const CUtensorMap* map, int c0, int r0, int cols,
                                           int wg, bool leader) {
  const int lane = threadIdx.x % 32, warp = (threadIdx.x / 32) % 4;
  if (leader) rt::bulk_wait_read<0>();
  rt::named_bar_sync(1 + wg, 128);
  // rows r and r + 8 (r % 8 == lane / 4: the swizzle's XOR), 4 bytes a lane
  unsigned char* row = tile + (warp * 16 + lane / 4) * 128 + (lane % 4) * 4;
#pragma unroll
  for (int j = 0; j < kN / 8; ++j) {
    unsigned char* p = row + (j / 8) * kBox + (((j % 8) ^ (lane / 4)) * 16);
    *reinterpret_cast<uint32_t*>(p) = acc ? rt::pack_bf16(acc[4 * j], acc[4 * j + 1]) : 0u;
    *reinterpret_cast<uint32_t*>(p + 8 * 128) =
        acc ? rt::pack_bf16(acc[4 * j + 2], acc[4 * j + 3]) : 0u;
  }
  rt::fence_proxy_async();
  rt::named_bar_sync(1 + wg, 128);
  if (leader) {
    for (int b = 0; b < kNBox && b * 64 < cols; ++b)
      rt::tma_store_2d(map, tile + b * kBox, c0 + b * 64, r0);
    rt::bulk_commit();
  }
}

// ---- dx ----

template <int NWG>
__global__ void __launch_bounds__(Ring<NWG>::kThreads, 1)
gmm_dx_wgmma_kernel(const __grid_constant__ CUtensorMap dy_map,
                    const __grid_constant__ CUtensorMap w_map,
                    const __grid_constant__ CUtensorMap dx_map, const int* __restrict__ bmap,
                    const int* __restrict__ used_blocks, int nt, int E, int D, int F) {
  using R = Ring<NWG>;
  constexpr int BT = NWG * 64;
  extern __shared__ unsigned char dx_smem[];
  unsigned char* ring = align_1024(dx_smem);
  unsigned char* out_tiles = ring + R::kBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(out_tiles + NWG * R::kOut);
  uint64_t* empty = full + kStages;
  init_ring(full, empty, NWG);
  __syncthreads();

  const int used = used_blocks ? min(*used_blocks, nt) : nt;
  const int NT = (D + kN - 1) / kN, tiles = nt * NT, KT = F / kBK;
  const int warp = threadIdx.x / 32;
  if (warp == NWG * 4) {                           // the producer
    if (threadIdx.x % 32 == 0) {
      int it = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int blk = t / NT, n0 = t % NT * kN;
        if (blk >= used) continue;
        const int e = bmap[blk];
        if (e < 0 || e >= E) __trap();             // the layout's contract: bmap in [0, E)
        const int nb = min(kNBox, (D - n0) / 64);
        for (int k = 0; k < KT; ++k, ++it) {
          const int s = it % kStages;
          rt::mbar_wait(empty + s, ((it / kStages) & 1) ^ 1);
          unsigned char* st = ring + s * R::kStage;
          rt::mbar_arrive_expect_tx(full + s, (NWG + nb) * kBox);
#pragma unroll
          for (int g = 0; g < NWG; ++g)
            rt::tma_load_2d(st + g * kBox, &dy_map, full + s, k * kBK, blk * BT + g * 64);
          for (int j = 0; j < nb; ++j)
            rt::tma_load_3d(st + R::kA + j * kBox, &w_map, full + s, k * kBK, n0 + j * 64, e);
        }
      }
    }
  } else {                                         // consumer warpgroup wg: rows wg*64..
    const int wg = warp / 4;
    const bool leader = threadIdx.x % 128 == 0;
    float acc[128];
    int it = 0;
    unsigned char* tile = out_tiles + wg * R::kOut;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int blk = t / NT, n0 = t % NT * kN, r0 = blk * BT + wg * 64;
      if (blk >= used) {
        store_tile(nullptr, tile, &dx_map, n0, r0, D - n0, wg, leader);
        continue;
      }
      for (int k = 0; k < KT; ++k, ++it) {
        const unsigned char* st = ring + (it % kStages) * R::kStage;
        // K-major A and B: LBO unused, 8-row groups 1024 bytes apart, k16 = +32 bytes
        consume<0, 0>(acc, full, empty, it, k == 0, rt::wgmma_desc(st + wg * kBox, 16, kSwizzleRow),
                      rt::wgmma_desc(st + R::kA, 16, kSwizzleRow), 2, 2, leader);
      }
      drain(acc, empty, it, leader);
      store_tile(acc, tile, &dx_map, n0, r0, D - n0, wg, leader);
    }
    if (leader) rt::bulk_wait_read<0>();
  }
}

// ---- dW ----

constexpr int kDwWG = 2;                          // 128 of D a tile

__global__ void __launch_bounds__(Ring<kDwWG>::kThreads, 1)
gmm_dw_wgmma_kernel(const __grid_constant__ CUtensorMap x_map,
                    const __grid_constant__ CUtensorMap dy_map,
                    const __grid_constant__ CUtensorMap dw_map, const int* __restrict__ bmap,
                    const int* __restrict__ used_blocks, int bt, int nt, int E, int D, int F) {
  using R = Ring<kDwWG>;
  extern __shared__ unsigned char dw_smem[];
  unsigned char* ring = align_1024(dw_smem);
  unsigned char* out_tiles = ring + R::kBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(out_tiles + kDwWG * R::kOut);
  uint64_t* empty = full + kStages;
  int* count = reinterpret_cast<int*>(empty + kStages);   // [E]: each expert's blocks
  init_ring(full, empty, kDwWG);
  for (int e = threadIdx.x; e < E; e += blockDim.x) count[e] = 0;
  __syncthreads();
  const int used = used_blocks ? min(*used_blocks, nt) : nt;
  for (int i = threadIdx.x; i < used; i += blockDim.x) {
    const int e = bmap[i];
    if (e >= 0 && e < E) atomicAdd(count + e, 1);          // ids outside [0, E): no rows
  }
  __syncthreads();

  const int spb = bt / kBK;                                // 64-row steps a block
  const int MT = (D + 127) / 128, NT = (F + kN - 1) / kN, tiles = E * MT * NT;
  const int warp = threadIdx.x / 32;
  if (warp == kDwWG * 4) {                                 // the producer warp
    // It walks block_to_expert[:used] for the tile's expert, 32 ids a ballot,
    // taking its blocks in ascending order; lane 0 waits and loads.
    const int lane = threadIdx.x % 32;
    int it = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int e = t / (MT * NT), d0 = t / NT % MT * 128, f0 = t % NT * kN;
      const int KT = count[e] * spb;
      const int na = min(kDwWG, (D - d0) / 64), nb = min(kNBox, (F - f0) / 64);
      int i0 = -32, blk = 0;
      unsigned found = 0;                                  // e's blocks among i0 .. i0+31
      for (int k = 0; k < KT; ++k, ++it) {
        if (k % spb == 0) {                                // e's next block
          while (found == 0) {
            i0 += 32;
            const int i = i0 + lane;
            found = __ballot_sync(0xffffffffu, i < used && bmap[i] == e);
          }
          blk = i0 + __ffs(found) - 1;
          found &= found - 1;
        }
        if (lane == 0) {
          const int s = it % kStages, row = blk * bt + k % spb * kBK;
          rt::mbar_wait(empty + s, ((it / kStages) & 1) ^ 1);
          unsigned char* st = ring + s * R::kStage;
          rt::mbar_arrive_expect_tx(full + s, (na + nb) * kBox);
          for (int c = 0; c < na; ++c)
            rt::tma_load_2d(st + c * kBox, &x_map, full + s, d0 + c * 64, row);
          for (int j = 0; j < nb; ++j)
            rt::tma_load_2d(st + R::kA + j * kBox, &dy_map, full + s, f0 + j * 64, row);
        }
        __syncwarp();
      }
    }
  } else {                                                 // consumer warpgroup wg: D rows wg*64..
    const int wg = warp / 4;
    const bool leader = threadIdx.x % 128 == 0;
    float acc[128];
    int it = 0;
    unsigned char* tile = out_tiles + wg * R::kOut;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int e = t / (MT * NT), d0 = t / NT % MT * 128 + wg * 64, f0 = t % NT * kN;
      const int KT = count[e] * spb;
      if (d0 >= D) {                                       // past D's edge: only the ring
        for (int k = 0; k < KT; ++k, ++it) {
          const int s = it % kStages;
          rt::mbar_wait(full + s, (it / kStages) & 1);
          if (leader) rt::mbar_arrive(empty + s);
        }
        continue;
      }
      const int r0 = e * D + d0;                           // dw's rows as [E * D, F]
      if (KT == 0) {
        store_tile(nullptr, tile, &dw_map, f0, r0, F - f0, wg, leader);
        continue;
      }
      for (int k = 0; k < KT; ++k, ++it) {
        const unsigned char* st = ring + (it % kStages) * R::kStage;
        // MN-major A and B: the next 64 of D or F one box (8 KB) on, 8-row K
        // groups 1024 bytes apart, k16 = 2 groups = +2048 bytes
        consume<1, 1>(acc, full, empty, it, k == 0,
                      rt::wgmma_desc(st + wg * kBox, kBox, kSwizzleRow),
                      rt::wgmma_desc(st + R::kA, kBox, kSwizzleRow), 128, 128, leader);
      }
      drain(acc, empty, it, leader);
      store_tile(acc, tile, &dw_map, f0, r0, F - f0, wg, leader);
    }
    if (leader) rt::bulk_wait_read<0>();
  }
}

// ---- host: tensor maps and launches ----

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a map of 64 x 64 (x 1) bf16 boxes, 128-byte swizzle, over a tensor of `rank`
// dims (innermost first) with the outer dims' strides in elements
bool make_map(CUtensorMap* map, const void* base, int rank, const uint64_t* dims,
              const int64_t* strides) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  cuuint64_t d[3], st[2];
  cuuint32_t box[3] = {64, 64, 1}, es[3] = {1, 1, 1};
  for (int i = 0; i < rank; ++i) d[i] = dims[i];
  for (int i = 0; i + 1 < rank; ++i) st[i] = static_cast<cuuint64_t>(strides[i]) * 2;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base), d, st,
                box, es, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return n;
}

template <int NWG>
int launch_dx(const void* dy, const void* w, const int* bmap, const int* used, void* dx, int nt,
              int E, int D, int F, int64_t sdy, int64_t swe, int64_t swd, cudaStream_t stream) {
  using R = Ring<NWG>;
  CUtensorMap dy_map, w_map, dx_map;
  const uint64_t T = static_cast<uint64_t>(nt) * NWG * 64;
  const uint64_t dy_dims[2] = {static_cast<uint64_t>(F), T};
  const uint64_t dx_dims[2] = {static_cast<uint64_t>(D), T};
  const uint64_t w_dims[3] = {static_cast<uint64_t>(F), static_cast<uint64_t>(D),
                              static_cast<uint64_t>(E)};
  const int64_t w_strides[2] = {swd, swe}, sdx = D;
  if (!make_map(&dy_map, dy, 2, dy_dims, &sdy) || !make_map(&w_map, w, 3, w_dims, w_strides) ||
      !make_map(&dx_map, dx, 2, dx_dims, &sdx))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = gmm_dx_wgmma_kernel<NWG>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, R::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = nt * ((D + kN - 1) / kN), sms = sm_count();
  if (sms == 0) return static_cast<int>(cudaErrorInvalidDevice);
  kernel<<<min(tiles, sms), R::kThreads, R::kSmem, stream>>>(
      dy_map, w_map, dx_map, bmap, used, nt, E, D, F);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points, loaded with ctypes; bf16 only, block_t 64 or 128, D
// and F multiples of 64, rows 16-byte aligned (the wrapper checks). used: a
// device int32, the layout's used row blocks (those at and past it hold only
// padding), or null for all nt. Strides in elements. Returns the cudaError_t
// of the launch (cudaErrorInvalidValue where a tensor map cannot be made).

// dx [T_pad, D] contiguous = dy (rows through sdy) @ w[e]^T, w [E, D, F] read
// in place (swe between experts, swd between rows)
extern "C" int grouped_matmul_dx_wgmma(const void* dy, const void* w, const void* bmap,
                                       const void* used, void* dx, int block_t, int nt, int E,
                                       int D, int F, int64_t sdy, int64_t swe, int64_t swd,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* b = static_cast<const int*>(bmap);
  const int* u = static_cast<const int*>(used);
  if (block_t == 64) return launch_dx<1>(dy, w, b, u, dx, nt, E, D, F, sdy, swe, swd, s);
  if (block_t == 128) return launch_dx<2>(dy, w, b, u, dx, nt, E, D, F, sdy, swe, swd, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// dw [E, D, F] contiguous from x [T_pad, D] and dy [T_pad, F] (rows through sx
// and sdy); every expert's tile is written, zeros where it has no rows
extern "C" int grouped_matmul_dw_wgmma(const void* x, const void* dy, const void* bmap,
                                       const void* used, void* dw, int block_t, int nt, int E,
                                       int D, int F, int64_t sx, int64_t sdy, void* stream) {
  using R = Ring<kDwWG>;
  if (block_t != 64 && block_t != 128) return static_cast<int>(cudaErrorInvalidValue);
  const uint64_t T = static_cast<uint64_t>(nt) * block_t;
  const uint64_t x_dims[2] = {static_cast<uint64_t>(D), T};
  const uint64_t dy_dims[2] = {static_cast<uint64_t>(F), T};
  const uint64_t dw_dims[2] = {static_cast<uint64_t>(F), static_cast<uint64_t>(E) * D};
  const int64_t sdw = F;
  CUtensorMap x_map, dy_map, dw_map;
  if (!make_map(&x_map, x, 2, x_dims, &sx) || !make_map(&dy_map, dy, 2, dy_dims, &sdy) ||
      !make_map(&dw_map, dw, 2, dw_dims, &sdw))
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = R::kSmem + E * static_cast<int>(sizeof(int));
  cudaError_t err = cudaFuncSetAttribute(gmm_dw_wgmma_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = E * ((D + 127) / 128) * ((F + kN - 1) / kN), sms = sm_count();
  if (sms == 0) return static_cast<int>(cudaErrorInvalidDevice);
  gmm_dw_wgmma_kernel<<<min(tiles, sms), R::kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x_map, dy_map, dw_map, static_cast<const int*>(bmap), static_cast<const int*>(used),
      block_t, nt, E, D, F);
  return static_cast<int>(cudaGetLastError());
}
