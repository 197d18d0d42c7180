// Mamba-1 selective scan for Hopper, with the state carried in and out:
//   h_t = exp(dt_t A) * h_{t-1} + (dt_t x_t) B_t      h_{-1} = h0 (zeros if absent)
//   y_t = C_t . h_t + D x_t                            and h_S written out.
// On request (hs not null) also the state at the start of every SC =
// rt::state_chunk(N) = 16 steps, hs [Bt, ceil(S/SC), DI, N] float32 (the
// first is h0): the backward (mamba_scan_bwd.cu) recomputes the states of
// each such span from them. SC divides the staging chunk TC (32, or 16 at N
// 32), so a state is written at every half-chunk or every chunk. Writing
// them changes nothing else: y and h_S are the same bits with or without.
// dt, x [Bt,S,DI]; B, C [Bt,S,N] (float32 or bfloat16, any strides);
// A [DI,N], D [DI], h0 and h_S [Bt,DI,N] float32, contiguous; y [Bt,S,DI]
// contiguous, in the inputs' type.
//
// Replaces the TPU kernel repro/kernels/mamba_scan.py::_mamba_kernel. The TPU
// grid is (batch, DI blocks, sequence chunks) with the chunk axis sequential
// and h carried across it in VMEM scratch. Blocks on the card run in no
// order, so nothing is carried between blocks: one block owns 64 channels for
// the whole sequence and loops over t itself. The TPU kernel starts from
// h = 0 and drops the final state; prefill needs it for the decode cache, so
// this one takes h0 and writes h_S.
//
// Bound: it reads dt, x, B, C, A, h0 once and writes y and h_S once (4.7 MB,
// 1.4 us at the serving shape Bt1 S32 DI8192 N16 in float32), and takes one
// exponential per (t, channel, state): 33.5 M at S256, which the SFUs (16 a
// clock per SM) need about 8 us for. Its floor is the SFUs at long prompts
// and the latency of its sequential loop over t at short ones; PERF.md has
// how far above it runs.
//
// Design. One block of 256 threads per 64 channels; one thread per (channel,
// N/4 states): the thread keeps its states and A (scaled by log2 e once, so
// each exponential is one ex2.approx) in registers, and its N/4 states are
// independent chains; y takes two shuffles a step. (With 1 or 2 threads a
// channel, fewer shuffles and longer chains, falcon_mamba_7b's prefill ran
// slower at every bucket on the H100: PERF.md.) Steps go in groups whose loads, exponentials and shuffles
// are independent of each other, only h carrying from step to step. dt and
// x of a chunk of time steps for the block's contiguous channels, and B and
// C (shared by the whole block, read as broadcast vectors), arrive in shared
// memory by 16-byte cp.async, double-buffered: chunk k+1 is in flight while
// chunk k is scanned. Inputs that are not 16-byte aligned along channels
// (strided views) are staged by plain loads instead. y of a step takes x's
// place in shared memory, and a chunk's y goes out in 16-byte stores once the
// chunk is done. For bfloat16 inputs dt*x is rounded to bfloat16 before the
// product with B, as the plain version and the JAX oracle compute it.
#include "common.cuh"

namespace {

constexpr int kCh = 64;                     // channels of a block
constexpr int kP = 4;                       // threads of a channel
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// n values of T from shared memory as float32, 16 bytes a load where n fills them
template <typename T, int n> __device__ __forceinline__ void load_row(const T* src, float* dst) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  if constexpr (n % kVec == 0) {
#pragma unroll
    for (int j = 0; j < n / kVec; ++j)
      rt::Cvt<T>::unpack(reinterpret_cast<const uint4*>(src)[j], dst + j * kVec);
  } else {
#pragma unroll
    for (int i = 0; i < n; ++i) dst[i] = rt::to_float(src[i]);
  }
}

template <typename T, int N>
__global__ void __launch_bounds__(kCh * kP)
mamba_scan_kernel(const T* __restrict__ dt, const T* __restrict__ x, const T* __restrict__ Bm,
                  const T* __restrict__ Cm, const float* __restrict__ A,
                  const float* __restrict__ D, const float* __restrict__ h0, T* __restrict__ y,
                  float* __restrict__ hS, float* __restrict__ hs, int S, int DI, int64_t sdb,
                  int64_t sdt, int64_t sdd,
                  int64_t sxb, int64_t sxt, int64_t sxd, int64_t sBb, int64_t sBt, int64_t sBn,
                  int64_t sCb, int64_t sCt, int64_t sCn, int vec_dx, int vec_bc) {
  constexpr int NP = N / kP;                // states of a thread
  constexpr int TC = rt::scan_chunk(N);     // time steps of a chunk
  constexpr int SC = rt::state_chunk(N);    // time steps between saved states
  constexpr int SG = NP >= 16 ? 32 / NP : NP == 8 ? 4 : 8;   // steps of a group
  static_assert(TC % SC == 0 && SC % SG == 0, "a saved state falls on a group's first step");
  constexpr int kThreads = kCh * kP;
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  __shared__ __align__(16) T s_dt[2][TC][kCh];
  __shared__ __align__(16) T s_x[2][TC][kCh];
  __shared__ __align__(16) T s_B[2][TC][N];
  __shared__ __align__(16) T s_C[2][TC][N];

  const int b = blockIdx.y;
  const int d0 = blockIdx.x * kCh;
  const int tid = threadIdx.x;
  const int c = tid / kP;
  const int n0 = tid % kP * NP;
  const int d = d0 + c;
  const bool live = d < DI;
  const int64_t hidx = (static_cast<int64_t>(b) * DI + d) * N + n0;

  const T* dtb = dt + b * sdb;
  const T* xb = x + b * sxb;
  const T* Bb = Bm + b * sBb;
  const T* Cb = Cm + b * sCb;
  T* yb = y + static_cast<int64_t>(b) * S * DI;
  const T zero = rt::from_float<T>(0.f);

  // dt and x move in 16-byte pieces (kVec channels of one time step); thread
  // tid owns pieces tid, tid + kThreads, ... of every chunk, for staging and
  // for writing y back from s_x, so no other thread touches them between
  constexpr int kPieces = TC * kCh / kVec;
  constexpr int kMine = (kPieces + kThreads - 1) / kThreads;
  const bool vec_y = DI % kVec == 0;

  // chunk k of dt, x, B, C into buffer buf; rows past S and channels past DI
  // are zero-filled (a row past S is an identity step of the scan)
  auto stage = [&](int k, int buf) {
    const int t0 = k * TC;
#pragma unroll
    for (int m = 0; m < kMine; ++m) {
      const int piece = tid + m * kThreads;
      if (kPieces % kThreads != 0 && piece >= kPieces) break;
      const int r = piece / (kCh / kVec), cc = piece % (kCh / kVec) * kVec;
      const int t = t0 + r;
      if (vec_dx) {
        const bool in = t < S && d0 + cc < DI;
        const int64_t ts = min(t, S - 1), ds = min(d0 + cc, DI - kVec);
        rt::cp_async16(&s_dt[buf][r][cc], dtb + ts * sdt + ds, in);
        rt::cp_async16(&s_x[buf][r][cc], xb + ts * sxt + ds, in);
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          const bool in = t < S && d0 + cc + e < DI;
          s_dt[buf][r][cc + e] = in ? dtb[t * sdt + (d0 + cc + e) * sdd] : zero;
          s_x[buf][r][cc + e] = in ? xb[t * sxt + (d0 + cc + e) * sxd] : zero;
        }
      }
    }
    if constexpr (N % kVec == 0) {
      if (vec_bc) {
        constexpr int kBC = N / kVec;
        for (int i = tid; i < 2 * TC * kBC; i += kThreads) {
          const int r = i / kBC % TC, nn = i % kBC * kVec;
          const int t = t0 + r;
          const int64_t ts = min(t, S - 1);
          if (i < TC * kBC)
            rt::cp_async16(&s_B[buf][r][nn], Bb + ts * sBt + nn, t < S);
          else
            rt::cp_async16(&s_C[buf][r][nn], Cb + ts * sCt + nn, t < S);
        }
        rt::cp_async_commit();
        return;
      }
    }
    for (int i = tid; i < TC * N; i += kThreads) {
      const int r = i / N, nn = i % N;
      const int t = t0 + r;
      s_B[buf][r][nn] = t < S ? Bb[t * sBt + nn * sBn] : zero;
      s_C[buf][r][nn] = t < S ? Cb[t * sCt + nn * sCn] : zero;
    }
    rt::cp_async_commit();
  };
  // y of chunk k, which the scan left in s_x[buf], to global memory: this
  // thread's pieces, 16 bytes a store where the row allows it
  auto write_y = [&](int k, int buf) {
    const int t0 = k * TC;
#pragma unroll
    for (int m = 0; m < kMine; ++m) {
      const int piece = tid + m * kThreads;
      if (kPieces % kThreads != 0 && piece >= kPieces) break;
      const int r = piece / (kCh / kVec), cc = piece % (kCh / kVec) * kVec;
      const int t = t0 + r;
      if (t >= S) continue;
      T* dst = yb + static_cast<int64_t>(t) * DI + d0 + cc;
      if (vec_y && d0 + cc < DI) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(&s_x[buf][r][cc]);
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e)
          if (d0 + cc + e < DI) dst[e] = s_x[buf][r][cc + e];
      }
    }
  };

  const int nchunks = (S + TC - 1) / TC;
  const int nstates = (S + SC - 1) / SC;
  stage(0, 0);
  float a2[NP], h[NP];
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    a2[i] = live ? A[static_cast<int64_t>(d) * N + n0 + i] * kLog2e : 0.f;
    h[i] = (live && h0 != nullptr) ? h0[hidx + i] : 0.f;
  }
  const float Dd = live ? D[d] : 0.f;

  for (int k = 0; k < nchunks; ++k) {
    const int buf = k & 1;
    rt::cp_async_wait<0>();                 // chunk k has landed for this thread ...
    __syncthreads();                        // ... for all; chunk k-1's buffer is free
    if (k > 0) write_y(k - 1, buf ^ 1);     // before its pieces take chunk k+1
    if (k + 1 < nchunks) stage(k + 1, buf ^ 1);
    // SG steps at a time: their loads, exponentials and y shuffles are
    // independent, only h carries from step to step. Rows of the chunk past
    // S are zeros: exp(0) = 1 and dt*x = 0 leave h as it is.
    for (int r0 = 0; r0 < min(TC, S - k * TC); r0 += SG) {
      if (hs != nullptr && live && r0 % SC == 0) {   // the state entering step k TC + r0
        float* dst = hs + ((static_cast<int64_t>(b) * nstates + (k * TC + r0) / SC) * DI + d) *
                              N + n0;
#pragma unroll
        for (int i = 0; i < NP; ++i) dst[i] = h[i];
      }
      float xv[SG], e[SG][NP], bx[SG][NP], cv[SG][NP], yv[SG];
#pragma unroll
      for (int j = 0; j < SG; ++j) {
        const float dtv = rt::to_float(s_dt[buf][r0 + j][c]);
        xv[j] = rt::to_float(s_x[buf][r0 + j][c]);
        const float dx = rt::round_to<T>(dtv * xv[j]);
        float bv[NP];
        load_row<T, NP>(&s_B[buf][r0 + j][n0], bv);
        load_row<T, NP>(&s_C[buf][r0 + j][n0], cv[j]);
#pragma unroll
        for (int i = 0; i < NP; ++i) {
          e[j][i] = ex2(dtv * a2[i]);
          bx[j][i] = dx * bv[i];
        }
      }
#pragma unroll
      for (int j = 0; j < SG; ++j) {
        float y0 = 0.f, y1 = 0.f;           // two partial sums, for ILP
#pragma unroll
        for (int i = 0; i < NP; ++i) {
          h[i] = fmaf(e[j][i], h[i], bx[j][i]);
          if (i % 2 == 0) y0 = fmaf(h[i], cv[j][i], y0);
          else y1 = fmaf(h[i], cv[j][i], y1);
        }
        yv[j] = y0 + y1;
      }
#pragma unroll
      for (int off = kP / 2; off > 0; off >>= 1)
#pragma unroll
        for (int j = 0; j < SG; ++j) yv[j] += __shfl_xor_sync(0xffffffffu, yv[j], off, kP);
      // y takes x's place in s_x: every lane of the channel has read x (the
      // shuffle waited for their sums, which need it)
      if (n0 == 0) {
#pragma unroll
        for (int j = 0; j < SG; ++j) s_x[buf][r0 + j][c] = rt::from_float<T>(fmaf(Dd, xv[j], yv[j]));
      }
    }
  }
  __syncthreads();
  write_y(nchunks - 1, (nchunks - 1) & 1);
  if (live) {
#pragma unroll
    for (int i = 0; i < NP; ++i) hS[hidx + i] = h[i];
  }
}

// dt and x can take 16-byte copies along channels: unit stride there, and
// every row and the base 16-byte aligned
bool vectorizable(const void* p, int64_t sb, int64_t st, int64_t sc, int elem, int width) {
  const int vec = 16 / elem;
  return sc == 1 && reinterpret_cast<uintptr_t>(p) % 16 == 0 && sb % vec == 0 &&
         st % vec == 0 && width % vec == 0;
}

template <typename T, int N>
int launch(const void* dt, const void* x, const void* Bm, const void* Cm, const float* A,
           const float* D, const float* h0, void* y, float* hS, float* hs, int Bt, int S,
           int DI, const int64_t* st, cudaStream_t stream) {
  const int e = static_cast<int>(sizeof(T));
  const int vec_dx = vectorizable(dt, st[0], st[1], st[2], e, DI) &&
                     vectorizable(x, st[3], st[4], st[5], e, DI);
  const int vec_bc = vectorizable(Bm, st[6], st[7], st[8], e, N) &&
                     vectorizable(Cm, st[9], st[10], st[11], e, N);
  const dim3 grid((DI + kCh - 1) / kCh, Bt);
  mamba_scan_kernel<T, N><<<grid, kCh * kP, 0, stream>>>(
      static_cast<const T*>(dt), static_cast<const T*>(x), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), A, D, h0, static_cast<T*>(y), hS, hs, S, DI, st[0], st[1], st[2],
      st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11], vec_dx, vec_bc);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_n(int N, const void* dt, const void* x, const void* Bm, const void* Cm,
               const float* A, const float* D, const float* h0, void* y, float* hS, float* hs,
               int Bt, int S, int DI, const int64_t* st, cudaStream_t stream) {
  switch (N) {
    case 4: return launch<T, 4>(dt, x, Bm, Cm, A, D, h0, y, hS, hs, Bt, S, DI, st, stream);
    case 8: return launch<T, 8>(dt, x, Bm, Cm, A, D, h0, y, hS, hs, Bt, S, DI, st, stream);
    case 16: return launch<T, 16>(dt, x, Bm, Cm, A, D, h0, y, hS, hs, Bt, S, DI, st, stream);
    case 32: return launch<T, 32>(dt, x, Bm, Cm, A, D, h0, y, hS, hs, Bt, S, DI, st, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes. Strides are in elements, three for
// each of dt, x, B, C (batch, time, channel or state). h0 may be null (zeros);
// hs may be null (no saved states); chunk must be rt::state_chunk(N).
// Returns the cudaError_t of the launch.
extern "C" int mamba_scan_fwd(const void* dt, const void* x, const void* Bm, const void* Cm,
                              const void* A, const void* D, const void* h0, void* y, void* hS,
                              void* hs, int dtype, int Bt, int S, int DI, int N, int chunk,
                              int64_t sdb, int64_t sdt, int64_t sdd,
                              int64_t sxb, int64_t sxt, int64_t sxd,
                              int64_t sBb, int64_t sBt, int64_t sBn,
                              int64_t sCb, int64_t sCt, int64_t sCn, void* stream) {
  if (chunk != rt::state_chunk(N)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t st[12] = {sdb, sdt, sdd, sxb, sxt, sxd, sBb, sBt, sBn, sCb, sCt, sCn};
  const float* a = static_cast<const float*>(A);
  const float* dd = static_cast<const float*>(D);
  const float* h = static_cast<const float*>(h0);
  float* hl = static_cast<float*>(hS);
  float* hc = static_cast<float*>(hs);
  if (dtype == rt::kFloat32)
    return dispatch_n<float>(N, dt, x, Bm, Cm, a, dd, h, y, hl, hc, Bt, S, DI, st, s);
  if (dtype == rt::kBFloat16)
    return dispatch_n<__nv_bfloat16>(N, dt, x, Bm, Cm, a, dd, h, y, hl, hc, Bt, S, DI, st, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
