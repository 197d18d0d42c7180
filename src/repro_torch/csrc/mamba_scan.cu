// Mamba-1 selective scan for Hopper, with the state carried in and out:
//   h_t = exp(dt_t A) * h_{t-1} + (dt_t x_t) B_t      h_{-1} = h0 (zeros if absent)
//   y_t = C_t . h_t + D x_t                            and h_S written out.
// dt, x [Bt,S,DI]; B, C [Bt,S,N] (float32 or bfloat16, any strides);
// A [DI,N], D [DI], h0 and h_S [Bt,DI,N] float32, contiguous; y [Bt,S,DI]
// contiguous, in the inputs' type.
//
// Replaces the TPU kernel repro/kernels/mamba_scan.py::_mamba_kernel. The TPU
// grid is (batch, DI blocks, sequence chunks) with the chunk axis sequential
// and h carried across it in VMEM scratch. Blocks on the card run in no
// order, so nothing is carried between blocks: one block owns its channels
// for the whole sequence and loops over t itself. The TPU kernel starts from
// h = 0 and drops the final state; prefill needs it for the decode cache, so
// this one takes h0 and writes h_S.
//
// Mapping: one thread per (channel, state), N threads to a channel, so a
// 128-thread block holds 128 / N channels (8 at N = 16) and the grid is
// (DI / channels, Bt): 1024 blocks at the serving shape Bt1 DI8192 N16, where
// one thread per channel would give 64 blocks for 132 SMs. Each thread keeps
// its h and A in registers; y_t is an xor-shuffle sum over the N lanes of a
// channel. dt, x, B and C of a chunk of time steps are staged in shared
// memory by loads with neighbouring channels on neighbouring addresses, and
// y of the chunk is written back the same way.
//
// Bound: it reads dt, x, B, C, A, h0 once and writes y and h_S once, and does
// about 10 float32 operations per (t, channel, state): bound by bytes (4.7 MB
// and 1.4 us at the serving shape in float32), and in practice by the
// latency of its sequential loop over S. expf, not __expf, keeps float32 next
// to the plain version. For bfloat16 inputs dt*x is rounded to bfloat16 before
// the product with B, as the plain version and the JAX oracle compute it.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 32;   // time steps staged in shared memory at once

template <typename T> __device__ __forceinline__ float round_to(float v) {
  return rt::to_float(rt::from_float<T>(v));
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
mamba_scan_kernel(const T* __restrict__ dt, const T* __restrict__ x, const T* __restrict__ Bm,
                  const T* __restrict__ Cm, const float* __restrict__ A,
                  const float* __restrict__ D, const float* __restrict__ h0, T* __restrict__ y,
                  float* __restrict__ hS, int S, int DI, int64_t sdb, int64_t sdt, int64_t sdd,
                  int64_t sxb, int64_t sxt, int64_t sxd, int64_t sBb, int64_t sBt, int64_t sBn,
                  int64_t sCb, int64_t sCt, int64_t sCn) {
  constexpr int CPB = kThreads / N;  // channels per block
  __shared__ float s_dt[kChunk][CPB];
  __shared__ float s_dx[kChunk][CPB];  // dt*x, rounded to T
  __shared__ float s_x[kChunk][CPB];
  __shared__ float s_y[kChunk][CPB];
  __shared__ float s_B[kChunk][N];
  __shared__ float s_C[kChunk][N];

  const int b = blockIdx.y;
  const int d0 = blockIdx.x * CPB;
  const int tid = threadIdx.x;
  const int c = tid / N;
  const int n = tid % N;
  const int d = d0 + c;
  const bool live = d < DI;
  const int64_t hidx = (static_cast<int64_t>(b) * DI + d) * N + n;

  const float a = live ? A[static_cast<int64_t>(d) * N + n] : 0.f;
  const float Dd = live ? D[d] : 0.f;
  float h = (live && h0 != nullptr) ? h0[hidx] : 0.f;

  const T* dtb = dt + b * sdb;
  const T* xb = x + b * sxb;
  const T* Bb = Bm + b * sBb;
  const T* Cb = Cm + b * sCb;
  T* yb = y + static_cast<int64_t>(b) * S * DI;

  for (int t0 = 0; t0 < S; t0 += kChunk) {
    const int len = min(kChunk, S - t0);
    for (int e = tid; e < len * CPB; e += kThreads) {
      const int t = e / CPB;
      const int cc = e % CPB;
      const int dd = d0 + cc;
      float dtv = 0.f, xv = 0.f;
      if (dd < DI) {
        dtv = rt::to_float(dtb[(t0 + t) * sdt + dd * sdd]);
        xv = rt::to_float(xb[(t0 + t) * sxt + dd * sxd]);
      }
      s_dt[t][cc] = dtv;
      s_x[t][cc] = xv;
      s_dx[t][cc] = round_to<T>(dtv * xv);
    }
    for (int e = tid; e < len * N; e += kThreads) {
      const int t = e / N;
      const int nn = e % N;
      s_B[t][nn] = rt::to_float(Bb[(t0 + t) * sBt + nn * sBn]);
      s_C[t][nn] = rt::to_float(Cb[(t0 + t) * sCt + nn * sCn]);
    }
    __syncthreads();

    for (int t = 0; t < len; ++t) {
      h = expf(s_dt[t][c] * a) * h + s_dx[t][c] * s_B[t][n];
      float p = h * s_C[t][n];
#pragma unroll
      for (int off = N / 2; off > 0; off >>= 1) p += __shfl_xor_sync(0xffffffffu, p, off, N);
      if (n == 0) s_y[t][c] = p + Dd * s_x[t][c];
    }
    __syncthreads();

    for (int e = tid; e < len * CPB; e += kThreads) {
      const int t = e / CPB;
      const int dd = d0 + e % CPB;
      if (dd < DI) yb[static_cast<int64_t>(t0 + t) * DI + dd] = rt::from_float<T>(s_y[t][e % CPB]);
    }
    // the next chunk's staging writes no buffer read above, and its barrier
    // orders these reads of s_y before the next writes to it
  }
  if (live) hS[hidx] = h;
}

template <typename T, int N>
int launch(const void* dt, const void* x, const void* Bm, const void* Cm, const float* A,
           const float* D, const float* h0, void* y, float* hS, int Bt, int S, int DI,
           const int64_t* st, cudaStream_t stream) {
  constexpr int CPB = kThreads / N;
  const dim3 grid((DI + CPB - 1) / CPB, Bt);
  mamba_scan_kernel<T, N><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(dt), static_cast<const T*>(x), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), A, D, h0, static_cast<T*>(y), hS, S, DI, st[0], st[1], st[2],
      st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11]);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_n(int N, const void* dt, const void* x, const void* Bm, const void* Cm,
               const float* A, const float* D, const float* h0, void* y, float* hS, int Bt,
               int S, int DI, const int64_t* st, cudaStream_t stream) {
  switch (N) {
    case 4: return launch<T, 4>(dt, x, Bm, Cm, A, D, h0, y, hS, Bt, S, DI, st, stream);
    case 8: return launch<T, 8>(dt, x, Bm, Cm, A, D, h0, y, hS, Bt, S, DI, st, stream);
    case 16: return launch<T, 16>(dt, x, Bm, Cm, A, D, h0, y, hS, Bt, S, DI, st, stream);
    case 32: return launch<T, 32>(dt, x, Bm, Cm, A, D, h0, y, hS, Bt, S, DI, st, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes. Strides are in elements, three for
// each of dt, x, B, C (batch, time, channel or state). h0 may be null (zeros).
// Returns the cudaError_t of the launch.
extern "C" int mamba_scan_fwd(const void* dt, const void* x, const void* Bm, const void* Cm,
                              const void* A, const void* D, const void* h0, void* y, void* hS,
                              int dtype, int Bt, int S, int DI, int N,
                              int64_t sdb, int64_t sdt, int64_t sdd,
                              int64_t sxb, int64_t sxt, int64_t sxd,
                              int64_t sBb, int64_t sBt, int64_t sBn,
                              int64_t sCb, int64_t sCt, int64_t sCn, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t st[12] = {sdb, sdt, sdd, sxb, sxt, sxd, sBb, sBt, sBn, sCb, sCt, sCn};
  const float* a = static_cast<const float*>(A);
  const float* dd = static_cast<const float*>(D);
  const float* h = static_cast<const float*>(h0);
  float* hs = static_cast<float*>(hS);
  if (dtype == rt::kFloat32)
    return dispatch_n<float>(N, dt, x, Bm, Cm, a, dd, h, y, hs, Bt, S, DI, st, s);
  if (dtype == rt::kBFloat16)
    return dispatch_n<__nv_bfloat16>(N, dt, x, Bm, Cm, a, dd, h, y, hs, Bt, S, DI, st, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
