// The selective scan's vector-Jacobian product for Hopper (kernel B3b):
//   g_t   = C_t dy_t + a_{t+1} g_{t+1}        a_t = exp(dt_t A), g_{S-1} from dh_S
//   dx_t  = dt_t sum_n g_t B_t + D dy_t
//   ddt_t = x_t sum_n g_t B_t + sum_n g_t A a_t h_{t-1}
//   dB_t  = sum_e g_t dt_t x_t                dC_t = sum_e dy_t h_t
//   dA    = sum_{b,t} g_t dt_t a_t h_{t-1}     dD = sum_{b,t} dy_t x_t      dh0 = a_0 g_0
// dt, x, dy [Bt,S,DI]; B, C [Bt,S,N]; A [DI,N]; D [DI]; hs [Bt,ceil(S/TC),DI,N]
// (B3's states at the start of every chunk of TC steps); dh_S, dh0 [Bt,DI,N];
// all float32 and contiguous.
//
// Replaces no TPU kernel: the JAX model differentiates the chunked scan
// (repro/models/mamba.py::_ssm_chunk_scan) by autodiff. The port's forward is
// B3 (mamba_scan.cu), so its backward is a kernel too.
//
// Bound: the bytes, ~0.74 GB of reads and writes at falcon_mamba_7b's
// training microbatch Bt4 S1024 DI8192 N16 (0.22 ms at an H100 SXM's 3.35
// TB/s). The function needs one exponential per (t, channel, state), a_t
// (0.54 G: 0.13 ms on the SFUs, 16 a clock on each of 132 SMs at 1.98 GHz),
// since a_t h_{t-1} = h_t - dt x B. This kernel takes two, a_t in the
// recompute of h_t and again in the reverse pass: keeping the chunk's a_t
// would double its shared memory, and the difference cancels where
// a_t h_{t-1} is small beside dt x B.
//
// Design. B3's layout: one block of 256 threads per (batch row, 64
// channels), one thread per (channel, N/4 states) with its states' A and
// A log2 e in registers. The block walks the chunks in reverse. For each, dt,
// x, dy, B and C of the chunk arrive in shared memory by cp.async, double-
// buffered (chunk k-1 in flight while k runs); the thread recomputes its
// states over the chunk from the saved state into shared memory (TC x N/4
// floats a thread, its own: 128 KB for the block at N 16), then runs the
// chunk in reverse, carrying g_t in registers. It never divides by a_t,
// which underflows to 0 at large dt |A|. Sums over a channel's 4 threads take
// two shuffles; dB and dC, sums over channels, are reduced over a warp's 8
// channels by a halving reduce-scatter (7 shuffles a step at N 16, each lane
// left with one of the warp's 2N sums), then over the block's 8 warps in
// shared memory at the end of the chunk, in a fixed order. They leave the
// block as per-tile partials dbc [DI/64, Bt, S, 2N]; dA and dD as per-row
// partials [Bt, DI, N] and [Bt, DI]. The wrapper sums the partials over their
// leading axis. No atomics anywhere, so two calls give the same bits.
#include "common.cuh"

namespace {

constexpr int kCh = 64;                     // channels of a block
constexpr int kP = 4;                       // threads of a channel
constexpr int kThreads = kCh * kP;
constexpr int kWarps = kThreads / 32;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// 4 bytes from device to shared memory, asynchronously; zeros when !full
__device__ __forceinline__ void cp_async4(float* smem, const float* gmem, bool full) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
               "r"(full ? 4 : 0)
               : "memory");
}

// Reduce-scatter of a lane's NV values over the warp's 8 channels (lane bits
// O = 16, 8, 4): each round a lane keeps half of its values and adds its
// partner's share of that half; once one value is left, it adds its
// partner's whole, and only the lane with the bit clear writes it. A lane
// ends with max(1, NV / 8) sums, of values base, base + 1, ...
template <int NV, int O>
__device__ __forceinline__ void reduce_scatter(float* v, int lane, int& base, bool& writer) {
  if constexpr (O >= 4) {
    const bool up = lane & O;
    if constexpr (NV >= 2) {
      constexpr int H = NV / 2;
#pragma unroll
      for (int j = 0; j < H; ++j) {
        const float send = up ? v[j] : v[j + H];
        const float keep = up ? v[j + H] : v[j];
        v[j] = keep + __shfl_xor_sync(0xffffffffu, send, O);
      }
      if (up) base += H;
      reduce_scatter<H, O / 2>(v, lane, base, writer);
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], O);
      writer = writer && !up;
      reduce_scatter<1, O / 2>(v, lane, base, writer);
    }
  }
}

template <int N> struct Smem {
  static constexpr int NP = N / kP;                          // states of a thread
  static constexpr int TC = rt::scan_chunk(N);               // B3's chunk of steps
  static constexpr int kIn = 3 * TC * kCh + 2 * TC * N;      // dt, x, dy, B, C of a chunk
  static constexpr int kH = TC * NP * kThreads;              // the chunk's states
  static constexpr int kPart = TC * kWarps * 2 * N;          // dB, dC per warp and step
  static constexpr int kBytes = (2 * kIn + kH + kPart) * static_cast<int>(sizeof(float));
};

template <int N>
__global__ void __launch_bounds__(kThreads, 1)
mamba_scan_bwd_kernel(const float* __restrict__ dt, const float* __restrict__ x,
                      const float* __restrict__ Bm, const float* __restrict__ Cm,
                      const float* __restrict__ A, const float* __restrict__ D,
                      const float* __restrict__ hs, const float* __restrict__ dy,
                      const float* __restrict__ dhS, float* __restrict__ ddt,
                      float* __restrict__ dx, float* __restrict__ dbc,
                      float* __restrict__ dA_b, float* __restrict__ dD_b,
                      float* __restrict__ dh0, int Bt, int S, int DI) {
  using Sm = Smem<N>;
  constexpr int NP = Sm::NP, TC = Sm::TC;
  extern __shared__ __align__(16) float smem[];
  float* s_in = smem;                                        // [2][kIn]
  float* s_h = smem + 2 * Sm::kIn;                           // [TC][NP][kThreads]
  float* s_part = s_h + Sm::kH;                              // [TC][kWarps][2N]
  auto s_dt = [&](int buf, int r) { return s_in + buf * Sm::kIn + r * kCh; };
  auto s_x = [&](int buf, int r) { return s_in + buf * Sm::kIn + (TC + r) * kCh; };
  auto s_dy = [&](int buf, int r) { return s_in + buf * Sm::kIn + (2 * TC + r) * kCh; };
  auto s_B = [&](int buf, int r) { return s_in + buf * Sm::kIn + 3 * TC * kCh + r * N; };
  auto s_C = [&](int buf, int r) {
    return s_in + buf * Sm::kIn + 3 * TC * kCh + (TC + r) * N;
  };

  const int b = blockIdx.y;
  const int tile = blockIdx.x;
  const int d0 = tile * kCh;
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int c = tid / kP;
  const int q = tid % kP;
  const int n0 = q * NP;
  const int d = d0 + c;
  const bool live = d < DI;
  const int64_t hidx = (static_cast<int64_t>(b) * DI + d) * N + n0;
  const int64_t row0 = static_cast<int64_t>(b) * S;           // (b, t = 0) of [Bt, S, .]
  const int nchunks = (S + TC - 1) / TC;

  // chunk k's dt, x, dy (the block's channels) and B, C into buffer buf;
  // rows past S and channels past DI are zeros
  auto stage = [&](int k, int buf) {
    const int t0 = k * TC;
    for (int i = tid; i < 3 * TC * kCh; i += kThreads) {
      const int which = i / (TC * kCh), r = i / kCh % TC, cc = i % kCh;
      const int t = t0 + r;
      const bool in = t < S && d0 + cc < DI;
      const float* src = which == 0 ? dt : which == 1 ? x : dy;
      const int64_t off = in ? (row0 + t) * DI + d0 + cc : 0;
      cp_async4(s_in + buf * Sm::kIn + i, src + off, in);
    }
    for (int i = tid; i < 2 * TC * N; i += kThreads) {
      const int r = i / N % TC, nn = i % N;
      const int t = t0 + r;
      const bool in = t < S;
      const float* src = i < TC * N ? Bm : Cm;
      cp_async4(s_in + buf * Sm::kIn + 3 * TC * kCh + i, src + (in ? (row0 + t) * N + nn : 0),
                in);
    }
    rt::cp_async_commit();
  };
  // chunk k's dx and ddt (left in s_x and s_dt of buf) and its dB, dC
  // partials (s_part, summed over the warps in order) to global memory
  auto write_out = [&](int k, int buf) {
    const int t0 = k * TC, len = min(TC, S - t0);
    for (int i = tid; i < len * kCh; i += kThreads) {
      const int r = i / kCh, cc = i % kCh;
      if (d0 + cc < DI) {
        const int64_t o = (row0 + t0 + r) * DI + d0 + cc;
        dx[o] = s_x(buf, r)[cc];
        ddt[o] = s_dt(buf, r)[cc];
      }
    }
    for (int i = tid; i < len * 2 * N; i += kThreads) {
      const int r = i / (2 * N), slot = i % (2 * N);
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) sum += s_part[(r * kWarps + w) * 2 * N + slot];
      dbc[((static_cast<int64_t>(tile) * Bt + b) * S + t0 + r) * 2 * N + slot] = sum;
    }
  };

  stage(nchunks - 1, 0);
  float a2[NP], av[NP], g[NP], dA[NP], h0v[NP];
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    av[i] = live ? A[static_cast<int64_t>(d) * N + n0 + i] : 0.f;
    a2[i] = av[i] * kLog2e;
    g[i] = (live && dhS != nullptr) ? dhS[hidx + i] : 0.f;
    dA[i] = 0.f;
  }
  const float Dd = live ? D[d] : 0.f;
  float dD = 0.f;

  for (int it = 0; it < nchunks; ++it) {
    const int k = nchunks - 1 - it;
    const int buf = it & 1;
    const int t0 = k * TC, len = min(TC, S - t0);
    rt::cp_async_wait<0>();                 // chunk k has landed for this thread ...
    __syncthreads();                        // ... for all; chunk k+1's steps are done
    if (it > 0) write_out(k + 1, buf ^ 1);
    __syncthreads();                        // its buffer and s_part are free again
    if (k > 0) stage(k - 1, buf ^ 1);

    // the chunk's states, recomputed from the one saved at its start; s_h
    // holds this thread's own, h_{t0 + r} at row r
    {
      const float* src = hs + ((static_cast<int64_t>(b) * nchunks + k) * DI + d) * N + n0;
      float h[NP];
#pragma unroll
      for (int i = 0; i < NP; ++i) h0v[i] = h[i] = live ? src[i] : 0.f;
      for (int r = 0; r < len; ++r) {
        const float dtv = s_dt(buf, r)[c];
        const float bx = dtv * s_x(buf, r)[c];
        const float* bv = s_B(buf, r) + n0;
#pragma unroll
        for (int i = 0; i < NP; ++i) {
          h[i] = fmaf(ex2(dtv * a2[i]), h[i], bx * bv[i]);
          s_h[(r * NP + i) * kThreads + tid] = h[i];
        }
      }
    }

    // the chunk in reverse
    for (int r = len - 1; r >= 0; --r) {
      const float dtv = s_dt(buf, r)[c];
      const float xv = s_x(buf, r)[c];
      const float dyv = s_dy(buf, r)[c];
      const float bx = dtv * xv;
      const float* bv = s_B(buf, r) + n0;
      const float* cv = s_C(buf, r) + n0;
      float dbx = 0.f, sa = 0.f;
      float v[2 * NP];                      // this thread's dB, then dC, terms
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        g[i] = fmaf(cv[i], dyv, g[i]);     // g carried a_{t+1} g_{t+1}
        const float a = ex2(dtv * a2[i]);
        const float hp = r > 0 ? s_h[((r - 1) * NP + i) * kThreads + tid] : h0v[i];
        const float gah = g[i] * a * hp;
        dbx = fmaf(g[i], bv[i], dbx);
        sa = fmaf(gah, av[i], sa);
        dA[i] = fmaf(gah, dtv, dA[i]);
        v[i] = g[i] * bx;
        v[NP + i] = dyv * s_h[(r * NP + i) * kThreads + tid];
        g[i] *= a;
      }
#pragma unroll
      for (int off = kP / 2; off > 0; off >>= 1) {
        dbx += __shfl_xor_sync(0xffffffffu, dbx, off);
        sa += __shfl_xor_sync(0xffffffffu, sa, off);
      }
      // dx and ddt take x's and dt's places: every lane of the channel has
      // read them (the shuffles waited for their sums, which need them)
      if (q == 0) {
        s_x(buf, r)[c] = fmaf(dbx, dtv, Dd * dyv);
        s_dt(buf, r)[c] = fmaf(dbx, xv, sa);
        dD = fmaf(dyv, xv, dD);
      }
      int base = 0;
      bool writer = true;
      reduce_scatter<2 * NP, 16>(v, lane, base, writer);
      if (writer) {
        float* dst = s_part + (r * kWarps + warp) * 2 * N;
#pragma unroll
        for (int j = 0; j < (2 * NP >= 8 ? 2 * NP / 8 : 1); ++j) {
          const int i = base + j;
          dst[i < NP ? n0 + i : N + n0 + i - NP] = v[j];
        }
      }
    }
  }
  __syncthreads();
  write_out(0, (nchunks - 1) & 1);
  if (live) {
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      dh0[hidx + i] = g[i];
      dA_b[hidx + i] = dA[i];
    }
    if (q == 0) dD_b[static_cast<int64_t>(b) * DI + d] = dD;
  }
}

template <int N>
int launch(const float* const* in, float* const* out, int Bt, int S, int DI,
           cudaStream_t stream) {
  constexpr int smem = Smem<N>::kBytes;
  auto kernel = mamba_scan_bwd_kernel<N>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((DI + kCh - 1) / kCh, Bt);
  kernel<<<grid, kThreads, smem, stream>>>(in[0], in[1], in[2], in[3], in[4], in[5], in[6],
                                           in[7], in[8], out[0], out[1], out[2], out[3],
                                           out[4], out[5], Bt, S, DI);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point, loaded with ctypes. dh_S may be null (zeros). dbc
// [DI/64, Bt, S, 2N] (dB then dC of each block of 64 channels), dA_b
// [Bt, DI, N] and dD_b [Bt, DI] are partials the caller sums over their
// leading axis. chunk, the steps between the states of hs, must be
// rt::scan_chunk(N). Returns the cudaError_t of the launch.
extern "C" int mamba_scan_bwd(const void* dt, const void* x, const void* Bm, const void* Cm,
                              const void* A, const void* D, const void* hs, const void* dy,
                              const void* dhS, void* ddt, void* dx, void* dbc, void* dA_b,
                              void* dD_b, void* dh0, int Bt, int S, int DI, int N,
                              int chunk, void* stream) {
  if (chunk != rt::scan_chunk(N)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* in[9] = {static_cast<const float*>(dt), static_cast<const float*>(x),
                        static_cast<const float*>(Bm), static_cast<const float*>(Cm),
                        static_cast<const float*>(A), static_cast<const float*>(D),
                        static_cast<const float*>(hs), static_cast<const float*>(dy),
                        static_cast<const float*>(dhS)};
  float* out[6] = {static_cast<float*>(ddt), static_cast<float*>(dx), static_cast<float*>(dbc),
                   static_cast<float*>(dA_b), static_cast<float*>(dD_b),
                   static_cast<float*>(dh0)};
  switch (N) {
    case 4: return launch<4>(in, out, Bt, S, DI, s);
    case 8: return launch<8>(in, out, Bt, S, DI, s);
    case 16: return launch<16>(in, out, Bt, S, DI, s);
    case 32: return launch<32>(in, out, Bt, S, DI, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
