// The selective scan's vector-Jacobian product for Hopper (kernel B3b):
//   g_t   = C_t dy_t + a_{t+1} g_{t+1}        a_t = exp(dt_t A), g_{S-1} from dh_S
//   dx_t  = dt_t sum_n g_t B_t + D dy_t
//   ddt_t = x_t sum_n g_t B_t + sum_n g_t A a_t h_{t-1}
//   dB_t  = sum_e g_t dt_t x_t                dC_t = sum_e dy_t h_t
//   dA    = sum_{b,t} g_t dt_t a_t h_{t-1}     dD = sum_{b,t} dy_t x_t      dh0 = a_0 g_0
// dt, x, dy [Bt,S,DI]; B, C [Bt,S,N]; A [DI,N]; D [DI]; hs [Bt,ceil(S/L),DI,N]
// (B3's states at the start of every L = rt::state_chunk(N) = 16 steps);
// dh_S, dh0 [Bt,DI,N]; all float32 and contiguous.
//
// Replaces no TPU kernel: the JAX model differentiates the chunked scan
// (repro/models/mamba.py::_ssm_chunk_scan) by autodiff. The port's forward is
// B3 (mamba_scan.cu), so its backward is a kernel too.
//
// Bound: the bytes, ~0.81 GB of reads and writes at falcon_mamba_7b's
// training microbatch Bt4 S1024 DI8192 N16, the states every 16 steps
// included (0.24 ms at an H100 SXM's 3.35 TB/s). The function needs one
// exponential per (t, channel, state), a_t (0.54 G: 0.13 ms on the SFUs, 16
// a clock on each of 132 SMs at 1.98 GHz), since a_t h_{t-1} = h_t - dt x B.
// This kernel takes two, a_t in the recompute of h_t and again in the
// reverse pass (0.26 ms of SFU time, which overlaps the rest): keeping a
// span's a_t as well would double the registers its states take, and the
// difference cancels where a_t h_{t-1} is small beside dt x B. What holds
// it above the bound is the instructions its warps issue: a step of a warp
// (128 (t, channel, state) elements) takes ~108 in the unrolled span, ~67
// of them float32 arithmetic, 12 selects and 7 shuffles of the
// reduce-scatters, 8 exponentials, 8 shared-memory loads; the span's
// staging, write-out and two barriers come on top (a third buffer, for
// one barrier a span, measured no faster).
//
// Design. A block of 256 threads owns 1024 / N channels of one batch row
// (64 at N 16); a thread owns 2 adjacent channels x 2 adjacent states, their
// A log2 e in registers; the N / 2 threads of a channel pair are neighbouring
// lanes. The block walks the spans of L steps in reverse. dt, x, dy, B and C
// of a span and the state saved at its start arrive in shared memory by
// cp.async, double-buffered (span k-1 in flight while k runs). The thread
// recomputes its 4 states over the span into registers, the loop fully
// unrolled (L x 4 = 64 registers: no recomputed state touches shared
// memory), then runs the span in reverse, carrying g_t, steps in groups of
// SG (2 at N >= 16; 1 below, where 2 spills): a group's loads and
// exponentials issue together, g carries through it (one FMA and one
// multiply a state a step), and its sums over the pair's lanes (dx, ddt)
// and over the warp's pairs (dB, dC) run as halving reduce-scatters whose
// shuffle rounds interleave across the group's steps. The state read as
// h_{t-1} at step t stays in its register as h_t of step t-1. It never
// divides by a_t, which underflows to 0 at large dt |A|. ddt and dx (less
// D dy) take dt's and x's places in shared memory and leave a span at a
// time in 16-byte stores, dx with D dy added; dB and dC go to shared memory
// per warp and are summed over the block's 8 warps in a fixed order at the
// end of the span. With ~52 KB of shared memory at N 16 (110 KB at N 4) and
// at most 128 registers a thread, two blocks share an SM: 16 warps. Across
// blocks, dB and dC leave as per-tile partials dbc [DI/(1024/N), Bt, S, 2N]
// (67 MB at the microbatch), dA and dD as per-row partials [Bt, DI, N] and
// [Bt, DI]; a second kernel of this file sums them in a fixed order
// (ascending tile, ascending row) into dB, dC, dA and dD. No atomics
// anywhere, so two calls give the same bits.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCT = 2;                      // channels of a thread
constexpr int kNT = 2;                      // states of a thread
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

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

// The thread's and block's indices, read anew where called: what the staging
// and write-out code derives from them is then recomputed at each span, not
// held in registers across a span's unrolled steps
__device__ __forceinline__ int fresh_tid() {
  int v;
  asm volatile("mov.u32 %0, %%tid.x;" : "=r"(v));
  return v;
}
__device__ __forceinline__ int fresh_ctaid_x() {
  int v;
  asm volatile("mov.u32 %0, %%ctaid.x;" : "=r"(v));
  return v;
}
__device__ __forceinline__ int fresh_ctaid_y() {
  int v;
  asm volatile("mov.u32 %0, %%ctaid.y;" : "=r"(v));
  return v;
}

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// Reduce-scatter of NV values a step over lane bits O, O/2, ..., OMIN, for
// SG steps at once (their shuffle rounds interleave): each round a lane keeps
// half of its values and adds its partner's share of that half; once one
// value is left, it adds its partner's whole. A lane ends with the sums of
// the values scatter_slot names, in v[s][0], v[s][1], ...
template <int SG, int NV, int O, int OMIN, int W>
__device__ __forceinline__ void reduce_scatter(float (&v)[SG][W], int lane) {
  if constexpr (O >= OMIN) {
    const bool up = lane & O;
    if constexpr (NV >= 2) {
      constexpr int H = NV / 2;
#pragma unroll
      for (int s = 0; s < SG; ++s) {
#pragma unroll
        for (int j = 0; j < H; ++j) {
          const float send = up ? v[s][j] : v[s][j + H];
          const float keep = up ? v[s][j + H] : v[s][j];
          v[s][j] = keep + __shfl_xor_sync(0xffffffffu, send, O);
        }
      }
      reduce_scatter<SG, H, O / 2, OMIN>(v, lane);
    } else {
#pragma unroll
      for (int s = 0; s < SG; ++s) v[s][0] += __shfl_xor_sync(0xffffffffu, v[s][0], O);
      reduce_scatter<SG, 1, O / 2, OMIN>(v, lane);
    }
  }
}

// Which of the NV values reduce_scatter<., NV, O, OMIN> leaves with this
// lane: the first, base (the others follow it), and whether the lane writes
// them (once a round sums a single value, only the lane with the bit clear)
template <int NV, int O, int OMIN>
__device__ __forceinline__ void scatter_slot(int lane, int& base, bool& writer) {
  if constexpr (O >= OMIN) {
    const bool up = lane & O;
    if constexpr (NV >= 2) {
      if (up) base += NV / 2;
      scatter_slot<NV / 2, O / 2, OMIN>(lane, base, writer);
    } else {
      writer = writer && !up;
      scatter_slot<1, O / 2, OMIN>(lane, base, writer);
    }
  }
}

template <int N> struct Cfg {
  static constexpr int P = N / kNT;                     // lanes of a channel pair
  static constexpr int G = 32 / P;                      // channel pairs of a warp
  static constexpr int kCh = kThreads / P * kCT;        // channels of a block: 1024 / N
  static constexpr int L = rt::state_chunk(N);          // steps between saved states
  // reverse steps of a group: 2 where the build shows no spill at 128 registers
  static constexpr int SG = N >= 16 ? 2 : 1;
  static constexpr int kNP = 4 / P > 1 ? 4 / P : 1;     // dx/ddt sums a pair lane ends with
  static constexpr int kNG = 4 / G > 1 ? 4 / G : 1;     // dB/dC sums a lane ends with
  // one buffer: dt, x, dy [L][kCh]; B, C [L][N]; the state entering the chunk [kCh][N]
  static constexpr int oX = L * kCh, oDy = 2 * L * kCh, oB = 3 * L * kCh;
  static constexpr int oC = oB + L * N, oH = oC + L * N;
  static constexpr int kIn = oH + kCh * N;
  static constexpr int kPart = L * kWarps * 2 * N;      // dB, dC per step and warp
  static constexpr int kBytes = (2 * kIn + kPart + kCh) * static_cast<int>(sizeof(float));
  static_assert(L % SG == 0 && kCh % 4 == 0 && N % 4 == 0, "chunk and tile shapes");
};

template <int N>
__global__ void __launch_bounds__(kThreads, 2)
mamba_scan_bwd_kernel(const float* __restrict__ dt, const float* __restrict__ x,
                      const float* __restrict__ Bm, const float* __restrict__ Cm,
                      const float* __restrict__ A, const float* __restrict__ D,
                      const float* __restrict__ hs, const float* __restrict__ dy,
                      const float* __restrict__ dhS, float* __restrict__ ddt,
                      float* __restrict__ dx, float* __restrict__ dbc,
                      float* __restrict__ dA_b, float* __restrict__ dD_b,
                      float* __restrict__ dh0, int Bt, int S, int DI, int vec,
                      int vec_bc) {
  using Cf = Cfg<N>;
  constexpr int P = Cf::P, kCh = Cf::kCh, L = Cf::L, SG = Cf::SG;
  extern __shared__ __align__(16) float smem[];
  float* s_part = smem + 2 * Cf::kIn;                        // [L][kWarps][2N]
  float* s_D = s_part + Cf::kPart;                           // D of the block's channels

  const int b = blockIdx.y;
  const int d0 = blockIdx.x * kCh;
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int c0 = tid / P * kCT;             // the thread's first channel in the block
  const int n0 = tid % P * kNT;             // its first state
  const int d = d0 + c0;
  const bool live[kCT] = {d < DI, d + 1 < DI};
  const int nsc = (S + L - 1) / L;

  // chunk k's dt, x, dy (the block's channels), B, C and saved state into
  // buffer buf; rows past S and channels past DI are zeros (a row past S is
  // an identity step: exp(0) = 1, dt x = 0, dy = 0)
  auto stage = [&](int k, int buf) {
    const int tid = fresh_tid(), b = fresh_ctaid_y(), d0 = fresh_ctaid_x() * kCh;
    const int64_t row0 = static_cast<int64_t>(b) * S;        // (b, t = 0) of [Bt, S, .]
    float* s = smem + buf * Cf::kIn;
    const int t0 = k * L;
    if (vec) {                              // 16-byte pieces of rows
      constexpr int kQ = kCh / 4;
      for (int i = tid; i < 3 * L * kQ; i += kThreads) {
        const int which = i / (L * kQ), r = i / kQ % L, cc = i % kQ * 4;
        const int t = t0 + r;
        const bool in = t < S && d0 + cc < DI;
        const float* src = which == 0 ? dt : which == 1 ? x : dy;
        rt::cp_async16(s + i * 4, src + (in ? (row0 + t) * DI + d0 + cc : 0), in);
      }
    } else {
      for (int i = tid; i < 3 * L * kCh; i += kThreads) {
        const int which = i / (L * kCh), r = i / kCh % L, cc = i % kCh;
        const int t = t0 + r;
        const bool in = t < S && d0 + cc < DI;
        const float* src = which == 0 ? dt : which == 1 ? x : dy;
        cp_async4(s + i, src + (in ? (row0 + t) * DI + d0 + cc : 0), in);
      }
    }
    // B, C and the state: pieces of 4 floats, one copy of 16 bytes where
    // their base pointers allow it
    auto piece = [&](float* dst, const float* src, bool in) {
      if (vec_bc) {
        rt::cp_async16(dst, src, in);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) cp_async4(dst + e, src + e, in);
      }
    };
    constexpr int kQn = N / 4;
    for (int i = tid; i < 2 * L * kQn; i += kThreads) {
      const int r = i / kQn % L, nn = i % kQn * 4;
      const int t = t0 + r;
      const float* src = i < L * kQn ? Bm : Cm;
      piece(s + Cf::oB + i * 4, src + (t < S ? (row0 + t) * N + nn : 0), t < S);
    }
    const int64_t h0 = ((static_cast<int64_t>(b) * ((S + L - 1) / L) + k) * DI + d0) * N;
    for (int i = tid; i < kCh * N / 4; i += kThreads) {
      const bool in = d0 + i * 4 / N < DI;
      piece(s + Cf::oH + i * 4, hs + (in ? h0 + i * 4 : 0), in);
    }
    rt::cp_async_commit();
  };
  // chunk k's dx and ddt (left in x's and dt's places of buf) and its dB, dC
  // partials (s_part, summed over the warps in order) to global memory
  auto write_out = [&](int k, int buf) {
    const int tid = fresh_tid(), b = fresh_ctaid_y(), tile = fresh_ctaid_x();
    const int d0 = tile * kCh;
    const int64_t row0 = static_cast<int64_t>(b) * S;
    const float* s = smem + buf * Cf::kIn;
    const int t0 = k * L, len = min(L, S - t0);
    // every row of the buffer is visited (constant divisors), rows past S
    // skipped; dx gets its D dy here
    if (vec) {
      constexpr int kQ = kCh / 4;
      for (int i = tid; i < 2 * L * kQ; i += kThreads) {
        const int which = i / (L * kQ), r = i / kQ % L, cc = i % kQ * 4;
        if (r < len && d0 + cc < DI) {
          float4 v = *reinterpret_cast<const float4*>(s + i * 4);
          if (which) {
            const float4 y = *reinterpret_cast<const float4*>(s + Cf::oDy + r * kCh + cc);
            const float4 dd = *reinterpret_cast<const float4*>(s_D + cc);
            v = make_float4(fmaf(dd.x, y.x, v.x), fmaf(dd.y, y.y, v.y), fmaf(dd.z, y.z, v.z),
                            fmaf(dd.w, y.w, v.w));
          }
          float* dst = (which ? dx : ddt) + (row0 + t0 + r) * DI + d0 + cc;
          *reinterpret_cast<float4*>(dst) = v;
        }
      }
    } else {
      for (int i = tid; i < 2 * L * kCh; i += kThreads) {
        const int which = i / (L * kCh), r = i / kCh % L, cc = i % kCh;
        if (r < len && d0 + cc < DI) {
          const float v = which ? fmaf(s_D[cc], s[Cf::oDy + r * kCh + cc], s[i]) : s[i];
          (which ? dx : ddt)[(row0 + t0 + r) * DI + d0 + cc] = v;
        }
      }
    }
    float* out = dbc + ((static_cast<int64_t>(tile) * Bt + b) * S + t0) * 2 * N;
    for (int i = tid; i < L * 2 * N; i += kThreads) {
      if (i >= len * 2 * N) break;
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w)
        sum += s_part[(i / (2 * N) * kWarps + w) * 2 * N + i % (2 * N)];
      out[i] = sum;
    }
  };

  stage(nsc - 1, 0);
  for (int i = tid; i < kCh; i += kThreads) s_D[i] = d0 + i < DI ? D[d0 + i] : 0.f;
  float a2[kCT][kNT], g[kCT][kNT], dA[kCT][kNT], dD[kCT];   // a2: A log2 e
#pragma unroll
  for (int ch = 0; ch < kCT; ++ch) {
    const int64_t hidx = (static_cast<int64_t>(b) * DI + d + ch) * N + n0;
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      a2[ch][j] = live[ch] ? A[static_cast<int64_t>(d + ch) * N + n0 + j] * kLog2e : 0.f;
      g[ch][j] = (live[ch] && dhS != nullptr) ? dhS[hidx + j] : 0.f;
      dA[ch][j] = 0.f;
    }
    dD[ch] = 0.f;
  }
  // where this lane's sums go once the reduce-scatters are done: value i of
  // the pair's {dx, dx, ddt, ddt} of channels {0, 1, 0, 1} to x's or dt's
  // place, value i of the warp's {dB, dB, dC, dC} of states {n0, n0 + 1, n0,
  // n0 + 1} to its slot of s_part
  int bp = 0, bg = 0;
  bool wp = true, wg = true;
  scatter_slot<4, P / 2, 1>(lane, bp, wp);
  scatter_slot<4, 16, P>(lane, bg, wg);
  int pofs[Cf::kNP], gofs[Cf::kNG];
#pragma unroll
  for (int m = 0; m < Cf::kNP; ++m)
    pofs[m] = (bp + m < 2 ? Cf::oX : 0) + c0 + ((bp + m) & 1);
#pragma unroll
  for (int m = 0; m < Cf::kNG; ++m)
    gofs[m] = warp * 2 * N + (bg + m < 2 ? n0 + bg + m : N + n0 + bg + m - 2);

  for (int it = 0; it < nsc; ++it) {
    const int k = nsc - 1 - it;
    const int buf = it & 1;
    rt::cp_async_wait<0>();                 // chunk k has landed for this thread ...
    __syncthreads();                        // ... for all; chunk k+1's steps are done
    if (it > 0) write_out(k + 1, buf ^ 1);
    __syncthreads();                        // its buffer and s_part are free again
    if (k > 0) stage(k - 1, buf ^ 1);

    float* s = smem + buf * Cf::kIn;
    const float* s_dy = s + Cf::oDy;
    const float* s_B = s + Cf::oB;
    const float* s_C = s + Cf::oC;
    const float* s_h0 = s + Cf::oH;

    // the span's states, recomputed from the saved one into registers: hr[i]
    // enters step i (hr[0], the saved one, is read again from shared memory
    // at the end); hc carries the chain
    float hr[L][kCT][kNT], hc[kCT][kNT];
#pragma unroll
    for (int ch = 0; ch < kCT; ++ch) {
      const float2 v = ld2(s_h0 + (c0 + ch) * N + n0);
      hc[ch][0] = v.x;
      hc[ch][1] = v.y;
    }
    // one step of the forward recurrence from hc; step r's a_t comes back
    // in the reverse pass
    auto advance = [&](int r, float (&h)[kCT][kNT]) {
      const float2 dt2 = ld2(s + r * kCh + c0), x2 = ld2(s + Cf::oX + r * kCh + c0);
      const float2 b2 = ld2(s_B + r * N + n0);
      const float dtv[kCT] = {dt2.x, dt2.y}, bx[kCT] = {dt2.x * x2.x, dt2.y * x2.y};
      const float bv[kNT] = {b2.x, b2.y};
#pragma unroll
      for (int ch = 0; ch < kCT; ++ch)
#pragma unroll
        for (int j = 0; j < kNT; ++j)
          h[ch][j] = fmaf(ex2(dtv[ch] * a2[ch][j]), h[ch][j], bx[ch] * bv[j]);
    };
#pragma unroll
    for (int r = 0; r + 1 < L; ++r) {
      advance(r, hc);
#pragma unroll
      for (int ch = 0; ch < kCT; ++ch)
#pragma unroll
        for (int j = 0; j < kNT; ++j) hr[r + 1][ch][j] = hc[ch][j];
    }
    // hn: h_t of the step (the state after it), carried down from the step
    // after as its state entering; the last step's from one more advance
    float hn[kCT][kNT];
#pragma unroll
    for (int ch = 0; ch < kCT; ++ch)
#pragma unroll
      for (int j = 0; j < kNT; ++j) hn[ch][j] = hc[ch][j];
    advance(L - 1, hn);

    // the chunk in reverse, SG steps at a time
#pragma unroll
    for (int gi = 0; gi < L / SG; ++gi) {
      const int r0 = L - SG - gi * SG;      // the group's steps r0 + SG - 1 down to r0
      float v[SG][4];                       // dx (less D dy) of the 2 channels, then ddt
      float w[SG][4];                       // dB of the 2 states, then dC
      float dtv[SG][kCT], xv[SG][kCT], dyv[SG][kCT], hp[SG][kCT][kNT];
#pragma unroll
      for (int s_ = 0; s_ < SG; ++s_) {
        const int r = r0 + SG - 1 - s_;
        const float2 dt2 = ld2(s + r * kCh + c0), x2 = ld2(s + Cf::oX + r * kCh + c0);
        const float2 dy2 = ld2(s_dy + r * kCh + c0);
        dtv[s_][0] = dt2.x; dtv[s_][1] = dt2.y;
        xv[s_][0] = x2.x; xv[s_][1] = x2.y;
        dyv[s_][0] = dy2.x; dyv[s_][1] = dy2.y;
#pragma unroll
        for (int ch = 0; ch < kCT; ++ch) {   // the state entering step r
          if (r == 0) {
            const float2 v2 = ld2(s_h0 + (c0 + ch) * N + n0);
            hp[s_][ch][0] = v2.x;
            hp[s_][ch][1] = v2.y;
          } else {
            hp[s_][ch][0] = hr[r][ch][0];
            hp[s_][ch][1] = hr[r][ch][1];
          }
        }
      }
#pragma unroll
      for (int s_ = 0; s_ < SG; ++s_) {
        const int r = r0 + SG - 1 - s_;
        const float2 b2 = ld2(s_B + r * N + n0), c2 = ld2(s_C + r * N + n0);
        const float bv[kNT] = {b2.x, b2.y}, cv[kNT] = {c2.x, c2.y};
        float dbx[kCT] = {0.f, 0.f}, sa[kCT] = {0.f, 0.f};
#pragma unroll
        for (int j = 0; j < 4; ++j) w[s_][j] = 0.f;
#pragma unroll
        for (int ch = 0; ch < kCT; ++ch) {
          const float bx = dtv[s_][ch] * xv[s_][ch];
#pragma unroll
          for (int j = 0; j < kNT; ++j) {
            const float gv = fmaf(cv[j], dyv[s_][ch], g[ch][j]);   // g carried a_{t+1} g_{t+1}
            const float a = ex2(dtv[s_][ch] * a2[ch][j]);
            const float gah = gv * a * hp[s_][ch][j];
            dbx[ch] = fmaf(gv, bv[j], dbx[ch]);
            sa[ch] = fmaf(gah, a2[ch][j], sa[ch]);
            dA[ch][j] = fmaf(gah, dtv[s_][ch], dA[ch][j]);
            w[s_][j] = fmaf(gv, bx, w[s_][j]);
            w[s_][2 + j] = fmaf(dyv[s_][ch], hn[ch][j], w[s_][2 + j]);
            g[ch][j] = gv * a;
            hn[ch][j] = hp[s_][ch][j];
          }
        }
#pragma unroll
        for (int ch = 0; ch < kCT; ++ch) {
          v[s_][ch] = dtv[s_][ch] * dbx[ch];
          v[s_][2 + ch] = fmaf(xv[s_][ch], dbx[ch], sa[ch] * kLn2);
          dD[ch] = fmaf(dyv[s_][ch], xv[s_][ch], dD[ch]);
        }
      }
      reduce_scatter<SG, 4, P / 2, 1>(v, lane);              // over the pair's lanes
      reduce_scatter<SG, 4, 16, P>(w, lane);                 // over the warp's pairs
      __syncwarp();                         // every lane has read the group's dt and x
#pragma unroll
      for (int s_ = 0; s_ < SG; ++s_) {
        const int r = r0 + SG - 1 - s_;
        if (wp) {
#pragma unroll
          for (int m = 0; m < Cf::kNP; ++m) s[pofs[m] + r * kCh] = v[s_][m];
        }
        if (wg) {
#pragma unroll
          for (int m = 0; m < Cf::kNG; ++m) s_part[r * kWarps * 2 * N + gofs[m]] = w[s_][m];
        }
      }
    }
  }
  __syncthreads();
  write_out(0, (nsc - 1) & 1);
#pragma unroll
  for (int ch = 0; ch < kCT; ++ch) {
    if (!live[ch]) continue;
    const int64_t hidx = (static_cast<int64_t>(b) * DI + d + ch) * N + n0;
    *reinterpret_cast<float2*>(dh0 + hidx) = make_float2(g[ch][0], g[ch][1]);
    *reinterpret_cast<float2*>(dA_b + hidx) = make_float2(dA[ch][0], dA[ch][1]);
    if (n0 == 0) dD_b[static_cast<int64_t>(b) * DI + d + ch] = dD[ch];
  }
}

// The second pass: dbc summed over its tiles, dA_b and dD_b over their rows,
// each in ascending order, one thread an output
__global__ void __launch_bounds__(kThreads)
mamba_scan_bwd_sum_kernel(const float* __restrict__ dbc, const float* __restrict__ dA_b,
                          const float* __restrict__ dD_b, float* __restrict__ dB,
                          float* __restrict__ dC, float* __restrict__ dA,
                          float* __restrict__ dD, int tiles, int Bt, int S, int DI, int N) {
  const int64_t nbc = static_cast<int64_t>(Bt) * S * 2 * N;
  const int64_t nA = static_cast<int64_t>(DI) * N;
  const int64_t total = nbc + nA + DI;
  for (int64_t o = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; o < total;
       o += static_cast<int64_t>(gridDim.x) * kThreads) {
    float sum = 0.f;
    if (o < nbc) {
#pragma unroll 8
      for (int i = 0; i < tiles; ++i) sum += dbc[i * nbc + o];
      const int64_t bs = o / (2 * N);
      const int slot = static_cast<int>(o % (2 * N));
      if (slot < N) dB[bs * N + slot] = sum;
      else dC[bs * N + slot - N] = sum;
    } else if (o < nbc + nA) {
      const int64_t e = o - nbc;
      for (int i = 0; i < Bt; ++i) sum += dA_b[i * nA + e];
      dA[e] = sum;
    } else {
      const int64_t e = o - nbc - nA;
      for (int i = 0; i < Bt; ++i) sum += dD_b[i * DI + e];
      dD[e] = sum;
    }
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// the kernel's shared memory, and the SM's whole carveout for shared memory,
// so that two blocks fit on an SM
template <int N> int configure() {
  auto kernel = mamba_scan_bwd_kernel<N>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Cfg<N>::kBytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  return static_cast<int>(err);
}

template <int N>
int launch(const float* const* in, float* const* out, float* const* part, int Bt, int S,
           int DI, cudaStream_t stream) {
  using Cf = Cfg<N>;
  auto kernel = mamba_scan_bwd_kernel<N>;
  const int err0 = configure<N>();
  if (err0) return err0;
  const int tiles = (DI + Cf::kCh - 1) / Cf::kCh;
  const dim3 grid(tiles, Bt);
  // rows of dt, x, dy, ddt and dx in 16-byte pieces where DI and the base
  // pointers allow it; B, C and hs likewise (their rows are N % 4 == 0 long)
  const int vec = DI % 4 == 0 && aligned16(in[0]) && aligned16(in[1]) && aligned16(in[7]) &&
                  aligned16(out[0]) && aligned16(out[1]);
  const int vec_bc = aligned16(in[2]) && aligned16(in[3]) && aligned16(in[6]);
  kernel<<<grid, kThreads, Cf::kBytes, stream>>>(in[0], in[1], in[2], in[3], in[4], in[5],
                                                 in[6], in[7], in[8], out[0], out[1], part[0],
                                                 part[1], part[2], out[6], Bt, S, DI, vec,
                                                 vec_bc);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t total = static_cast<int64_t>(Bt) * S * 2 * N + static_cast<int64_t>(DI) * N + DI;
  const int64_t need = (total + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(need < 8192 ? need : 8192);
  mamba_scan_bwd_sum_kernel<<<blocks, kThreads, 0, stream>>>(
      part[0], part[1], part[2], out[2], out[3], out[4], out[5], tiles, Bt, S, DI, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point, loaded with ctypes. dh_S may be null (zeros). Outputs
// ddt, dx [Bt,S,DI], dB, dC [Bt,S,N], dA [DI,N], dD [DI], dh0 [Bt,DI,N];
// scratch for the first kernel's partials: dbc [ceil(DI/(1024/N)),Bt,S,2N],
// dA_b [Bt,DI,N], dD_b [Bt,DI]. chunk, the steps between the states of hs,
// must be rt::state_chunk(N). Returns the cudaError_t of the launches.
extern "C" int mamba_scan_bwd(const void* dt, const void* x, const void* Bm, const void* Cm,
                              const void* A, const void* D, const void* hs, const void* dy,
                              const void* dhS, void* ddt, void* dx, void* dB, void* dC,
                              void* dA, void* dD, void* dh0, void* dbc, void* dA_b,
                              void* dD_b, int Bt, int S, int DI, int N, int chunk,
                              void* stream) {
  if (chunk != rt::state_chunk(N)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* in[9] = {static_cast<const float*>(dt), static_cast<const float*>(x),
                        static_cast<const float*>(Bm), static_cast<const float*>(Cm),
                        static_cast<const float*>(A), static_cast<const float*>(D),
                        static_cast<const float*>(hs), static_cast<const float*>(dy),
                        static_cast<const float*>(dhS)};
  float* out[7] = {static_cast<float*>(ddt), static_cast<float*>(dx), static_cast<float*>(dB),
                   static_cast<float*>(dC), static_cast<float*>(dA), static_cast<float*>(dD),
                   static_cast<float*>(dh0)};
  float* part[3] = {static_cast<float*>(dbc), static_cast<float*>(dA_b),
                    static_cast<float*>(dD_b)};
  switch (N) {
    case 4: return launch<4>(in, out, part, Bt, S, DI, s);
    case 8: return launch<8>(in, out, part, Bt, S, DI, s);
    case 16: return launch<16>(in, out, part, Bt, S, DI, s);
    case 32: return launch<32>(in, out, part, Bt, S, DI, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Blocks of the main kernel resident on one SM at d_state N, as the runtime
// reckons them from its registers and shared memory; negative: a CUDA error.
extern "C" int mamba_scan_bwd_blocks_per_sm(int N) {
  auto query = [](auto kernel, int bytes, int err) {
    int blocks = 0;
    if (err) return -err;
    const cudaError_t e =
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, bytes);
    return e == cudaSuccess ? blocks : -static_cast<int>(e);
  };
  switch (N) {
    case 4: return query(mamba_scan_bwd_kernel<4>, Cfg<4>::kBytes, configure<4>());
    case 8: return query(mamba_scan_bwd_kernel<8>, Cfg<8>::kBytes, configure<8>());
    case 16: return query(mamba_scan_bwd_kernel<16>, Cfg<16>::kBytes, configure<16>());
    case 32: return query(mamba_scan_bwd_kernel<32>, Cfg<32>::kBytes, configure<32>());
    default: return -static_cast<int>(cudaErrorInvalidValue);
  }
}
