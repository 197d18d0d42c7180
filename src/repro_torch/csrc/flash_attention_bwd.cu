// Flash attention backward for Hopper (kernel B1b): dq, dk, dv of causal,
// sliding-window or bidirectional GQA attention from (q, k, v, out, lse, dout),
// q/out/dout/dq [B,S,H,hd], k/v/dk/dv [B,S,KV,hd], lse [B,S,H] float32 (the
// forward B1's logsumexp, = [B,S,KV,G]).
//
// The JAX package has no Pallas backward: attend_blocked's custom VJP is the
// plain-JAX _attend_bwd_impl (repro/models/attention.py:150-209), a scan over
// the (q block, kv block) pairs the mask lets through that recomputes each
// pair's probabilities p = exp(s - lse) from the saved logsumexp and adds
// into dq, dk and dv. This kernel computes the same with its rounding: p
// rounded to the input type before p^T dO, ds = p * (dp - D) * scale rounded
// to the input type before ds K and ds^T Q, every sum in float32, D =
// rowsum(dO * O). On a TPU the scan carries the three sums from step to
// step; here blocks run in no order, so each output is owned by one block
// and nothing is added across blocks: no atomics, and two calls give the
// same bits.
//
// Two kernels, launched one after the other on the caller's stream:
//  1. dq: one block per (q tile, head, batch). It computes D for its rows
//     (saved for kernel 2), then loops over the kv tiles its rows can see
//     (the causal triangle or the window band): s = Q K^T, dp = dO V^T, ds,
//     dq += ds K.
//  2. dk, dv: one block per (kv tile, kv head, batch). It loops over the G
//     query heads of its kv head and the q tiles that can see its keys:
//     s, p, dv += p^T dO, dp, ds, dk += ds^T Q.
// A tile is 64 rows up to hd 64, 32 up to hd 128, 16 at hd 256, so that the
// four float32 tiles of a block (Q, dO, K, V; rows padded by one float, so
// the 16 rows a warp reads at one column hit distinct banks) stay under
// 100 KB. 256 threads a block as 16 x 16: a thread owns rows ty + 16i and
// columns tx + 16j of each product tile.
//
// Bound: at train_100m's microbatch (B 4, S 1024, 12 heads, hd 64, causal)
// the function needs 5 products over the 0.52 M visible (query, key) pairs of
// each of the 48 (batch, head) rows, 16 GFLOP, and moves 50 MB (eight bf16
// tensors of 6.3 MB): 16 us at the tensor cores' bf16 rate, 15 us at HBM's,
// so it is bound by operations, barely. This first kernel computes on the
// FMA units in float32 out of shared memory, seven products (s and dp are
// formed in both kernels) at about one shared load per FMA, so it runs far
// from that bound; wgmma and TMA are a later PR's.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTx = 16;                  // threads along columns
constexpr int kTy = kThreads / kTx;      // threads along rows

template <int HD> struct Bwd {
  static constexpr int BR = HD <= 64 ? 64 : HD <= 128 ? 32 : 16;   // rows of a tile
  static constexpr int LD = HD + 1;      // padded float row of a Q/dO/K/V tile
  static constexpr int LP = BR + 1;      // padded float row of a p/ds tile
  static constexpr int RPT = BR / kTy;   // tile rows a thread owns
  static constexpr int CPT = BR / kTx;   // tile columns (of a p/ds tile) a thread owns
  static constexpr int DPT = HD / kTx;   // head-dim columns a thread owns
  static constexpr int kSmem = (4 * BR * LD + 2 * BR * LP + 2 * BR) * 4;
  static_assert(BR % kTy == 0 && BR % kTx == 0 && HD % kTx == 0, "tiles split over threads");
};

// rows [r0, r0 + BR) of a [rows, row_stride] tensor into a float tile; rows
// at or past S zeroed
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int64_t row_stride,
                                          int r0, int S) {
  using L = Bwd<HD>;
  for (int e = threadIdx.x; e < L::BR * HD; e += kThreads) {
    const int r = e / HD, c = e % HD;
    dst[r * L::LD + c] = r0 + r < S ? rt::to_float(src[(r0 + r) * row_stride + c]) : 0.f;
  }
}

__device__ __forceinline__ bool visible(int qi, int t, int S, int causal, int window) {
  bool vis = qi < S && t < S;
  if (causal) vis = vis && t <= qi;
  if (window > 0) vis = vis && qi - t < window;
  return vis;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const T* __restrict__ o, const T* __restrict__ dout,
              const float* __restrict__ lse, float* __restrict__ dsum, T* __restrict__ dq,
              int S, int H, int KV, int causal, int window, float scale) {
  using L = Bwd<HD>;
  constexpr int BR = L::BR, LD = L::LD, LP = L::LP;
  extern __shared__ float smem[];
  float* q_s = smem;
  float* do_s = q_s + BR * LD;
  float* k_s = do_s + BR * LD;
  float* v_s = k_s + BR * LD;
  float* ds_s = v_s + BR * LD;
  float* lse_s = ds_s + BR * LP;
  float* d_s = lse_s + BR;

  const int q0 = blockIdx.x * BR, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tx = threadIdx.x % kTx, ty = threadIdx.x / kTx;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t rq = static_cast<int64_t>(H) * HD, rk = static_cast<int64_t>(KV) * HD;
  const int64_t qoff = (static_cast<int64_t>(b) * S * H + h) * HD;
  const int64_t koff = (static_cast<int64_t>(b) * S * KV + kvh) * HD;

  load_tile<T, HD>(q_s, q + qoff, rq, q0, S);
  load_tile<T, HD>(do_s, dout + qoff, rq, q0, S);
  // D = rowsum(dO * O), a warp a row; saved for the dk/dv kernel
  for (int r = warp; r < BR; r += kThreads / 32) {
    const int s = q0 + r;
    float acc = 0.f;
    if (s < S)
      for (int c = lane; c < HD; c += 32)
        acc += rt::to_float(dout[qoff + s * rq + c]) * rt::to_float(o[qoff + s * rq + c]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) {
      d_s[r] = acc;
      lse_s[r] = s < S ? lse[(static_cast<int64_t>(b) * S + s) * H + h] : 0.f;
      if (s < S) dsum[(static_cast<int64_t>(b) * S + s) * H + h] = acc;
    }
  }

  float acc[L::RPT][L::DPT];
#pragma unroll
  for (int i = 0; i < L::RPT; ++i)
#pragma unroll
    for (int j = 0; j < L::DPT; ++j) acc[i][j] = 0.f;

  const int q_last = min(q0 + BR, S) - 1;
  const int kv_end = causal ? q_last + 1 : S;
  const int kv_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  for (int t0 = kv_begin / BR * BR; t0 < kv_end; t0 += BR) {
    __syncthreads();                     // the previous tile is consumed (and Q, D landed)
    load_tile<T, HD>(k_s, k + koff, rk, t0, S);
    load_tile<T, HD>(v_s, v + koff, rk, t0, S);
    __syncthreads();
    float sc[L::RPT][L::CPT], dp[L::RPT][L::CPT];
#pragma unroll
    for (int i = 0; i < L::RPT; ++i)
#pragma unroll
      for (int j = 0; j < L::CPT; ++j) sc[i][j] = dp[i][j] = 0.f;
    for (int d = 0; d < HD; ++d) {
      float qv[L::RPT], dov[L::RPT], kv[L::CPT], vv[L::CPT];
#pragma unroll
      for (int i = 0; i < L::RPT; ++i) {
        qv[i] = q_s[(ty + kTy * i) * LD + d];
        dov[i] = do_s[(ty + kTy * i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < L::CPT; ++j) {
        kv[j] = k_s[(tx + kTx * j) * LD + d];
        vv[j] = v_s[(tx + kTx * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < L::RPT; ++i)
#pragma unroll
        for (int j = 0; j < L::CPT; ++j) {
          sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
          dp[i][j] = fmaf(dov[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < L::RPT; ++i) {
      const int r = ty + kTy * i;
#pragma unroll
      for (int j = 0; j < L::CPT; ++j) {
        const int c = tx + kTx * j;
        const float p = visible(q0 + r, t0 + c, S, causal, window)
                            ? expf(sc[i][j] * scale - lse_s[r]) : 0.f;
        ds_s[r * LP + c] = rt::round_to<T>(p * (dp[i][j] - d_s[r]) * scale);
      }
    }
    __syncthreads();
    for (int t = 0; t < BR; ++t) {
      float kt[L::DPT];
#pragma unroll
      for (int j = 0; j < L::DPT; ++j) kt[j] = k_s[t * LD + tx + kTx * j];
#pragma unroll
      for (int i = 0; i < L::RPT; ++i) {
        const float ds = ds_s[(ty + kTy * i) * LP + t];
#pragma unroll
        for (int j = 0; j < L::DPT; ++j) acc[i][j] = fmaf(ds, kt[j], acc[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < L::RPT; ++i) {
    const int s = q0 + ty + kTy * i;
    if (s >= S) continue;
#pragma unroll
    for (int j = 0; j < L::DPT; ++j)
      dq[qoff + s * rq + tx + kTx * j] = rt::from_float<T>(acc[i][j]);
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const T* __restrict__ dout, const float* __restrict__ lse,
                const float* __restrict__ dsum, T* __restrict__ dk, T* __restrict__ dv,
                int S, int H, int KV, int causal, int window, float scale) {
  using L = Bwd<HD>;
  constexpr int BR = L::BR, LD = L::LD, LP = L::LP;
  extern __shared__ float smem[];
  float* k_s = smem;
  float* v_s = k_s + BR * LD;
  float* q_s = v_s + BR * LD;
  float* do_s = q_s + BR * LD;
  float* p_s = do_s + BR * LD;
  float* ds_s = p_s + BR * LP;
  float* lse_s = ds_s + BR * LP;
  float* d_s = lse_s + BR;

  const int t0 = blockIdx.x * BR, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KV;
  const int tx = threadIdx.x % kTx, ty = threadIdx.x / kTx;
  const int64_t rq = static_cast<int64_t>(H) * HD, rk = static_cast<int64_t>(KV) * HD;
  const int64_t koff = (static_cast<int64_t>(b) * S * KV + kvh) * HD;
  load_tile<T, HD>(k_s, k + koff, rk, t0, S);
  load_tile<T, HD>(v_s, v + koff, rk, t0, S);

  // rows t = ty + 16i of this kv tile, head-dim columns tx + 16j
  float dk_acc[L::RPT][L::DPT], dv_acc[L::RPT][L::DPT];
#pragma unroll
  for (int i = 0; i < L::RPT; ++i)
#pragma unroll
    for (int j = 0; j < L::DPT; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  // the q rows that can see a key of this tile
  const int t_last = min(t0 + BR, S) - 1;
  const int q_begin = causal ? t0 : 0;
  const int q_end = window > 0 ? min(S, t_last + window) : S;
  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const int64_t qoff = (static_cast<int64_t>(b) * S * H + h) * HD;
    for (int q0 = q_begin / BR * BR; q0 < q_end; q0 += BR) {
      __syncthreads();                   // the previous q tile is consumed (and K, V landed)
      load_tile<T, HD>(q_s, q + qoff, rq, q0, S);
      load_tile<T, HD>(do_s, dout + qoff, rq, q0, S);
      for (int r = threadIdx.x; r < BR; r += kThreads) {
        const bool in = q0 + r < S;
        const int64_t at = (static_cast<int64_t>(b) * S + q0 + r) * H + h;
        lse_s[r] = in ? lse[at] : 0.f;
        d_s[r] = in ? dsum[at] : 0.f;
      }
      __syncthreads();
      // s and dp of q rows r = tx + 16j against keys c = ty + 16i
      float sc[L::RPT][L::CPT], dp[L::RPT][L::CPT];
#pragma unroll
      for (int i = 0; i < L::RPT; ++i)
#pragma unroll
        for (int j = 0; j < L::CPT; ++j) sc[i][j] = dp[i][j] = 0.f;
      for (int d = 0; d < HD; ++d) {
        float kv[L::RPT], vv[L::RPT], qv[L::CPT], dov[L::CPT];
#pragma unroll
        for (int i = 0; i < L::RPT; ++i) {
          kv[i] = k_s[(ty + kTy * i) * LD + d];
          vv[i] = v_s[(ty + kTy * i) * LD + d];
        }
#pragma unroll
        for (int j = 0; j < L::CPT; ++j) {
          qv[j] = q_s[(tx + kTx * j) * LD + d];
          dov[j] = do_s[(tx + kTx * j) * LD + d];
        }
#pragma unroll
        for (int i = 0; i < L::RPT; ++i)
#pragma unroll
          for (int j = 0; j < L::CPT; ++j) {
            sc[i][j] = fmaf(qv[j], kv[i], sc[i][j]);
            dp[i][j] = fmaf(dov[j], vv[i], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < L::RPT; ++i) {
        const int c = ty + kTy * i;
#pragma unroll
        for (int j = 0; j < L::CPT; ++j) {
          const int r = tx + kTx * j;
          const float p = visible(q0 + r, t0 + c, S, causal, window)
                              ? expf(sc[i][j] * scale - lse_s[r]) : 0.f;
          p_s[r * LP + c] = rt::round_to<T>(p);
          ds_s[r * LP + c] = rt::round_to<T>(p * (dp[i][j] - d_s[r]) * scale);
        }
      }
      __syncthreads();
      // dv += p^T dO, dk += ds^T Q over the tile's q rows
      for (int r = 0; r < BR; ++r) {
        float dov[L::DPT], qv[L::DPT];
#pragma unroll
        for (int j = 0; j < L::DPT; ++j) {
          dov[j] = do_s[r * LD + tx + kTx * j];
          qv[j] = q_s[r * LD + tx + kTx * j];
        }
#pragma unroll
        for (int i = 0; i < L::RPT; ++i) {
          const float p = p_s[r * LP + ty + kTy * i];
          const float ds = ds_s[r * LP + ty + kTy * i];
#pragma unroll
          for (int j = 0; j < L::DPT; ++j) {
            dv_acc[i][j] = fmaf(p, dov[j], dv_acc[i][j]);
            dk_acc[i][j] = fmaf(ds, qv[j], dk_acc[i][j]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < L::RPT; ++i) {
    const int t = t0 + ty + kTy * i;
    if (t >= S) continue;
#pragma unroll
    for (int j = 0; j < L::DPT; ++j) {
      dk[koff + t * rk + tx + kTx * j] = rt::from_float<T>(dk_acc[i][j]);
      dv[koff + t * rk + tx + kTx * j] = rt::from_float<T>(dv_acc[i][j]);
    }
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
           const float* lse, void* dq, void* dk, void* dv, float* dsum, int B, int S, int H,
           int KV, int causal, int window, float scale, cudaStream_t stream) {
  using L = Bwd<HD>;
  auto kdq = bwd_dq_kernel<T, HD>;
  auto kdkdv = bwd_dkdv_kernel<T, HD>;
  cudaError_t err =
      cudaFuncSetAttribute(kdq, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kdkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (S + L::BR - 1) / L::BR;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  kdq<<<dim3(tiles, H, B), kThreads, L::kSmem, stream>>>(
      qt, kt, vt, static_cast<const T*>(o), dot, lse, dsum, static_cast<T*>(dq), S, H, KV,
      causal, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  kdkdv<<<dim3(tiles, KV, B), kThreads, L::kSmem, stream>>>(
      qt, kt, vt, dot, lse, dsum, static_cast<T*>(dk), static_cast<T*>(dv), S, H, KV, causal,
      window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v, const void* o,
                const void* dout, const float* lse, void* dq, void* dk, void* dv, float* dsum,
                int B, int S, int H, int KV, int causal, int window, float scale,
                cudaStream_t st) {
#define RT_BWD_CASE(D)                                                                   \
  case D:                                                                                \
    return launch<T, D>(q, k, v, o, dout, lse, dq, dk, dv, dsum, B, S, H, KV, causal,    \
                        window, scale, st);
  switch (hd) {
    RT_BWD_CASE(16)
    RT_BWD_CASE(32)
    RT_BWD_CASE(64)
    RT_BWD_CASE(80)
    RT_BWD_CASE(96)
    RT_BWD_CASE(128)
    RT_BWD_CASE(256)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef RT_BWD_CASE
}

}  // namespace

// Plain C entry point, loaded with ctypes. Every tensor contiguous: q, out,
// dout, dq [B,S,H,hd]; k, v, dk, dv [B,S,KV,hd]; lse and the scratch dsum
// [B,S,H] float32. Launches the dq kernel, then the dk/dv kernel, which
// reads the D the first wrote to dsum. Returns the first cudaError_t.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* out,
                                   const void* dout, const float* lse, void* dq, void* dk,
                                   void* dv, float* dsum, int dtype, int B, int S, int H, int KV,
                                   int hd, int causal, int window, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == rt::kFloat32)
    return dispatch_hd<float>(hd, q, k, v, out, dout, lse, dq, dk, dv, dsum, B, S, H, KV,
                              causal, window, scale, st);
  if (dtype == rt::kBFloat16)
    return dispatch_hd<__nv_bfloat16>(hd, q, k, v, out, dout, lse, dq, dk, dv, dsum, B, S, H,
                                      KV, causal, window, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
