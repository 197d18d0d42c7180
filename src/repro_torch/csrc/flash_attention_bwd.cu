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
// Two kernels a route, launched one after the other on the caller's stream:
//  1. dq: one block per (q tile, head, batch). It computes D for its rows
//     (saved for kernel 2), then loops over the kv tiles its rows can see
//     (the causal triangle or the window band): s = Q K^T, dp = dO V^T, ds,
//     dq += ds K.
//  2. dk, dv: one block per (kv tile, kv head, batch). It loops over the G
//     query heads of its kv head and the q tiles that can see its keys:
//     s, p, dv += p^T dO, dp, ds, dk += ds^T Q.
// Seven products in all (s and dp are formed in both kernels).
//
// Bound: at train_100m's microbatch (B 4, S 1024, 12 heads, hd 64, causal)
// the function needs 5 products over the 0.52 M visible (query, key) pairs of
// each of the 48 (batch, head) rows, 16 GFLOP, and moves 50 MB (eight bf16
// tensors of 6.3 MB): 16 us at the tensor cores' bf16 rate, 15 us at HBM's,
// so it is bound by operations, barely.
//
// bfloat16 (the training path): the tensor cores, mma.sync.m16n8k16 with
// bf16 operands and float32 sums (bwd_dq_tc_kernel, bwd_dkdv_tc_kernel).
// Blocks of 4 warps; each warp owns 16 rows of its kernel's output (queries
// in dq, keys in dk/dv), so every product has them on the M dimension and
// the float32 accumulators of s, p and ds are, rounded to bf16 in pairs, the
// A fragments of the next product: p and ds never pass through shared
// memory. Operands come from padded shared tiles by ldmatrix (.trans for the
// [k][n] ones: K in dq += ds K, dO and Q in dv and dk), fed by a 2-stage ring
// of 16-byte cp.async copies (lse and D rows by 4-byte copies). dk/dv takes
// 64 keys and steps over 64 queries at a time up to hd 64, 32 above; dq
// takes 64 queries and steps over 32 keys. Up to hd 64 each warp holds its A
// operands (K and V, or Q and dO) in registers; above, it reads them from
// shared memory at each step, beside its float32 sums of 16 x hd (dq) or 2 x
// 16 x hd (dk, dv). At hd 256 those two would take 256 registers a thread,
// so each dk/dv block sums half of the columns, and two blocks form the same
// s and dp. Masks are applied, in a loop of their own, only on the tiles
// that cross the diagonal, the window's edge or the ragged end of S (a mask
// test folded into every element's exponential slowed every tile); a warp
// skips a step its rows cannot see at all. p = 2^(s scale log2(e) - lse log2(e)) by
// ex2.approx. Blocks launch the longest first: the dq pass's from the last q
// tile, the dk/dv pass's from the first kv tile. At train_100m's microbatch
// the two passes issue 5.8 M mma.sync (23.6 GFLOP with the masked halves of
// the diagonal tiles); neither more warps a block, nor deeper rings, nor
// fewer registers made them faster, so mma.sync's issue rate bounds them,
// and wgmma is the next step.
//
// float32: kept for exactness, on the FMA units. A tile is 64 rows up to hd
// 64, 32 up to hd 128, 16 at hd 256, so that the four float32 tiles of a
// block (Q, dO, K, V; rows padded by one float, so the 16 rows a warp reads
// at one column hit distinct banks) stay under 100 KB. 256 threads a block
// as 16 x 16: a thread owns rows ty + 16i and columns tx + 16j of each
// product tile, in float32 FMA out of shared memory at about one shared load
// per FMA.
#include <type_traits>

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

// ---- bfloat16: tensor cores (mma.sync.m16n8k16, bf16 operands, float32 sums) ----

constexpr float kLog2e = 1.4426950408889634f;

// 2^x (ex2.approx: relative error about 2^-22, far under bf16's rounding of p)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// 4 bytes from device to shared memory, asynchronously; zeroed with full = false
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool full) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
               "r"(full ? 4 : 0)
               : "memory");
}

// Tiles of the two passes. Every warp owns 16 rows of its pass's output (keys
// in dk/dv, queries in dq), so each product has them on the M dimension of
// m16n8k16 and p and ds go from the accumulator registers of one product
// straight into the A fragments of the next.
template <int HD> struct TcBwd {
  static constexpr int kWarps = 4, kThreads = 32 * kWarps, kStages = 2;
  static constexpr int kLd = HD + 8;                 // padded shared row (+16 bytes)
  // dk/dv: 64 keys a block, BQ queries a step of its loop
  static constexpr int BK = 16 * kWarps;
  static constexpr int BQ = HD <= 64 ? 64 : 32;
  // at hd 256 one warp's dK and dV sums (16 x 256 each, float32) would take
  // 256 registers a thread: there each block sums half of the head dim's
  // columns (S^T and dP^T, over the whole head dim, are formed by both)
  static constexpr int kSplit = HD > 128 ? 2 : 1;
  static constexpr int HDO = HD / kSplit;            // dK/dV columns a block writes
  static constexpr bool kKVRegs = HD <= 64;          // K/V fragments held in registers
  static constexpr int kStageQ = 2 * BQ * kLd;       // a step's Q and dO tiles, elements
  static constexpr int kSmemKV =
      (2 * BK * kLd + kStages * kStageQ) * 2 + kStages * 2 * BQ * 4;
  // dq: 64 queries a block, BKD keys a step
  static constexpr int BR = 16 * kWarps;
  static constexpr int BKD = 32;
  static constexpr bool kQRegs = HD <= 64;           // Q/dO fragments held in registers
  static constexpr int kStageK = 2 * BKD * kLd;      // a step's K and V tiles, elements
  static constexpr int kSmemQ = (2 * BR * kLd + kStages * kStageK) * 2;
  static_assert(HD % 16 == 0 && (HDO / 8) % 2 == 0, "head dim in k16 steps, n8 tiles in pairs");
  static_assert(kSmemKV <= 227 * 1024 && kSmemQ <= 227 * 1024, "shared memory of a block");
};

// rows [r0, r0 + R) of a [rows, row_stride] bf16 tensor into a padded shared
// tile by 16-byte cp.async; rows at or past S zero-filled
template <int HD, int R, int NT>
__device__ __forceinline__ void cp_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                        int64_t row_stride, int r0, int S) {
  constexpr int CPR = HD / 8, kLd = HD + 8;
#pragma unroll
  for (int i = 0; i < (R * CPR + NT - 1) / NT; ++i) {
    const int c = threadIdx.x + i * NT;
    if (R * CPR % NT == 0 || c < R * CPR) {
      const int r = c / CPR, col = c % CPR * 8;
      const int s = r0 + r;
      rt::cp_async16(dst + r * kLd + col,
                     src + static_cast<int64_t>(min(s, S - 1)) * row_stride + col, s < S);
    }
  }
}

// the A fragments of 16 rows x HD columns from shared memory, for mma_abt
template <int HD>
__device__ __forceinline__ void load_afrag(uint32_t (*af)[4], const __nv_bfloat16* as, int lane) {
  const int j8 = lane / 8, r8 = lane % 8;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    rt::ldsm_x4(af[kk], as + (r8 + (j8 % 2) * 8) * (HD + 8) + kk * 16 + (j8 / 2) * 8);
}

// acc[16 x 8 NB] += A[16 x HD] B^T: A's fragments from registers (af) or from
// the 16 shared rows at `as`; B's 8 NB rows held [n][hd] in shared memory at
// `bs`
template <int HD, int NB, bool kRegs>
__device__ __forceinline__ void mma_abt(float (*acc)[4], const uint32_t (*af)[4],
                                        const __nv_bfloat16* as, const __nv_bfloat16* bs,
                                        int lane) {
  constexpr int kLd = HD + 8;
  const int j8 = lane / 8, r8 = lane % 8;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    uint32_t a[4];
    if constexpr (kRegs) {
#pragma unroll
      for (int e = 0; e < 4; ++e) a[e] = af[kk][e];
    } else {
      rt::ldsm_x4(a, as + (r8 + (j8 % 2) * 8) * kLd + kk * 16 + (j8 / 2) * 8);
    }
#pragma unroll
    for (int nt = 0; nt < NB; nt += 2) {        // two n8 tiles of B a load
      uint32_t b[4];
      rt::ldsm_x4(b, bs + ((nt + j8 / 2) * 8 + r8) * kLd + kk * 16 + (j8 % 2) * 8);
      rt::mma_bf16_16816(acc[nt], a, b);
      rt::mma_bf16_16816(acc[nt + 1], a, b + 2);
    }
  }
}

// acc[16 x NO] += X[16 x 16 KB] Y: X given as the bf16 rounding of the float32
// accumulator tiles x (16 x 8 each, 2 KB of them: an accumulator pair of n8
// tiles is the A fragment of one k16 step); Y's 16 KB rows held [k][n] in
// shared memory at `ys`, columns [0, NO) of them
template <int HD, int KB, int NO>
__device__ __forceinline__ void mma_xy(float (*acc)[4], const float (*x)[4],
                                       const __nv_bfloat16* ys, int lane) {
  constexpr int kLd = HD + 8;
  const int j8 = lane / 8, r8 = lane % 8;
#pragma unroll
  for (int kk = 0; kk < KB; ++kk) {
    const uint32_t a[4] = {rt::pack_bf16(x[2 * kk][0], x[2 * kk][1]),
                           rt::pack_bf16(x[2 * kk][2], x[2 * kk][3]),
                           rt::pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]),
                           rt::pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3])};
#pragma unroll
    for (int d = 0; d < NO / 8; d += 2) {       // two n8 column tiles a load
      uint32_t b[4];
      rt::ldsm_x4_trans(b, ys + (kk * 16 + (j8 % 2) * 8 + r8) * kLd + (d + j8 / 2) * 8);
      rt::mma_bf16_16816(acc[d], a, b);
      rt::mma_bf16_16816(acc[d + 1], a, b + 2);
    }
  }
}

// dq pass: one block per (64-query tile, head, batch), 16 queries a warp. It
// writes D = rowsum(dO * O) of its rows (for the dk/dv pass), then walks the
// kv tiles its rows can see through a cp.async ring: S = Q K^T, P = exp(S
// scale - lse), dP = dO V^T, dS = P (dP - D) scale, dQ += dS K.
template <int HD>
__global__ void __launch_bounds__(TcBwd<HD>::kThreads)
bwd_dq_tc_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ o,
                 const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                 float* __restrict__ dsum, __nv_bfloat16* __restrict__ dq, int S, int H, int KV,
                 int causal, int window, float scale, float scale_log2) {
  using L = TcBwd<HD>;
  constexpr int kLd = L::kLd, BR = L::BR, BKD = L::BKD, NT = L::kThreads, kStages = L::kStages;
  constexpr int CPR = HD / 8;
  extern __shared__ __align__(16) unsigned char bwd_dq_smem[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(bwd_dq_smem);
  __nv_bfloat16* do_s = q_s + BR * kLd;
  __nv_bfloat16* ring = do_s + BR * kLd;        // slot s: K, then V

  // q tiles slowest in launch order (every head's last q tile first, under a
  // causal mask the ones that see most), so that the long blocks start early
  const int lin = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
  const int yz = gridDim.y * gridDim.z, at = lin % yz;
  const int qt = causal ? gridDim.x - 1 - lin / yz : lin / yz;
  const int q0 = qt * BR, h = at % gridDim.y, b = at / gridDim.y;
  const int kvh = h / (H / KV);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  const int64_t rq = static_cast<int64_t>(H) * HD, rk = static_cast<int64_t>(KV) * HD;
  const int64_t qoff = (static_cast<int64_t>(b) * S * H + h) * HD;
  const int64_t koff = (static_cast<int64_t>(b) * S * KV + kvh) * HD;

  cp_tile<HD, BR, NT>(q_s, q + qoff, rq, q0, S);
  cp_tile<HD, BR, NT>(do_s, dout + qoff, rq, q0, S);
  rt::cp_async_commit();
  const int q_last = min(q0 + BR, S) - 1;
  const int kv_end = causal ? q_last + 1 : S;
  const int t_first = (window > 0 ? max(0, q0 - window + 1) : 0) / BKD * BKD;
  const int n_tiles = (kv_end - t_first + BKD - 1) / BKD;
  auto load_kv = [&](int j) {
    __nv_bfloat16* ks = ring + (j % kStages) * L::kStageK;
    const int t0 = t_first + j * BKD;
    cp_tile<HD, BKD, NT>(ks, k + koff, rk, t0, S);
    cp_tile<HD, BKD, NT>(ks + BKD * kLd, v + koff, rk, t0, S);
  };
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) {
    if (j < n_tiles) load_kv(j);
    rt::cp_async_commit();
  }

  // D of this warp's 16 rows (two lanes a row, half the head dim each) while
  // the copies fly; then each lane's rows g, g + 8 take their D and lse
  const int qw0 = q0 + warp * 16;
  float dsum_row = 0.f;
  {
    const int s = qw0 + lane / 2;
    if (s < S) {
      const __nv_bfloat16* dr = dout + qoff + s * rq;
      const __nv_bfloat16* orow = o + qoff + s * rq;
#pragma unroll
      for (int i = 0; i < CPR / 2; ++i) {
        const int c = lane % 2 * (CPR / 2) + i;
        float fd[8], fo[8];
        rt::Cvt<__nv_bfloat16>::unpack(*reinterpret_cast<const uint4*>(dr + c * 8), fd);
        rt::Cvt<__nv_bfloat16>::unpack(*reinterpret_cast<const uint4*>(orow + c * 8), fo);
#pragma unroll
        for (int e = 0; e < 8; ++e) dsum_row = fmaf(fd[e], fo[e], dsum_row);
      }
    }
    dsum_row += __shfl_xor_sync(0xffffffffu, dsum_row, 1);
    if (lane % 2 == 0 && s < S) dsum[(static_cast<int64_t>(b) * S + s) * H + h] = dsum_row;
  }
  const int qi[2] = {qw0 + g, qw0 + g + 8};
  float drow[2], lrow[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    drow[r] = __shfl_sync(0xffffffffu, dsum_row, 2 * (g + 8 * r));
    lrow[r] = qi[r] < S ? lse[(static_cast<int64_t>(b) * S + qi[r]) * H + h] * kLog2e : 0.f;
  }

  rt::cp_async_wait<kStages - 1>();             // Q and dO have landed ...
  __syncthreads();                              // ... every thread's part of them
  const __nv_bfloat16* qw_s = q_s + warp * 16 * kLd;
  const __nv_bfloat16* dow_s = do_s + warp * 16 * kLd;
  uint32_t qf[HD / 16][4], df[HD / 16][4];      // registers only where kQRegs
  if constexpr (L::kQRegs) {
    load_afrag<HD>(qf, qw_s, lane);
    load_afrag<HD>(df, dow_s, lane);
  }
  float acc[HD / 8][4];
#pragma unroll
  for (int d = 0; d < HD / 8; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[d][e] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    rt::cp_async_wait<kStages - 2>();           // tile j has landed ...
    __syncthreads();                            // ... for every warp; slot j - 1 is free
    if (j + kStages - 1 < n_tiles) load_kv(j + kStages - 1);
    rt::cp_async_commit();
    const int t0 = t_first + j * BKD;
    // this warp's rows against the tile's keys: none visible, or some masked
    if (qw0 >= S || (causal && t0 > qw0 + 15) || (window > 0 && qw0 - (t0 + BKD - 1) >= window))
      continue;
    const bool masked = qw0 + 16 > S || t0 + BKD > S || (causal && t0 + BKD - 1 > qw0) ||
                        (window > 0 && qw0 + 15 - t0 >= window);
    const __nv_bfloat16* ks = ring + (j % kStages) * L::kStageK;
    const __nv_bfloat16* vs = ks + BKD * kLd;
    float sc[BKD / 8][4], dp[BKD / 8][4];
#pragma unroll
    for (int nt = 0; nt < BKD / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] = dp[nt][e] = 0.f;
    mma_abt<HD, BKD / 8, L::kQRegs>(sc, qf, qw_s, ks, lane);       // S = Q K^T
    mma_abt<HD, BKD / 8, L::kQRegs>(dp, df, dow_s, vs, lane);      // dP = dO V^T
#pragma unroll
    for (int nt = 0; nt < BKD / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] = ex2(fmaf(sc[nt][e], scale_log2, -lrow[e / 2]));
    if (masked)                                 // a loop of its own: the others pay nothing
#pragma unroll
      for (int nt = 0; nt < BKD / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (!visible(qi[e / 2], t0 + nt * 8 + 2 * tq + (e & 1), S, causal, window))
            sc[nt][e] = 0.f;
#pragma unroll
    for (int nt = 0; nt < BKD / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] = sc[nt][e] * (dp[nt][e] - drow[e / 2]) * scale;   // dS
    mma_xy<HD, BKD / 16, HD>(acc, sc, ks, lane);                     // dQ += dS K
  }
  rt::cp_async_wait<0>();

  __nv_bfloat16* dqb = dq + qoff + 2 * tq;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qi[r] >= S) continue;
#pragma unroll
    for (int d = 0; d < HD / 8; ++d)
      *reinterpret_cast<uint32_t*>(dqb + qi[r] * rq + d * 8) =
          rt::pack_bf16(acc[d][2 * r], acc[d][2 * r + 1]);
  }
}

// dk/dv pass: one block per (64-key tile, kv head [, column half], batch), 16
// keys a warp. It walks the G query heads of its kv head and the q tiles that
// can see its keys through a cp.async ring: S^T = K Q^T, P^T = exp(S^T scale -
// lse), dV += P^T dO, dP^T = V dO^T, dS^T = P^T (dP^T - D) scale, dK += dS^T Q.
template <int HD>
__global__ void __launch_bounds__(TcBwd<HD>::kThreads)
bwd_dkdv_tc_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ dsum,
                   __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int S, int H,
                   int KV, int causal, int window, float scale, float scale_log2) {
  using L = TcBwd<HD>;
  constexpr int kLd = L::kLd, BK = L::BK, BQ = L::BQ, NT = L::kThreads, kStages = L::kStages;
  constexpr int HDO = L::HDO;
  extern __shared__ __align__(16) unsigned char bwd_dkdv_smem[];
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(bwd_dkdv_smem);
  __nv_bfloat16* v_s = k_s + BK * kLd;
  __nv_bfloat16* ring = v_s + BK * kLd;         // slot s: Q, then dO
  float* stats = reinterpret_cast<float*>(ring + kStages * L::kStageQ);   // slot s: lse, D

  // kv tiles slowest in launch order (every head's first kv tile first, under
  // a causal mask the ones that most queries see)
  const int lin = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
  const int yz = gridDim.y * gridDim.z, at = lin % yz, y = at % gridDim.y;
  const int t0 = lin / yz * BK, b = at / gridDim.y;
  const int kvh = y / L::kSplit, col0 = y % L::kSplit * HDO;
  const int G = H / KV;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  const int64_t rq = static_cast<int64_t>(H) * HD, rk = static_cast<int64_t>(KV) * HD;
  const int64_t koff = (static_cast<int64_t>(b) * S * KV + kvh) * HD;

  cp_tile<HD, BK, NT>(k_s, k + koff, rk, t0, S);
  cp_tile<HD, BK, NT>(v_s, v + koff, rk, t0, S);
  rt::cp_async_commit();
  // the q tiles that can see a key of this tile, for each of the G heads
  const int t_last = min(t0 + BK, S) - 1;
  const int q_first = (causal ? t0 : 0) / BQ * BQ;
  const int q_end = window > 0 ? min(S, t_last + window) : S;
  const int nq = (q_end - q_first + BQ - 1) / BQ;
  const int n_steps = G * nq;
  auto load_q = [&](int j) {
    const int h = kvh * G + j / nq, q0 = q_first + j % nq * BQ;
    const int64_t qoff = (static_cast<int64_t>(b) * S * H + h) * HD;
    __nv_bfloat16* qs = ring + (j % kStages) * L::kStageQ;
    cp_tile<HD, BQ, NT>(qs, q + qoff, rq, q0, S);
    cp_tile<HD, BQ, NT>(qs + BQ * kLd, dout + qoff, rq, q0, S);
    if (threadIdx.x < BQ) {
      float* st = stats + (j % kStages) * 2 * BQ;
      const int s = q0 + threadIdx.x;
      const int64_t row = (static_cast<int64_t>(b) * S + min(s, S - 1)) * H + h;
      cp_async4(st + threadIdx.x, lse + row, s < S);
      cp_async4(st + BQ + threadIdx.x, dsum + row, s < S);
    }
  };
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) {
    if (j < n_steps) load_q(j);
    rt::cp_async_commit();
  }

  rt::cp_async_wait<kStages - 1>();             // K and V have landed ...
  __syncthreads();                              // ... every thread's part of them
  const int kw0 = t0 + warp * 16;               // this warp's keys
  const __nv_bfloat16* kw_s = k_s + warp * 16 * kLd;
  const __nv_bfloat16* vw_s = v_s + warp * 16 * kLd;
  uint32_t kf[HD / 16][4], vf[HD / 16][4];      // registers only where kKVRegs
  if constexpr (L::kKVRegs) {
    load_afrag<HD>(kf, kw_s, lane);
    load_afrag<HD>(vf, vw_s, lane);
  }
  float dka[HDO / 8][4], dva[HDO / 8][4];
#pragma unroll
  for (int d = 0; d < HDO / 8; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[d][e] = dva[d][e] = 0.f;
  const int ti[2] = {kw0 + g, kw0 + g + 8};

  for (int j = 0; j < n_steps; ++j) {
    rt::cp_async_wait<kStages - 2>();           // step j's tiles have landed ...
    __syncthreads();                            // ... for every warp; slot j - 1 is free
    if (j + kStages - 1 < n_steps) load_q(j + kStages - 1);
    rt::cp_async_commit();
    const int q0 = q_first + j % nq * BQ;
    // this warp's keys against the step's queries: none visible, or some masked
    if (kw0 >= S || (causal && q0 + BQ - 1 < kw0) || (window > 0 && q0 - (kw0 + 15) >= window))
      continue;
    const bool masked = kw0 + 16 > S || q0 + BQ > S || (causal && q0 < kw0 + 15) ||
                        (window > 0 && q0 + BQ - 1 - kw0 >= window);
    const __nv_bfloat16* qs = ring + (j % kStages) * L::kStageQ;
    const __nv_bfloat16* dos = qs + BQ * kLd;
    const float* st = stats + (j % kStages) * 2 * BQ;
    float sc[BQ / 8][4];
#pragma unroll
    for (int nt = 0; nt < BQ / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] = 0.f;
    mma_abt<HD, BQ / 8, L::kKVRegs>(sc, kf, kw_s, qs, lane);        // S^T = K Q^T
#pragma unroll
    for (int nt = 0; nt < BQ / 8; ++nt) {                            // P^T
      const float2 l2 = *reinterpret_cast<const float2*>(st + nt * 8 + 2 * tq);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sc[nt][e] = ex2(fmaf(sc[nt][e], scale_log2, -((e & 1) ? l2.y : l2.x) * kLog2e));
    }
    if (masked)                                 // a loop of its own: the others pay nothing
#pragma unroll
      for (int nt = 0; nt < BQ / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (!visible(q0 + nt * 8 + 2 * tq + (e & 1), ti[e / 2], S, causal, window))
            sc[nt][e] = 0.f;
    mma_xy<HD, BQ / 16, HDO>(dva, sc, dos + col0, lane);             // dV += P^T dO
    float dp[BQ / 8][4];
#pragma unroll
    for (int nt = 0; nt < BQ / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[nt][e] = 0.f;
    mma_abt<HD, BQ / 8, L::kKVRegs>(dp, vf, vw_s, dos, lane);       // dP^T = V dO^T
#pragma unroll
    for (int nt = 0; nt < BQ / 8; ++nt) {                            // dS^T
      const float2 d2 = *reinterpret_cast<const float2*>(st + BQ + nt * 8 + 2 * tq);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sc[nt][e] = sc[nt][e] * (dp[nt][e] - ((e & 1) ? d2.y : d2.x)) * scale;
    }
    mma_xy<HD, BQ / 16, HDO>(dka, sc, qs + col0, lane);              // dK += dS^T Q
  }
  rt::cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (ti[r] >= S) continue;
    const int64_t off = koff + ti[r] * rk + col0 + 2 * tq;
#pragma unroll
    for (int d = 0; d < HDO / 8; ++d) {
      *reinterpret_cast<uint32_t*>(dk + off + d * 8) =
          rt::pack_bf16(dka[d][2 * r], dka[d][2 * r + 1]);
      *reinterpret_cast<uint32_t*>(dv + off + d * 8) =
          rt::pack_bf16(dva[d][2 * r], dva[d][2 * r + 1]);
    }
  }
}

template <int HD>
int launch_tc(const void* q, const void* k, const void* v, const void* o, const void* dout,
              const float* lse, void* dq, void* dk, void* dv, float* dsum, int B, int S, int H,
              int KV, int causal, int window, float scale, cudaStream_t stream) {
  using L = TcBwd<HD>;
  using bf = __nv_bfloat16;
  auto kdq = bwd_dq_tc_kernel<HD>;
  auto kdkdv = bwd_dkdv_tc_kernel<HD>;
  cudaError_t err =
      cudaFuncSetAttribute(kdq, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmemQ);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kdkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmemKV);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale_log2 = scale * kLog2e;
  const bf* qt = static_cast<const bf*>(q);
  const bf* kt = static_cast<const bf*>(k);
  const bf* vt = static_cast<const bf*>(v);
  const bf* dot = static_cast<const bf*>(dout);
  kdq<<<dim3((S + L::BR - 1) / L::BR, H, B), L::kThreads, L::kSmemQ, stream>>>(
      qt, kt, vt, static_cast<const bf*>(o), dot, lse, dsum, static_cast<bf*>(dq), S, H, KV,
      causal, window, scale, scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  kdkdv<<<dim3((S + L::BK - 1) / L::BK, KV * L::kSplit, B), L::kThreads, L::kSmemKV, stream>>>(
      qt, kt, vt, dot, lse, dsum, static_cast<bf*>(dk), static_cast<bf*>(dv), S, H, KV, causal,
      window, scale, scale_log2);
  return static_cast<int>(cudaGetLastError());
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
    if constexpr (std::is_same<T, __nv_bfloat16>::value)                                 \
      return launch_tc<D>(q, k, v, o, dout, lse, dq, dk, dv, dsum, B, S, H, KV, causal,  \
                          window, scale, st);                                            \
    else                                                                                 \
      return launch<T, D>(q, k, v, o, dout, lse, dq, dk, dv, dsum, B, S, H, KV, causal,  \
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
