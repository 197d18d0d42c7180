// Flash attention forward (prefill) for Hopper: causal, sliding-window or
// bidirectional GQA attention, q [B,S,H,hd], k/v [B,S,KV,hd] -> out [B,S,H,hd].
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::_flash_kernel.
// The TPU walks kv tiles as a sequential grid axis with the online-softmax
// state in VMEM scratch; here a loop inside the block visits only the kv tiles
// the mask lets through (the causal triangle or the window band) and keeps
// (m, l, acc) per row in registers. Both routes keep the reference's numerics:
// an online softmax in float32, scale hd**-0.5, masked scores at the finite
// -1e30, l clamped at 1e-30, rows past S not written.
//
// Bound: at the serving shapes (S <= 256) the work is a few MFLOP and the
// inputs a few hundred KB (0.16 us of HBM time at moonshot's S32), so the
// kernel is bound by latency, not by bytes or the tensor cores' rate: how
// many SMs its blocks occupy and how long each block's chain of loads and
// dependent arithmetic is.
//
// bfloat16 (the serving path): 16 query rows per block (one m16 tile of
// mma.sync.m16n8k16), so the grid is (ceil(S/16), H, B): 32 blocks at
// moonshot S32, 128 at tiny_lm S256. QK^T and PV run on the tensor cores with
// float32 sums; Q and K fragments come from shared memory by ldmatrix, V's by
// ldmatrix.trans, and P is rounded to bf16 for the PV product (the score tile
// of QK^T is already laid out as the A fragment of PV, so P never leaves
// registers). 32-key K/V tiles stream in by 16-byte cp.async.cg through a
// ring per warp (3 stages with one warp, 2 with more), rows past S
// zero-filled; shared rows are padded by 16 bytes so the 8 rows of an
// ldmatrix hit distinct banks at every hd. A q tile's kv tiles form a chain
// of dependent steps (8 for the last q tile at S256), so where the grid
// leaves the card room they go round-robin to 2 or 4 groups of warps
// ("splits"), each with its own ring and online softmax, and the splits'
// (m, l, o) are combined through shared memory at the end, each scaled by
// exp(m_w - max m). Two 16-row q tiles may share a block (QW = 2), which
// halves the blocks and the K/V bytes read from L2; the launcher takes the
// shape (QW, NW) with the shortest chain for the grid (tc_shape), among the
// shapes whose shared memory fits a block (at hd 256, at most 2 splits). At
// hd 256 Q's fragments are read from shared memory at each step instead of
// being held in registers beside o.
//
// The logsumexp: where the caller passes an `lse` buffer (training, whose
// backward B1b recomputes the probabilities from it), each row's
// m + log(max(l, 1e-30)) is written there in float32, laid out [B, S, H]
// (= [B, S, KV, G], as the JAX package's _attend_fwd_impl returns it). The
// serving calls pass none and do no more than test the pointer once a row.
//
// float32: kept for exactness (TF32 on the tensor cores would not hold 2e-4);
// not on the serving path. One block of 256 threads per (64-row q tile, head,
// batch); Q, K and V staged through shared memory as float32; each row owned
// by 4 neighbouring threads, each holding hd/4 of its dimensions
// (interleaved, so reads of a shared K/V row hit distinct banks); a score is
// the xor-shuffle sum of their partial dot products, in float32 FMA.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kBQ = 64;   // query rows per block
constexpr int kBK = 32;   // keys per kv tile
constexpr int kTPR = 4;   // threads per query row

template <typename T, int HD>
__global__ void __launch_bounds__(kBQ * kTPR)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ out, float* __restrict__ lse, int S, int H, int KV,
                 int64_t sqb, int64_t sqs, int64_t sqh,
                 int64_t skb, int64_t sks, int64_t skh,
                 int64_t svb, int64_t svs, int64_t svh,
                 int causal, int window, float scale) {
  constexpr int NT = kBQ * kTPR;
  constexpr int DPT = HD / kTPR;
  extern __shared__ float smem[];
  float* q_s = smem;               // [kBQ][HD]
  float* k_s = q_s + kBQ * HD;     // [kBK][HD]
  float* v_s = k_s + kBK * HD;     // [kBK][HD]

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int row = tid / kTPR;
  const int part = tid % kTPR;
  const int qi = q0 + row;

  const T* qb = q + b * sqb + h * sqh;
  const T* kb = k + b * skb + kvh * skh;
  const T* vb = v + b * svb + kvh * svh;

  for (int e = tid; e < kBQ * HD; e += NT) {
    const int s = q0 + e / HD;
    q_s[e] = s < S ? rt::to_float(qb[s * sqs + e % HD]) : 0.f;
  }
  __syncthreads();
  float qr[DPT], acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    qr[i] = q_s[row * HD + part + i * kTPR];
    acc[i] = 0.f;
  }
  float m = rt::kMasked, l = 0.f;

  // kv tiles that can contribute to some row of this q tile
  const int q_last = min(q0 + kBQ, S) - 1;
  const int kv_end = causal ? q_last + 1 : S;
  const int kv_begin = window > 0 ? max(0, q0 - window + 1) : 0;

  for (int t0 = (kv_begin / kBK) * kBK; t0 < kv_end; t0 += kBK) {
    __syncthreads();  // the previous tile is consumed
    for (int e = tid; e < kBK * HD; e += NT) {
      const int t = t0 + e / HD;
      const int d = e % HD;
      const bool in = t < S;
      k_s[e] = in ? rt::to_float(kb[t * sks + d]) : 0.f;
      v_s[e] = in ? rt::to_float(vb[t * svs + d]) : 0.f;
    }
    __syncthreads();

    float p[kBK];
    float tile_max = rt::kMasked;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < DPT; ++i) dot = fmaf(qr[i], k_s[j * HD + part + i * kTPR], dot);
#pragma unroll
      for (int off = kTPR / 2; off > 0; off >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
      const int t = t0 + j;
      bool visible = t < S;
      if (causal) visible = visible && t <= qi;
      if (window > 0) visible = visible && (qi - t) < window;
      p[j] = visible ? dot * scale : rt::kMasked;
      tile_max = fmaxf(tile_max, p[j]);
    }
    const float m_new = fmaxf(m, tile_max);
    const float corr = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      p[j] = expf(p[j] - m_new);
      psum += p[j];
    }
    l = l * corr + psum;
#pragma unroll
    for (int i = 0; i < DPT; ++i) acc[i] *= corr;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
#pragma unroll
      for (int i = 0; i < DPT; ++i) acc[i] = fmaf(p[j], v_s[j * HD + part + i * kTPR], acc[i]);
    }
    m = m_new;
  }

  if (qi < S) {
    const float lc = fmaxf(l, 1e-30f);
    T* ob = out + ((static_cast<int64_t>(b) * S + qi) * H + h) * HD;
#pragma unroll
    for (int i = 0; i < DPT; ++i) ob[part + i * kTPR] = rt::from_float<T>(acc[i] / lc);
    if (lse != nullptr && part == 0)
      lse[(static_cast<int64_t>(b) * S + qi) * H + h] = m + logf(lc);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out, float* lse, int B, int S,
           int H, int KV,
           int64_t sqb, int64_t sqs, int64_t sqh, int64_t skb, int64_t sks, int64_t skh,
           int64_t svb, int64_t svs, int64_t svh, int causal, int window, float scale,
           cudaStream_t stream) {
  const int smem = (kBQ + 2 * kBK) * HD * static_cast<int>(sizeof(float));
  auto kernel = flash_fwd_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((S + kBQ - 1) / kBQ, H, B);
  kernel<<<grid, kBQ * kTPR, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), lse, S, H, KV, sqb, sqs, sqh, skb, sks, skh, svb, svs, svh,
      causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---- bfloat16: tensor cores; QW x 16 query rows per block, kv tiles over NW splits ----

constexpr int kTcBQ = 16;      // query rows per warp (one m16 tile)
constexpr int kTcBK = 32;      // keys per kv tile

// QW warps of 16 query rows share each K/V tile; NW such groups ("splits")
// take the block's kv tiles round-robin, each through its own ring.
template <int HD, int QW, int NW> struct TcFlash {
  static constexpr int kWarps = QW * NW;
  static constexpr int kStages = NW == 1 ? 3 : 2;   // each split's cp.async ring of K/V tiles
  static constexpr int kLd = HD + 8;                // padded shared row (+16 bytes)
  static constexpr int kQ = QW * kTcBQ * kLd;       // Q tile, elements
  static constexpr int kKV = kTcBK * kLd;           // one K or one V tile
  static constexpr int kRing = kStages * 2 * kKV;   // one split's ring
  static constexpr int kSmem = (kQ + NW * kRing) * static_cast<int>(sizeof(__nv_bfloat16));
  // the combine of NW > 1 reuses the rings: per warp (m, l) and o, [HD/8 + 1][32][4] floats
  static constexpr int kComb = (HD / 8 + 1) * 32 * 4;
  static_assert(NW == 1 || kWarps * kComb * 4 <= NW * kRing * 2, "the combine fits");
  // the shared memory a block may take; a shape above it is never instantiated
  static constexpr bool kFits = kSmem <= 227 * 1024;
  // Q's fragments stay in registers up to hd 128; at hd 256 they (64
  // registers) beside o (128) would spill, so each kk step reads its own
  // from shared memory, where Q stays for the whole kernel
  static constexpr bool kQRegs = HD <= 128;
};

// the most kv splits a block of this head dim can take within shared memory
template <int HD> constexpr int tc_max_nw() {
  return TcFlash<HD, 1, 4>::kFits && TcFlash<HD, 2, 4>::kFits ? 4 : 2;
}

template <int HD, int QW, int NW>
__global__ void __launch_bounds__(32 * QW * NW)
flash_fwd_tc_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                    float* __restrict__ lse, int S, int H, int KV,
                    int64_t sqb, int64_t sqs, int64_t sqh,
                    int64_t skb, int64_t sks, int64_t skh,
                    int64_t svb, int64_t svs, int64_t svh,
                    int causal, int window, float scale) {
  using L = TcFlash<HD, QW, NW>;
  constexpr int kLd = L::kLd, CPR = HD / 8, kStages = L::kStages;   // CPR: 16-byte chunks a row
  constexpr int kRows = QW * kTcBQ, kThreads = 32 * L::kWarps, kGroup = 32 * QW;
  extern __shared__ __align__(16) unsigned char flash_tc_smem[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(flash_tc_smem);

  const int q0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int qsub = warp % QW, split = warp / QW;    // this warp's 16 rows, its kv split
  const int gt = qsub * 32 + lane;                  // thread within the split's group
  __nv_bfloat16* ring = q_s + L::kQ + split * L::kRing;   // slot s: K, then V
  const __nv_bfloat16* qb = q + b * sqb + h * sqh;
  const __nv_bfloat16* kb = k + b * skb + kvh * skh;
  const __nv_bfloat16* vb = v + b * svb + kvh * svh;

  // kv tiles that can contribute to some row of this q tile; split s takes
  // tiles s, s + NW, ...
  const int q_last = min(q0 + kRows, S) - 1;
  const int kv_end = causal ? q_last + 1 : S;
  const int kv_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_first = (kv_begin / kTcBK) * kTcBK;
  const int n_tiles = (kv_end - t_first + kTcBK - 1) / kTcBK;
  const int n_mine = (n_tiles - split + NW - 1) / NW;

#pragma unroll
  for (int i = 0; i < (kRows * CPR + kThreads - 1) / kThreads; ++i) {   // Q: rows past S zeroed
    const int c = threadIdx.x + i * kThreads;
    const int r = c / CPR, col = c % CPR * 8;
    const int s = q0 + r;
    if (kRows * CPR % kThreads == 0 || c < kRows * CPR)
      rt::cp_async16(q_s + r * kLd + col, qb + min(s, S - 1) * sqs + col, s < S);
  }
  rt::cp_async_commit();
  auto load_kv = [&](int j) {                   // this split's j-th tile
    __nv_bfloat16* ks = ring + (j % kStages) * 2 * L::kKV;
    __nv_bfloat16* vs = ks + L::kKV;
    const int t0 = t_first + (split + j * NW) * kTcBK;
#pragma unroll
    for (int i = 0; i < kTcBK * CPR / kGroup; ++i) {
      const int c = gt + i * kGroup;
      const int r = c / CPR, col = c % CPR * 8;
      const int t = t0 + r;
      const int64_t tc = min(t, S - 1);
      rt::cp_async16(ks + r * kLd + col, kb + tc * sks + col, t < S);
      rt::cp_async16(vs + r * kLd + col, vb + tc * svs + col, t < S);
    }
  };
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) {
    if (j < n_mine) load_kv(j);
    rt::cp_async_commit();
  }
  rt::cp_async_wait<kStages - 1>();             // Q has landed ...
  __syncthreads();                              // ... every thread's part of it

  const int g = lane / 4, tq = lane % 4;        // fragment row group, column pair
  const int j8 = lane / 8, r8 = lane % 8;       // ldmatrix: matrix, row
  const int qi[2] = {q0 + qsub * kTcBQ + g, q0 + qsub * kTcBQ + g + 8};
  uint32_t qf[L::kQRegs ? HD / 16 : 1][4];
  if constexpr (L::kQRegs) {
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)        // (rows lo, d lo), (hi, lo), (lo, hi), (hi, hi)
      rt::ldsm_x4(qf[kk], q_s + (qsub * kTcBQ + r8 + (j8 % 2) * 8) * kLd + kk * 16 + (j8 / 2) * 8);
  }
  float o[HD / 8][4];
#pragma unroll
  for (int d = 0; d < HD / 8; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[d][e] = 0.f;
  float m[2] = {rt::kMasked, rt::kMasked}, l[2] = {0.f, 0.f};

  for (int j = 0; j < n_mine; ++j) {
    rt::cp_async_wait<kStages - 2>();           // tile j has landed ...
    if constexpr (NW == 1)                      // ... for the whole split; slot j-1 is free
      __syncthreads();
    else
      asm volatile("bar.sync %0, %1;\n" ::"r"(1 + split), "n"(kGroup) : "memory");
    if (j + kStages - 1 < n_mine) load_kv(j + kStages - 1);
    rt::cp_async_commit();
    const __nv_bfloat16* ks = ring + (j % kStages) * 2 * L::kKV;
    const __nv_bfloat16* vs = ks + L::kKV;
    const int t0 = t_first + (split + j * NW) * kTcBK;
    float sc[kTcBK / 8][4];                     // scores: rows g, g+8 x keys 2tq, 2tq+1
#pragma unroll
    for (int nt = 0; nt < kTcBK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      if constexpr (L::kQRegs) {
#pragma unroll
        for (int nt = 0; nt < kTcBK / 8; nt += 2) {   // B = K^T: two n8 key tiles a load
          uint32_t kf[4];
          rt::ldsm_x4(kf, ks + ((nt + j8 / 2) * 8 + r8) * kLd + kk * 16 + (j8 % 2) * 8);
          rt::mma_bf16_16816(sc[nt], qf[kk], kf);
          rt::mma_bf16_16816(sc[nt + 1], qf[kk], kf + 2);
        }
      } else {                                  // Q's fragment kk from shared memory
        uint32_t qk[4];
        rt::ldsm_x4(qk, q_s + (qsub * kTcBQ + r8 + (j8 % 2) * 8) * kLd + kk * 16 + (j8 / 2) * 8);
#pragma unroll
        for (int nt = 0; nt < kTcBK / 8; nt += 2) {
          uint32_t kf[4];
          rt::ldsm_x4(kf, ks + ((nt + j8 / 2) * 8 + r8) * kLd + kk * 16 + (j8 % 2) * 8);
          rt::mma_bf16_16816(sc[nt], qk, kf);
          rt::mma_bf16_16816(sc[nt + 1], qk, kf + 2);
        }
      }
    }

    float mx[2] = {rt::kMasked, rt::kMasked};
#pragma unroll
    for (int nt = 0; nt < kTcBK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = t0 + nt * 8 + 2 * tq + (e & 1);
        const int row = qi[e / 2];
        bool visible = t < S;
        if (causal) visible = visible && t <= row;
        if (window > 0) visible = visible && (row - t) < window;
        sc[nt][e] = visible ? sc[nt][e] * scale : rt::kMasked;
        mx[e / 2] = fmaxf(mx[e / 2], sc[nt][e]);
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {               // the 4 lanes of a row group share its max
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      corr[r] = expf(m[r] - m_new);
      m[r] = m_new;
      l[r] *= corr[r];
    }
#pragma unroll
    for (int d = 0; d < HD / 8; ++d) {
      o[d][0] *= corr[0]; o[d][1] *= corr[0];
      o[d][2] *= corr[1]; o[d][3] *= corr[1];
    }
#pragma unroll
    for (int nt = 0; nt < kTcBK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[nt][e] = expf(sc[nt][e] - m[e / 2]);
        l[e / 2] += sc[nt][e];                  // this lane's columns; summed at the end
      }
    }
#pragma unroll
    for (int kk = 0; kk < kTcBK / 16; ++kk) {   // P (bf16) as the A fragment of 16 keys
      const uint32_t pa[4] = {rt::pack_bf16(sc[2 * kk][0], sc[2 * kk][1]),
                              rt::pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
                              rt::pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                              rt::pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
      // B = V, two n8 column tiles a load: (keys lo, d), (hi, d), (lo, d+1), (hi, d+1)
#pragma unroll
      for (int d = 0; d < HD / 8; d += 2) {
        uint32_t vf[4];
        rt::ldsm_x4_trans(vf, vs + (kk * 16 + (j8 % 2) * 8 + r8) * kLd + (d + j8 / 2) * 8);
        rt::mma_bf16_16816(o[d], pa, vf);
        rt::mma_bf16_16816(o[d + 1], pa, vf + 2);
      }
    }
  }
  rt::cp_async_wait<0>();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }

  __nv_bfloat16* ob = out + (static_cast<int64_t>(b) * S * H + h) * HD + 2 * tq;
  const int64_t row_stride = static_cast<int64_t>(H) * HD;
  if constexpr (NW == 1) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (qi[r] >= S) continue;
      const float lc = fmaxf(l[r], 1e-30f);
      const float inv = 1.f / lc;
#pragma unroll
      for (int d = 0; d < HD / 8; ++d)
        *reinterpret_cast<uint32_t*>(ob + qi[r] * row_stride + d * 8) =
            rt::pack_bf16(o[d][2 * r] * inv, o[d][2 * r + 1] * inv);
      if (lse != nullptr && tq == 0)
        lse[(static_cast<int64_t>(b) * S + qi[r]) * H + h] = m[r] + logf(lc);
    }
  } else {
    // combine the warps' partial (m, l, o) of the same rows, as the online
    // softmax would have: each scaled by exp(m_w - max_w m_w)
    __syncthreads();                            // every warp is done with its ring
    float* comb = reinterpret_cast<float*>(q_s + L::kQ);
    float* mine = comb + warp * L::kComb;       // warp = split * QW + qsub
#pragma unroll
    for (int d = 0; d < HD / 8; ++d)
      *reinterpret_cast<float4*>(mine + (d * 32 + lane) * 4) =
          make_float4(o[d][0], o[d][1], o[d][2], o[d][3]);
    *reinterpret_cast<float4*>(mine + (HD / 8 * 32 + lane) * 4) =
        make_float4(m[0], m[1], l[0], l[1]);
    __syncthreads();
    float mw[NW][2], lw[NW][2], mt[2] = {rt::kMasked, rt::kMasked};
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float4 ml = *reinterpret_cast<const float4*>(comb + (w * QW + qsub) * L::kComb +
                                                         (HD / 8 * 32 + lane) * 4);
      mw[w][0] = ml.x; mw[w][1] = ml.y;
      lw[w][0] = ml.z; lw[w][1] = ml.w;
      mt[0] = fmaxf(mt[0], ml.x); mt[1] = fmaxf(mt[1], ml.y);
    }
    float sw[NW][2], lt[2] = {0.f, 0.f};
#pragma unroll
    for (int w = 0; w < NW; ++w) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        sw[w][r] = expf(mw[w][r] - mt[r]);
        lt[r] += lw[w][r] * sw[w][r];
      }
    }
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      inv[r] = 1.f / fmaxf(lt[r], 1e-30f);
      if (lse != nullptr && split == 0 && tq == 0 && qi[r] < S)
        lse[(static_cast<int64_t>(b) * S + qi[r]) * H + h] = mt[r] + logf(fmaxf(lt[r], 1e-30f));
    }
    for (int d = split; d < HD / 8; d += NW) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        const float4 ow = *reinterpret_cast<const float4*>(comb + (w * QW + qsub) * L::kComb +
                                                           (d * 32 + lane) * 4);
        acc[0] += ow.x * sw[w][0]; acc[1] += ow.y * sw[w][0];
        acc[2] += ow.z * sw[w][1]; acc[3] += ow.w * sw[w][1];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (qi[r] < S)
          *reinterpret_cast<uint32_t*>(ob + qi[r] * row_stride + d * 8) =
              rt::pack_bf16(acc[2 * r] * inv[r], acc[2 * r + 1] * inv[r]);
    }
  }
}

template <int HD, int QW, int NW>
int launch_tc(const void* q, const void* k, const void* v, void* out, float* lse, int B, int S,
              int H, int KV,
              int64_t sqb, int64_t sqs, int64_t sqh, int64_t skb, int64_t sks, int64_t skh,
              int64_t svb, int64_t svs, int64_t svh, int causal, int window, float scale,
              cudaStream_t stream) {
  using L = TcFlash<HD, QW, NW>;
  auto kernel = flash_fwd_tc_kernel<HD, QW, NW>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((S + QW * kTcBQ - 1) / (QW * kTcBQ), H, B);
  kernel<<<grid, 32 * L::kWarps, L::kSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), lse, S, H, KV,
      sqb, sqs, sqh, skb, sks, skh, svb, svs, svh, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

// kv tiles of the q tile of `rows` rows at q0, as the kernel counts them
int tc_tiles(int q0, int rows, int S, int causal, int window) {
  const int kv_end = causal ? min(q0 + rows, S) : S;
  const int t_first = (window > 0 ? max(0, q0 - window + 1) : 0) / kTcBK * kTcBK;
  return (kv_end - t_first + kTcBK - 1) / kTcBK;
}

// The block's shape (QW, NW). A q tile's kv tiles are a chain of dependent
// steps; splitting them over NW groups of warps shortens the longest chain,
// as long as the grid leaves the card room (at most 4 such groups a SM in
// all). Two q tiles a block (QW = 2) halve the blocks, so a grid too large
// for more splits with one may take them with two, and each K/V tile is read
// once for both. The shape with the shortest chain wins; one q tile a block
// on a tie, for the larger grid. max_nw: the most splits the head dim's
// shared memory allows (tc_max_nw).
int tc_shape(int S, int H, int B, int causal, int window, int max_nw, int* qw) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      sms = 0;
  }
  int best_chain = 0, best_nw = 1;
  for (int qs = 1; qs <= 2; ++qs) {
    const int rows = qs * kTcBQ;
    // the first and the last q tile visit the most kv tiles
    const int tiles = max(tc_tiles(0, rows, S, causal, window),
                          tc_tiles((S - 1) / rows * rows, rows, S, causal, window));
    const int blocks = (S + rows - 1) / rows * H * B;
    int nw = 1;
    for (int n = max_nw; n > 1 && nw == 1; n /= 2)
      if (n <= tiles && blocks * n <= 4 * sms) nw = n;
    const int chain = (tiles + nw - 1) / nw;
    if (qs == 1 || chain < best_chain) {
      best_chain = chain;
      best_nw = nw;
      *qw = qs;
    }
  }
  return best_nw;
}

template <int HD>
int launch_tc_shape(const void* q, const void* k, const void* v, void* out, float* lse, int B,
                    int S, int H, int KV, int64_t sqb, int64_t sqs, int64_t sqh,
                    int64_t skb, int64_t sks, int64_t skh, int64_t svb, int64_t svs, int64_t svh,
                    int causal, int window, float scale, cudaStream_t st) {
  int qw = 1;
  const int nw = tc_shape(S, H, B, causal, window, tc_max_nw<HD>(), &qw);
#define RT_FLASH_TC(QW, NW)                                                                  \
  if constexpr (TcFlash<HD, QW, NW>::kFits)                                                  \
    if (qw == QW && nw == NW)                                                                \
      return launch_tc<HD, QW, NW>(q, k, v, out, lse, B, S, H, KV, sqb, sqs, sqh, skb, sks,  \
                                   skh, svb, svs, svh, causal, window, scale, st);
  RT_FLASH_TC(1, 1)
  RT_FLASH_TC(1, 2)
  RT_FLASH_TC(1, 4)
  RT_FLASH_TC(2, 2)
  RT_FLASH_TC(2, 4)
#undef RT_FLASH_TC
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v, void* out, float* lse,
                int B, int S, int H, int KV, int64_t sqb, int64_t sqs, int64_t sqh,
                int64_t skb, int64_t sks, int64_t skh, int64_t svb, int64_t svs, int64_t svh,
                int causal, int window, float scale, cudaStream_t st) {
#define RT_FLASH_CASE(D)                                                                     \
  case D:                                                                                    \
    if constexpr (std::is_same<T, __nv_bfloat16>::value)                                     \
      return launch_tc_shape<D>(q, k, v, out, lse, B, S, H, KV, sqb, sqs, sqh, skb, sks, skh,  \
                                svb, svs, svh, causal, window, scale, st);                   \
    else                                                                                     \
      return launch<T, D>(q, k, v, out, lse, B, S, H, KV, sqb, sqs, sqh, skb, sks, skh, svb,  \
                          svs, svh, causal, window, scale, st);
  switch (hd) {
    RT_FLASH_CASE(16)
    RT_FLASH_CASE(32)
    RT_FLASH_CASE(64)
    RT_FLASH_CASE(80)
    RT_FLASH_CASE(96)
    RT_FLASH_CASE(128)
    RT_FLASH_CASE(256)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef RT_FLASH_CASE
}

}  // namespace

// Plain C entry point, loaded with ctypes. Strides are in elements; the head
// dimension must be contiguous, and for bfloat16 (16-byte cp.async) every
// row 16-byte aligned. lse: null, or a contiguous float32 [B, S, H] buffer for
// each row's logsumexp. Returns the cudaError_t of the launch.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                   float* lse, int dtype, int B, int S, int H, int KV, int hd,
                                   int64_t sqb, int64_t sqs, int64_t sqh,
                                   int64_t skb, int64_t sks, int64_t skh,
                                   int64_t svb, int64_t svs, int64_t svh,
                                   int causal, int window, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == rt::kFloat32)
    return dispatch_hd<float>(hd, q, k, v, out, lse, B, S, H, KV, sqb, sqs, sqh, skb, sks, skh,
                              svb, svs, svh, causal, window, scale, st);
  if (dtype == rt::kBFloat16)
    return dispatch_hd<__nv_bfloat16>(hd, q, k, v, out, lse, B, S, H, KV, sqb, sqs, sqh, skb,
                                      sks, skh, svb, svs, svh, causal, window, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
