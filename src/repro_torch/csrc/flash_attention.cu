// Flash attention forward (prefill) for Hopper: causal, sliding-window or
// bidirectional GQA attention, q [B,S,H,hd], k/v [B,S,KV,hd] -> out [B,S,H,hd].
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::_flash_kernel.
// One block per (q-tile of BQ rows, query head, batch). The TPU walks kv tiles
// as a sequential grid axis with the online-softmax state in VMEM scratch;
// here a loop inside the block visits only the kv tiles the mask lets through
// (the causal triangle or the window band) and keeps (m, l, acc) per row in
// registers. Q, K and V tiles are staged through shared memory as float32.
// Each row is owned by TPR neighbouring threads, each holding HD/TPR of its
// dimensions (interleaved, so reads of a shared K/V row hit distinct banks);
// a score is the xor-shuffle sum of their partial dot products.
//
// Bound: at the serving shapes (S <= 256, hd <= 64) the work is a few MFLOP
// and the inputs a few hundred KB, so the kernel is bound by launch latency
// and by its float32 FMA loop, not by HBM; this first version does not use
// the tensor cores (wgmma), which keeps float32 inputs exact.
#include "common.cuh"

namespace {

constexpr int kBQ = 64;   // query rows per block
constexpr int kBK = 32;   // keys per kv tile
constexpr int kTPR = 4;   // threads per query row

template <typename T, int HD>
__global__ void __launch_bounds__(kBQ * kTPR)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ out, int S, int H, int KV,
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
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B, int S, int H, int KV,
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
      static_cast<T*>(out), S, H, KV, sqb, sqs, sqh, skb, sks, skh, svb, svs, svh,
      causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v, void* out, int B, int S,
                int H, int KV, int64_t sqb, int64_t sqs, int64_t sqh, int64_t skb, int64_t sks,
                int64_t skh, int64_t svb, int64_t svs, int64_t svh, int causal, int window,
                float scale, cudaStream_t st) {
#define RT_FLASH_CASE(D)                                                                     \
  case D:                                                                                    \
    return launch<T, D>(q, k, v, out, B, S, H, KV, sqb, sqs, sqh, skb, sks, skh, svb, svs, \
                        svh, causal, window, scale, st);
  switch (hd) {
    RT_FLASH_CASE(16)
    RT_FLASH_CASE(32)
    RT_FLASH_CASE(64)
    RT_FLASH_CASE(128)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef RT_FLASH_CASE
}

}  // namespace

// Plain C entry point, loaded with ctypes. Strides are in elements; the head
// dimension must be contiguous. Returns the cudaError_t of the launch.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                   int dtype, int B, int S, int H, int KV, int hd,
                                   int64_t sqb, int64_t sqs, int64_t sqh,
                                   int64_t skb, int64_t sks, int64_t skh,
                                   int64_t svb, int64_t svs, int64_t svh,
                                   int causal, int window, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == rt::kFloat32)
    return dispatch_hd<float>(hd, q, k, v, out, B, S, H, KV, sqb, sqs, sqh, skb, sks, skh, svb,
                              svs, svh, causal, window, scale, st);
  if (dtype == rt::kBFloat16)
    return dispatch_hd<__nv_bfloat16>(hd, q, k, v, out, B, S, H, KV, sqb, sqs, sqh, skb, sks,
                                      skh, svb, svs, svh, causal, window, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
