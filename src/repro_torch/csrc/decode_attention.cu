// Decode attention for Hopper: one query token per sequence against a linear
// or ring KV cache. q [B,H,hd], caches [B,W,KV,hd], positions [B] -> [B,H,hd].
//
// Replaces the TPU kernel repro/kernels/decode_attention.py::_decode_kernel.
// The TPU runs one program per (b, kv head) and walks W sequentially. On the
// card that grid is far too small (B*KV = 16 blocks for tiny_lm with 4 slots,
// on 132 SMs), so this is flash-decoding: pass 1 splits W into chunks, one
// block per (chunk, kv head, b), and writes a partial (m, l, acc) for the G
// query heads that share the kv head; pass 2 rescales and sums the partials of
// each (b, h). Chunks at or past the sequence's valid length are skipped, as
// the TPU kernel skips its blocks: valid_len = min(pos + 1, W), and for a
// ring cache W once pos >= W.
//
// Bound: the cache is read once and every score is used once, so the kernel
// is bound by bytes (HBM or L2); at the serving shapes (W <= 256) it is bound
// by launch latency. The chunk's K (padded rows, conflict-free column reads)
// and V are staged in shared memory as float32, scores in float32.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ int valid_len(int pos, int W, int ring) {
  if (ring) return pos >= W ? W : pos + 1;
  return min(pos + 1, W);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// partials: acc [B, H, nsplit, HD], ml [B, H, nsplit, 2]
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
decode_partial_kernel(const T* __restrict__ q, const T* __restrict__ kc, const T* __restrict__ vc,
                      const int* __restrict__ pos, float* __restrict__ part_acc,
                      float* __restrict__ part_ml, int W, int H, int KV, int chunk, int nsplit,
                      int64_t sqb, int64_t sqh, int64_t skb, int64_t skw, int64_t skh,
                      int64_t svb, int64_t svw, int64_t svh, int ring, float scale) {
  const int split = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / KV;
  const int vl = valid_len(pos[b], W, ring);
  const int c0 = split * chunk;
  if (c0 >= vl) return;                  // pass 2 reads only chunks below vl
  const int n = min(chunk, vl - c0);     // keys of this chunk that are valid

  extern __shared__ float smem[];
  float* q_s = smem;                     // [G][HD]
  float* k_s = q_s + G * HD;             // [chunk][HD + 1]
  float* v_s = k_s + chunk * (HD + 1);   // [chunk][HD]
  float* p_s = v_s + chunk * HD;         // [G][chunk]

  const int tid = threadIdx.x;
  for (int e = tid; e < G * HD; e += kThreads) {
    const int g = e / HD;
    q_s[e] = rt::to_float(q[b * sqb + (kvh * G + g) * sqh + e % HD]);
  }
  const T* kb = kc + b * skb + kvh * skh;
  const T* vb = vc + b * svb + kvh * svh;
  for (int e = tid; e < n * HD; e += kThreads) {
    const int t = e / HD;
    const int d = e % HD;
    k_s[t * (HD + 1) + d] = rt::to_float(kb[(c0 + t) * skw + d]);
    v_s[e] = rt::to_float(vb[(c0 + t) * svw + d]);
  }
  __syncthreads();

  for (int e = tid; e < G * n; e += kThreads) {
    const int g = e / n;
    const int t = e % n;
    const float* qg = q_s + g * HD;
    const float* kt = k_s + t * (HD + 1);
    float dot = 0.f;
#pragma unroll 16
    for (int d = 0; d < HD; ++d) dot = fmaf(qg[d], kt[d], dot);
    p_s[g * chunk + t] = dot * scale;
  }
  __syncthreads();

  const int warp = tid / 32;
  const int lane = tid % 32;
  for (int g = warp; g < G; g += kThreads / 32) {
    float* pg = p_s + g * chunk;
    float m = rt::kMasked;
    for (int t = lane; t < n; t += 32) m = fmaxf(m, pg[t]);
    m = warp_max(m);
    float l = 0.f;
    for (int t = lane; t < n; t += 32) {
      const float p = expf(pg[t] - m);
      pg[t] = p;
      l += p;
    }
    l = warp_sum(l);
    if (lane == 0) {
      float* ml = part_ml + ((static_cast<int64_t>(b) * H + kvh * G + g) * nsplit + split) * 2;
      ml[0] = m;
      ml[1] = l;
    }
  }
  __syncthreads();

  for (int e = tid; e < G * HD; e += kThreads) {
    const int g = e / HD;
    const int d = e % HD;
    const float* pg = p_s + g * chunk;
    float a = 0.f;
    for (int t = 0; t < n; ++t) a = fmaf(pg[t], v_s[t * HD + d], a);
    part_acc[((static_cast<int64_t>(b) * H + kvh * G + g) * nsplit + split) * HD + d] = a;
  }
}

// one block per (h, b), one thread per output dimension
template <typename T, int HD>
__global__ void __launch_bounds__(HD)
decode_combine_kernel(const float* __restrict__ part_acc, const float* __restrict__ part_ml,
                      const int* __restrict__ pos, T* __restrict__ out, int W, int H, int chunk,
                      int nsplit, int ring) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int d = threadIdx.x;
  const int nv = (valid_len(pos[b], W, ring) + chunk - 1) / chunk;
  const int64_t bh = static_cast<int64_t>(b) * H + h;
  const float* ml = part_ml + bh * nsplit * 2;
  const float* acc = part_acc + bh * nsplit * HD;
  float M = rt::kMasked;
  for (int c = 0; c < nv; ++c) M = fmaxf(M, ml[c * 2]);
  float L = 0.f, A = 0.f;
  for (int c = 0; c < nv; ++c) {
    const float w = expf(ml[c * 2] - M);
    L = fmaf(ml[c * 2 + 1], w, L);
    A = fmaf(acc[c * HD + d], w, A);
  }
  out[bh * HD + d] = rt::from_float<T>(A / fmaxf(L, 1e-30f));
}

template <typename T, int HD>
int launch(const void* q, const void* kc, const void* vc, const int* pos, void* out,
           float* part_acc, float* part_ml, int B, int W, int H, int KV, int chunk,
           int64_t sqb, int64_t sqh, int64_t skb, int64_t skw, int64_t skh, int64_t svb,
           int64_t svw, int64_t svh, int ring, float scale, cudaStream_t stream) {
  const int G = H / KV;
  const int nsplit = (W + chunk - 1) / chunk;
  const int smem = (G * HD + chunk * (HD + 1) + chunk * HD + G * chunk) *
                   static_cast<int>(sizeof(float));
  auto partial = decode_partial_kernel<T, HD>;
  cudaError_t err =
      cudaFuncSetAttribute(partial, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  partial<<<dim3(nsplit, KV, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc), static_cast<const T*>(vc), pos,
      part_acc, part_ml, W, H, KV, chunk, nsplit, sqb, sqh, skb, skw, skh, svb, svw, svh, ring,
      scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_combine_kernel<T, HD><<<dim3(H, B), HD, 0, stream>>>(
      part_acc, part_ml, pos, static_cast<T*>(out), W, H, chunk, nsplit, ring);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* kc, const void* vc, const int* pos, void* out,
                float* part_acc, float* part_ml, int B, int W, int H, int KV, int chunk,
                int64_t sqb, int64_t sqh, int64_t skb, int64_t skw, int64_t skh, int64_t svb,
                int64_t svw, int64_t svh, int ring, float scale, cudaStream_t st) {
#define RT_DECODE_CASE(D)                                                                    \
  case D:                                                                                    \
    return launch<T, D>(q, kc, vc, pos, out, part_acc, part_ml, B, W, H, KV, chunk, sqb, sqh, \
                        skb, skw, skh, svb, svw, svh, ring, scale, st);
  switch (hd) {
    RT_DECODE_CASE(16)
    RT_DECODE_CASE(32)
    RT_DECODE_CASE(64)
    RT_DECODE_CASE(128)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef RT_DECODE_CASE
}

}  // namespace

// Plain C entry point, loaded with ctypes. Strides are in elements; the head
// dimension must be contiguous; positions are int32. part_acc holds
// B*H*nsplit*hd floats and part_ml B*H*nsplit*2, nsplit = ceil(W / chunk).
// Returns the cudaError_t of the launches.
extern "C" int decode_attention_fwd(const void* q, const void* kc, const void* vc,
                                    const void* pos, void* out, void* part_acc, void* part_ml,
                                    int dtype, int B, int W, int H, int KV, int hd, int chunk,
                                    int64_t sqb, int64_t sqh,
                                    int64_t skb, int64_t skw, int64_t skh,
                                    int64_t svb, int64_t svw, int64_t svh,
                                    int ring, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(pos);
  float* pa = static_cast<float*>(part_acc);
  float* pm = static_cast<float*>(part_ml);
  if (dtype == rt::kFloat32)
    return dispatch_hd<float>(hd, q, kc, vc, p, out, pa, pm, B, W, H, KV, chunk, sqb, sqh, skb,
                              skw, skh, svb, svw, svh, ring, scale, st);
  if (dtype == rt::kBFloat16)
    return dispatch_hd<__nv_bfloat16>(hd, q, kc, vc, p, out, pa, pm, B, W, H, KV, chunk, sqb,
                                      sqh, skb, skw, skh, svb, svw, svh, ring, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
