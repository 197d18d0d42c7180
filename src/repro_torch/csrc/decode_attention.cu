// Decode attention for Hopper: one query token per sequence against a linear
// or ring KV cache. q [B,H,hd], caches [B,W,KV,hd], positions [B] -> [B,H,hd].
//
// Replaces the TPU kernel repro/kernels/decode_attention.py::_decode_kernel.
// The TPU runs one program per (b, kv head) and walks W sequentially with the
// online-softmax state of the G query heads in VMEM. Here one block of 8
// warps takes a (b, kv head, group of up to 8 of its query heads) and a range
// of keys: all of [0, valid_len) at the serving shapes, so one launch does the
// whole call; a chunk of it (flash-decoding) where one block per (b, kv head)
// would walk too many keys, and then a second launch combines the chunks'
// partials (the route is chosen on the host, kernels/decode_attention.py).
// valid_len = min(pos + 1, W), and W for a ring cache once pos >= W; keys at
// or past it are never read.
//
// A cache whose slots are split over ranks (flash-decoding across devices):
// decode_attention_partial takes one rank's range of slots, W of the W_total
// of the whole cache from slot w_off on, masks them by their global index,
// and writes the range's unnormalized partial (acc [B,H,HD], (m, l) [B,H,2])
// for the ranks to combine by a max and two sums. A range with no valid slot
// gives m = -inf, l = 0, acc = 0.
//
// Bound: every cache row below valid_len is read once, so the kernel is bound
// by bytes (HBM or L2); at the serving shapes (W <= 256, a few KB a block) it
// is bound by latency: the chain pos -> K/V loads -> scores -> combine. The
// design keeps that chain short. The cache is read straight from global
// memory in 16-byte vectors, LPK lanes a key row (its vectors rounded up to a
// power of two) and 32 / LPK keys a warp step; a warp has the K and V loads
// of 2-4 steps in flight at once, the warps of a block take interleaved keys,
// and the q rows of the block's heads (in registers) share each K/V load. A
// score is the xor-shuffle sum of the LPK lanes' partial dot products, float32
// throughout; each key group of a warp keeps its own (m, l, o), and the groups
// and warps are merged once: shuffles within a warp, then shared memory.
// p is rounded to the cache's type before the PV product, as the TPU kernel
// rounds it.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kStaticSmem = 48 * 1024;   // above it only with the attribute set

__device__ __forceinline__ int valid_len(int pos, int W, int ring) {
  if (ring) return pos >= W ? W : pos + 1;
  return min(pos + 1, W);
}

// the valid slots of the range [w_off, w_off + W) of a cache of W_total slots,
// counted from w_off: the global valid length clamped to the range
__device__ __forceinline__ int range_valid(int pos, int W, int W_total, int w_off, int ring) {
  return min(max(valid_len(pos, W_total, ring) - w_off, 0), W);
}

constexpr int pow2_at_least(int n) { return n <= 1 ? 1 : 2 * pow2_at_least((n + 1) / 2); }

// How a cache row of HD elements of T is spread over a warp: 16-byte vectors
// of kVec elements, kLPK lanes a key (kVPL vectors each), kKPS keys a step.
template <typename T, int HD> struct Rows {
  static constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  static constexpr int kNV = HD / kVec;
  static constexpr int kLPK = kNV >= 32 ? 32 : pow2_at_least(kNV);
  static constexpr int kVPL = kNV > 32 ? kNV / 32 : 1;
  static constexpr int kKPS = 32 / kLPK;
  static constexpr int kE = kVPL * kVec;
  static_assert(HD % kVec == 0 && kNV % kVPL == 0 && kNV <= kLPK * kVPL, "row layout");
};

// grid (nsplit, KV * head groups, B). nsplit == 1 and not partial: out
// [B,H,HD] directly. Otherwise partials: acc [B,H,nsplit,HD], ml
// [B,H,nsplit,2] (m, l; m = -inf where a block saw no valid slot).
template <typename T, int HD, int GB>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const T* __restrict__ kc, const T* __restrict__ vc,
              const int* __restrict__ pos, T* __restrict__ out, float* __restrict__ part_acc,
              float* __restrict__ part_ml, int W, int H, int KV, int chunk, int nsplit,
              int64_t sqb, int64_t sqh, int64_t skb, int64_t skw, int64_t skh,
              int64_t svb, int64_t svw, int64_t svh, int ring, float scale, int w_off,
              int W_total, int partial) {
  using R = Rows<T, HD>;
  // U: the steps of a round, whose K/V loads a warp has in flight at once
  // (fewer where the heads' q and o take the registers)
  constexpr int E = R::kE, U = R::kVPL == 1 && GB <= 4 ? 4 : 2, kStep = kWarps * R::kKPS;
  const int split = blockIdx.x;
  const int G = H / KV;
  const int ngroups = (G + GB - 1) / GB;
  const int kvh = blockIdx.y / ngroups;
  const int g0 = blockIdx.y % ngroups * GB;          // first query head of the block in its group
  const int ng = min(GB, G - g0);
  const int b = blockIdx.z;
  const int h0 = kvh * G + g0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ks = lane / R::kLPK, vi = lane % R::kLPK;  // key slot, vector of the row
  const bool lane_on = vi < R::kNV;                  // lanes past the row's vectors idle

  float qr[GB][E];                                   // loaded before pos[b] returns
#pragma unroll
  for (int g = 0; g < GB; ++g)
#pragma unroll
    for (int j = 0; j < R::kVPL; ++j) {
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (lane_on && g < ng)
        v = *reinterpret_cast<const uint4*>(q + b * sqb + (h0 + g) * sqh +
                                            (vi + j * R::kLPK) * R::kVec);
      rt::Cvt<T>::unpack(v, qr[g] + j * R::kVec);
    }
  const T* kb = kc + b * skb + kvh * skh + vi * R::kVec;
  const T* vb = vc + b * svb + kvh * svh + vi * R::kVec;
  const int mine = warp * R::kKPS + ks;             // this lane's key in a block step
  const int k0 = split * chunk;
  uint4 kv[U][R::kVPL], vv[U][R::kVPL];
  // the K/V rows of a round below lim (lim <= W: every row exists)
  auto load = [&](int r0, int lim) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = r0 + u * kStep + mine;
#pragma unroll
      for (int j = 0; j < R::kVPL; ++j) {
        kv[u][j] = vv[u][j] = make_uint4(0u, 0u, 0u, 0u);
        if (t < lim && lane_on) {
          kv[u][j] = *reinterpret_cast<const uint4*>(kb + t * skw + j * R::kLPK * R::kVec);
          vv[u][j] = *reinterpret_cast<const uint4*>(vb + t * svw + j * R::kLPK * R::kVec);
        }
      }
    }
  };
  // one launch: the first round's rows are loaded before pos[b] returns, and
  // those at or past valid_len are masked after
  if (nsplit == 1) load(k0, W);
  const int vl = range_valid(pos[b], W, W_total, w_off, ring);
  if (k0 >= vl && nsplit > 1) return;               // the combine reads chunks below vl only
  const int k1 = min(k0 + chunk, vl);                // vl < 1 (pos < 0): no key, out = 0

  float m[GB], l[GB], o[GB][E];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    m[g] = rt::kMasked;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) o[g][e] = 0.f;
  }

  for (int r0 = k0; r0 < k1; r0 += U * kStep) {
    if (r0 > k0 || nsplit > 1) load(r0, k1);
    bool on[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      on[u] = r0 + u * kStep + mine < k1;
      if (!on[u])                                    // a row past valid_len weighs nothing
#pragma unroll
        for (int j = 0; j < R::kVPL; ++j) kv[u][j] = vv[u][j] = make_uint4(0u, 0u, 0u, 0u);
    }
    float s[GB][U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[E];
#pragma unroll
      for (int j = 0; j < R::kVPL; ++j) rt::Cvt<T>::unpack(kv[u][j], kf + j * R::kVec);
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) d = fmaf(qr[g][e], kf[e], d);
        s[g][u] = d;
      }
    }
#pragma unroll
    for (int off = R::kLPK / 2; off > 0; off >>= 1)
#pragma unroll
      for (int g = 0; g < GB; ++g)
#pragma unroll
        for (int u = 0; u < U; ++u) s[g][u] += __shfl_xor_sync(0xffffffffu, s[g][u], off);

    float p[GB][U];
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        s[g][u] *= scale;
        if (on[u]) mx = fmaxf(mx, s[g][u]);
      }
      const float corr = expf(m[g] - mx);
      m[g] = mx;
      l[g] *= corr;
#pragma unroll
      for (int e = 0; e < E; ++e) o[g][e] *= corr;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float pu = on[u] ? expf(s[g][u] - mx) : 0.f;   // masked keys weigh nothing
        l[g] += pu;
        p[g][u] = rt::round_to<T>(pu);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float vf[E];
#pragma unroll
      for (int j = 0; j < R::kVPL; ++j) rt::Cvt<T>::unpack(vv[u][j], vf + j * R::kVec);
#pragma unroll
      for (int g = 0; g < GB; ++g)
#pragma unroll
        for (int e = 0; e < E; ++e) o[g][e] = fmaf(p[g][u], vf[e], o[g][e]);
    }
  }

  // merge the warp's key groups (lanes LPK apart), as the online softmax
  // would have: each scaled by exp(m - max m)
#pragma unroll
  for (int off = R::kLPK; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m[g], off);
      const float l2 = __shfl_xor_sync(0xffffffffu, l[g], off);
      const float M = fmaxf(m[g], m2);
      const float a = expf(m[g] - M), c = expf(m2 - M);
      m[g] = M;
      l[g] = l[g] * a + l2 * c;
#pragma unroll
      for (int e = 0; e < E; ++e)
        o[g][e] = o[g][e] * a + __shfl_xor_sync(0xffffffffu, o[g][e], off) * c;
    }
  }

  // then the warps, through shared memory: o [kWarps][GB][HD], ml [kWarps][GB][2]
  extern __shared__ __align__(16) float dec_smem[];
  float* sm_o = dec_smem;
  float* sm_ml = sm_o + kWarps * GB * HD;
  if (ks == 0 && lane_on) {
#pragma unroll
    for (int g = 0; g < GB; ++g) {
#pragma unroll
      for (int j = 0; j < R::kVPL; ++j)
#pragma unroll
        for (int e = 0; e < R::kVec; e += 4)
          *reinterpret_cast<float4*>(sm_o + (warp * GB + g) * HD +
                                     (vi + j * R::kLPK) * R::kVec + e) =
              make_float4(o[g][j * R::kVec + e], o[g][j * R::kVec + e + 1],
                          o[g][j * R::kVec + e + 2], o[g][j * R::kVec + e + 3]);
      if (lane == 0) {
        sm_ml[(warp * GB + g) * 2] = m[g];
        sm_ml[(warp * GB + g) * 2 + 1] = l[g];
      }
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < ng * R::kNV; i += kThreads) {
    const int g = i / R::kNV, d0 = i % R::kNV * R::kVec;
    float M = rt::kMasked;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, sm_ml[(w * GB + g) * 2]);
    float L = 0.f, acc[R::kVec];
#pragma unroll
    for (int e = 0; e < R::kVec; ++e) acc[e] = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float sw = expf(sm_ml[(w * GB + g) * 2] - M);
      L = fmaf(sm_ml[(w * GB + g) * 2 + 1], sw, L);
      const float* ow = sm_o + (w * GB + g) * HD + d0;
#pragma unroll
      for (int e = 0; e < R::kVec; ++e) acc[e] = fmaf(ow[e], sw, acc[e]);
    }
    const int64_t bh = static_cast<int64_t>(b) * H + h0 + g;
    if (nsplit == 1 && !partial) {
      const float inv = 1.f / fmaxf(L, 1e-30f);
#pragma unroll
      for (int e = 0; e < R::kVec; ++e) acc[e] *= inv;
      *reinterpret_cast<uint4*>(out + bh * HD + d0) = rt::Cvt<T>::pack(acc);
    } else {
      float* pa = part_acc + (bh * nsplit + split) * HD + d0;
#pragma unroll
      for (int e = 0; e < R::kVec; e += 4)
        *reinterpret_cast<float4*>(pa + e) = make_float4(acc[e], acc[e + 1], acc[e + 2], acc[e + 3]);
      if (d0 == 0) {
        part_ml[(bh * nsplit + split) * 2] = L > 0.f ? M : -INFINITY;
        part_ml[(bh * nsplit + split) * 2 + 1] = L;
      }
    }
  }
}

// the split route's second pass: one block per (h, b), one thread per output
// dimension, rescaling and summing the partials of the chunks below valid_len;
// partial: the sums unnormalized into acc_out [B,H,HD] and (m, l) into
// ml_out [B,H,2] (m = -inf where the range has no valid slot)
template <typename T, int HD>
__global__ void __launch_bounds__(HD)
decode_combine_kernel(const float* __restrict__ part_acc, const float* __restrict__ part_ml,
                      const int* __restrict__ pos, T* __restrict__ out, int W, int H, int chunk,
                      int nsplit, int ring, int w_off, int W_total, float* __restrict__ acc_out,
                      float* __restrict__ ml_out) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int d = threadIdx.x;
  const int nv = (range_valid(pos[b], W, W_total, w_off, ring) + chunk - 1) / chunk;
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
  if (acc_out != nullptr) {
    acc_out[bh * HD + d] = A;
    if (d == 0) {
      ml_out[bh * 2] = L > 0.f ? M : -INFINITY;
      ml_out[bh * 2 + 1] = L;
    }
    return;
  }
  out[bh * HD + d] = rt::from_float<T>(A / fmaxf(L, 1e-30f));
}

// a call's slot range and, for the partial entry point, its outputs
struct Range {
  int w_off, W_total;
  float* acc_out;    // null: the whole cache, out normalized
  float* ml_out;
};

template <typename T, int HD, int GB>
int launch(const void* q, const void* kc, const void* vc, const int* pos, void* out,
           float* part_acc, float* part_ml, int B, int W, int H, int KV, int chunk,
           int64_t sqb, int64_t sqh, int64_t skb, int64_t skw, int64_t skh, int64_t svb,
           int64_t svw, int64_t svh, int ring, float scale, Range rg, cudaStream_t stream) {
  const int ngroups = (H / KV + GB - 1) / GB;
  const int nsplit = (W + chunk - 1) / chunk;
  constexpr int smem = kWarps * GB * (HD + 2) * static_cast<int>(sizeof(float));
  auto kernel = decode_kernel<T, HD, GB>;
  if constexpr (smem > kStaticSmem) {
    // the attribute is set once per instantiation and device (a bit each,
    // for devices 0-63; set on every call past them)
    static unsigned long long attr_set = 0;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
    if (!(attr_set & bit)) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
      attr_set |= bit;
    }
  }
  const int partial = rg.acc_out != nullptr;
  // one launch of a partial: its block writes the range's partial directly
  float* pa = partial && nsplit == 1 ? rg.acc_out : part_acc;
  float* pm = partial && nsplit == 1 ? rg.ml_out : part_ml;
  kernel<<<dim3(nsplit, KV * ngroups, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc), static_cast<const T*>(vc), pos,
      static_cast<T*>(out), pa, pm, W, H, KV, chunk, nsplit, sqb, sqh, skb, skw, skh,
      svb, svw, svh, ring, scale, rg.w_off, rg.W_total, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 1) return static_cast<int>(err);
  decode_combine_kernel<T, HD><<<dim3(H, B), HD, 0, stream>>>(
      part_acc, part_ml, pos, static_cast<T*>(out), W, H, chunk, nsplit, ring, rg.w_off,
      rg.W_total, rg.acc_out, rg.ml_out);
  return static_cast<int>(cudaGetLastError());
}

// the block's query heads: all G of a kv head up to 8, else groups of 8
template <typename T, int HD>
int dispatch_g(const void* q, const void* kc, const void* vc, const int* pos, void* out,
               float* part_acc, float* part_ml, int B, int W, int H, int KV, int chunk,
               int64_t sqb, int64_t sqh, int64_t skb, int64_t skw, int64_t skh, int64_t svb,
               int64_t svw, int64_t svh, int ring, float scale, Range rg, cudaStream_t st) {
  const int G = H / KV;
#define RT_DECODE_G(GB)                                                                      \
  return launch<T, HD, GB>(q, kc, vc, pos, out, part_acc, part_ml, B, W, H, KV, chunk, sqb,  \
                           sqh, skb, skw, skh, svb, svw, svh, ring, scale, rg, st);
  if (G == 1) RT_DECODE_G(1)
  if (G == 2) RT_DECODE_G(2)
  if (G <= 4) RT_DECODE_G(4)
  RT_DECODE_G(8)
#undef RT_DECODE_G
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* kc, const void* vc, const int* pos, void* out,
                float* part_acc, float* part_ml, int B, int W, int H, int KV, int chunk,
                int64_t sqb, int64_t sqh, int64_t skb, int64_t skw, int64_t skh, int64_t svb,
                int64_t svw, int64_t svh, int ring, float scale, Range rg, cudaStream_t st) {
#define RT_DECODE_CASE(D)                                                                    \
  case D:                                                                                    \
    return dispatch_g<T, D>(q, kc, vc, pos, out, part_acc, part_ml, B, W, H, KV, chunk, sqb, \
                            sqh, skb, skw, skh, svb, svw, svh, ring, scale, rg, st);
  switch (hd) {
    RT_DECODE_CASE(16)
    RT_DECODE_CASE(32)
    RT_DECODE_CASE(64)
    RT_DECODE_CASE(80)
    RT_DECODE_CASE(96)
    RT_DECODE_CASE(128)
    RT_DECODE_CASE(256)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef RT_DECODE_CASE
}

template <typename T> int keys_per_block_step(int hd) {
  switch (hd) {
    case 16: return kWarps * Rows<T, 16>::kKPS;
    case 32: return kWarps * Rows<T, 32>::kKPS;
    case 64: return kWarps * Rows<T, 64>::kKPS;
    case 80: return kWarps * Rows<T, 80>::kKPS;
    case 96: return kWarps * Rows<T, 96>::kKPS;
    case 128: return kWarps * Rows<T, 128>::kKPS;
    case 256: return kWarps * Rows<T, 256>::kKPS;
    default: return 0;
  }
}

}  // namespace

// The keys a block covers in one step of its warps at head dim hd (0 for a
// head dim or type it does not take): what the host's route choice
// (kernels/decode_attention.py::decode_route) counts with.
extern "C" int decode_keys_per_block_step(int dtype, int hd) {
  if (dtype == rt::kFloat32) return keys_per_block_step<float>(hd);
  if (dtype == rt::kBFloat16) return keys_per_block_step<__nv_bfloat16>(hd);
  return 0;
}

namespace {

int run(const void* q, const void* kc, const void* vc, const void* pos, void* out,
        void* part_acc, void* part_ml, int dtype, int B, int W, int H, int KV, int hd, int chunk,
        int64_t sqb, int64_t sqh, int64_t skb, int64_t skw, int64_t skh, int64_t svb,
        int64_t svw, int64_t svh, int ring, float scale, Range rg, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(pos);
  float* pa = static_cast<float*>(part_acc);
  float* pm = static_cast<float*>(part_ml);
  if (chunk > W) chunk = W;
  if (dtype == rt::kFloat32)
    return dispatch_hd<float>(hd, q, kc, vc, p, out, pa, pm, B, W, H, KV, chunk, sqb, sqh, skb,
                              skw, skh, svb, svw, svh, ring, scale, rg, st);
  if (dtype == rt::kBFloat16)
    return dispatch_hd<__nv_bfloat16>(hd, q, kc, vc, p, out, pa, pm, B, W, H, KV, chunk, sqb,
                                      sqh, skb, skw, skh, svb, svw, svh, ring, scale, rg, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Plain C entry point, loaded with ctypes. Strides are in elements; the head
// dimension must be contiguous and every row of q and the caches 16-byte
// aligned; positions are int32. chunk: keys a block takes (>= W: one launch,
// part_acc and part_ml unused and may be null); otherwise part_acc holds
// B*H*nsplit*hd floats and part_ml B*H*nsplit*2, nsplit = ceil(W / chunk).
// Returns the cudaError_t of the launches.
extern "C" int decode_attention_fwd(const void* q, const void* kc, const void* vc,
                                    const void* pos, void* out, void* part_acc, void* part_ml,
                                    int dtype, int B, int W, int H, int KV, int hd, int chunk,
                                    int64_t sqb, int64_t sqh,
                                    int64_t skb, int64_t skw, int64_t skh,
                                    int64_t svb, int64_t svw, int64_t svh,
                                    int ring, float scale, void* stream) {
  return run(q, kc, vc, pos, out, part_acc, part_ml, dtype, B, W, H, KV, hd, chunk, sqb, sqh,
             skb, skw, skh, svb, svw, svh, ring, scale, Range{0, W, nullptr, nullptr}, stream);
}

// The partial of a range of slots: the caches hold slots [w_off, w_off + W)
// of a cache of W_total; acc_out [B,H,hd] and ml_out [B,H,2] float32 receive
// the unnormalized sum of p v, and (m, l), each p = exp(s - m) over the
// range's valid slots. chunk, part_acc and part_ml as above (the split route's
// per-chunk partials, summed into acc_out and ml_out by its second launch).
extern "C" int decode_attention_partial(const void* q, const void* kc, const void* vc,
                                        const void* pos, void* acc_out, void* ml_out,
                                        void* part_acc, void* part_ml, int dtype, int B, int W,
                                        int H, int KV, int hd, int chunk, int64_t sqb,
                                        int64_t sqh, int64_t skb, int64_t skw, int64_t skh,
                                        int64_t svb, int64_t svw, int64_t svh, int ring,
                                        float scale, int w_off, int W_total, void* stream) {
  if (acc_out == nullptr || ml_out == nullptr || w_off < 0 || w_off + W > W_total)
    return static_cast<int>(cudaErrorInvalidValue);
  return run(q, kc, vc, pos, nullptr, part_acc, part_ml, dtype, B, W, H, KV, hd, chunk, sqb,
             sqh, skb, skw, skh, svb, svw, svh, ring, scale,
             Range{w_off, W_total, static_cast<float*>(acc_out), static_cast<float*>(ml_out)},
             stream);
}
