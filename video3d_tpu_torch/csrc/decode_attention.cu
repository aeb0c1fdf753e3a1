// Single-token decode attention over the stacked flat KV cache, split-K
// flash-decoding (kernel B3).
//
// Replaces: video3d_tpu/kernels/decode_attention.py::_decode_kernel_blockdiag
// (entry decode_attention with kv_heads given: the stacked
// (layers, B, S, KV*hd) cache addressed at `layer`), in three forms: a
// bf16 cache, and an int8 or an int4 cache with per-position, per-kv-head
// f32 scales (quantized=True; stacked scales (layers, B, S, KV, 1)); the
// int4 cache is packed two channels per byte, (layers, B, S, KV*hd / 2).
//
// What bounds it on an H100: HBM. One step of one layer streams
// 2 * kv_len * KV * hd * 2 bytes of K and V (17.8 MB at kv_len 8704, KV 4,
// hd 128) for ~4 FLOP per byte, far below the card's ~295 FLOP/byte ridge;
// the int8 form streams half of it plus 2 * kv_len * KV * 4 bytes of scales.
//
// Design: the block-diagonal head packing of the TPU kernel is an MXU trick
// and is not copied. Instead, pass 1 runs one 256-thread block per
// (S-chunk of 256 positions, kv head, batch row): only a few blocks per
// row would otherwise stream the cache, so the chunks spread the read over
// every SM. Each block reads its K rows once for all G = H / KV query heads
// of the group (16 lanes per position, one 16-byte load per lane, so a warp
// reads two contiguous 256-byte head rows), keeps scores in shared memory,
// and writes a partial (max, sum, unnormalised output) per query head.
// Pass 2 merges the partials of the chunks below kv_len with the usual
// exp(m_c - M) rescaling and divides by max(l, 1e-30). Blocks whose chunk
// starts at or beyond kv_len exit at once, so the cache past the valid
// length is never read. The query is pre-scaled by hd**-0.5 in bf16, as the
// TPU kernel does; dots accumulate in f32. The layer and row offsets come
// from the stacked cache's strides, so no per-layer copy is made.
// int8 form: one template on the cache element type. Values convert to f32
// exactly; as in the TPU kernel, a score is multiplied by its key's scale
// after the dot, the chunk's sum is taken over the unscaled weights p, and
// p is multiplied by its value's scale before P V. The scales of `layer`
// are read by strides out of the stacked arrays.
// int4 form: a third instantiation, on the tag type v3d_nib4 (one byte, two
// channels; element offsets are halved into bytes). A lane's 8 key values
// are one 4-byte word, unpacked exactly to bf16 and f32 by B8's nibble
// splice (common.cuh); the arithmetic is the int8 form's.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kHd = 128;
constexpr int kChunk = 256;       // cache positions per pass-1 block
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 8;          // query heads per kv head
constexpr int kPosGroups = kThreads / (kHd / 2);

typedef __nv_bfloat16 bf16;

// 8 consecutive cache values -> f32 (read-only loads: the cache is
// __restrict__ in the kernel, and these helpers keep the non-coherent path)
__device__ __forceinline__ void load8(const bf16* p, float* f) {
  v3d_bf16x8_to_float(__ldg(reinterpret_cast<const uint4*>(p)), f);
}
__device__ __forceinline__ void load8(const int8_t* p, float* f) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  v3d_int8x4_to_float(u.x, f);
  v3d_int8x4_to_float(u.y, f + 4);
}
__device__ __forceinline__ void load8(const v3d_nib4* p, float* f) {
  v3d_int4x8_to_float(__ldg(reinterpret_cast<const unsigned*>(p)), f);
}
// 2 consecutive cache values -> f32
__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(__ldg(reinterpret_cast<const __nv_bfloat162*>(p)));
}
__device__ __forceinline__ float2 load2(const int8_t* p) {
  const char2 c = __ldg(reinterpret_cast<const char2*>(p));
  return make_float2(static_cast<float>(c.x), static_cast<float>(c.y));
}
__device__ __forceinline__ float2 load2(const v3d_nib4* p) {
  float f[8];
  v3d_int4x8_to_float(__ldg(reinterpret_cast<const unsigned char*>(p)), f);
  return make_float2(f[0], f[1]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_partial_kernel(const bf16* __restrict__ q,       // (B, 1, H, hd)
                      const T* __restrict__ k_all,      // (NL, B, S, KV*hd / kPer)
                      const T* __restrict__ v_all,
                      const float* __restrict__ k_scale,  // (NL, B, S, KV) or
                      const float* __restrict__ v_scale,  // null (bf16)
                      const int* __restrict__ kv_len,   // (B,)
                      float* __restrict__ part_m,       // (B, H, NC)
                      float* __restrict__ part_l,       // (B, H, NC)
                      float* __restrict__ part_acc,     // (B, H, NC, hd)
                      int layer, int B, int S, int H, int KV, int NC,
                      float sm_scale) {
  constexpr bool kQuant = !std::is_same<T, bf16>::value;
  constexpr int kPer = v3d_per_element<T>();   // cache values per T
  const int c = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int len = min(kv_len[b], S);
  const int start = c * kChunk;
  if (start >= len) return;
  const int n = min(kChunk, len - start);
  const int G = H / KV;

  __shared__ float qs[kMaxG][kHd];
  __shared__ float sc[kMaxG][kChunk];
  __shared__ float red[kPosGroups][kMaxG][kHd];
  __shared__ float ms[kMaxG], ls[kMaxG];

  const float scale = __bfloat162float(__float2bfloat16(sm_scale));
  for (int i = threadIdx.x; i < G * kHd; i += kThreads) {
    const int g = i / kHd, d = i % kHd;
    const float qv = __bfloat162float(q[((long long)b * H + kvh * G + g) * kHd + d]);
    qs[g][d] = __bfloat162float(__float2bfloat16(qv * scale));
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long row_stride = (long long)KV * kHd / kPer;
  const long long cache_off = (((long long)layer * B + b) * S + start) * row_stride + kvh * kHd / kPer;
  // scale of chunk position i: scale_off + i * KV
  const long long scale_off = (((long long)layer * B + b) * S + start) * KV + kvh;

  // scores: half-warp per position, 8 dims per lane
  {
    const int half = lane >> 4, sub = lane & 15;
    float qreg[kMaxG][8];
#pragma unroll
    for (int g = 0; g < kMaxG; ++g)
#pragma unroll
      for (int i = 0; i < 8; ++i) qreg[g][i] = g < G ? qs[g][sub * 8 + i] : 0.f;
    const T* kbase = k_all + cache_off + sub * 8 / kPer;
    for (int base = warp * 2; base < n; base += 2 * kWarps) {
      const int pos = base + half;
      float kf[8];
      float ks = 1.f;   // the key's scale (quantized), loaded beside its values
      if (pos < n) {
        load8(kbase + pos * row_stride, kf);
        if constexpr (kQuant) ks = __ldg(k_scale + scale_off + (long long)pos * KV);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) kf[i] = 0.f;
      }
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g < G) {
          float dot = 0.f;
#pragma unroll
          for (int i = 0; i < 8; ++i) dot += qreg[g][i] * kf[i];
#pragma unroll
          for (int o = 8; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
          if (sub == 0 && pos < n) {
            if constexpr (kQuant) dot *= ks;
            sc[g][pos] = dot;
          }
        }
      }
    }
  }
  __syncthreads();

  // per-head max and exp-sum over this chunk: warp g owns head g
  if (warp < G) {
    float mx = V3D_NEG_INF;
    for (int i = lane; i < n; i += 32) mx = fmaxf(mx, sc[warp][i]);
    mx = v3d_warp_max(mx);
    float sum = 0.f;
    for (int i = lane; i < n; i += 32) {
      const float p = expf(sc[warp][i] - mx);
      if constexpr (kQuant)
        sc[warp][i] = p * __ldg(v_scale + scale_off + (long long)i * KV);
      else
        sc[warp][i] = p;
      sum += p;
    }
    sum = v3d_warp_sum(sum);
    if (lane == 0) {
      ms[warp] = mx;
      ls[warp] = sum;
    }
  }
  __syncthreads();

  // unnormalised P V: thread owns 2 dims, kPosGroups interleaved position sets
  {
    const int dp = threadIdx.x % (kHd / 2), grp = threadIdx.x / (kHd / 2);
    float acc[kMaxG][2];
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) acc[g][0] = acc[g][1] = 0.f;
    const T* vbase = v_all + cache_off + 2 * dp / kPer;
    for (int pos = grp; pos < n; pos += kPosGroups) {
      const float2 vv = load2(vbase + pos * row_stride);
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g < G) {
          const float p = sc[g][pos];
          acc[g][0] += p * vv.x;
          acc[g][1] += p * vv.y;
        }
      }
    }
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g < G) {
        red[grp][g][2 * dp] = acc[g][0];
        red[grp][g][2 * dp + 1] = acc[g][1];
      }
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < G * kHd; i += kThreads) {
    const int g = i / kHd, d = i % kHd;
    float s = 0.f;
#pragma unroll
    for (int p = 0; p < kPosGroups; ++p) s += red[p][g][d];
    const long long idx = ((long long)b * H + kvh * G + g) * NC + c;
    part_acc[idx * kHd + d] = s;
    if (d == 0) {
      part_m[idx] = ms[g];
      part_l[idx] = ls[g];
    }
  }
}

__global__ void __launch_bounds__(kHd)
decode_combine_kernel(const float* __restrict__ part_m,
                      const float* __restrict__ part_l,
                      const float* __restrict__ part_acc,
                      const int* __restrict__ kv_len, bf16* __restrict__ out,
                      int S, int H, int NC) {
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const int len = min(kv_len[b], S);
  const int nvalid = len > 0 ? (len + kChunk - 1) / kChunk : 0;
  const long long base = ((long long)b * H + h) * NC;
  float M = V3D_NEG_INF;
  for (int c = 0; c < nvalid; ++c) M = fmaxf(M, part_m[base + c]);
  float lsum = 0.f, o = 0.f;
  for (int c = 0; c < nvalid; ++c) {
    const float w = expf(part_m[base + c] - M);
    lsum += part_l[base + c] * w;
    o += part_acc[(base + c) * kHd + d] * w;
  }
  out[((long long)b * H + h) * kHd + d] = __float2bfloat16(o / fmaxf(lsum, 1e-30f));
}

template <typename T>
int launch(const void* q, const void* k_all, const void* v_all,
           const void* k_scale, const void* v_scale, const void* kv_len,
           void* out, void* part_m, void* part_l, void* part_acc, int layer,
           int B, int S, int H, int KV, int n_chunks, float sm_scale,
           void* stream) {
  if (KV <= 0 || H % KV != 0 || H / KV > kMaxG ||
      n_chunks * kChunk < S)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  decode_partial_kernel<T><<<dim3(n_chunks, KV, B), kThreads, 0, st>>>(
      static_cast<const bf16*>(q), static_cast<const T*>(k_all),
      static_cast<const T*>(v_all), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int*>(kv_len),
      static_cast<float*>(part_m), static_cast<float*>(part_l),
      static_cast<float*>(part_acc), layer, B, S, H, KV, n_chunks, sm_scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  decode_combine_kernel<<<dim3(H, B), kHd, 0, st>>>(
      static_cast<const float*>(part_m), static_cast<const float*>(part_l),
      static_cast<const float*>(part_acc), static_cast<const int*>(kv_len),
      static_cast<bf16*>(out), S, H, n_chunks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int v3d_decode_attention(const void* q, const void* k_all,
                                    const void* v_all, const void* kv_len,
                                    void* out, void* part_m, void* part_l,
                                    void* part_acc, int layer, int B, int S,
                                    int H, int KV, int n_chunks,
                                    float sm_scale, void* stream) {
  return launch<bf16>(q, k_all, v_all, nullptr, nullptr, kv_len, out, part_m,
                      part_l, part_acc, layer, B, S, H, KV, n_chunks,
                      sm_scale, stream);
}

extern "C" int v3d_decode_attention_int8(
    const void* q, const void* k_all, const void* v_all, const void* k_scale,
    const void* v_scale, const void* kv_len, void* out, void* part_m,
    void* part_l, void* part_acc, int layer, int B, int S, int H, int KV,
    int n_chunks, float sm_scale, void* stream) {
  return launch<int8_t>(q, k_all, v_all, k_scale, v_scale, kv_len, out,
                        part_m, part_l, part_acc, layer, B, S, H, KV,
                        n_chunks, sm_scale, stream);
}

extern "C" int v3d_decode_attention_int4(
    const void* q, const void* k_all, const void* v_all, const void* k_scale,
    const void* v_scale, const void* kv_len, void* out, void* part_m,
    void* part_l, void* part_acc, int layer, int B, int S, int H, int KV,
    int n_chunks, float sm_scale, void* stream) {
  return launch<v3d_nib4>(q, k_all, v_all, k_scale, v_scale, kv_len, out,
                          part_m, part_l, part_acc, layer, B, S, H, KV,
                          n_chunks, sm_scale, stream);
}
