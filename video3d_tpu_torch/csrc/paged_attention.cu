// Paged single-token decode attention over stacked page pools, split-K
// flash-decoding (kernel B7).
//
// Replaces: video3d_tpu/kernels/paged_attention.py::_ragged_kernel (entry
// paged_decode_attention with the stacked (layers, P, page, KV*hd) pools
// addressed at `layer`), in three forms: bf16 pools, and int8 or int4
// pools with per-position, per-kv-head f32 scales (quantized=True; stacked
// scale pools (layers, P, KV, 1, page), contiguous over a page's
// positions); int4 pools are packed two channels per byte, (layers, P,
// page, KV*hd / 2). Slot b
// attends its first kv_len[b] positions; position s lives in pool page
// table[b, s / page], row s % page.
//
// What bounds it on an H100: HBM. One step of one layer streams each slot's
// 2 * kv_len * KV * hd * 2 bytes of K and V (the int8 form half of it plus
// 2 * kv_len * KV * 4 bytes of scales) for ~4 FLOP per byte, far below the
// card's ~295 FLOP/byte ridge. Pages shared by several slots (the scene
// prefix of the paged batcher) are read once per slot; after the first
// slot they come mostly from the 50 MB L2.
//
// Design: the tile code is B3's (csrc/decode_attention.cu); only the
// position -> address mapping differs. The TPU kernel walks a compacted
// (slot, page) worklist on a sequential grid and carries the online
// softmax across a slot's pages in scratch; that worklist and its
// pool-sized variant exist to keep the TPU's grid short. Here pass 1 runs
// one 256-thread block per (256-position split, kv head, slot): the grid is
// slots x ceil(maxp * page / 256) x KV, whatever the pool size P, so tables
// whose live (slot, page) pairs outnumber P (aliased prefix pages) are
// covered by construction. A block first resolves its positions' pool rows
// from the slot's page-table row (global memory, one read per position)
// into shared memory, then reads each K row once for all G = H / KV query
// heads of the group, keeps scores in shared memory and writes a partial
// (max, sum, unnormalised output) per query head. Pass 2 merges the
// partials of the splits below kv_len with exp(m_c - M) rescaling and
// divides by max(l, 1e-30). Blocks whose split starts at or beyond kv_len
// exit at once, so no position past kv_len is read and masked positions
// contribute exactly 0 whatever a reused page holds; a slot with
// kv_len == 0 writes zeros. The query is pre-scaled by hd**-0.5 in bf16, as
// the TPU kernel does; dots accumulate in f32. The layer, page and row
// offsets come from the stacked pools' strides, so no per-layer copy is
// made. int8 form: a score is multiplied by its key's scale after the dot,
// the split's sum is taken over the unscaled weights p, and p is multiplied
// by its value's scale before P V, as in the TPU kernel. int4 form: B3's
// (csrc/decode_attention.cu), per pool row: the tag type v3d_nib4 halves
// the element offsets into bytes, and 8 key values are one 4-byte word.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kHd = 128;
constexpr int kChunk = 256;       // positions per pass-1 block
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 8;          // query heads per kv head
constexpr int kPosGroups = kThreads / (kHd / 2);

typedef __nv_bfloat16 bf16;

// B3's load helpers (csrc/decode_attention.cu), repeated here so that B3's
// source and SASS stay as they are.
// 8 consecutive pool values -> f32 (read-only loads)
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
// 2 consecutive pool values -> f32
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
paged_partial_kernel(const bf16* __restrict__ q,         // (B, 1, H, hd)
                     const T* __restrict__ k_pages,      // (NL, P, page, KV*hd)
                     const T* __restrict__ v_pages,
                     const float* __restrict__ k_scale,  // (NL, P, KV, 1, page)
                     const float* __restrict__ v_scale,  // or null (bf16)
                     const int* __restrict__ table,      // (B, maxp)
                     const int* __restrict__ kv_len,     // (B,)
                     float* __restrict__ part_m,         // (B, H, NC)
                     float* __restrict__ part_l,         // (B, H, NC)
                     float* __restrict__ part_acc,       // (B, H, NC, hd)
                     int layer, int P, int page, int maxp, int H, int KV,
                     int NC, float sm_scale) {
  constexpr bool kQuant = !std::is_same<T, bf16>::value;
  constexpr int kPer = v3d_per_element<T>();   // pool values per T
  const int c = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int len = min(kv_len[b], maxp * page);
  const int start = c * kChunk;
  if (start >= len) return;
  const int n = min(kChunk, len - start);
  const int G = H / KV;

  __shared__ float qs[kMaxG][kHd];
  __shared__ float sc[kMaxG][kChunk];
  __shared__ float red[kPosGroups][kMaxG][kHd];
  __shared__ float ms[kMaxG], ls[kMaxG];
  // pool row of split position i, ((layer * P + pid) * page + s % page),
  // and (quantized) the index of its scale in the (NL, P, KV, 1, page) pools
  __shared__ long long rows[kChunk];
  __shared__ long long srows[kChunk];

  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int s = start + i;
    const long long pg = (long long)layer * P
        + table[(long long)b * maxp + s / page];
    rows[i] = pg * page + s % page;
    if constexpr (kQuant) srows[i] = (pg * KV + kvh) * page + s % page;
  }
  const float scale = __bfloat162float(__float2bfloat16(sm_scale));
  for (int i = threadIdx.x; i < G * kHd; i += kThreads) {
    const int g = i / kHd, d = i % kHd;
    const float qv = __bfloat162float(q[((long long)b * H + kvh * G + g) * kHd + d]);
    qs[g][d] = __bfloat162float(__float2bfloat16(qv * scale));
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long row_stride = (long long)KV * kHd / kPer;

  // scores: half-warp per position, 8 dims per lane
  {
    const int half = lane >> 4, sub = lane & 15;
    float qreg[kMaxG][8];
#pragma unroll
    for (int g = 0; g < kMaxG; ++g)
#pragma unroll
      for (int i = 0; i < 8; ++i) qreg[g][i] = g < G ? qs[g][sub * 8 + i] : 0.f;
    const T* kbase = k_pages + kvh * kHd / kPer + sub * 8 / kPer;
    for (int base = warp * 2; base < n; base += 2 * kWarps) {
      const int pos = base + half;
      float kf[8];
      float ks = 1.f;   // the key's scale (quantized), loaded beside its values
      if (pos < n) {
        load8(kbase + rows[pos] * row_stride, kf);
        if constexpr (kQuant) ks = __ldg(k_scale + srows[pos]);
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

  // per-head max and exp-sum over this split: warp g owns head g
  if (warp < G) {
    float mx = V3D_NEG_INF;
    for (int i = lane; i < n; i += 32) mx = fmaxf(mx, sc[warp][i]);
    mx = v3d_warp_max(mx);
    float sum = 0.f;
    for (int i = lane; i < n; i += 32) {
      const float p = expf(sc[warp][i] - mx);
      if constexpr (kQuant)
        sc[warp][i] = p * __ldg(v_scale + srows[i]);
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
    const T* vbase = v_pages + kvh * kHd / kPer + 2 * dp / kPer;
    for (int pos = grp; pos < n; pos += kPosGroups) {
      const float2 vv = load2(vbase + rows[pos] * row_stride);
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
paged_combine_kernel(const float* __restrict__ part_m,
                     const float* __restrict__ part_l,
                     const float* __restrict__ part_acc,
                     const int* __restrict__ kv_len, bf16* __restrict__ out,
                     int cap, int H, int NC) {
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const int len = min(kv_len[b], cap);
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
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* k_scale, const void* v_scale, const void* table,
           const void* kv_len, void* out, void* part_m, void* part_l,
           void* part_acc, int layer, int B, int P, int page, int maxp,
           int H, int KV, int n_chunks, float sm_scale, void* stream) {
  if (KV <= 0 || H % KV != 0 || H / KV > kMaxG || page <= 0 || maxp <= 0 ||
      (long long)n_chunks * kChunk < (long long)maxp * page)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  paged_partial_kernel<T><<<dim3(n_chunks, KV, B), kThreads, 0, st>>>(
      static_cast<const bf16*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int*>(table),
      static_cast<const int*>(kv_len), static_cast<float*>(part_m),
      static_cast<float*>(part_l), static_cast<float*>(part_acc), layer, P,
      page, maxp, H, KV, n_chunks, sm_scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  paged_combine_kernel<<<dim3(H, B), kHd, 0, st>>>(
      static_cast<const float*>(part_m), static_cast<const float*>(part_l),
      static_cast<const float*>(part_acc), static_cast<const int*>(kv_len),
      static_cast<bf16*>(out), maxp * page, H, n_chunks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int v3d_paged_attention(const void* q, const void* k_pages,
                                   const void* v_pages, const void* table,
                                   const void* kv_len, void* out,
                                   void* part_m, void* part_l,
                                   void* part_acc, int layer, int B, int P,
                                   int page, int maxp, int H, int KV,
                                   int n_chunks, float sm_scale,
                                   void* stream) {
  return launch<bf16>(q, k_pages, v_pages, nullptr, nullptr, table, kv_len,
                      out, part_m, part_l, part_acc, layer, B, P, page, maxp,
                      H, KV, n_chunks, sm_scale, stream);
}

extern "C" int v3d_paged_attention_int8(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scale, const void* v_scale, const void* table,
    const void* kv_len, void* out, void* part_m, void* part_l,
    void* part_acc, int layer, int B, int P, int page, int maxp, int H,
    int KV, int n_chunks, float sm_scale, void* stream) {
  return launch<int8_t>(q, k_pages, v_pages, k_scale, v_scale, table, kv_len,
                        out, part_m, part_l, part_acc, layer, B, P, page,
                        maxp, H, KV, n_chunks, sm_scale, stream);
}

extern "C" int v3d_paged_attention_int4(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scale, const void* v_scale, const void* table,
    const void* kv_len, void* out, void* part_m, void* part_l,
    void* part_acc, int layer, int B, int P, int page, int maxp, int H,
    int KV, int n_chunks, float sm_scale, void* stream) {
  return launch<v3d_nib4>(q, k_pages, v_pages, k_scale, v_scale, table,
                          kv_len, out, part_m, part_l, part_acc, layer, B, P,
                          page, maxp, H, KV, n_chunks, sm_scale, stream);
}
