// Shared helpers for the port's hand-written Hopper kernels.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#define V3D_NEG_INF (-1e30f)

__device__ __forceinline__ float v3d_warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float v3d_warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// 4 packed int8 (one 32-bit word) -> 4 exact floats, without I2F: flip
// the sign bit (b -> b + 128 as a byte), splice the byte under the
// exponent of 2^23 (0x4B0000xx == 2^23 + b + 128) and subtract 2^23 + 128
__device__ __forceinline__ void v3d_int8x4_to_float(unsigned w, float* f) {
  const unsigned u = w ^ 0x80808080u;
  f[0] = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7440)) - 8388736.f;
  f[1] = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7441)) - 8388736.f;
  f[2] = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7442)) - 8388736.f;
  f[3] = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7443)) - 8388736.f;
}

// 8 packed bf16 (one 16-byte load) -> 8 floats
__device__ __forceinline__ void v3d_bf16x8_to_float(const uint4& u, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// bf16x2 minus (136, 136), exact for the spliced nibbles
__device__ __forceinline__ unsigned v3d_sub136(unsigned v) {
  const unsigned k = 0x43084308u;
  const __nv_bfloat162 r = __hsub2(
      *reinterpret_cast<const __nv_bfloat162*>(&v),
      *reinterpret_cast<const __nv_bfloat162*>(&k));
  return *reinterpret_cast<const unsigned*>(&r);
}

// 4 packed int4 bytes (two's complement nibbles in [-7, 7]) -> per byte k
// the exact bf16 pair (low nibble, high nibble): a nibble n becomes bf16
// 128 + (n + 8) by splicing n ^ 8 under 0x43, then 136 is subtracted. The
// int4 weights of B8 (weight_stream.cuh: input rows 2k, 2k + 1) and the
// int4 KV cache (channels 2k, 2k + 1 of a token row) share this order.
__device__ __forceinline__ void v3d_nibble_pairs(unsigned w, unsigned* p) {
  const unsigned l = (w & 0x0F0F0F0Fu) ^ 0x08080808u;          // n + 8
  const unsigned h = ((w >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;
  const unsigned lo2 = __byte_perm(l, h, 0x5140);               // l0 h0 l1 h1
  const unsigned hi2 = __byte_perm(l, h, 0x7362);               // l2 h2 l3 h3
  p[0] = v3d_sub136(__byte_perm(lo2, 0x43434343u, 0x4140));
  p[1] = v3d_sub136(__byte_perm(lo2, 0x43434343u, 0x4342));
  p[2] = v3d_sub136(__byte_perm(hi2, 0x43434343u, 0x4140));
  p[3] = v3d_sub136(__byte_perm(hi2, 0x43434343u, 0x4342));
}

// The element type of an int4 KV cache in the attention kernels' templates:
// one byte holding two channels. Pointer arithmetic on it counts bytes, so
// a template divides its element offsets by v3d_per_element<T>().
struct v3d_nib4 {
  unsigned char bits;
};

template <typename T>
__host__ __device__ constexpr int v3d_per_element() {
  return std::is_same<T, v3d_nib4>::value ? 2 : 1;
}

// 8 consecutive int4 cache values (one 4-byte word) -> f32, exact
__device__ __forceinline__ void v3d_int4x8_to_float(unsigned w, float* f) {
  unsigned p[4];
  v3d_nibble_pairs(w, p);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&p[i]));
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}
