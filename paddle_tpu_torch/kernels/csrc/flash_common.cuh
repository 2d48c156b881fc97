// Shared by the three flash-attention kernels (flash_fwd.cu,
// flash_bwd_dq.cu, flash_bwd_dkv.cu): the dropout keep test, which the
// backward kernels must reproduce bit for bit from the forward's seed, the
// key-length rule, and the dtype helpers. One definition, so the three
// cannot drift apart.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace flash {

constexpr float kNeg = -1e30f;  // the reference's _NEG

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// x rounded to T and read back as float: the reference's cast of p or ds
// to the input dtype before it enters a product (flash_attention.py:320,
// :383, :392); the identity for float32.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return __bfloat162float(__float2bfloat16(x));
  } else {
    return x;
  }
}

// ops/common.py hash_mix_bits: 2-round xorshift-multiply finalizer.
__device__ __forceinline__ uint32_t hash_mix_bits(uint32_t h) {
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// The seed term of row block bh: seed + 0x9E3779B9 * (bh + 1).
__device__ __forceinline__ uint32_t dropout_seed_term(uint32_t seed, int bh) {
  return seed + 0x9E3779B9u * (uint32_t)(bh + 1);
}

// _keep_mask (flash_attention.py:65-82): the counter q_pos * Tk + k_pos
// (positions local to the call) xor the seed term, kept when the top 24
// bits of its hash reach keep_thr.
__device__ __forceinline__ bool dropout_keep(uint32_t seed_term, int q_pos,
                                             int k_pos, int Tk,
                                             uint32_t keep_thr) {
  const uint32_t idx = (uint32_t)q_pos * (uint32_t)Tk + (uint32_t)k_pos;
  return (hash_mix_bits(idx ^ seed_term) >> 8) >= keep_thr;
}

// Keys at or past the returned length are padding. Lengths are clamped to
// [1, Tk], so an empty sequence attends to key 0 (the reference's rule,
// flash_attention.py:231); no lengths means every key is valid.
__device__ __forceinline__ int key_length(const long long* lens, int b,
                                          int Tk) {
  if (lens == nullptr) return Tk;
  const long long n = lens[b];
  return n < 1 ? 1 : (n < Tk ? (int)n : Tk);
}

}  // namespace flash
