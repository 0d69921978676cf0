// Device code shared by the walk kernels: the reference's clips, the
// float32 uniform pick, and the stateless task RNG (Threefry-2x32).
//
// Every function here is bit-equal to its plain PyTorch counterpart:
//   clampi / uniform_index  -> repro_torch.core.samplers._uniform_index
//   threefry2x32 / fold_in  -> repro_torch.core.rng.threefry2x32 / fold_in_pair
//   task_prefix / fold_in   -> repro_torch.core.rng.task_key_pair
//   bits_to_uniform         -> repro_torch.core.rng.bits_to_uniform
// The Python side holds each 32-bit word in an int64 masked to 32 bits;
// here they are native uint32, whose add and shift wrap the same way.
// Build without --use_fast_math: the pick's multiply and the uniform's
// subtract must round to nearest, uncontracted.
#pragma once

#include <cstdint>

namespace walk {

// Salt channels (repro_torch.core.rng).
constexpr uint32_t kSaltColumn = 0;
constexpr uint32_t kSaltStop = 2;
constexpr uint32_t kSaltChunk0 = 8;   // reservoir chunk c draws at 8 + c

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return min(max(x, lo), hi);
}

// index = min(floor(u * deg), deg - 1), never below 0.
__device__ __forceinline__ int uniform_index(int deg, float u) {
  const int idx = static_cast<int>(floorf(__fmul_rn(u, __int2float_rn(deg))));
  return clampi(idx, 0, max(deg - 1, 0));
}

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// One Threefry-2x32 block (20 rounds): encrypt counter (x0, x1) under key
// (k0, k1).  Rotation sets and key injection as in Salmon et al., SC'11.
__device__ __forceinline__ uint2 threefry2x32(uint32_t k0, uint32_t k1,
                                              uint32_t x0, uint32_t x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
#define WALK_TF_ROUND(r) \
  x0 += x1;              \
  x1 = rotl32(x1, r);    \
  x1 ^= x0;
#define WALK_TF_GROUP_A WALK_TF_ROUND(13) WALK_TF_ROUND(15) \
  WALK_TF_ROUND(26) WALK_TF_ROUND(6)
#define WALK_TF_GROUP_B WALK_TF_ROUND(17) WALK_TF_ROUND(29) \
  WALK_TF_ROUND(16) WALK_TF_ROUND(24)
  x0 += k0;
  x1 += k1;
  WALK_TF_GROUP_A
  x0 += k1;
  x1 += k2 + 1u;
  WALK_TF_GROUP_B
  x0 += k2;
  x1 += k0 + 2u;
  WALK_TF_GROUP_A
  x0 += k0;
  x1 += k1 + 3u;
  WALK_TF_GROUP_B
  x0 += k1;
  x1 += k2 + 4u;
  WALK_TF_GROUP_A
  x0 += k2;
  x1 += k0 + 5u;
#undef WALK_TF_GROUP_B
#undef WALK_TF_GROUP_A
#undef WALK_TF_ROUND
  return make_uint2(x0, x1);
}

// Fold a 32-bit datum into a key pair: encrypt the counter (0, datum).
__device__ __forceinline__ uint2 fold_in(uint2 key, uint32_t datum) {
  return threefry2x32(key.x, key.y, 0u, datum);
}

// The part of a task's key that its draws share: (seed[, epoch], query_id,
// hop).  A draw's key is fold_in(prefix, salt).  Epoch 0 folds nothing; a
// negative id (an idle lane's -1) wraps as a uint32 cast does.
__device__ __forceinline__ uint2 task_prefix(uint2 base, int query_id, int hop,
                                             int epoch) {
  uint2 k = epoch > 0 ? fold_in(base, static_cast<uint32_t>(epoch)) : base;
  k = fold_in(k, static_cast<uint32_t>(query_id));
  return fold_in(k, static_cast<uint32_t>(hop));
}

// 32 random bits -> U[0, 1): the top 23 bits as the mantissa of a float in
// [1, 2), minus 1.
__device__ __forceinline__ float bits_to_uniform(uint32_t bits) {
  const float f = __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u), 1.0f);
  return fmaxf(f, 0.0f);
}

}  // namespace walk
