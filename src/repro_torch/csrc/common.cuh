// Shared helpers for the ParisKV Hopper kernels (plain C interface).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define REPRO_EXPORT extern "C" __attribute__((visibility("default")))

namespace repro {

// Stage-II score of a candidate outside the retrieval region. Matches the
// JAX package's NEG_INF (core/retrieval.py), which is finite.
constexpr float kNegInf = -1e30f;

// Positions per segment of the score histograms that Stage I hands the
// top-C cut (kernels/__init__.py:SEG_LEN). Stage I runs one block of
// kSegLen threads per segment.
constexpr int kSegLen = 256;

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// A key's B uint8 centroid ids, kept as 32-bit words so that they stay in
// registers; one 16-byte (B=16) or 8-byte (B=8) load.
template <int B>
struct KeyIds {
  static_assert(B == 8 || B == 16, "B must be 8 or 16");
  uint32_t w[B / 4];
  __device__ __forceinline__ void load(const uint8_t* __restrict__ p) {
    if constexpr (B == 16) {
      const uint4 x = *reinterpret_cast<const uint4*>(p);
      w[0] = x.x; w[1] = x.y; w[2] = x.z; w[3] = x.w;
    } else {
      const uint2 x = *reinterpret_cast<const uint2*>(p);
      w[0] = x.x; w[1] = x.y;
    }
  }
  __device__ __forceinline__ uint32_t operator[](int s) const {
    return (w[s >> 2] >> ((s & 3) * 8)) & 0xFFu;
  }
};

}  // namespace repro
