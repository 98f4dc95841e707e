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

}  // namespace repro
