// The colour-word count of the mask kernels (csrc/slot_expand.cuh,
// csrc/coverage.cu): W 32-bit words of colour bits per mask row, at most
// kMax (256 colours), fixed at compile time so a thread keeps its words in
// registers.
#pragma once

#include <cuda_runtime.h>

#include <type_traits>

namespace words {

constexpr int kMax = 8;

inline bool valid(int W) { return W >= 1 && W <= kMax; }

// Calls f(std::integral_constant<int, W>{}) for the runtime word count W in
// [1, kMax] (checked by valid), so each kernel is compiled once per W.
template <class F>
cudaError_t dispatch(int W, F&& f) {
  switch (W) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 3: return f(std::integral_constant<int, 3>{});
    case 4: return f(std::integral_constant<int, 4>{});
    case 5: return f(std::integral_constant<int, 5>{});
    case 6: return f(std::integral_constant<int, 6>{});
    case 7: return f(std::integral_constant<int, 7>{});
    default: return f(std::integral_constant<int, 8>{});
  }
}

}  // namespace words
