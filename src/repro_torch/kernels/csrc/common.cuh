// Shared helpers of the port's hand-written Hopper kernels.
//
// Every kernel here reads residues as u32 (the bits PyTorch stores as int32:
// all primes are < 2^30, so residues are non-negative either way), per-limb
// primes and index tables as int64 (how repro_torch.core.const_cache stages
// them), and writes fully reduced u32 residues in [0, q).
//
// Products of two residues are < 2^60, so up to 15 of them plus a reduced
// running sum (< 2^30) fit a u64 without overflow: accumulators add raw
// products and reduce every kReduceEvery terms.  That keeps a sum exact for
// any number of terms, as the reference's hi16/lo16 column sum is.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace repro {

constexpr int kThreads = 256;
constexpr int kReduceEvery = 15;

inline unsigned grid_for(long long total) {
  return static_cast<unsigned>((total + kThreads - 1) / kThreads);
}

}  // namespace repro

// Human-readable text for the cudaError_t a launcher returned.
extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
