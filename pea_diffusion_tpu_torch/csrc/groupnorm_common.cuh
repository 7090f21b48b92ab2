// Pieces both GroupNorm variants share (groupnorm.cu: `three_pass`, the
// entry points and the variant table; groupnorm_sm90.cu: `persistent`): the
// element conversions, parameter reads, vector packs, SiLU, the warp sum,
// the split of a row's channel vectors over a block's threads, and the
// persistent variant's launcher.
#pragma once

#include "attention_common.cuh"

namespace pea {
namespace gn {

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __half from_float<__half>(float v) { return __float2half_rn(v); }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// A weight, bias or t value: fp32, or x's type.
template <typename T>
__device__ __forceinline__ float param(const void* p, long long i, int is_f32) {
  return is_f32 ? static_cast<const float*>(p)[i] : to_float(static_cast<const T*>(p)[i]);
}

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

__device__ __forceinline__ float silu(float v) { return v / (1.f + __expf(-v)); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Which vectors of a row and which rows a thread of a kThreads-thread block
// takes: with at most kThreads vectors in a row, kThreads / per_row rows go
// in parallel and each thread owns one vector; with more, one row at a time
// and each thread owns the vectors t, t + kThreads, ...
template <int kThreads>
struct RowSplit {
  int per_row, rows_par, sub, col0;
  bool active;
  __device__ RowSplit(int width, int v) {
    per_row = width / v;
    const bool narrow = per_row <= kThreads;
    rows_par = narrow ? kThreads / per_row : 1;
    sub = narrow ? threadIdx.x / per_row : 0;
    col0 = narrow ? threadIdx.x % per_row : threadIdx.x;
    active = sub < rows_par;
  }
  __device__ int col(int m) const { return col0 + m * kThreads; }
  __device__ bool owns(int m) const { return active && col(m) < per_row; }
};

// The persistent variant (groupnorm_sm90.cu): one cooperative launch. t is
// nullptr for B6. `work` holds the grid barrier's word (16 bytes with its
// padding), then the partial sums. Returns a CUDA error code.
int launch_persistent(const void* x, const void* t, const void* scale, const void* bias,
                      void* y, float* work, int n, int c, int hw, int groups, float eps,
                      int silu, int channels_last, int vec, int dtype, int scale_f32,
                      int bias_f32, int t_f32, int width, int tile_rows, int slots,
                      int blocks, int device, cudaStream_t stream);

}  // namespace gn
}  // namespace pea
