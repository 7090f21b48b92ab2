// The backward's parameters, and the launchers of its wgmma + TMA body
// (attention_bwd_sm90_body.cuh) that attention_bwd.cu's entry points and
// variant tables call. Each launcher returns a CUDA error code (0 on
// success), or kTensorMapError + the CUDA driver API's CUresult when a
// tensor map cannot be encoded.
#pragma once

#include <cuda_runtime.h>

#include "attention_fwd_sm90.cuh"

namespace pea {

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // [bh, sq]
  const float* delta;  // [bh, sq]
  void* dq;
  void* dk;
  void* dv;
  int sq;
  int skv;
  float scale;
};

namespace sm90 {

// B4 (`dkdv`) or B5 at head dim kD, one head dim's instantiations each:
// defined in flash_bwd_sm90_d<kD>.cu (the body: attention_bwd_sm90_body.cuh).
template <int kD>
int bwd_launch_dim(const BwdParams& p, bool dkdv, int bh, int dtype, int warpgroups, int rows,
                   int device, cudaStream_t stream);
template <>
int bwd_launch_dim<40>(const BwdParams&, bool, int, int, int, int, int, cudaStream_t);
template <>
int bwd_launch_dim<64>(const BwdParams&, bool, int, int, int, int, int, cudaStream_t);
template <>
int bwd_launch_dim<80>(const BwdParams&, bool, int, int, int, int, int, cudaStream_t);
template <>
int bwd_launch_dim<128>(const BwdParams&, bool, int, int, int, int, int, cudaStream_t);
template <>
int bwd_launch_dim<160>(const BwdParams&, bool, int, int, int, int, int, cudaStream_t);

}  // namespace sm90

// B4 (`dkdv`) or B5 on head-major [BH, S, D] in one instantiation of the
// wgmma body: `warpgroups` (1 or 2) consumer warpgroups of 64 rows each (B4:
// K/V rows, B5: Q rows) and streamed tiles of `rows` rows (B4: Q and dO
// tiles of 32 or 64 rows; B5: K and V tiles of 64 or 128). dtype: 0 =
// bfloat16, 1 = float16. The (head dim, warpgroups, rows) combinations built
// are listed at each head dim's bwd_launch_dim (flash_bwd_sm90_d<D>.cu); any
// other returns cudaErrorInvalidValue.
int flash_bwd_wgmma(const BwdParams& p, bool dkdv, int bh, int head_dim, int dtype,
                    int warpgroups, int rows, int device, cudaStream_t stream);

}  // namespace pea
