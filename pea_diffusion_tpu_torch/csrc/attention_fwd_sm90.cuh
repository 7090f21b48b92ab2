// The launchers of the wgmma + TMA attention body (attention_fwd_sm90_body.cuh,
// attention_fwd_sm90.cu) that attention_fwd.cu's entry points call: B1 at
// head dim 64 (its entry point and S1 variant table) and B3 (its entry
// point and variant table). Each returns a CUDA error code (0 on success),
// or kTensorMapError + the CUDA driver API's CUresult when a tensor map
// cannot be encoded.
#pragma once

#include <cuda_runtime.h>

namespace pea {

constexpr int kTensorMapError = 1000;

// B1 on [B, S, H*64] in one instantiation of the wgmma body: `warpgroups`
// (1 or 2) consumer warpgroups of 64 query rows each, a ring of `stages`
// K/V tiles of 128 rows, filled (`mode`) by cp.async (0, the first, staged
// form) or by TMA (1). dtype: 0 = bfloat16, 1 = float16. The
// combinations built are listed at the definition; any other returns
// cudaErrorInvalidValue.
int onepass_wgmma(const void* q, const void* k, const void* v, void* o, int batch, int heads,
                  int sq, int skv, float scale, int dtype, int warpgroups, int stages, int mode,
                  int device, cudaStream_t stream);

// B1 as it ships: the instantiation the S1 sweep chose for `sq`
// (attention_fwd_sm90.cu).
int onepass_wgmma_shipped(const void* q, const void* k, const void* v, void* o, int batch,
                          int heads, int sq, int skv, float scale, int dtype, int device,
                          cudaStream_t stream);

// B3 on head-major [BH, S, D] with an optional fp32 lse [BH, Sq] (nullptr:
// none) in one TMA-form instantiation of the wgmma body: `warpgroups` (1 or
// 2) of 64 query rows, K/V tiles of `kv_tile` rows (64 or 128), two stages.
// dtype: 0 = bfloat16, 1 = float16. The (head dim, warpgroups, kv_tile)
// combinations built are listed at each head dim's launch_dim; any other
// returns cudaErrorInvalidValue.
int flash_wgmma(const void* q, const void* k, const void* v, void* o, float* lse, int bh, int sq,
                int skv, int head_dim, float scale, int dtype, int warpgroups, int kv_tile,
                int device, cudaStream_t stream);

}  // namespace pea
