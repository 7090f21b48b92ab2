// B3 at head dim 80 on the wgmma + TMA body (attention_fwd_sm90_body.cuh),
// built in a source of its own so that nvcc compiles each head dim's
// instantiations in parallel: one or two warpgroups, K/V tiles of 64 or 128
// rows, in bf16 and fp16.
#include "attention_fwd_sm90_body.cuh"

namespace pea {
namespace sm90 {

template <>
int launch_dim<80>(const Params& p, int batch, int dtype, int warpgroups, int kv_tile,
                   int device, cudaStream_t stream) {
  return launch_shapes<80, kFlashStages, 1064, 2064, 1128, 2128>(
      p, batch, dtype, warpgroups, kv_tile, device, stream);
}

}  // namespace sm90
}  // namespace pea
