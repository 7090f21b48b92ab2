// B4 and B5 at head dim 64 on the wgmma + TMA body (attention_bwd_sm90_body.cuh),
// built in a source of their own so that nvcc compiles each head dim's
// instantiations in parallel, in bf16 and fp16: B4 with one or two
// warpgroups of 64 K/V rows and Q tiles of 64 or 32 rows, B5 with one or two
// warpgroups of 64 Q rows and K/V tiles of 64 (or 128) rows, as listed.
#include "attention_bwd_sm90_body.cuh"

namespace pea {
namespace sm90 {

template <>
int bwd_launch_dim<64>(const BwdParams& p, bool dkdv, int bh, int dtype, int warpgroups,
                       int rows, int device, cudaStream_t stream) {
  if (dkdv) {
    return launch_dkdv_shapes<64, 1064, 2064, 2032>(p, bh, dtype, warpgroups, rows, device, stream);
  }
  return launch_dq_shapes<64, 1064, 2064, 2128>(p, bh, dtype, warpgroups, rows, device, stream);
}

}  // namespace sm90
}  // namespace pea
