// The launchers of the wgmma + TMA attention body (attention_fwd_sm90_body.cuh)
// and its head-dim-64 instantiations: B1 at head dim 64 on the projections'
// [B, S, H*D] layout (onepass_wgmma, onepass_wgmma_shipped, which
// attention_fwd.cu's pea_onepass_attention_fwd and its S1 variant table
// call), and B3 on head-major [BH, S, D] at every head dim it takes
// (flash_wgmma, which attention_fwd.cu's pea_flash_attention_fwd and its B3
// variant table call; the instantiations of D = 40, 80, 128 and 160 are
// built in flash_fwd_sm90_d<D>.cu). The design, the bound and the rounding
// points are described in the body's header. B1 at D = 128 stays on
// attention_fwd.cu's mma.sync body.
#include "attention_fwd_sm90_body.cuh"

namespace pea {

namespace sm90 {

// D = 64: B1's shipped shapes (one or two warpgroups, K/V tiles of 128
// rows), which B3 runs too, and K/V tiles of 64 rows, in bf16 and fp16.
template <>
int launch_dim<64>(const Params& p, int batch, int dtype, int warpgroups, int kv_tile, int device,
                   cudaStream_t stream) {
  return launch_shapes<64, kFlashStages, 1064, 2064, 1128, 2128>(
      p, batch, dtype, warpgroups, kv_tile, device, stream);
}

}  // namespace sm90

// B1 as it ships: two TMA stages of 128 K/V rows, and one warpgroup of 64
// query rows per block up to kOneWarpgroupMaxSq query rows (the S1 variant
// wg1_kv128_s2; SDXL's level 2, S = 1024), two above (wg2_kv128_s2; level 1,
// S = 4096, and the training teacher's 1600). The two compute the same
// per-row arithmetic in the same order (the same bits); what differs is how
// the blocks fill the card's 132 SMs: one-warpgroup blocks of 150
// registers fit three to an SM (396 at once), two-warpgroup blocks (128
// registers) two (264). At the SDXL serving pair (batch 2) the S1 sweep
// measured wg2 faster at S = 4096 (640 blocks, where wg1's 1280 end in a
// ragged fourth round of 396) and wg1 faster at S = 1024 (PERF.md, S1).
constexpr int kShippedStages = 2;
constexpr int kOneWarpgroupMaxSq = 1024;

// The instantiations built: (warpgroups, stages, mode) = (1, 2, kTma),
// (2, 2, kTma), (2, 3, kTma) and the staged form (1, 2, kCpAsync) in bf16
// for S1, and the two shipped ones in fp16 too; all with K/V tiles of 128
// rows at D = 64.
int onepass_wgmma(const void* q, const void* k, const void* v, void* o, int batch, int heads,
                  int sq, int skv, float scale, int dtype, int warpgroups, int stages, int mode,
                  int device, cudaStream_t stream) {
  using sm90::kCpAsync, sm90::kTma;
  using bf16 = __nv_bfloat16;
  const sm90::Params p{q, k, v, o, nullptr, heads, sq, skv, scale};
  const int shape = warpgroups * 100 + stages * 10 + mode;
  return on_device(device, [&]() -> cudaError_t {
    int err = static_cast<int>(cudaErrorInvalidValue);
    const auto launch = [&](auto kernel_launch) {
      err = kernel_launch(p, batch, dtype, device, stream);
    };
    if (dtype == 0) {
      if (shape == 120 + kTma) launch(sm90::launch<bf16, 64, 1, 128, 2, kTma>);
      if (shape == 220 + kTma) launch(sm90::launch<bf16, 64, 2, 128, 2, kTma>);
      if (shape == 230 + kTma) launch(sm90::launch<bf16, 64, 2, 128, 3, kTma>);
      if (shape == 120 + kCpAsync) launch(sm90::launch<bf16, 64, 1, 128, 2, kCpAsync>);
    } else if (dtype == 1) {
      if (shape == 120 + kTma) launch(sm90::launch<__half, 64, 1, 128, 2, kTma>);
      if (shape == 220 + kTma) launch(sm90::launch<__half, 64, 2, 128, 2, kTma>);
    }
    return static_cast<cudaError_t>(err);
  });
}

int onepass_wgmma_shipped(const void* q, const void* k, const void* v, void* o, int batch,
                          int heads, int sq, int skv, float scale, int dtype, int device,
                          cudaStream_t stream) {
  const int warpgroups = sq <= kOneWarpgroupMaxSq ? 1 : 2;
  return onepass_wgmma(q, k, v, o, batch, heads, sq, skv, scale, dtype, warpgroups,
                       kShippedStages, sm90::kTma, device, stream);
}

int flash_wgmma(const void* q, const void* k, const void* v, void* o, float* lse, int bh, int sq,
                int skv, int head_dim, float scale, int dtype, int warpgroups, int kv_tile,
                int device, cudaStream_t stream) {
  const sm90::Params p{q, k, v, o, lse, 1, sq, skv, scale};
  return on_device(device, [&]() -> cudaError_t {
    int err = static_cast<int>(cudaErrorInvalidValue);
    const auto run = [&](auto launch_dim) {
      err = launch_dim(p, bh, dtype, warpgroups, kv_tile, device, stream);
    };
    if (head_dim == 40) run(sm90::launch_dim<40>);
    if (head_dim == 64) run(sm90::launch_dim<64>);
    if (head_dim == 80) run(sm90::launch_dim<80>);
    if (head_dim == 128) run(sm90::launch_dim<128>);
    if (head_dim == 160) run(sm90::launch_dim<160>);
    return static_cast<cudaError_t>(err);
  });
}

}  // namespace pea
