// Non-causal softmax attention backward for Hopper (sm_90a), behind two C
// entry points built into the same library as the forward:
//
// - pea_flash_attention_bwd_dkdv (B4) writes dK and dV. It replaces the TPU
//   kernel pea_diffusion_tpu/ops/flash_attention.py::_bwd_dkdv_kernel.
// - pea_flash_attention_bwd_dq (B5) writes dQ. It replaces
//   pea_diffusion_tpu/ops/flash_attention.py::_bwd_dq_kernel.
//
// Each runs the variant its rule picks (shipped_bwd_variant, below): the
// wgmma + TMA body (attention_bwd_sm90_body.cuh) or this file's mma.sync
// body, kept as the variant `mma_sync` of each (the ..._variant entry points
// run any variant). This header describes the mma.sync body.
//
// Both take head-major [BH, S, D] Q, K, V, dO in bf16 or fp16, the forward's
// fp32 lse [BH, Sq] and delta = rowsum(dO * O) [BH, Sq] in fp32 (computed by
// the caller, as the JAX package computes it outside its kernels), and
// recompute P = exp(S * scale - lse) tile by tile:
//
//   dV = P^T dO,  dP = dO V^T,  dS = P * (dP - delta),
//   dK = dS^T Q * scale,  dQ = dS K * scale.
//
// Rounding points follow the JAX kernels: scores accumulate in fp32 and are
// multiplied by `scale`; P and dS are cast to the operand type for the
// matrix products, which accumulate in fp32; the outputs are stored in the
// input type. The exponentials are taken as exp2 of scores pre-multiplied
// by scale*log2(e) against lse*log2(e), the same function.
//
// Schedule. Blocks of 4 warps and 64 rows, as the forward:
// - B4: one block per (bh, 64-row KV tile); each warp owns 16 KV rows. K and
//   V of the tile stay in shared memory with the fp32 dK/dV accumulators in
//   registers, while Q, dO, lse and delta stream through two shared-memory
//   stages in 64-row tiles over all Sq rows (cp.async, the copy of tile i+1
//   overlapping the math on tile i). The block computes S^T = K Q^T and
//   dP^T = V dO^T directly, so their C fragments are already the A operands
//   of P^T dO and dS^T Q: no transpose in registers or shared memory.
// - B5: one block per (bh, 64-row Q tile); each warp owns 16 Q rows. Q and
//   dO stay in registers as A fragments with the fp32 dQ accumulator, while
//   K and V stream through two stages, as in the forward.
// The TPU kernels walk 1024-row KV blocks because VMEM is large; here a
// block holds 64 rows of each operand. Fusing B4 and B5 (dQ by atomics) is
// later work. Head dims 40, 64, 80, 128 and 160: the k-step and n-tile
// tails and the zero padding of D = 40 are described in
// attention_common.cuh. B4's fp32 dK and dV accumulators take D / 2
// registers per thread each (40 at D = 80), beside the S^T and dP^T tiles
// and the K/V fragments.
//
// D = 160 (SD1.5's level 2 at 1024^2 and up) does not fit that register
// budget, so it has kernels of its own, each computing what the others do
// in the same order:
// - B4 (attention_bwd_dkdv_wide_kernel): the dK and dV accumulators alone
//   would be 160 registers a thread. The grid gets a third dimension of 2:
//   blocks with z = 0 accumulate dV = P^T dO, blocks with z = 1 dK = dS^T Q
//   (dV and dK in two passes over Q, the passes run side by side). Both
//   recompute S^T = K Q^T; only the dK pass needs dP^T = V dO^T. That is 10
//   products of the S^T tile's size where the fused kernel does 8 (the
//   bound below counts 8), against 12 for splitting D into two halves that
//   each recompute both S^T and dP^T, and each pass keeps 80 accumulator
//   registers. The K and V fragments are read from shared memory one pair
//   of k-steps at a time (16 registers, not 80).
// - B5 (attention_bwd_dq_wide_kernel): Q and dO fragments of the whole
//   width (80 registers) do not fit beside the dQ accumulator (80) and the
//   S and dP tiles (64). The block copies its 64 Q and dO rows into shared
//   memory once and reads each pair of k-steps' fragments with ldmatrix
//   inside the KV walk.
//
// Masking. KV rows at or past skv are zero-filled and their scores set to
// -1e30, so P = 0 there; they are not stored. Q rows at or past sq read
// zero Q and dO, lse 0 and delta 0, so they add exactly 0 to dK and dV; they
// are not stored.
#include "attention_bwd_sm90.cuh"
#include "attention_common.cuh"

namespace pea {

template <int D>
constexpr int dq_smem_bytes() {  // [stage][K | V][row][k_ld<D>]
  return kStages * 2 * kBlockN * k_ld<D>() * 2;
}

template <int D>
constexpr int dkdv_smem_bytes() {  // K | V, [stage][Q | dO], [stage][lse | delta]
  return (2 + kStages * 2) * kBlockN * k_ld<D>() * 2 + kStages * 2 * kBlockM * 4;
}

// Head dims above 128 take the wide kernels.
template <int D>
constexpr bool wide_head() {
  return D > 128;
}

template <int D>
constexpr int dq_wide_smem_bytes() {  // [stage][K | V], then Q | dO of the block
  return dq_smem_bytes<D>() + 2 * kBlockM * k_ld<D>() * 2;
}

// Copies rows [q0, q0 + kBlockM) of lse (times log2(e)) and delta into
// shared memory, 0 for rows at or past sq. Threads 0-63 copy lse, 64-127
// delta.
__device__ __forceinline__ void load_rows(float* dst, const float* lse, const float* delta,
                                          int q0, int sq) {
  const int i = threadIdx.x % kBlockM;
  const bool is_lse = threadIdx.x < kBlockM;
  const int row = q0 + i;
  float x = 0.f;
  if (row < sq) x = is_lse ? lse[row] * kLog2e : delta[row];
  dst[(is_lse ? 0 : kBlockM) + i] = x;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dkdv_kernel(const BwdParams p) {
  static_assert(D % 8 == 0, "head_dim must be a multiple of 8");
  constexpr int kKSteps = k_dpad<D>() / 16;  // k-steps over the head dim
  constexpr int kDTiles = D / 8;             // n-tiles of dK and dV
  constexpr int kNTiles = kBlockM / 8;       // n-tiles of the S^T tile (Q rows)
  constexpr int kLd = k_ld<D>();
  constexpr int kTile = kBlockN * kLd;

  extern __shared__ __align__(16) uint16_t smem[];
  uint16_t* kts = smem;           // this block's K rows
  uint16_t* vts = smem + kTile;   // and V rows
  uint16_t* stages = smem + 2 * kTile;  // [stage][Q | dO]
  float* rows_s = reinterpret_cast<float*>(smem + (2 + kStages * 2) * kTile);  // [stage][lse | delta]

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int lm_row = lane % 8;
  const int lm_mat = lane / 8;
  const long long bh = blockIdx.y;
  const int n0 = blockIdx.x * kBlockN;
  const int kv_row0 = n0 + warp * 16;

  const uint16_t* qp = static_cast<const uint16_t*>(p.q) + bh * p.sq * D;
  const uint16_t* dop = static_cast<const uint16_t*>(p.dout) + bh * p.sq * D;
  const uint16_t* kp = static_cast<const uint16_t*>(p.k) + bh * p.skv * D;
  const uint16_t* vp = static_cast<const uint16_t*>(p.v) + bh * p.skv * D;
  const float* lsep = p.lse + bh * p.sq;
  const float* deltap = p.delta + bh * p.sq;

  zero_pad_columns<D>(smem, (2 + kStages * 2) * kBlockN);
  load_tile_async<D>(kts, kp, D, n0, p.skv);
  load_tile_async<D>(vts, vp, D, n0, p.skv);
  load_tile_async<D>(stages, qp, D, 0, p.sq);
  load_tile_async<D>(stages + kTile, dop, D, 0, p.sq);
  load_rows(rows_s, lsep, deltap, 0, p.sq);
  cp_async_commit();

  float dk[kDTiles][4], dv[kDTiles][4];
#pragma unroll
  for (int j = 0; j < kDTiles; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;
  }
  const float scale_log2 = p.scale * kLog2e;
  // this thread's two KV rows (g and g + 8 of the warp's 16): masked past skv
  const bool kv_masked[2] = {kv_row0 + g >= p.skv, kv_row0 + g + 8 >= p.skv};

  const int n_tiles = (p.sq + kBlockM - 1) / kBlockM;
  for (int tile = 0; tile < n_tiles; ++tile) {
    if (tile + 1 < n_tiles) {  // prefetch the next Q tile into the other stage
      const int stage = (tile + 1) % kStages;
      const int q_next = (tile + 1) * kBlockM;
      load_tile_async<D>(stages + stage * 2 * kTile, qp, D, q_next, p.sq);
      load_tile_async<D>(stages + stage * 2 * kTile + kTile, dop, D, q_next, p.sq);
      load_rows(rows_s + stage * 2 * kBlockM, lsep, deltap, q_next, p.sq);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint16_t* qs = stages + (tile % kStages) * 2 * kTile;
    const uint16_t* dos = qs + kTile;
    const float* ls = rows_s + (tile % kStages) * 2 * kBlockM;
    const float* dls = ls + kBlockM;

    // S^T = K Q^T and dP^T = V dO^T for this warp's 16 KV rows x 64 Q rows
    float st[kNTiles][4], dpt[kNTiles][4];
    {
      uint32_t ka[kKSteps][4], va[kKSteps][4];
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk) {
        const int off = (warp * 16 + (lm_mat & 1) * 8 + lm_row) * kLd + kk * 16 + (lm_mat >> 1) * 8;
        ldmatrix_x4(ka[kk], kts + off);
        ldmatrix_x4(va[kk], vts + off);
      }
#pragma unroll
      for (int j = 0; j < kNTiles; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < kKSteps; kk += 2) {
          mma_ksteps<T, D>(st[j], ka, qs + (j * 8 + lm_row) * kLd, kk, lm_mat);
          mma_ksteps<T, D>(dpt[j], va, dos + (j * 8 + lm_row) * kLd, kk, lm_mat);
        }
      }
    }

    // P^T = exp(S^T * scale - lse), dS^T = P^T * (dP^T - delta), both in the
    // A layout (k = Q row) of the products with dO and Q
    uint32_t pa[kNTiles / 2][4], dsa[kNTiles / 2][4];
#pragma unroll
    for (int j = 0; j < kNTiles; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + t * 2 + (e & 1);
        float x = st[j][e] * scale_log2;
        if (kv_masked[e >> 1]) x = kNegInf;
        const float pr = exp2f(x - ls[col]);
        st[j][e] = pr;
        dpt[j][e] = pr * (dpt[j][e] - dls[col]);
      }
      pa[j / 2][(j & 1) * 2 + 0] = MmaOp<T>::pack(st[j][0], st[j][1]);
      pa[j / 2][(j & 1) * 2 + 1] = MmaOp<T>::pack(st[j][2], st[j][3]);
      dsa[j / 2][(j & 1) * 2 + 0] = MmaOp<T>::pack(dpt[j][0], dpt[j][1]);
      dsa[j / 2][(j & 1) * 2 + 1] = MmaOp<T>::pack(dpt[j][2], dpt[j][3]);
    }

    // dV += P^T dO, dK += dS^T Q: dO and Q rows are the k index (Q row),
    // their columns the n index (head-dim column), read transposed
#pragma unroll
    for (int kk = 0; kk < kNTiles / 2; ++kk) {
      const int off = (kk * 16 + (lm_mat & 1) * 8 + lm_row) * kLd;
#pragma unroll
      for (int j = 0; j < kDTiles; j += 2) {
        mma_ntiles<T, D>(dv, pa[kk], dos + off, j, lm_mat);
        mma_ntiles<T, D>(dk, dsa[kk], qs + off, j, lm_mat);
      }
    }
    __syncthreads();  // the next prefetch overwrites this stage
  }

  uint16_t* dkp = static_cast<uint16_t*>(p.dk) + bh * p.skv * D;
  uint16_t* dvp = static_cast<uint16_t*>(p.dv) + bh * p.skv * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = kv_row0 + g + r * 8;
    if (row >= p.skv) continue;
#pragma unroll
    for (int j = 0; j < kDTiles; ++j) {
      const long long at = (long long)row * D + j * 8 + t * 2;
      *reinterpret_cast<uint32_t*>(dkp + at) =
          MmaOp<T>::pack(dk[j][r * 2] * p.scale, dk[j][r * 2 + 1] * p.scale);
      *reinterpret_cast<uint32_t*>(dvp + at) = MmaOp<T>::pack(dv[j][r * 2], dv[j][r * 2 + 1]);
    }
  }
}

template <typename T, int D>
__device__ __forceinline__ void bwd_dq(const BwdParams& p) {
  static_assert(D % 8 == 0, "head_dim must be a multiple of 8");
  constexpr int kKSteps = k_dpad<D>() / 16;
  constexpr int kDTiles = D / 8;
  constexpr int kNTiles = kBlockN / 8;  // n-tiles of the S tile (KV rows)
  constexpr int kLd = k_ld<D>();
  constexpr int kTile = kBlockN * kLd;

  extern __shared__ __align__(16) uint16_t smem[];  // [stage][K | V][row][kLd]

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int lm_row = lane % 8;
  const int lm_mat = lane / 8;
  const long long bh = blockIdx.y;
  const int row0 = blockIdx.x * kBlockM + warp * 16;

  const uint16_t* qp = static_cast<const uint16_t*>(p.q) + bh * p.sq * D;
  const uint16_t* dop = static_cast<const uint16_t*>(p.dout) + bh * p.sq * D;
  const uint16_t* kp = static_cast<const uint16_t*>(p.k) + bh * p.skv * D;
  const uint16_t* vp = static_cast<const uint16_t*>(p.v) + bh * p.skv * D;

  const int n_tiles = (p.skv + kBlockN - 1) / kBlockN;
  zero_pad_columns<D>(smem, kStages * 2 * kBlockN);
  load_tile_async<D>(smem, kp, D, 0, p.skv);
  load_tile_async<D>(smem + kTile, vp, D, 0, p.skv);
  cp_async_commit();

  // Q and dO fragments stay in registers for the whole KV walk
  uint32_t qa[kKSteps][4], da[kKSteps][4];
  load_a_fragments<D>(qa, qp, D, row0, p.sq, g, t);
  load_a_fragments<D>(da, dop, D, row0, p.sq, g, t);
  float lse2[2], delta[2];  // rows g and g + 8 of this warp's 16
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + r * 8;
    const bool valid = row < p.sq;
    lse2[r] = valid ? p.lse[bh * p.sq + row] * kLog2e : 0.f;
    delta[r] = valid ? p.delta[bh * p.sq + row] : 0.f;
  }

  float acc[kDTiles][4];
#pragma unroll
  for (int j = 0; j < kDTiles; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  const float scale_log2 = p.scale * kLog2e;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int n0 = tile * kBlockN;
    if (tile + 1 < n_tiles) {
      uint16_t* next = smem + ((tile + 1) % kStages) * 2 * kTile;
      load_tile_async<D>(next, kp, D, n0 + kBlockN, p.skv);
      load_tile_async<D>(next + kTile, vp, D, n0 + kBlockN, p.skv);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint16_t* ks = smem + (tile % kStages) * 2 * kTile;
    const uint16_t* vs = ks + kTile;

    // S = Q K^T and dP = dO V^T for this warp's 16 Q rows x 64 KV rows
    float s[kNTiles][4], dp[kNTiles][4];
#pragma unroll
    for (int j = 0; j < kNTiles; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kKSteps; kk += 2) {
        mma_ksteps<T, D>(s[j], qa, ks + (j * 8 + lm_row) * kLd, kk, lm_mat);
        mma_ksteps<T, D>(dp[j], da, vs + (j * 8 + lm_row) * kLd, kk, lm_mat);
      }
    }

    // dS = P * (dP - delta) with P = exp(S * scale - lse), in the A layout
    // (k = KV row) of dS K
    uint32_t dsa[kNTiles / 2][4];
#pragma unroll
    for (int j = 0; j < kNTiles; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale_log2;
        if (n0 + j * 8 + t * 2 + (e & 1) >= p.skv) x = kNegInf;
        s[j][e] = exp2f(x - lse2[e >> 1]) * (dp[j][e] - delta[e >> 1]);
      }
      dsa[j / 2][(j & 1) * 2 + 0] = MmaOp<T>::pack(s[j][0], s[j][1]);
      dsa[j / 2][(j & 1) * 2 + 1] = MmaOp<T>::pack(s[j][2], s[j][3]);
    }

    // dQ += dS K: K's rows are the k index (KV row), its columns the n
    // index (head-dim column), read transposed
#pragma unroll
    for (int kk = 0; kk < kNTiles / 2; ++kk) {
#pragma unroll
      for (int j = 0; j < kDTiles; j += 2)
        mma_ntiles<T, D>(acc, dsa[kk], ks + (kk * 16 + (lm_mat & 1) * 8 + lm_row) * kLd, j,
                         lm_mat);
    }
    __syncthreads();  // the next prefetch overwrites this stage
  }

  uint16_t* dqp = static_cast<uint16_t*>(p.dq) + bh * p.sq * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + r * 8;
    if (row >= p.sq) continue;
#pragma unroll
    for (int j = 0; j < kDTiles; ++j) {
      *reinterpret_cast<uint32_t*>(dqp + (long long)row * D + j * 8 + t * 2) =
          MmaOp<T>::pack(acc[j][r * 2] * p.scale, acc[j][r * 2 + 1] * p.scale);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) attention_bwd_dq_kernel(const BwdParams p) {
  bwd_dq<T, D>(p);
}

// B5 at D = 64 asks for four blocks per SM, i.e. at most 128 registers a
// thread: without the hint ptxas takes 131-132 and the SM holds three
// blocks, 13 % slower at S = 1600 on the H100; with it a few bytes spill and
// the time is back at that of the 128-register build. Only D = 64 launches this
// variant: at D = 40 the hint spills more and runs slower than three blocks,
// and a hint of one block lets ptxas take up to 255 registers.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 4) attention_bwd_dq_kernel_4blocks(const BwdParams p) {
  bwd_dq<T, D>(p);
}

// One pass of B4 at a wide head dim (see the top of this file): with
// kDkPass, dK = dS^T Q * scale, else dV = P^T dO, for this block's 64 KV
// rows over all Sq rows.
template <typename T, int D, bool kDkPass>
__device__ __forceinline__ void bwd_dkdv_pass(const BwdParams& p) {
  static_assert(k_dpad<D>() == D && D % 32 == 0, "k-steps and n-tiles in pairs");
  constexpr int kKSteps = D / 16;       // k-steps over the head dim
  constexpr int kDTiles = D / 8;        // n-tiles of dK or dV
  constexpr int kNTiles = kBlockM / 8;  // n-tiles of the S^T tile (Q rows)
  constexpr int kLd = k_ld<D>();
  constexpr int kTile = kBlockN * kLd;

  extern __shared__ __align__(16) uint16_t smem[];
  uint16_t* kts = smem;           // this block's K rows
  uint16_t* vts = smem + kTile;   // and V rows (read by the dK pass)
  uint16_t* stages = smem + 2 * kTile;  // [stage][Q | dO]
  float* rows_s = reinterpret_cast<float*>(smem + (2 + kStages * 2) * kTile);  // [stage][lse | delta]

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int lm_row = lane % 8;
  const int lm_mat = lane / 8;
  const long long bh = blockIdx.y;
  const int n0 = blockIdx.x * kBlockN;
  const int kv_row0 = n0 + warp * 16;

  const uint16_t* qp = static_cast<const uint16_t*>(p.q) + bh * p.sq * D;
  const uint16_t* dop = static_cast<const uint16_t*>(p.dout) + bh * p.sq * D;
  const uint16_t* kp = static_cast<const uint16_t*>(p.k) + bh * p.skv * D;
  const uint16_t* vp = static_cast<const uint16_t*>(p.v) + bh * p.skv * D;
  const float* lsep = p.lse + bh * p.sq;
  const float* deltap = p.delta + bh * p.sq;

  load_tile_async<D>(kts, kp, D, n0, p.skv);
  if constexpr (kDkPass) load_tile_async<D>(vts, vp, D, n0, p.skv);
  load_tile_async<D>(stages, qp, D, 0, p.sq);
  load_tile_async<D>(stages + kTile, dop, D, 0, p.sq);
  load_rows(rows_s, lsep, deltap, 0, p.sq);
  cp_async_commit();

  float acc[kDTiles][4];
#pragma unroll
  for (int j = 0; j < kDTiles; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  const float scale_log2 = p.scale * kLog2e;
  const bool kv_masked[2] = {kv_row0 + g >= p.skv, kv_row0 + g + 8 >= p.skv};
  const uint16_t* kw = kts + warp * 16 * kLd;  // this warp's 16 K rows
  const uint16_t* vw = vts + warp * 16 * kLd;

  const int n_tiles = (p.sq + kBlockM - 1) / kBlockM;
  for (int tile = 0; tile < n_tiles; ++tile) {
    if (tile + 1 < n_tiles) {  // prefetch the next Q tile into the other stage
      const int stage = (tile + 1) % kStages;
      const int q_next = (tile + 1) * kBlockM;
      load_tile_async<D>(stages + stage * 2 * kTile, qp, D, q_next, p.sq);
      load_tile_async<D>(stages + stage * 2 * kTile + kTile, dop, D, q_next, p.sq);
      load_rows(rows_s + stage * 2 * kBlockM, lsep, deltap, q_next, p.sq);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint16_t* qs = stages + (tile % kStages) * 2 * kTile;
    const uint16_t* dos = qs + kTile;
    const float* ls = rows_s + (tile % kStages) * 2 * kBlockM;
    const float* dls = ls + kBlockM;

    // S^T = K Q^T (and, in the dK pass, dP^T = V dO^T) for this warp's 16
    // KV rows x 64 Q rows, a pair of k-steps of K (and V) fragments at a time
    float st[kNTiles][4], dpt[kNTiles][4];
#pragma unroll
    for (int j = 0; j < kNTiles; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < kKSteps; kk += 2) {
      uint32_t ka[2][4];
      ldmatrix_a<D>(ka[0], kw, kk, lm_row, lm_mat);
      ldmatrix_a<D>(ka[1], kw, kk + 1, lm_row, lm_mat);
#pragma unroll
      for (int j = 0; j < kNTiles; ++j)
        mma_kpair<T>(st[j], ka, qs + (j * 8 + lm_row) * kLd + kk * 16, lm_mat);
      if constexpr (kDkPass) {
        uint32_t va[2][4];
        ldmatrix_a<D>(va[0], vw, kk, lm_row, lm_mat);
        ldmatrix_a<D>(va[1], vw, kk + 1, lm_row, lm_mat);
#pragma unroll
        for (int j = 0; j < kNTiles; ++j)
          mma_kpair<T>(dpt[j], va, dos + (j * 8 + lm_row) * kLd + kk * 16, lm_mat);
      }
    }

    // P^T = exp(S^T * scale - lse), or in the dK pass dS^T = P^T * (dP^T -
    // delta), in the A layout (k = Q row) of the product with dO or Q
    uint32_t pa[kNTiles / 2][4];
#pragma unroll
    for (int j = 0; j < kNTiles; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + t * 2 + (e & 1);
        float x = st[j][e] * scale_log2;
        if (kv_masked[e >> 1]) x = kNegInf;
        const float pt = exp2f(x - ls[col]);
        st[j][e] = kDkPass ? pt * (dpt[j][e] - dls[col]) : pt;
      }
      pa[j / 2][(j & 1) * 2 + 0] = MmaOp<T>::pack(st[j][0], st[j][1]);
      pa[j / 2][(j & 1) * 2 + 1] = MmaOp<T>::pack(st[j][2], st[j][3]);
    }

    // dV += P^T dO, or dK += dS^T Q: dO and Q rows are the k index (Q row),
    // their columns the n index (head-dim column), read transposed
    const uint16_t* rhs = kDkPass ? qs : dos;
#pragma unroll
    for (int kk = 0; kk < kNTiles / 2; ++kk) {
      const int off = (kk * 16 + (lm_mat & 1) * 8 + lm_row) * kLd;
#pragma unroll
      for (int j = 0; j < kDTiles; j += 2) mma_ntiles<T, D>(acc, pa[kk], rhs + off, j, lm_mat);
    }
    __syncthreads();  // the next prefetch overwrites this stage
  }

  uint16_t* out = static_cast<uint16_t*>(kDkPass ? p.dk : p.dv) + bh * p.skv * D;
  const float mul = kDkPass ? p.scale : 1.f;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = kv_row0 + g + r * 8;
    if (row >= p.skv) continue;
#pragma unroll
    for (int j = 0; j < kDTiles; ++j) {
      *reinterpret_cast<uint32_t*>(out + (long long)row * D + j * 8 + t * 2) =
          MmaOp<T>::pack(acc[j][r * 2] * mul, acc[j][r * 2 + 1] * mul);
    }
  }
}

// B4 at a wide head dim: grid (KV tiles, bh, 2), z = 0 the dV pass, z = 1
// the dK pass.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) attention_bwd_dkdv_wide_kernel(const BwdParams p) {
  if (blockIdx.z == 0) {
    bwd_dkdv_pass<T, D, false>(p);
  } else {
    bwd_dkdv_pass<T, D, true>(p);
  }
}

// B5 at a wide head dim: bwd_dq with this block's Q and dO rows in shared
// memory, their fragments read a pair of k-steps at a time.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) attention_bwd_dq_wide_kernel(const BwdParams p) {
  static_assert(k_dpad<D>() == D && D % 32 == 0, "k-steps and n-tiles in pairs");
  constexpr int kKSteps = D / 16;
  constexpr int kDTiles = D / 8;
  constexpr int kNTiles = kBlockN / 8;  // n-tiles of the S tile (KV rows)
  constexpr int kLd = k_ld<D>();
  constexpr int kTile = kBlockN * kLd;

  extern __shared__ __align__(16) uint16_t smem[];  // [stage][K | V][row][kLd], Q, dO
  uint16_t* qs = smem + kStages * 2 * kTile;
  uint16_t* dos = qs + kBlockM * kLd;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int lm_row = lane % 8;
  const int lm_mat = lane / 8;
  const long long bh = blockIdx.y;
  const int q0 = blockIdx.x * kBlockM;
  const int row0 = q0 + warp * 16;

  const uint16_t* qp = static_cast<const uint16_t*>(p.q) + bh * p.sq * D;
  const uint16_t* dop = static_cast<const uint16_t*>(p.dout) + bh * p.sq * D;
  const uint16_t* kp = static_cast<const uint16_t*>(p.k) + bh * p.skv * D;
  const uint16_t* vp = static_cast<const uint16_t*>(p.v) + bh * p.skv * D;

  const int n_tiles = (p.skv + kBlockN - 1) / kBlockN;
  // the block's Q and dO rows (zero past sq) join the first K/V tile's group
  load_tile_async<D, kBlockM>(qs, qp, D, q0, p.sq);
  load_tile_async<D, kBlockM>(dos, dop, D, q0, p.sq);
  load_tile_async<D>(smem, kp, D, 0, p.skv);
  load_tile_async<D>(smem + kTile, vp, D, 0, p.skv);
  cp_async_commit();

  float lse2[2], delta[2];  // rows g and g + 8 of this warp's 16
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + r * 8;
    const bool valid = row < p.sq;
    lse2[r] = valid ? p.lse[bh * p.sq + row] * kLog2e : 0.f;
    delta[r] = valid ? p.delta[bh * p.sq + row] : 0.f;
  }

  float acc[kDTiles][4];
#pragma unroll
  for (int j = 0; j < kDTiles; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  const float scale_log2 = p.scale * kLog2e;
  const uint16_t* qw = qs + warp * 16 * kLd;  // this warp's 16 Q rows
  const uint16_t* dow = dos + warp * 16 * kLd;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int n0 = tile * kBlockN;
    if (tile + 1 < n_tiles) {
      uint16_t* next = smem + ((tile + 1) % kStages) * 2 * kTile;
      load_tile_async<D>(next, kp, D, n0 + kBlockN, p.skv);
      load_tile_async<D>(next + kTile, vp, D, n0 + kBlockN, p.skv);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint16_t* ks = smem + (tile % kStages) * 2 * kTile;
    const uint16_t* vs = ks + kTile;

    // S = Q K^T and dP = dO V^T for this warp's 16 Q rows x 64 KV rows
    float s[kNTiles][4], dp[kNTiles][4];
#pragma unroll
    for (int j = 0; j < kNTiles; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < kKSteps; kk += 2) {
      uint32_t qa[2][4], da[2][4];
      ldmatrix_a<D>(qa[0], qw, kk, lm_row, lm_mat);
      ldmatrix_a<D>(qa[1], qw, kk + 1, lm_row, lm_mat);
      ldmatrix_a<D>(da[0], dow, kk, lm_row, lm_mat);
      ldmatrix_a<D>(da[1], dow, kk + 1, lm_row, lm_mat);
#pragma unroll
      for (int j = 0; j < kNTiles; ++j) {
        mma_kpair<T>(s[j], qa, ks + (j * 8 + lm_row) * kLd + kk * 16, lm_mat);
        mma_kpair<T>(dp[j], da, vs + (j * 8 + lm_row) * kLd + kk * 16, lm_mat);
      }
    }

    // dS = P * (dP - delta) with P = exp(S * scale - lse), in the A layout
    // (k = KV row) of dS K
    uint32_t dsa[kNTiles / 2][4];
#pragma unroll
    for (int j = 0; j < kNTiles; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale_log2;
        if (n0 + j * 8 + t * 2 + (e & 1) >= p.skv) x = kNegInf;
        s[j][e] = exp2f(x - lse2[e >> 1]) * (dp[j][e] - delta[e >> 1]);
      }
      dsa[j / 2][(j & 1) * 2 + 0] = MmaOp<T>::pack(s[j][0], s[j][1]);
      dsa[j / 2][(j & 1) * 2 + 1] = MmaOp<T>::pack(s[j][2], s[j][3]);
    }

    // dQ += dS K
#pragma unroll
    for (int kk = 0; kk < kNTiles / 2; ++kk) {
#pragma unroll
      for (int j = 0; j < kDTiles; j += 2)
        mma_ntiles<T, D>(acc, dsa[kk], ks + (kk * 16 + (lm_mat & 1) * 8 + lm_row) * kLd, j,
                         lm_mat);
    }
    __syncthreads();  // the next prefetch overwrites this stage
  }

  uint16_t* dqp = static_cast<uint16_t*>(p.dq) + bh * p.sq * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + r * 8;
    if (row >= p.sq) continue;
#pragma unroll
    for (int j = 0; j < kDTiles; ++j) {
      *reinterpret_cast<uint32_t*>(dqp + (long long)row * D + j * 8 + t * 2) =
          MmaOp<T>::pack(acc[j][r * 2] * p.scale, acc[j][r * 2 + 1] * p.scale);
    }
  }
}

// The B4 and B5 kernels of one instantiation (only the kernels used are
// compiled).
template <typename T, int D>
inline auto dkdv_kernel() {
  if constexpr (wide_head<D>()) {
    return attention_bwd_dkdv_wide_kernel<T, D>;
  } else {
    return attention_bwd_dkdv_kernel<T, D>;
  }
}

template <typename T, int D>
inline auto dq_kernel() {
  if constexpr (D == 64) {
    return attention_bwd_dq_kernel_4blocks<T, D>;
  } else if constexpr (wide_head<D>()) {
    return attention_bwd_dq_wide_kernel<T, D>;
  } else {
    return attention_bwd_dq_kernel<T, D>;
  }
}

// B4's launch: at a wide head dim the two passes side by side (grid z = 2).
// Above the default 48 KB of shared memory (every head dim but 40; D = 160
// takes 130,048 bytes, its B5 129,024) B4 and B5 opt in once per device.
template <typename T, int D>
inline cudaError_t launch_dkdv(const BwdParams& p, int bh, int device, cudaStream_t stream) {
  constexpr int bytes = dkdv_smem_bytes<D>();
  static std::atomic<bool> opted_in[kMaxDevices];
  const auto kernel = dkdv_kernel<T, D>();
  const cudaError_t err = opt_in_smem(kernel, bytes, device, opted_in);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.skv + kBlockN - 1) / kBlockN, bh, wide_head<D>() ? 2 : 1);
  kernel<<<grid, kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int D>
inline cudaError_t launch_dq(const BwdParams& p, int bh, int device, cudaStream_t stream) {
  constexpr int bytes = wide_head<D>() ? dq_wide_smem_bytes<D>() : dq_smem_bytes<D>();
  static std::atomic<bool> opted_in[kMaxDevices];
  const auto kernel = dq_kernel<T, D>();
  const cudaError_t err = opt_in_smem(kernel, bytes, device, opted_in);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.sq + kBlockM - 1) / kBlockM, bh);
  kernel<<<grid, kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int D>
inline cudaError_t launch_bwd(const BwdParams& p, bool dkdv, int bh, int device,
                              cudaStream_t stream) {
  return dkdv ? launch_dkdv<T, D>(p, bh, device, stream) : launch_dq<T, D>(p, bh, device, stream);
}

template <typename T>
inline cudaError_t launch_bwd_dim(const BwdParams& p, bool dkdv, int bh, int head_dim,
                                  int device, cudaStream_t stream) {
  if (head_dim == 40) return launch_bwd<T, 40>(p, dkdv, bh, device, stream);
  if (head_dim == 64) return launch_bwd<T, 64>(p, dkdv, bh, device, stream);
  if (head_dim == 80) return launch_bwd<T, 80>(p, dkdv, bh, device, stream);
  if (head_dim == 128) return launch_bwd<T, 128>(p, dkdv, bh, device, stream);
  if (head_dim == 160) return launch_bwd<T, 160>(p, dkdv, bh, device, stream);
  return cudaErrorInvalidValue;
}

// dtype: 0 = bfloat16, 1 = float16; `dkdv` picks B4, else B5.
inline int launch_attention_bwd(const BwdParams& p, bool dkdv, int bh, int head_dim,
                                int dtype, int device, cudaStream_t stream) {
  return on_device(device, [&]() -> cudaError_t {
    if (dtype == 0) return launch_bwd_dim<__nv_bfloat16>(p, dkdv, bh, head_dim, device, stream);
    if (dtype == 1) return launch_bwd_dim<__half>(p, dkdv, bh, head_dim, device, stream);
    return cudaErrorInvalidValue;
  });
}

inline BwdParams bwd_params(const void* q, const void* k, const void* v, const void* dout,
                            const float* lse, const float* delta, int sq, int skv,
                            float scale) {
  BwdParams p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse = lse;
  p.delta = delta;
  p.sq = sq;
  p.skv = skv;
  p.scale = scale;
  return p;
}

int flash_bwd_wgmma(const BwdParams& p, bool dkdv, int bh, int head_dim, int dtype,
                    int warpgroups, int rows, int device, cudaStream_t stream) {
  return on_device(device, [&]() -> cudaError_t {
    int err = static_cast<int>(cudaErrorInvalidValue);
    const auto run = [&](auto launch_dim) {
      err = launch_dim(p, dkdv, bh, dtype, warpgroups, rows, device, stream);
    };
    if (head_dim == 40) run(sm90::bwd_launch_dim<40>);
    if (head_dim == 64) run(sm90::bwd_launch_dim<64>);
    if (head_dim == 80) run(sm90::bwd_launch_dim<80>);
    if (head_dim == 128) run(sm90::bwd_launch_dim<128>);
    if (head_dim == 160) run(sm90::bwd_launch_dim<160>);
    return static_cast<cudaError_t>(err);
  });
}

// The variants of B4 and B5: the mma.sync body of this file (their earlier
// body, kept as the yardstick), and the wgmma + TMA body
// (attention_bwd_sm90_body.cuh) with 1 or 2 warpgroups of 64 rows (B4: K/V
// rows, B5: Q rows) and streamed tiles of `rows` rows (B4: Q and dO, B5: K
// and V), at the head dims each is built for (each head dim's
// bwd_launch_dim; any other returns cudaErrorInvalidValue). All give the
// same function; each kernel ships the one its rule picks, with the bits of
// that variant.
struct BwdVariant {
  const char* name;
  int warpgroups;  // 0: the mma.sync body
  int rows;
};
constexpr BwdVariant kDkdvVariants[] = {
    {"mma_sync", 0, kBlockM}, {"wg1_q64", 1, 64}, {"wg2_q64", 2, 64}, {"wg2_q32", 2, 32},
};
constexpr BwdVariant kDqVariants[] = {
    {"mma_sync", 0, kBlockN}, {"wg1_kv64", 1, 64}, {"wg2_kv64", 2, 64}, {"wg2_kv128", 2, 128},
};
constexpr int kNumDkdvVariants = sizeof(kDkdvVariants) / sizeof(kDkdvVariants[0]);
constexpr int kNumDqVariants = sizeof(kDqVariants) / sizeof(kDqVariants[0]);

// which: 0 = B4 (dkdv), 1 = B5 (dq).
constexpr int bwd_variant_count(int which) {
  return which == 0 ? kNumDkdvVariants : which == 1 ? kNumDqVariants : 0;
}
constexpr const BwdVariant* bwd_variants(int which) {
  return which == 0 ? kDkdvVariants : kDqVariants;
}

// The index of the variant of `which`'s table with this shape.
constexpr int bwd_variant(int which, int warpgroups, int rows) {
  for (int i = 0; i < bwd_variant_count(which); ++i) {
    if (bwd_variants(which)[i].warpgroups == warpgroups && bwd_variants(which)[i].rows == rows) {
      return i;
    }
  }
  return -1;
}

// B4 and B5 as they ship, from the smoke's times of every variant at the
// paths' shapes (PERF.md, B4 and B5): blocks of two warpgroups for
// self-attention (one-warpgroup blocks were up to 1.7x slower at D = 40,
// within 8 % either way from D = 64 on). B4 streams Q tiles of 64 rows at
// every head dim (32-row ones were as fast at D = 40 and 64 and 17-33 %
// slower from D = 80 on; at D = 160 the 64-row instantiation takes 252
// registers without spill), and up to kBwdShortKv K/V rows
// (cross-attention: one K/V tile a head, BH blocks) one warpgroup, 1.2-1.4x
// faster than two, whose second 64 rows would be empty. B5 streams K/V
// tiles of 64 rows (128-row ones 3-21 % slower), but up to kBwdShortKv K/V
// rows at D <= 80 the mma.sync body, as fast or up to 15 % faster there
// (at D = 160 the wgmma body is 25 % faster).
constexpr int kBwdShortKv = 64;

inline int shipped_bwd_variant(int which, int sq, int skv, int head_dim) {
  (void)sq;
  const bool short_kv = skv <= kBwdShortKv;
  if (which == 0) return bwd_variant(0, short_kv ? 1 : 2, 64);
  return short_kv && head_dim <= 80 ? bwd_variant(1, 0, kBlockN) : bwd_variant(1, 2, 64);
}

// B4 (which 0) or B5 (1) in variant `variant` of its table.
inline int flash_bwd_variant(const BwdParams& p, int which, int bh, int head_dim, int dtype,
                             int variant, int device, cudaStream_t stream) {
  if (variant < 0 || variant >= bwd_variant_count(which)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const BwdVariant& var = bwd_variants(which)[variant];
  if (var.warpgroups > 0) {
    return flash_bwd_wgmma(p, which == 0, bh, head_dim, dtype, var.warpgroups, var.rows, device,
                           stream);
  }
  return launch_attention_bwd(p, which == 0, bh, head_dim, dtype, device, stream);
}

}  // namespace pea

// B4: dK and dV on head-major [BH, S, D].
//
// Bound on the H100: 8*BH*Sq*Skv*D operations (four products of the S^T
// tile's size) on 2*BH*(2*Sq + 4*Skv)*D bytes plus 8*BH*Sq of lse and
// delta. At the self-attention shapes (SDXL: S = 1600, D = 64; SD1.5: S =
// 4096 at D = 40, 1024 at D = 80, and at 1024^2 16384, 4096 and 1024 at
// D = 40, 80, 160) it is bound by tensor-core operations, and at D = 40
// nearly as much by the exponentials (attention_bwd_sm90_body.cuh); at the
// cross-attention shapes (Skv = 52) by device memory, and there one block
// per (bh, K/V tile) walks all of Sq alone: with one K/V tile per head, BH
// blocks serialise Sq / 64 Q tiles each. It runs the variant
// shipped_bwd_variant picks.
extern "C" int pea_flash_attention_bwd_dkdv(const void* q, const void* k, const void* v,
                                            const void* dout, const float* lse,
                                            const float* delta, void* dk, void* dv, int bh,
                                            int sq, int skv, int head_dim, float scale,
                                            int dtype, int device, void* stream) {
  pea::BwdParams p = pea::bwd_params(q, k, v, dout, lse, delta, sq, skv, scale);
  p.dk = dk;
  p.dv = dv;
  return pea::flash_bwd_variant(p, 0, bh, head_dim, dtype,
                                pea::shipped_bwd_variant(0, sq, skv, head_dim), device,
                                static_cast<cudaStream_t>(stream));
}

// B5: dQ on head-major [BH, S, D].
//
// Bound on the H100: 6*BH*Sq*Skv*D operations (three products) on
// 2*BH*(3*Sq + 2*Skv)*D bytes plus 8*BH*Sq of lse and delta: bound by
// operations at the self-attention shapes, by device memory at Skv = 52,
// where each block reads its Q and dO rows once and K/V (one tile) hit in
// L2. It runs the variant shipped_bwd_variant picks.
extern "C" int pea_flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                          const void* dout, const float* lse,
                                          const float* delta, void* dq, int bh, int sq,
                                          int skv, int head_dim, float scale, int dtype,
                                          int device, void* stream) {
  pea::BwdParams p = pea::bwd_params(q, k, v, dout, lse, delta, sq, skv, scale);
  p.dq = dq;
  return pea::flash_bwd_variant(p, 1, bh, head_dim, dtype,
                                pea::shipped_bwd_variant(1, sq, skv, head_dim), device,
                                static_cast<cudaStream_t>(stream));
}

// B4 in the variant `variant` (0 .. pea_flash_bwd_variant_count(0) - 1):
// cudaErrorInvalidValue where that variant is not built for the head dim or
// type, kTensorMapError + CUresult where a wgmma variant's tensor map cannot
// be encoded. Bound as B4.
extern "C" int pea_flash_attention_bwd_dkdv_variant(const void* q, const void* k, const void* v,
                                                    const void* dout, const float* lse,
                                                    const float* delta, void* dk, void* dv,
                                                    int bh, int sq, int skv, int head_dim,
                                                    float scale, int dtype, int variant,
                                                    int device, void* stream) {
  pea::BwdParams p = pea::bwd_params(q, k, v, dout, lse, delta, sq, skv, scale);
  p.dk = dk;
  p.dv = dv;
  return pea::flash_bwd_variant(p, 0, bh, head_dim, dtype, variant, device,
                                static_cast<cudaStream_t>(stream));
}

// B5 in the variant `variant` (0 .. pea_flash_bwd_variant_count(1) - 1), as
// B4's. Bound as B5.
extern "C" int pea_flash_attention_bwd_dq_variant(const void* q, const void* k, const void* v,
                                                  const void* dout, const float* lse,
                                                  const float* delta, void* dq, int bh, int sq,
                                                  int skv, int head_dim, float scale, int dtype,
                                                  int variant, int device, void* stream) {
  pea::BwdParams p = pea::bwd_params(q, k, v, dout, lse, delta, sq, skv, scale);
  p.dq = dq;
  return pea::flash_bwd_variant(p, 1, bh, head_dim, dtype, variant, device,
                                static_cast<cudaStream_t>(stream));
}

// which: 0 = B4, 1 = B5 (0 variants for any other).
extern "C" int pea_flash_bwd_variant_count(int which) { return pea::bwd_variant_count(which); }

// The name of variant `variant` of B4 (which 0) or B5 (1), or nullptr past
// the end.
extern "C" const char* pea_flash_bwd_variant_name(int which, int variant) {
  return variant >= 0 && variant < pea::bwd_variant_count(which)
             ? pea::bwd_variants(which)[variant].name
             : nullptr;
}

// The variant B4 (which 0) or B5 (1) ships for sq query and skv KV rows at
// head dim head_dim (its index).
extern "C" int pea_flash_bwd_shipped_variant(int which, int sq, int skv, int head_dim) {
  return pea::shipped_bwd_variant(which, sq, skv, head_dim);
}
