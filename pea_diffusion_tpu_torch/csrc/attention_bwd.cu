// Non-causal softmax attention backward for Hopper (sm_90a), behind two C
// entry points built into the same library as the forward:
//
// - pea_flash_attention_bwd_dkdv (B4) writes dK and dV. It replaces the TPU
//   kernel pea_diffusion_tpu/ops/flash_attention.py::_bwd_dkdv_kernel.
// - pea_flash_attention_bwd_dq (B5) writes dQ. It replaces
//   pea_diffusion_tpu/ops/flash_attention.py::_bwd_dq_kernel.
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
// later work. Head dims 40, 64, 80 and 128: the k-step and n-tile tails
// and the zero padding of D = 40 are described in attention_common.cuh.
// B4's fp32 dK and dV accumulators take D / 2 registers per thread each
// (40 at D = 80), beside the S^T and dP^T tiles and the K/V fragments.
//
// Masking. KV rows at or past skv are zero-filled and their scores set to
// -1e30, so P = 0 there; they are not stored. Q rows at or past sq read
// zero Q and dO, lse 0 and delta 0, so they add exactly 0 to dK and dV; they
// are not stored.
#include "attention_common.cuh"

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

template <int D>
constexpr int dq_smem_bytes() {  // [stage][K | V][row][k_ld<D>]
  return kStages * 2 * kBlockN * k_ld<D>() * 2;
}

template <int D>
constexpr int dkdv_smem_bytes() {  // K | V, [stage][Q | dO], [stage][lse | delta]
  return (2 + kStages * 2) * kBlockN * k_ld<D>() * 2 + kStages * 2 * kBlockM * 4;
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

// The B5 kernel of one instantiation (only the variant used is compiled).
template <typename T, int D>
inline auto dq_kernel() {
  if constexpr (D == 64) {
    return attention_bwd_dq_kernel_4blocks<T, D>;
  } else {
    return attention_bwd_dq_kernel<T, D>;
  }
}

template <typename T, int D>
inline cudaError_t launch_dkdv(const BwdParams& p, int bh, int device, cudaStream_t stream) {
  constexpr int bytes = dkdv_smem_bytes<D>();
  static std::atomic<bool> opted_in[kMaxDevices];
  const cudaError_t err = opt_in_smem(attention_bwd_dkdv_kernel<T, D>, bytes, device, opted_in);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.skv + kBlockN - 1) / kBlockN, bh);
  attention_bwd_dkdv_kernel<T, D><<<grid, kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int D>
inline cudaError_t launch_dq(const BwdParams& p, int bh, int device, cudaStream_t stream) {
  constexpr int bytes = dq_smem_bytes<D>();
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

}  // namespace pea

// B4: dK and dV on head-major [BH, S, D].
//
// Bound on the H100: 8*BH*Sq*Skv*D operations (four products of the S^T
// tile's size) on 2*BH*(2*Sq + 4*Skv)*D bytes plus 8*BH*Sq of lse and
// delta. At the self-attention shapes (SDXL: S = 1600, D = 64; SD1.5: S =
// 4096 at D = 40, 1024 at D = 80) it is bound by tensor-core operations; at
// the cross-attention shapes (Skv = 52) by device memory, and there one
// block per (bh, KV tile) walks all of Sq alone: with one KV tile per head,
// BH blocks serialise Sq / 64 Q tiles each.
extern "C" int pea_flash_attention_bwd_dkdv(const void* q, const void* k, const void* v,
                                            const void* dout, const float* lse,
                                            const float* delta, void* dk, void* dv, int bh,
                                            int sq, int skv, int head_dim, float scale,
                                            int dtype, int device, void* stream) {
  pea::BwdParams p = pea::bwd_params(q, k, v, dout, lse, delta, sq, skv, scale);
  p.dk = dk;
  p.dv = dv;
  return pea::launch_attention_bwd(p, true, bh, head_dim, dtype, device,
                                   static_cast<cudaStream_t>(stream));
}

// B5: dQ on head-major [BH, S, D].
//
// Bound on the H100: 6*BH*Sq*Skv*D operations (three products) on
// 2*BH*(3*Sq + 2*Skv)*D bytes plus 8*BH*Sq of lse and delta: bound by
// operations at the self-attention shapes, by device memory at Skv = 52,
// where each block reads its Q and dO rows once and K/V (one tile) hit in L2.
extern "C" int pea_flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                          const void* dout, const float* lse,
                                          const float* delta, void* dq, int bh, int sq,
                                          int skv, int head_dim, float scale, int dtype,
                                          int device, void* stream) {
  pea::BwdParams p = pea::bwd_params(q, k, v, dout, lse, delta, sq, skv, scale);
  p.dq = dq;
  return pea::launch_attention_bwd(p, false, bh, head_dim, dtype, device,
                                   static_cast<cudaStream_t>(stream));
}
