// The wgmma + TMA backward of non-causal softmax attention for Hopper
// (sm_90a), on head-major [BH, S, D] at D = 40, 64, 80, 128 and 160, in bf16
// and fp16: B4 (flash_bwd_dkdv_kernel: dK, dV), replacing the TPU kernel
// pea_diffusion_tpu/ops/flash_attention.py::_bwd_dkdv_kernel (:156), and B5
// (flash_bwd_dq_kernel: dQ), replacing ::_bwd_dq_kernel (:203). Two
// kernels and no atomics, as the JAX package has them: every output element
// is summed by one thread in a fixed order, so a run gives the same bits as
// the last. The function and its rounding points are attention_bwd.cu's
// (P = exp2(S * scale * log2(e) - lse * log2(e)), dV = P^T dO with P cast to
// the input type, dS = P * (dP - delta) cast to it, dK = dS^T Q * scale, dQ =
// dS K * scale, all products accumulated in fp32, outputs stored in the
// input type); only the order of the additions differs.
//
// Bound on the H100. Self-attention (Sq = Skv = S >= 1024): B4 does four
// products of the S^T tile's size (8 * BH * S^2 * D operations), B5 three
// (6 * BH * S^2 * D), both far above the card's ~295 operations a byte:
// bound by tensor-core operations (989 TFLOP/s). Each takes BH * S^2
// exponentials, which at 16 a cycle an SM set a floor of their own that
// is close to the operations bound at D = 40 (1.72e10 exp2 at BH 64, S =
// 16384: >= 4.1 ms on 132 SMs at 1.98 GHz, against 4.17 ms of operations
// for B5): at D = 40 neither kernel can pass about half of its bound
// unless one warpgroup's exponentials overlap the other's products.
// Cross-attention (Skv = 52) is bound by device memory.
//
// Design: the forward's body (attention_fwd_sm90_body.cuh) with its
// primitives (sm90_common.cuh). Every product has the form of one the
// forward issues:
// - B5: a block of kWG warpgroups owns kWG * 64 Q rows. Its Q and dO rows
//   come in once by TMA and stay; their lse * log2(e) and delta sit in
//   registers (rows g and g + 8 of each warp's 16). K and V stream through
//   a ring of kBwdStages tiles of kBN rows, refilled by thread 0 after a
//   named barrier, as the forward's. Per tile: S = Q.K^T and dP = dO.V^T
//   (both K-major from shared memory, m64n<kBN>k16, issued together and
//   waited on together), then P, the KV mask, dS in registers, packed
//   pairwise into the A fragments of dQ += dS.K (A from registers, K's tile
//   the MN-major B operand, N = D: the forward's P.V).
// - B4: the same with the rows swapped. A block of kWG warpgroups owns kWG *
//   64 K/V rows, K and V in shared memory by TMA once; Q, dO and their lse
//   and delta (fp32, by a 1-D map over [BH * Sq]) stream through the ring in
//   tiles of kBM rows (64, or 32 where the registers would not hold 64),
//   shared by the block's warpgroups. Per tile: S^T = K.Q^T and dP^T =
//   V.dO^T (N = kBM), then P^T with the lse and delta of each column's Q
//   row, read from the tile's rows in shared memory, and dS^T; then dV +=
//   P^T.dO and dK += dS^T.Q (A from registers, the dO and Q tiles MN-major,
//   N = D).
// A thread holds S and dP (kBN / 2 each, or S^T and dP^T, kBM / 2), and its
// outputs' accumulators: dQ, D / 2; dK and dV, D / 2 each.
//
// Padding and masks. The 16-bit maps' inner extent is D, so TMA's zero fill
// pads D = 40, 80 and 160 (columns past D add 0 to every contraction over
// D). Q rows at or past sq read zero Q and dO; in B4 their lse and delta
// come from the next head's rows (or zero fill past the end), so their
// columns of S^T are set to -1e30: P = 0 and dS = 0 there, and they add
// exactly 0 to dK and dV. KV columns at or past skv get -1e30 in B5 (K's zero
// fill already makes them add 0 to dQ: the mask is a second guard). Rows
// past the end are never stored; in B4 a K/V row past skv only feeds its
// own, unstored, accumulator row.
#pragma once

#include "attention_bwd_sm90.cuh"
#include "sm90_common.cuh"

namespace pea {
namespace sm90 {

constexpr int kBwdStages = 2;  // streamed tiles in flight

// B4: 1 KB of alignment slack, the block's K and V rows, kBwdStages (Q, dO)
// tiles and their (lse, delta) rows, kBwdStages + 1 mbarriers.
template <int kD, int kWG, int kBM>
constexpr int dkdv_smem_bytes() {
  return 1024 + atoms(kD) * (2 * kWG * kRowsWG + kBwdStages * 2 * kBM) * kAtomRow +
         kBwdStages * 2 * kBM * 4 + (kBwdStages + 1) * 8;
}

// B5: 1 KB of slack, the block's Q and dO rows, kBwdStages (K, V) tiles,
// kBwdStages + 1 mbarriers.
template <int kD, int kWG, int kBN>
constexpr int dq_smem_bytes() {
  return 1024 + atoms(kD) * (2 * kWG * kRowsWG + kBwdStages * 2 * kBN) * kAtomRow +
         (kBwdStages + 1) * 8;
}

// Thread 0 initialises kN mbarriers of one arrival each from `bar`; then
// the block syncs.
template <int kN>
__device__ __forceinline__ void init_barriers(uint32_t bar) {
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kN; ++s) mbar_init(bar + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// One thread arms B4's stage at `q_addr` (Q, then dO) and `rows_addr` (lse,
// then delta) with the bytes of the Q tile from row `row` of head `bh`, and
// starts their TMA copies.
template <int kAtoms, int kBM>
__device__ __forceinline__ void refill_q(uint32_t q_addr, uint32_t rows_addr, uint32_t bar,
                                         const CUtensorMap* tm_q, const CUtensorMap* tm_do,
                                         const CUtensorMap* tm_lse, const CUtensorMap* tm_delta,
                                         int row, int bh, int sq) {
  constexpr int kQAtom = kBM * kAtomRow;
  mbar_expect_tx(bar, 2 * kAtoms * kQAtom + 2 * kBM * 4);
  tma_load_atoms<kAtoms>(q_addr, tm_q, bar, 0, row, bh, kQAtom);
  tma_load_atoms<kAtoms>(q_addr + kAtoms * kQAtom, tm_do, bar, 0, row, bh, kQAtom);
  tma_load_1d(rows_addr, tm_lse, bar, bh * sq + row);
  tma_load_1d(rows_addr + kBM * 4, tm_delta, bar, bh * sq + row);
}

// One Q tile's P^T and dS^T from S^T = K.Q^T and dP^T = V.dO^T. Thread
// element st[j * 4 + e] is K/V row g + 8 * (e / 2) of its warp's 16 and Q
// row c = 8 * j + 2 * t + e % 2 of the tile (q0 + c of the head): P^T =
// exp2(S^T * scale * log2(e) - lse[c] * log2(e)) with the lse of the
// column's Q row (-1e30 for columns at or past sq: P = 0), dS^T = P^T *
// (dP^T - delta[c]), both packed into the A fragments of dV += P^T.dO and
// dK += dS^T.Q.
template <typename T, int kBM>
__device__ __forceinline__ void dkdv_tile(const float (&st)[kBM / 2], const float (&dpt)[kBM / 2],
                                          uint32_t (&pa)[kBM / 16][4],
                                          uint32_t (&dsa)[kBM / 16][4], const float* ls,
                                          const float* dl, int q0, int sq, float scale_log2,
                                          int t) {
  const bool ragged = q0 + kBM > sq;
#pragma unroll
  for (int j = 0; j < kBM / 8; ++j) {
    float pr[4], ds[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = j * 8 + t * 2 + (e & 1);
      float x = st[j * 4 + e] * scale_log2;
      if (ragged && q0 + c >= sq) x = kNegInf;
      pr[e] = exp2f(x - ls[c] * kLog2e);
      ds[e] = pr[e] * (dpt[j * 4 + e] - dl[c]);
    }
    pa[j / 2][(j & 1) * 2 + 0] = MmaOp<T>::pack(pr[0], pr[1]);
    pa[j / 2][(j & 1) * 2 + 1] = MmaOp<T>::pack(pr[2], pr[3]);
    dsa[j / 2][(j & 1) * 2 + 0] = MmaOp<T>::pack(ds[0], ds[1]);
    dsa[j / 2][(j & 1) * 2 + 1] = MmaOp<T>::pack(ds[2], ds[3]);
  }
}

// B4: head dim kD, kWG warpgroups of 64 K/V rows, Q tiles of kBM rows.
template <typename T, int kD, int kWG, int kBM>
__global__ void __launch_bounds__(kWG * 128, 1)
flash_bwd_dkdv_kernel(const BwdParams p, const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_do,
                      const __grid_constant__ CUtensorMap tm_lse,
                      const __grid_constant__ CUtensorMap tm_delta) {
  static_assert((kWG == 1 || kWG == 2) && (kBM == 32 || kBM == 64), "block shape");
  constexpr int kAtoms = atoms(kD);
  constexpr int kNThreads = kWG * 128;
  constexpr int kKAtom = kWG * kRowsWG * kAtomRow;  // one atom of the block's K or V
  constexpr int kQAtom = kBM * kAtomRow;            // one atom of a Q or dO tile
  constexpr int kTileBytes = kAtoms * kQAtom;
  constexpr int kRowBytes = kBM * 4;  // a tile's lse or delta
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // where the swizzle pattern starts
  const uint32_t k_addr = base;                       // [atom][kWG * 64][64]
  const uint32_t v_addr = k_addr + kAtoms * kKAtom;
  const uint32_t ring = v_addr + kAtoms * kKAtom;     // stage s: Q, then dO
  const uint32_t rows_addr = ring + kBwdStages * 2 * kTileBytes;    // stage s: lse, delta
  const uint32_t bar_addr = rows_addr + kBwdStages * 2 * kRowBytes;  // full[], then K/V's
  const float* rows_s = reinterpret_cast<const float*>(smem_raw + (rows_addr - raw));

  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int bh = blockIdx.y;
  const int kv0 = blockIdx.x * (kWG * kRowsWG);
  const int n_tiles = (p.sq + kBM - 1) / kBM;

  init_barriers<kBwdStages + 1>(bar_addr);
  if (threadIdx.x == 0) {
    const uint32_t kv_bar = bar_addr + 8 * kBwdStages;
    mbar_expect_tx(kv_bar, 2 * kAtoms * kKAtom);
    tma_load_atoms<kAtoms>(k_addr, &tm_k, kv_bar, 0, kv0, bh, kKAtom);
    tma_load_atoms<kAtoms>(v_addr, &tm_v, kv_bar, 0, kv0, bh, kKAtom);
    for (int s = 0; s < kBwdStages && s < n_tiles; ++s) {
      refill_q<kAtoms, kBM>(ring + s * 2 * kTileBytes, rows_addr + s * 2 * kRowBytes,
                            bar_addr + 8 * s, &tm_q, &tm_do, &tm_lse, &tm_delta, s * kBM, bh,
                            p.sq);
    }
  }
  mbar_wait(bar_addr + 8 * kBwdStages, 0);

  const uint64_t desc_k = desc_sw128(k_addr + wg * kRowsWG * kAtomRow);
  const uint64_t desc_v = desc_sw128(v_addr + wg * kRowsWG * kAtomRow);
  float dk[kD / 2], dv[kD / 2];
#pragma unroll
  for (int i = 0; i < kD / 2; ++i) dk[i] = dv[i] = 0.f;
  const float scale_log2 = p.scale * kLog2e;
  float st[kBM / 2], dpt[kBM / 2];  // S^T and dP^T of the tile
  uint32_t pa[kBM / 16][4], dsa[kBM / 16][4];

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int stage = tile % kBwdStages;
    mbar_wait(bar_addr + 8 * stage, (tile / kBwdStages) & 1);
    const uint32_t q_addr = ring + stage * 2 * kTileBytes;
    const uint32_t do_addr = q_addr + kTileBytes;
    const float* ls = rows_s + stage * 2 * kBM;  // the tile's lse
    const float* dl = ls + kBM;                  // and delta

    fence_regs(st);
    fence_regs(dpt);
    wgmma_fence();
    issue_qk<T, kD, kBM, kKAtom, kQAtom>(st, desc_k, desc_sw128(q_addr));
    issue_qk<T, kD, kBM, kKAtom, kQAtom>(dpt, desc_v, desc_sw128(do_addr));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(st);
    fence_regs(dpt);
    dkdv_tile<T, kBM>(st, dpt, pa, dsa, ls, dl, tile * kBM, p.sq, scale_log2, t);

    // dV += P^T.dO and dK += dS^T.Q: the tile's rows are the k index (Q
    // row), its columns the n index (head-dim column), as V in the forward
    fence_regs(dv);
    fence_regs(dk);
    wgmma_fence();
    const uint64_t desc_do = desc_sw128(do_addr, kQAtom), desc_q = desc_sw128(q_addr, kQAtom);
#pragma unroll
    for (int kk = 0; kk < kBM / 16; ++kk) {
      WgmmaRS<T, kD>::run(dv, pa[kk], desc_do + 128 * kk);
      WgmmaRS<T, kD>::run(dk, dsa[kk], desc_q + 128 * kk);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dv);
    fence_regs(dk);

    // the stage is read: refill it with tile + kBwdStages
    asm volatile("bar.sync 1, %0;\n" ::"n"(kNThreads) : "memory");
    if (threadIdx.x == 0 && tile + kBwdStages < n_tiles) {
      refill_q<kAtoms, kBM>(q_addr, rows_addr + stage * 2 * kRowBytes, bar_addr + 8 * stage,
                            &tm_q, &tm_do, &tm_lse, &tm_delta, (tile + kBwdStages) * kBM, bh,
                            p.sq);
    }
  }

  // dK * scale and dV in the input type; rows at or past skv are not stored
  const long long head = static_cast<long long>(bh) * p.skv * kD;
  uint16_t* dkp = static_cast<uint16_t*>(p.dk) + head;
  uint16_t* dvp = static_cast<uint16_t*>(p.dv) + head;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = kv0 + wg * kRowsWG + warp * 16 + g + r * 8;
    if (row >= p.skv) continue;
#pragma unroll
    for (int j = 0; j < kD / 8; ++j) {
      const long long at = static_cast<long long>(row) * kD + j * 8 + t * 2;
      *reinterpret_cast<uint32_t*>(dkp + at) =
          MmaOp<T>::pack(dk[j * 4 + r * 2] * p.scale, dk[j * 4 + r * 2 + 1] * p.scale);
      *reinterpret_cast<uint32_t*>(dvp + at) =
          MmaOp<T>::pack(dv[j * 4 + r * 2], dv[j * 4 + r * 2 + 1]);
    }
  }
}

// One K/V tile's dS from S = Q.K^T and dP = dO.V^T. Thread element s[j * 4
// + e] is row g + 8 * (e / 2) of its warp's 16, KV column n0 + 8 * j + 2 * t
// + e % 2: P = exp2(S * scale * log2(e) - lse2) (-1e30 for columns at or
// past skv: P = 0), dS = P * (dP - delta), packed into the A fragments of
// dQ += dS.K.
template <typename T, int kBN>
__device__ __forceinline__ void dq_tile(const float (&s)[kBN / 2], const float (&dp)[kBN / 2],
                                        uint32_t (&dsa)[kBN / 16][4], const float (&lse2)[2],
                                        const float (&delta)[2], int n0, int skv,
                                        float scale_log2, int t) {
  const bool ragged = n0 + kBN > skv;
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    float ds[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[j * 4 + e] * scale_log2;
      if (ragged && n0 + j * 8 + t * 2 + (e & 1) >= skv) x = kNegInf;
      ds[e] = exp2f(x - lse2[e >> 1]) * (dp[j * 4 + e] - delta[e >> 1]);
    }
    dsa[j / 2][(j & 1) * 2 + 0] = MmaOp<T>::pack(ds[0], ds[1]);
    dsa[j / 2][(j & 1) * 2 + 1] = MmaOp<T>::pack(ds[2], ds[3]);
  }
}

// B5: head dim kD, kWG warpgroups of 64 Q rows, K/V tiles of kBN rows.
template <typename T, int kD, int kWG, int kBN>
__global__ void __launch_bounds__(kWG * 128, 1)
flash_bwd_dq_kernel(const BwdParams p, const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_do,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v) {
  static_assert((kWG == 1 || kWG == 2) && (kBN == 64 || kBN == 128), "block shape");
  constexpr int kAtoms = atoms(kD);
  constexpr int kNThreads = kWG * 128;
  constexpr int kQAtom = kWG * kRowsWG * kAtomRow;  // one atom of the block's Q or dO
  constexpr int kKVAtom = kBN * kAtomRow;           // one atom of a K or V tile
  constexpr int kTileBytes = kAtoms * kKVAtom;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_addr = base;                        // [atom][kWG * 64][64]
  const uint32_t do_addr = q_addr + kAtoms * kQAtom;
  const uint32_t ring = do_addr + kAtoms * kQAtom;     // stage s: K, then V
  const uint32_t bar_addr = ring + kBwdStages * 2 * kTileBytes;  // full[], then Q/dO's

  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * (kWG * kRowsWG);
  const int n_tiles = (p.skv + kBN - 1) / kBN;

  init_barriers<kBwdStages + 1>(bar_addr);
  if (threadIdx.x == 0) {
    const uint32_t q_bar = bar_addr + 8 * kBwdStages;
    mbar_expect_tx(q_bar, 2 * kAtoms * kQAtom);
    tma_load_atoms<kAtoms>(q_addr, &tm_q, q_bar, 0, q0, bh, kQAtom);
    tma_load_atoms<kAtoms>(do_addr, &tm_do, q_bar, 0, q0, bh, kQAtom);
    for (int s = 0; s < kBwdStages && s < n_tiles; ++s) {
      refill<kAtoms, kBN>(ring + s * 2 * kTileBytes, bar_addr + 8 * s, &tm_k, &tm_v, 0, s * kBN,
                          bh);
    }
  }
  // rows g and g + 8 of this warp's 16: lse * log2(e) and delta, 0 past sq
  float lse2[2], delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + wg * kRowsWG + warp * 16 + g + r * 8;
    const bool valid = row < p.sq;
    const long long at = static_cast<long long>(bh) * p.sq + row;
    lse2[r] = valid ? p.lse[at] * kLog2e : 0.f;
    delta[r] = valid ? p.delta[at] : 0.f;
  }
  mbar_wait(bar_addr + 8 * kBwdStages, 0);

  const uint64_t desc_q = desc_sw128(q_addr + wg * kRowsWG * kAtomRow);
  const uint64_t desc_do = desc_sw128(do_addr + wg * kRowsWG * kAtomRow);
  float dq[kD / 2];
#pragma unroll
  for (int i = 0; i < kD / 2; ++i) dq[i] = 0.f;
  const float scale_log2 = p.scale * kLog2e;
  float s[kBN / 2], dp[kBN / 2];  // S and dP of the tile
  uint32_t dsa[kBN / 16][4];

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int stage = tile % kBwdStages;
    mbar_wait(bar_addr + 8 * stage, (tile / kBwdStages) & 1);
    const uint32_t k_addr = ring + stage * 2 * kTileBytes;

    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
    issue_qk<T, kD, kBN, kQAtom, kKVAtom>(s, desc_q, desc_sw128(k_addr));
    issue_qk<T, kD, kBN, kQAtom, kKVAtom>(dp, desc_do, desc_sw128(k_addr + kTileBytes));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);
    dq_tile<T, kBN>(s, dp, dsa, lse2, delta, tile * kBN, p.skv, scale_log2, t);

    fence_regs(dq);
    wgmma_fence();
    issue_pv<T, kD, kBN>(dq, dsa, desc_sw128(k_addr, kKVAtom));  // dQ += dS.K
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dq);

    // the stage is read: refill it with tile + kBwdStages
    asm volatile("bar.sync 1, %0;\n" ::"n"(kNThreads) : "memory");
    if (threadIdx.x == 0 && tile + kBwdStages < n_tiles) {
      refill<kAtoms, kBN>(k_addr, bar_addr + 8 * stage, &tm_k, &tm_v, 0,
                          (tile + kBwdStages) * kBN, bh);
    }
  }

  // dQ * scale in the input type; rows at or past sq are not stored
  uint16_t* dqp = static_cast<uint16_t*>(p.dq) + static_cast<long long>(bh) * p.sq * kD;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + wg * kRowsWG + warp * 16 + g + r * 8;
    if (row >= p.sq) continue;
#pragma unroll
    for (int j = 0; j < kD / 8; ++j) {
      *reinterpret_cast<uint32_t*>(dqp + static_cast<long long>(row) * kD + j * 8 + t * 2) =
          MmaOp<T>::pack(dq[j * 4 + r * 2] * p.scale, dq[j * 4 + r * 2 + 1] * p.scale);
    }
  }
}

// The map of a head-major [bh, rows, kD] tensor in boxes of 64 columns x
// box_rows rows: its inner extent is kD itself, so that TMA zero-fills the
// columns of a box past it.
template <int kD>
int encode_head_major(CUtensorMap* map, const void* ptr, int dtype, int bh, int rows,
                      int box_rows) {
  return encode(map, ptr, dtype, bh, rows, kD, kD, box_rows);
}

// Opts in to the shared memory above 48 KB once per device and launches
// `kernel` on `stream` over `grid`, with the maps.
template <typename Kernel, typename... Maps>
int launch_bwd_kernel(Kernel kernel, int bytes, std::atomic<bool>* opted_in, dim3 grid,
                      int threads, int device, cudaStream_t stream, const BwdParams& p,
                      const Maps&... maps) {
  const cudaError_t err = opt_in_smem(kernel, bytes, device, opted_in);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, threads, bytes, stream>>>(p, maps...);
  return static_cast<int>(cudaGetLastError());
}

// B4: (skv / (kWG * 64)) x bh blocks.
template <typename T, int kD, int kWG, int kBM>
int launch_dkdv(const BwdParams& p, int bh, int dtype, int device, cudaStream_t stream) {
  CUtensorMap m[6] = {};
  const long long rows = static_cast<long long>(bh) * p.sq;
  int err = encode_head_major<kD>(&m[0], p.k, dtype, bh, p.skv, kWG * kRowsWG);
  if (err == 0) err = encode_head_major<kD>(&m[1], p.v, dtype, bh, p.skv, kWG * kRowsWG);
  if (err == 0) err = encode_head_major<kD>(&m[2], p.q, dtype, bh, p.sq, kBM);
  if (err == 0) err = encode_head_major<kD>(&m[3], p.dout, dtype, bh, p.sq, kBM);
  if (err == 0) err = encode_fp32(&m[4], p.lse, rows, kBM);
  if (err == 0) err = encode_fp32(&m[5], p.delta, rows, kBM);
  if (err != 0) return err;
  static std::atomic<bool> opted_in[kMaxDevices];
  const dim3 grid((p.skv + kWG * kRowsWG - 1) / (kWG * kRowsWG), bh);
  return launch_bwd_kernel(flash_bwd_dkdv_kernel<T, kD, kWG, kBM>,
                           dkdv_smem_bytes<kD, kWG, kBM>(), opted_in, grid, kWG * 128, device,
                           stream, p, m[0], m[1], m[2], m[3], m[4], m[5]);
}

// B5: (sq / (kWG * 64)) x bh blocks.
template <typename T, int kD, int kWG, int kBN>
int launch_dq(const BwdParams& p, int bh, int dtype, int device, cudaStream_t stream) {
  CUtensorMap m[4] = {};
  int err = encode_head_major<kD>(&m[0], p.q, dtype, bh, p.sq, kWG * kRowsWG);
  if (err == 0) err = encode_head_major<kD>(&m[1], p.dout, dtype, bh, p.sq, kWG * kRowsWG);
  if (err == 0) err = encode_head_major<kD>(&m[2], p.k, dtype, bh, p.skv, kBN);
  if (err == 0) err = encode_head_major<kD>(&m[3], p.v, dtype, bh, p.skv, kBN);
  if (err != 0) return err;
  static std::atomic<bool> opted_in[kMaxDevices];
  const dim3 grid((p.sq + kWG * kRowsWG - 1) / (kWG * kRowsWG), bh);
  return launch_bwd_kernel(flash_bwd_dq_kernel<T, kD, kWG, kBN>, dq_smem_bytes<kD, kWG, kBN>(),
                           opted_in, grid, kWG * 128, device, stream, p, m[0], m[1], m[2], m[3]);
}

// The instantiations of B4 (dkdv) and B5 at head dim kD, one per
// (warpgroups, rows) pair of kShapes (each warpgroups * 1000 + rows: B4's Q
// tile rows, B5's K/V tile rows), in bf16 (dtype 0) and fp16 (1): launches
// the pair asked for, or returns cudaErrorInvalidValue for any other pair
// or type.
template <int kD, int... kShapes>
int launch_dkdv_shapes(const BwdParams& p, int bh, int dtype, int warpgroups, int rows,
                       int device, cudaStream_t stream) {
  int err = static_cast<int>(cudaErrorInvalidValue);
  const int shape = warpgroups * 1000 + rows;
  ((shape == kShapes && dtype == 0
        ? (err = launch_dkdv<__nv_bfloat16, kD, kShapes / 1000, kShapes % 1000>(p, bh, dtype,
                                                                                device, stream))
        : 0),
   ...);
  ((shape == kShapes && dtype == 1
        ? (err = launch_dkdv<__half, kD, kShapes / 1000, kShapes % 1000>(p, bh, dtype, device,
                                                                         stream))
        : 0),
   ...);
  return err;
}
template <int kD, int... kShapes>
int launch_dq_shapes(const BwdParams& p, int bh, int dtype, int warpgroups, int rows, int device,
                     cudaStream_t stream) {
  int err = static_cast<int>(cudaErrorInvalidValue);
  const int shape = warpgroups * 1000 + rows;
  ((shape == kShapes && dtype == 0
        ? (err = launch_dq<__nv_bfloat16, kD, kShapes / 1000, kShapes % 1000>(p, bh, dtype,
                                                                              device, stream))
        : 0),
   ...);
  ((shape == kShapes && dtype == 1
        ? (err = launch_dq<__half, kD, kShapes / 1000, kShapes % 1000>(p, bh, dtype, device,
                                                                       stream))
        : 0),
   ...);
  return err;
}

}  // namespace sm90
}  // namespace pea
