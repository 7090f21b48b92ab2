// The wgmma + TMA attention body for Hopper (sm_90a), shared by B1 and B3:
// non-causal softmax attention on [B, S, H*D], written for the warpgroup
// matrix multiply (wgmma) and the Tensor Memory Accelerator (TMA). B1 runs
// it on the projections' layout at head dim 64 (attention_fwd_sm90.cu:
// onepass_wgmma, onepass_wgmma_shipped); B3 on head-major [BH, S, D], which
// is [B, S, H*D] with H = 1 (flash_wgmma, at D = 40, 64, 80, 128 and 160,
// with its fp32 lse). The body is a template; each head dim's
// instantiations are built in a source of their own (attention_fwd_sm90.cu
// for 64, flash_fwd_sm90_d<D>.cu for the others), so that nvcc compiles
// them in parallel. It replaces the TPU kernels
// pea_diffusion_tpu/ops/onepass_attention.py::_kernel (:50) and _kernel_bb
// (:78), and pea_diffusion_tpu/ops/flash_attention.py::_fwd_kernel (:31).
//
// Bound on the H100. Self-attention (Sq = Skv = S >= 1024) is 4*BH*S*S*D
// operations on 8*BH*S*D bytes, S/2 operations per byte, above the card's
// ~295: bound by tensor-core operations (989 TFLOP/s in bf16 and fp16).
// mma.sync (attention_fwd.cu) reached 13-20 % of that bound: it issues
// 16x8x16 products from one warp, with every B operand passed through
// registers by ldmatrix; wgmma is the only way to the tensor cores' full
// rate. At D = 40 and 64 the exponentials set the floor, not the products:
// 2*BH*S*S exp2 on the SM's 16 MUFU lanes a cycle. Cross-attention (Skv =
// 52 or 77, one K/V tile) is bound by device memory.
//
// Design. A block of kWG consumer warpgroups (1 or 2) owns kWG * 64 query
// rows of one (batch, head). Its Q tile comes into shared memory once, by
// TMA, and stays there for the whole walk over K/V, which comes in tiles of
// kBN rows (64 or 128) through a ring of kST stages. One thread (thread 0;
// no producer warp) issues every copy: a stage's full mbarrier is armed with
// the tile's bytes (expect_tx) and the TMA copies complete it; the thread
// refills a stage only after every warpgroup has passed a named barrier
// that marks the stage as read. Per tile and warpgroup:
// - S = Q.K^T: ceil(D / 16) k-steps of wgmma m64n<kBN>k16, both operands
//   from shared memory; K's tile, row-major [kv, d], is the K-major B
//   operand, so nothing is transposed.
// - online softmax on the accumulator layout: each thread holds 2 rows
//   (warp*16 + g and + 8) of kBN / 4 columns; the row max and sum reduce
//   over the 4 threads of a quad.
// - O += P.V: kBN / 16 k-steps of wgmma m64n<D>k16 with A = P taken from
//   registers (the fp32 score accumulator packs pairwise into the A
//   fragment, cast to the input type) and B = V's tile, row-major [kv, d],
//   the MN-major operand (transpose bit set). N = D exactly (40, 64, 80,
//   128, 160 are legal wgmma widths): no padded output column is computed.
//
// Shared memory holds every tile in the 128-byte swizzle, in atoms of 64
// 16-bit columns (sm90_common.cuh, which also holds the descriptors, the
// wgmma wrappers, the mbarrier and TMA helpers and the map encode that the
// backward shares). The tensor maps are 3-D over [B, S, H*D] (inner H*D,
// then S, then B), one 64-column box per atom: columns past H*D (B3 at D =
// 40, 80 and 160) and rows past a batch's last row are out of bounds and
// read as zeros, never the next row's or the next batch's values, so D =
// 40's third k-step (columns 32-47) adds 0 for columns 40-47. This holds
// only while the map's inner extent is H*D, not the padded width. Zero fill
// is not a mask: KV columns >= skv still get -1e30. The maps are encoded on
// the host for each call and passed as __grid_constant__ parameters.
//
// The staged form (kCpAsync, D = 64 only) fills the same swizzled layout
// with cp.async by every thread (a proxy fence makes the writes visible to
// wgmma), and syncs the block once per tile. It is kept as an S1 variant.
//
// Rounding points are those of attention_fwd.cu: fp32 scores times scale
// (scale * log2(e), for exp2), KV columns at or past skv set to -1e30, P =
// exp(S - m) summed in fp32 and cast to the input type for P.V, which
// accumulates in fp32, the output divided by l at the end and stored in the
// input type, and lse = m * ln(2) + log(l) in fp32 (natural log). Only the
// order of the additions differs (kBN-column tiles).
#pragma once

#include "sm90_common.cuh"

namespace pea {
namespace sm90 {

// 1 KB of alignment slack, Q, kST (K, V) stages, kST + 1 mbarriers.
template <int kD, int kWG, int kBN, int kST>
constexpr int smem_bytes() {
  return 1024 + atoms(kD) * (kWG * kRowsWG + kST * 2 * kBN) * kAtomRow + (kST + 1) * 8;
}

// The blocks an SM can hold by shared memory, up to two: what the register
// allocator is told to leave room for (__launch_bounds__).
template <int kD, int kWG, int kBN, int kST>
constexpr int min_blocks() {
  return smem_bytes<kD, kWG, kBN, kST>() <= kTwoBlocksMaxSmem ? 2 : 1;
}

// The staged form's copy: rows [row0, row0 + kRows) of one (batch, head)
// slice, 64 columns each, into the 128B-swizzled tile at `dst` by
// kNThreads threads; rows at or past `rows` are zero-filled.
template <int kRows, int kNThreads>
__device__ __forceinline__ void load_rows_sw128(uint8_t* dst, const uint16_t* src,
                                                long long row_stride, int row0, int rows) {
  for (int c = threadIdx.x; c < kRows * 8; c += kNThreads) {
    const int r = c / 8, chunk = c % 8;
    const bool valid = row0 + r < rows;
    const uint16_t* from = valid ? src + (long long)(row0 + r) * row_stride + chunk * 8 : src;
    cp_async_16(dst + r * kAtomRow + ((chunk ^ (r & 7)) * 16), from, valid);
  }
}

// One tile's scores into P. Thread element s[j * 4 + e] is row g + 8 *
// (e / 2), column n0 + 8 * j + 2 * t + e % 2: scale into the log2 domain,
// set columns at or past skv to -1e30, fold the tile's row max (over the
// quad) into m_run, with corr the factor that rescales what was summed
// under the old max (0 on the first tile); P = exp2(S - m) packed into the
// A fragments pa, and l_tile its row sums over the quad.
template <typename T, int kBN>
__device__ __forceinline__ void tile_softmax(float (&s)[kBN / 2], uint32_t (&pa)[kBN / 16][4],
                                             float (&m_run)[2], float (&corr)[2],
                                             float (&l_tile)[2], int n0, int skv,
                                             float scale_log2, int t) {
  const bool ragged = n0 + kBN > skv;
  float m_tile[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[j * 4 + e] * scale_log2;
      if (ragged && n0 + j * 8 + t * 2 + (e & 1) >= skv) x = kNegInf;
      s[j * 4 + e] = x;
      m_tile[e >> 1] = fmaxf(m_tile[e >> 1], x);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    m_tile[r] = fmaxf(m_tile[r], __shfl_xor_sync(0xffffffffu, m_tile[r], 1));
    m_tile[r] = fmaxf(m_tile[r], __shfl_xor_sync(0xffffffffu, m_tile[r], 2));
    const float m_new = fmaxf(m_run[r], m_tile[r]);
    corr[r] = exp2f(m_run[r] - m_new);
    m_run[r] = m_new;
  }
  l_tile[0] = l_tile[1] = 0.f;
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    const float p0 = exp2f(s[j * 4 + 0] - m_run[0]);
    const float p1 = exp2f(s[j * 4 + 1] - m_run[0]);
    const float p2 = exp2f(s[j * 4 + 2] - m_run[1]);
    const float p3 = exp2f(s[j * 4 + 3] - m_run[1]);
    l_tile[0] += p0 + p1;
    l_tile[1] += p2 + p3;
    pa[j / 2][(j & 1) * 2 + 0] = MmaOp<T>::pack(p0, p1);
    pa[j / 2][(j & 1) * 2 + 1] = MmaOp<T>::pack(p2, p3);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_tile[r] += __shfl_xor_sync(0xffffffffu, l_tile[r], 1);
    l_tile[r] += __shfl_xor_sync(0xffffffffu, l_tile[r], 2);
  }
}

// The running sum and the output accumulator under the new max.
template <int N>
__device__ __forceinline__ void rescale(float (&o)[N], float (&l_run)[2], const float (&corr)[2],
                                        const float (&l_tile)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * corr[r] + l_tile[r];
#pragma unroll
  for (int i = 0; i < N; ++i) o[i] *= corr[(i >> 1) & 1];  // o[j * 4 + e]: row e / 2
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;  // [batch * heads, sq] fp32, or nullptr
  int heads;
  int sq;
  int skv;
  float scale;
};


// How a block fills its stages: cp.async by every thread (the staged form)
// or TMA from one thread.
constexpr int kCpAsync = 0, kTma = 1;

// Head dim kD, kWG warpgroups of 64 query rows, kST stages of kBN K/V rows,
// filled as kMode says (kCpAsync, kTma).
template <typename T, int kD, int kWG, int kBN, int kST, int kMode>
__global__ void __launch_bounds__(kWG * 128, (min_blocks<kD, kWG, kBN, kST>()))
wgmma_attention_kernel(const Params p, const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v) {
  static_assert((kWG == 1 || kWG == 2) && kST >= 2 && (kBN == 64 || kBN == 128), "block shape");
  static_assert(kMode == kTma || (kMode == kCpAsync && kD == kAtomCols), "fill mode");
  constexpr int kAtoms = atoms(kD);
  constexpr int kNThreads = kWG * 128;
  constexpr int kQAtom = kWG * kRowsWG * kAtomRow;  // bytes of one atom of the block's Q
  constexpr int kKVAtom = kBN * kAtomRow;           // bytes of one atom of a K or V tile
  constexpr int kTileBytes = kAtoms * kKVAtom;      // one K or V tile
  extern __shared__ __align__(16) uint8_t smem_raw[];
  // the tiles start on 1024 bytes, where the swizzle pattern starts
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const smem = smem_raw + (base - raw);
  const uint32_t q_addr = base;                              // [atom][kWG * 64][64]
  const uint32_t kv_addr = base + kAtoms * kQAtom;           // stage s: K, then V
  const uint32_t bar_addr = kv_addr + kST * 2 * kTileBytes;  // full[kST], then Q's

  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // row within the 8-row group
  const int t = lane % 4;  // thread within the group
  const int bidx = blockIdx.z;
  const int head = blockIdx.y;
  const int q0 = blockIdx.x * (kWG * kRowsWG);
  const long long feat = static_cast<long long>(p.heads) * kD;
  const int n_tiles = (p.skv + kBN - 1) / kBN;

  const uint16_t* kp = static_cast<const uint16_t*>(p.k) + bidx * p.skv * feat + head * kD;
  const uint16_t* vp = static_cast<const uint16_t*>(p.v) + bidx * p.skv * feat + head * kD;

  if constexpr (kMode == kTma) {
    if (threadIdx.x == 0) {
#pragma unroll
      for (int s = 0; s <= kST; ++s) mbar_init(bar_addr + 8 * s, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      const uint32_t q_bar = bar_addr + 8 * kST;
      mbar_expect_tx(q_bar, kAtoms * kQAtom);
      tma_load_atoms<kAtoms>(q_addr, &tm_q, q_bar, head * kD, q0, bidx, kQAtom);
      for (int s = 0; s < kST && s < n_tiles; ++s) {
        const uint32_t stage = kv_addr + s * 2 * kTileBytes;
        refill<kAtoms, kBN>(stage, bar_addr + 8 * s, &tm_k, &tm_v, head * kD, s * kBN, bidx);
      }
    }
    mbar_wait(bar_addr + 8 * kST, 0);
  } else {
    // Q joins the commit group of tile 0; tiles 0 .. kST - 2, one group
    // each (empty past the last tile, so the group count stays tile + kST - 1)
    const uint16_t* qp = static_cast<const uint16_t*>(p.q) + bidx * p.sq * feat + head * kD;
    load_rows_sw128<kWG * kRowsWG, kNThreads>(smem, qp, feat, q0, p.sq);
#pragma unroll
    for (int s = 0; s < kST - 1; ++s) {
      if (s < n_tiles) {
        uint8_t* stage = smem + kQAtom + s * 2 * kTileBytes;
        load_rows_sw128<kBN, kNThreads>(stage, kp, feat, s * kBN, p.skv);
        load_rows_sw128<kBN, kNThreads>(stage + kTileBytes, vp, feat, s * kBN, p.skv);
      }
      cp_async_commit();
    }
  }

  const uint64_t desc_q = desc_sw128(q_addr + wg * kRowsWG * kAtomRow);
  float o[kD / 2];
#pragma unroll
  for (int i = 0; i < kD / 2; ++i) o[i] = 0.f;
  // rows g and g + 8 of this warp's 16: running max (log2 domain) and sum
  float m_run[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float l_run[2] = {0.f, 0.f};
  const float scale_log2 = p.scale * kLog2e;
  float s[kBN / 2];             // the tile's scores, then exponents
  uint32_t pa[kBN / 16][4];     // P as the A fragments of P.V
  float corr[2], l_tile[2];

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int st = tile % kST;
    if constexpr (kMode == kTma) {
      mbar_wait(bar_addr + 8 * st, (tile / kST) & 1);
    } else {
      // prefetch tile + kST - 1 into the stage the previous tile read
      const int ahead = tile + kST - 1;
      if (ahead < n_tiles) {
        uint8_t* stage = smem + kQAtom + (ahead % kST) * 2 * kTileBytes;
        load_rows_sw128<kBN, kNThreads>(stage, kp, feat, ahead * kBN, p.skv);
        load_rows_sw128<kBN, kNThreads>(stage + kTileBytes, vp, feat, ahead * kBN, p.skv);
      }
      cp_async_commit();
      cp_async_wait<kST - 1>();  // this tile's group (and Q) has landed
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma
      __syncthreads();
    }
    const uint32_t k_addr = kv_addr + st * 2 * kTileBytes;

    fence_regs(s);
    wgmma_fence();
    issue_qk<T, kD, kBN, kQAtom, kKVAtom>(s, desc_q, desc_sw128(k_addr));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    tile_softmax<T, kBN>(s, pa, m_run, corr, l_tile, tile * kBN, p.skv, scale_log2, t);
    rescale(o, l_run, corr, l_tile);

    fence_regs(o);
    wgmma_fence();
    issue_pv<T, kD, kBN>(o, pa, desc_sw128(k_addr + kTileBytes, kKVAtom));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);

    // the stage is read: refill it with tile + kST
    if constexpr (kMode == kTma) {
      asm volatile("bar.sync 1, %0;\n" ::"n"(kNThreads) : "memory");
      if (threadIdx.x == 0 && tile + kST < n_tiles) {
        const int row = (tile + kST) * kBN;
        refill<kAtoms, kBN>(k_addr, bar_addr + 8 * st, &tm_k, &tm_v, head * kD, row, bidx);
      }
    } else {
      __syncthreads();  // the next prefetch overwrites this stage
    }
  }

  // epilogue: divide by l, store in the input type at column head * kD of
  // [B, S, H*D], and the lse of each row; rows at or past sq are not stored
  uint16_t* op = static_cast<uint16_t*>(p.o) + bidx * p.sq * feat + head * kD;
  const float inv[2] = {1.f / l_run[0], 1.f / l_run[1]};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + wg * kRowsWG + warp * 16 + g + r * 8;
    if (row >= p.sq) continue;
#pragma unroll
    for (int j = 0; j < kD / 8; ++j) {
      const uint32_t v =
          MmaOp<T>::pack(o[j * 4 + r * 2] * inv[r], o[j * 4 + r * 2 + 1] * inv[r]);
      *reinterpret_cast<uint32_t*>(op + row * feat + j * 8 + t * 2) = v;
    }
    if (p.lse != nullptr && t == 0) {
      p.lse[((long long)bidx * p.heads + head) * p.sq + row] = m_run[r] * kLn2 + logf(l_run[r]);
    }
  }
}


// Encodes the maps (TMA form), opts in to the shared memory above 48 KB
// once per device, and launches on `stream`, (sq / (kWG * 64)) x heads x
// batch blocks.
template <typename T, int kD, int kWG, int kBN, int kST, int kMode>
int launch(const Params& p, int batch, int dtype, int device, cudaStream_t stream) {
  CUtensorMap maps[3] = {};
  if constexpr (kMode == kTma) {
    const long long feat = static_cast<long long>(p.heads) * kD;
    int err = encode(&maps[0], p.q, dtype, batch, p.sq, feat, feat, kWG * kRowsWG);
    if (err == 0) err = encode(&maps[1], p.k, dtype, batch, p.skv, feat, feat, kBN);
    if (err == 0) err = encode(&maps[2], p.v, dtype, batch, p.skv, feat, feat, kBN);
    if (err != 0) return err;
  }
  constexpr int bytes = smem_bytes<kD, kWG, kBN, kST>();
  static std::atomic<bool> opted_in[kMaxDevices];
  const auto kernel = wgmma_attention_kernel<T, kD, kWG, kBN, kST, kMode>;
  const cudaError_t err = opt_in_smem(kernel, bytes, device, opted_in);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.sq + kWG * kRowsWG - 1) / (kWG * kRowsWG), p.heads, batch);
  kernel<<<grid, kWG * 128, bytes, stream>>>(p, maps[0], maps[1], maps[2]);
  return static_cast<int>(cudaGetLastError());
}

// The TMA form's instantiations at head dim kD with kStages stages, one per
// (warpgroups, K/V tile rows) pair of kShapes (each warpgroups * 1000 + rows),
// in bf16 (dtype 0) and fp16 (1): launches the pair asked for, or returns
// cudaErrorInvalidValue for any other pair or type.
template <int kD, int kStages, int... kShapes>
int launch_shapes(const Params& p, int batch, int dtype, int warpgroups, int kv_tile, int device,
                  cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  int err = static_cast<int>(cudaErrorInvalidValue);
  const int shape = warpgroups * 1000 + kv_tile;
  ((shape == kShapes && dtype == 0
        ? (err = launch<bf16, kD, kShapes / 1000, kShapes % 1000, kStages, kTma>(
               p, batch, dtype, device, stream))
        : 0),
   ...);
  ((shape == kShapes && dtype == 1
        ? (err = launch<__half, kD, kShapes / 1000, kShapes % 1000, kStages, kTma>(
               p, batch, dtype, device, stream))
        : 0),
   ...);
  return err;
}

// B3's shipped stage count: two TMA stages, as B1's.
constexpr int kFlashStages = 2;

// B3 at head dim kD (the TMA form, kFlashStages stages), one head-dim's
// instantiations each: defined in attention_fwd_sm90.cu (64) and
// flash_fwd_sm90_d<kD>.cu.
template <int kD>
int launch_dim(const Params& p, int batch, int dtype, int warpgroups, int kv_tile, int device,
               cudaStream_t stream);
template <>
int launch_dim<40>(const Params&, int, int, int, int, int, cudaStream_t);
template <>
int launch_dim<64>(const Params&, int, int, int, int, int, cudaStream_t);
template <>
int launch_dim<80>(const Params&, int, int, int, int, int, cudaStream_t);
template <>
int launch_dim<128>(const Params&, int, int, int, int, int, cudaStream_t);
template <>
int launch_dim<160>(const Params&, int, int, int, int, int, cudaStream_t);

}  // namespace sm90
}  // namespace pea
