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
// 16-bit columns: a row of D columns spans ceil(D / 64) atoms (1 at D = 40
// and 64, 2 at 80 and 128, 3 at 160), each atom a [rows][128 bytes] block
// on 1024 bytes, in which the 16-byte chunk c of row r sits at chunk
// c ^ (r % 8): what TMA's SWIZZLE_128B writes and the descriptors' swizzle
// mode reads. A K-major k-step moves its descriptor by 32 bytes inside an
// atom and by one atom (rows x 128 bytes) across; V's MN-major descriptor
// steps 16 rows (2048 bytes) a k-step and takes the atom stride as its
// leading byte offset, so that one P.V product spans all of D's atoms.
//
// Padding comes from TMA, not from memory. The tensor maps are 3-D over
// [B, S, H*D] (inner H*D, then S, then B), one 64-column box per atom:
// columns past H*D (B3 at D = 40, 80 and 160) and rows past a batch's last
// row are out of bounds and read as zeros, never the next row's or the
// next batch's values, so D = 40's third k-step (columns 32-47) adds 0 for
// columns 40-47. This holds only while the map's inner extent is H*D, not
// the padded width. Zero fill is not a mask: KV columns >= skv still get
// -1e30. The maps are encoded on the host for each call and passed as
// __grid_constant__ parameters; the encode function is the CUDA driver
// API's cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint (the
// library links no libcuda).
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

#include <cuda.h>

#include "attention_common.cuh"
#include "attention_fwd_sm90.cuh"

namespace pea {
namespace sm90 {

constexpr int kRowsWG = 64;    // query rows per warpgroup (wgmma's M)
constexpr int kAtomCols = 64;  // 16-bit columns of one 128-byte swizzle atom
constexpr int kAtomRow = 128;  // bytes of one atom row
constexpr int kTwoBlocksMaxSmem = 113 * 1024;  // two blocks fit an SM's 228 KB

// 128-byte swizzle atoms per row at head dim `d`.
__host__ __device__ constexpr int atoms(int d) { return (d + kAtomCols - 1) / kAtomCols; }

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

// Descriptor of a 128B-swizzled operand at shared address `addr` (1024-byte
// aligned, or advanced from such an address by whole k-steps): start
// address, leading byte offset `lbo` (an MN-major operand's stride from one
// 64-column atom to the next; K-major operands do not read it), stride byte
// offset 1024 (one 8-row group of the swizzle), swizzle mode 1 (128 bytes)
// in bits 62-63.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo = 1024) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (uint64_t{1024 >> 4} << 32) | (uint64_t{1} << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous products that use them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a 3-D tensor map into shared memory at `dst`, completing
// `bar`'s transaction bytes: c0 the column (inner), c1 the row, c2 the batch.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// A row block's kAtoms boxes of 64 columns from column `col`, into atoms
// `atom_bytes` apart from `dst`.
template <int kAtoms>
__device__ __forceinline__ void tma_load_atoms(uint32_t dst, const CUtensorMap* map,
                                               uint32_t bar, int col, int row, int batch,
                                               int atom_bytes) {
#pragma unroll
  for (int a = 0; a < kAtoms; ++a) {
    tma_load(dst + a * atom_bytes, map, bar, col + a * kAtomCols, row, batch);
  }
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

// The two products of a tile as wgmma instructions, for bf16 and fp16, at
// the widths the body uses. Accumulator element d[j * 4 + e] of a thread is
// row g + 8 * (e / 2) of its warp's 16, column 8 * j + 2 * t + e % 2.
// WgmmaSS<T, N>: S (m64nN, fp32) = A . B^T over one k-step of 16, A and B
// from shared memory, both K-major; scale_d 0 overwrites d, 1 accumulates.
// WgmmaRS<T, N>: O (m64nN, fp32) += A . B over one k-step, A from registers
// (the m16k16 fragment of each warp's 16 rows), B from shared memory,
// MN-major.
template <typename T, int N>
struct WgmmaSS;
template <typename T, int N>
struct WgmmaRS;

// The accumulator operand lists: PEA_F<n>(d, i) is d[i .. i + n) as "+f"
// operands, PEA_REGS<n> the asm text of operands %0 .. %n-1.
#define PEA_F4(d, i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define PEA_F8(d, i) PEA_F4(d, i), PEA_F4(d, i + 4)
#define PEA_F16(d, i) PEA_F8(d, i), PEA_F8(d, i + 8)
#define PEA_F32(d, i) PEA_F16(d, i), PEA_F16(d, i + 16)
#define PEA_REGS20                                                                        \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19"
#define PEA_REGS32 PEA_REGS20 ", %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define PEA_REGS40 PEA_REGS32 ", %32, %33, %34, %35, %36, %37, %38, %39"
#define PEA_REGS64                                                                          \
  PEA_REGS40 ", %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, " \
             "%55, %56, %57, %58, %59, %60, %61, %62, %63"
#define PEA_REGS80 \
  PEA_REGS64 ", %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79"

// N columns in R = N / 2 registers; A, B, SC: the operand numbers (R, R + 1,
// R + 2) of the two descriptors and scale_d.
#define PEA_WGMMA_SS(TYPE, TY, N, R, REGS, A, B, SC, ...)                                  \
  template <>                                                                              \
  struct WgmmaSS<TYPE, N> {                                                                \
    static __device__ __forceinline__ void run(float (&d)[R], uint64_t desc_a,             \
                                               uint64_t desc_b, int scale_d) {             \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" SC ", 0;\n"                        \
                   "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TY "." TY " {" REGS   \
                   "}, %" A ", %" B ", p, 1, 1, 0, 0;\n}\n"                                \
                   : __VA_ARGS__                                                           \
                   : "l"(desc_a), "l"(desc_b), "r"(scale_d));                              \
    }                                                                                      \
  };
// A0-A3, B, SC: the operand numbers (R .. R + 5) of the A fragment, the
// descriptor and scale_d (always 1: P.V accumulates).
#define PEA_WGMMA_RS(TYPE, TY, N, R, REGS, A0, A1, A2, A3, B, SC, ...)                       \
  template <>                                                                                \
  struct WgmmaRS<TYPE, N> {                                                                  \
    static __device__ __forceinline__ void run(float (&d)[R], const uint32_t (&a)[4],        \
                                               uint64_t desc_b) {                            \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" SC ", 0;\n"                          \
                   "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TY "." TY " {" REGS     \
                   "}, {%" A0 ", %" A1 ", %" A2 ", %" A3 "}, %" B ", p, 1, 1, 1;\n}\n"       \
                   : __VA_ARGS__                                                             \
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));       \
    }                                                                                        \
  };
#define PEA_WGMMA_OPS(TYPE, TY)                                                               \
  PEA_WGMMA_SS(TYPE, TY, 64, 32, PEA_REGS32, "32", "33", "34", PEA_F32(d, 0))                 \
  PEA_WGMMA_SS(TYPE, TY, 128, 64, PEA_REGS64, "64", "65", "66", PEA_F32(d, 0), PEA_F32(d, 32)) \
  PEA_WGMMA_RS(TYPE, TY, 40, 20, PEA_REGS20, "20", "21", "22", "23", "24", "25",              \
               PEA_F16(d, 0), PEA_F4(d, 16))                                                  \
  PEA_WGMMA_RS(TYPE, TY, 64, 32, PEA_REGS32, "32", "33", "34", "35", "36", "37",              \
               PEA_F32(d, 0))                                                                 \
  PEA_WGMMA_RS(TYPE, TY, 80, 40, PEA_REGS40, "40", "41", "42", "43", "44", "45",              \
               PEA_F32(d, 0), PEA_F8(d, 32))                                                  \
  PEA_WGMMA_RS(TYPE, TY, 128, 64, PEA_REGS64, "64", "65", "66", "67", "68", "69",             \
               PEA_F32(d, 0), PEA_F32(d, 32))                                                 \
  PEA_WGMMA_RS(TYPE, TY, 160, 80, PEA_REGS80, "80", "81", "82", "83", "84", "85",             \
               PEA_F32(d, 0), PEA_F32(d, 32), PEA_F16(d, 64))
PEA_WGMMA_OPS(__nv_bfloat16, "bf16")
PEA_WGMMA_OPS(__half, "f16")
#undef PEA_WGMMA_OPS
#undef PEA_WGMMA_RS
#undef PEA_WGMMA_SS
#undef PEA_REGS80
#undef PEA_REGS64
#undef PEA_REGS40
#undef PEA_REGS32
#undef PEA_REGS20
#undef PEA_F32
#undef PEA_F16
#undef PEA_F8
#undef PEA_F4

// S = Q.K^T for a warpgroup's 64 rows x kBN KV columns, fp32: ceil(kD / 16)
// k-steps of 32 bytes (2 in descriptor units), four to an atom, then on to
// the next atom of Q (kQAtom bytes on) and of K (kKAtom bytes on).
template <typename T, int kD, int kBN, int kQAtom, int kKAtom>
__device__ __forceinline__ void issue_qk(float (&s)[kBN / 2], uint64_t desc_q, uint64_t desc_k) {
  constexpr int kKSteps = (kD + 15) / 16;
#pragma unroll
  for (int kk = 0; kk < kKSteps; ++kk) {
    const int a = kk / 4, step = 2 * (kk % 4);
    WgmmaSS<T, kBN>::run(s, desc_q + a * (kQAtom >> 4) + step,
                         desc_k + a * (kKAtom >> 4) + step, kk > 0);
  }
}

// O += P.V: V's rows are the k index (KV row), its columns the n index
// (head-dim column); 16 rows of 128 bytes per k-step, 128 in descriptor
// units. P's k-step kk is its column blocks 2 * kk and 2 * kk + 1.
template <typename T, int kD, int kBN>
__device__ __forceinline__ void issue_pv(float (&o)[kD / 2], const uint32_t (&pa)[kBN / 16][4],
                                         uint64_t desc_v) {
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk) WgmmaRS<T, kD>::run(o, pa[kk], desc_v + 128 * kk);
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

// One thread arms a stage's full barrier with the bytes of its K and V
// tiles and starts their TMA copies (KV rows from `row`, each tile kAtoms
// boxes of 64 columns from column `col`).
template <int kAtoms, int kBN>
__device__ __forceinline__ void refill(uint32_t k_addr, uint32_t bar, const CUtensorMap* tm_k,
                                       const CUtensorMap* tm_v, int col, int row, int bidx) {
  constexpr int kAtomBytes = kBN * kAtomRow;
  mbar_expect_tx(bar, 2 * kAtoms * kAtomBytes);
  tma_load_atoms<kAtoms>(k_addr, tm_k, bar, col, row, bidx, kAtomBytes);
  tma_load_atoms<kAtoms>(k_addr + kAtoms * kAtomBytes, tm_v, bar, col, row, bidx, kAtomBytes);
}

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

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of the CUDA driver API, looked up once; nullptr
// where the installed CUDA driver lacks it.
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(f)
               : nullptr;
  }();
  return fn;
}

// A 3-D map over `ptr` as [batch, rows, feat] (dims innermost first: feat,
// rows, batch) whose box is 64 columns x box_rows rows x 1 batch, 128B
// swizzle, zeros past each bound: the inner extent is feat itself, so the
// columns of a box past it read zeros. Returns 0 or kTensorMapError +
// CUresult.
inline int encode(CUtensorMap* map, const void* ptr, int dtype, int batch, int rows,
                  long long feat, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return kTensorMapError + CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(feat), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(feat) * 2,
                                 static_cast<cuuint64_t>(rows) * feat * 2};
  const cuuint32_t box[3] = {kAtomCols, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUresult r = fn(
      map, dtype == 0 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT16, 3,
      const_cast<void*>(ptr), dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kTensorMapError + static_cast<int>(r);
}

// Encodes the maps (TMA form), opts in to the shared memory above 48 KB
// once per device, and launches on `stream`, (sq / (kWG * 64)) x heads x
// batch blocks.
template <typename T, int kD, int kWG, int kBN, int kST, int kMode>
int launch(const Params& p, int batch, int dtype, int device, cudaStream_t stream) {
  CUtensorMap maps[3] = {};
  if constexpr (kMode == kTma) {
    const long long feat = static_cast<long long>(p.heads) * kD;
    int err = encode(&maps[0], p.q, dtype, batch, p.sq, feat, kWG * kRowsWG);
    if (err == 0) err = encode(&maps[1], p.k, dtype, batch, p.skv, feat, kBN);
    if (err == 0) err = encode(&maps[2], p.v, dtype, batch, p.skv, feat, kBN);
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
