// Primitives of the wgmma + TMA bodies for Hopper (sm_90a), shared by the
// forward (attention_fwd_sm90_body.cuh: B1 and B3) and the backward
// (attention_bwd_sm90_body.cuh: B4 and B5): the 128-byte swizzle's atoms and
// descriptors, the wgmma instructions and their fences, the mbarrier and TMA
// helpers, the two product shapes every attention tile is made of, and the
// tensor-map encode, the CUDA driver API's cuTensorMapEncodeTiled reached
// through cudaGetDriverEntryPoint (the library links no libcuda).
//
// Shared memory holds every 16-bit tile in the 128-byte swizzle, in atoms of
// 64 columns: a row of D columns spans ceil(D / 64) atoms (1 at D = 40 and
// 64, 2 at 80 and 128, 3 at 160), each atom a [rows][128 bytes] block on
// 1024 bytes, in which the 16-byte chunk c of row r sits at chunk c ^ (r %
// 8): what TMA's SWIZZLE_128B writes and the descriptors' swizzle mode
// reads. A K-major k-step moves its descriptor by 32 bytes inside an atom
// and by one atom (rows x 128 bytes) across; an MN-major operand's
// descriptor steps 16 rows (2048 bytes) a k-step and takes the atom stride
// as its leading byte offset, so that one product at N = D spans all of D's
// atoms.
//
// Padding comes from TMA, not from memory: a map's inner extent is the
// tensor's true row width, so the columns of a box past it (D = 40, 80 and
// 160) and the rows past a batch's last row read as zeros. Zero fill is not
// a mask: the kernels still mask what must not count.
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

// One box of a 1-D tensor map (fp32 rows) into shared memory at `dst`,
// completing `bar`'s transaction bytes, from element c0.
__device__ __forceinline__ void tma_load_1d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0)
      : "memory");
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
#define PEA_REGS16 \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
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
  PEA_WGMMA_SS(TYPE, TY, 32, 16, PEA_REGS16, "16", "17", "18", PEA_F16(d, 0))                 \
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
#undef PEA_REGS16
#undef PEA_F32
#undef PEA_F16
#undef PEA_F8
#undef PEA_F4

// S = Q.K^T for a warpgroup's 64 rows x kBN columns, fp32, both operands
// K-major rows of kD columns (Q.K^T; the backward's dO.V^T, K.Q^T and
// V.dO^T): ceil(kD / 16) k-steps of 32 bytes (2 in descriptor units), four
// to an atom, then on to the next atom of A (kAAtom bytes on) and of B
// (kBAtom bytes on).
template <typename T, int kD, int kBN, int kAAtom, int kBAtom>
__device__ __forceinline__ void issue_qk(float (&s)[kBN / 2], uint64_t desc_a, uint64_t desc_b) {
  constexpr int kKSteps = (kD + 15) / 16;
#pragma unroll
  for (int kk = 0; kk < kKSteps; ++kk) {
    const int a = kk / 4, step = 2 * (kk % 4);
    WgmmaSS<T, kBN>::run(s, desc_a + a * (kAAtom >> 4) + step,
                         desc_b + a * (kBAtom >> 4) + step, kk > 0);
  }
}

// O += P.V: V's rows are the k index (KV row), its columns the n index
// (head-dim column); 16 rows of 128 bytes per k-step, 128 in descriptor
// units. P's k-step kk is its column blocks 2 * kk and 2 * kk + 1. The
// backward's dQ += dS.K has the same form.
template <typename T, int kD, int kBN>
__device__ __forceinline__ void issue_pv(float (&o)[kD / 2], const uint32_t (&pa)[kBN / 16][4],
                                         uint64_t desc_v) {
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk) WgmmaRS<T, kD>::run(o, pa[kk], desc_v + 128 * kk);
}

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

// A 3-D map over `ptr` as [batch, rows, row_elems] 16-bit elements, whose
// inner extent is `cols` (dims innermost first: cols, rows, batch), with a
// box of 64 columns x box_rows rows x 1 batch, 128B swizzle, zeros past
// each bound. The callers pass cols = row_elems, the tensor's true row
// width, so that the columns of a box past it read zeros. Returns 0 or
// kTensorMapError + CUresult.
inline int encode(CUtensorMap* map, const void* ptr, int dtype, int batch, int rows,
                  long long cols, long long row_elems, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return kTensorMapError + CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(row_elems) * 2,
                                 static_cast<cuuint64_t>(rows) * row_elems * 2};
  const cuuint32_t box[3] = {kAtomCols, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUresult r = fn(
      map, dtype == 0 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT16, 3,
      const_cast<void*>(ptr), dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kTensorMapError + static_cast<int>(r);
}

// A 1-D map over `n` fp32 values at `ptr` (16-byte aligned) with a box of
// `box` values (a multiple of 4), no swizzle, zeros past the end. Returns 0
// or kTensorMapError + CUresult.
inline int encode_fp32(CUtensorMap* map, const float* ptr, long long n, int box) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return kTensorMapError + CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[1] = {static_cast<cuuint64_t>(n)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(n) * 4};  // not read at rank 1
  const cuuint32_t box_dims[1] = {static_cast<cuuint32_t>(box)};
  const cuuint32_t elem_strides[1] = {1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, const_cast<float*>(ptr), dims,
                        strides, box_dims, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kTensorMapError + static_cast<int>(r);
}

}  // namespace sm90
}  // namespace pea
