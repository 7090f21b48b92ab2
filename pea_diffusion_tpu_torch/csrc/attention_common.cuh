// Building blocks shared by the attention kernels of this directory
// (attention_fwd.cu: B1, B3 and B1's tile variants; attention_bwd.cu: B4,
// B5): tile sizes, the bf16/fp16 mma.sync.m16n8k16 wrapper, ldmatrix,
// cp.async, the tile loader and the per-device launch helpers. Header-only:
// every function is inline.
//
// Head dims. The kernels take D = 40, 64, 80, 128 and 160 (SD1.5's 40, 80
// and 160, SDXL's 64). A product over D runs in k-steps of 16 columns: D =
// 80 has five, an odd number, so the loops that load two k-steps per
// ldmatrix.x4 finish with one x2 load (mma_ksteps). D = 40 is not a
// multiple of 16: its contraction is padded to kDPad = 48 with zeros, on
// both operands. Q and dO fragments read from device memory give 0 for
// columns 40-47 (load_a_fragments; reading them would take the next row's
// values, or run past the tensor's end on its last row), and columns 40-47
// of every shared-memory tile, which cp.async never writes, are zeroed once
// when a block starts (zero_pad_columns), so that no uninitialised bits
// (possibly a NaN) enter a product. The products over KV rows give D / 8
// output n-tiles, five at D = 40: the loops that pair n-tiles per
// transposed ldmatrix.x4 finish with one x2 load (mma_ntiles). D = 160 has
// ten k-steps and twenty n-tiles, so neither tail applies; what it changes
// is the register budget (attention_bwd.cu). The tensors keep their true D:
// nothing is padded in device memory, and the scale is 1/sqrt(D).
#pragma once

#include <atomic>

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace pea {

// The tile shape of the shipped kernels. The forward kernel takes its query
// block, KV tile and stage count as template parameters (the tile variants
// in attention_fwd.cu use other values); the backward kernels use these.
constexpr int kBlockM = 64;   // query rows per block (16 per warp)
constexpr int kBlockN = 64;   // K/V rows per shared-memory tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8;       // 16-bit elements of row padding: no bank conflicts
constexpr int kStages = 2;    // K/V tiles in flight
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// The head dim padded to whole k-steps of 16, and the shared-memory row
// stride: 8 elements past it keep ldmatrix's eight row reads on distinct
// banks (row strides of 112, 144, 176, 272 and 336 bytes).
template <int D>
__host__ __device__ constexpr int k_dpad() { return (D + 15) / 16 * 16; }
template <int D>
__host__ __device__ constexpr int k_ld() { return k_dpad<D>() + kPad; }

template <typename T>
struct MmaOp;

template <>
struct MmaOp<__nv_bfloat16> {
  static __device__ __forceinline__ void run(float* c, const uint32_t* a,
                                             const uint32_t* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};

template <>
struct MmaOp<__half> {
  static __device__ __forceinline__ void run(float* c, const uint32_t* a,
                                             const uint32_t* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 16-bit matrices; lane i gives the address of row i % 8 of matrix
// i / 8 and receives, for each matrix m, r[m] = its elements
// (row lane / 4, columns 2 * (lane % 4) + {0, 1}) — or of the transpose.
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row)));
}

// Two 8x8 matrices; lanes 0-15 give the row addresses (lane i: row i % 8 of
// matrix i / 8), the other lanes' addresses are not read.
__device__ __forceinline__ void ldmatrix_x2(uint32_t* r, const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(row)));
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t* r, const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(row)));
}

// c (one m16n8 tile) += A . B^T over k-steps kk and kk + 1 of the padded
// head dim, or over k-step kk alone when it is the odd last one (D = 40,
// 80): A is a warp's 16 rows as register fragments a[k-step], B's 8 rows
// (the n index) lie in shared memory, `brow` pointing at row (lane % 8) of
// them. Two k-steps take one ldmatrix.x4, a lone one an x2. Callers step
// kk by 2 and, where they run two products over the same k-steps, call it
// for both in turn, so the two products' loads and mma interleave.
template <typename T, int D>
__device__ __forceinline__ void mma_ksteps(float* c, const uint32_t (*a)[4],
                                           const uint16_t* brow, int kk, int lm_mat) {
  if (kk + 1 < k_dpad<D>() / 16) {
    uint32_t b[4];
    ldmatrix_x4(b, brow + kk * 16 + lm_mat * 8);
    MmaOp<T>::run(c, a[kk], b);
    MmaOp<T>::run(c, a[kk + 1], b + 2);
  } else {
    uint32_t b[2];
    ldmatrix_x2(b, brow + kk * 16 + (lm_mat & 1) * 8);
    MmaOp<T>::run(c, a[kk], b);
  }
}

// c += A . B^T over the two k-steps whose A fragments are a[0] and a[1]
// (held for this pair only, where the whole row of fragments would not fit
// in registers): `brow` points at row (lane % 8) of B's 8 rows, at the
// pair's first column. The per-element order of the additions is that of
// mma_ksteps.
template <typename T>
__device__ __forceinline__ void mma_kpair(float* c, const uint32_t (*a)[4],
                                          const uint16_t* brow, int lm_mat) {
  uint32_t b[4];
  ldmatrix_x4(b, brow + lm_mat * 8);
  MmaOp<T>::run(c, a[0], b);
  MmaOp<T>::run(c, a[1], b + 2);
}

// The A fragment (m16k16) of k-step kk of the 16 rows of a shared-memory
// tile of stride k_ld<D> that `rows` points at, read with one ldmatrix.x4:
// the layout load_a_fragments gives from device memory.
template <int D>
__device__ __forceinline__ void ldmatrix_a(uint32_t* a, const uint16_t* rows, int kk,
                                           int lm_row, int lm_mat) {
  ldmatrix_x4(a, rows + ((lm_mat & 1) * 8 + lm_row) * k_ld<D>() + kk * 16 + (lm_mat >> 1) * 8);
}

// acc[j] and acc[j + 1] (output n-tiles of 8 head-dim columns) += A . B,
// or acc[j] alone when it is the odd last n-tile (D = 40), for one k-step
// of 16 rows of a shared-memory tile: A is the m16k16 fragment `a`, B those
// 16 rows with the head dim as n, read transposed (one ldmatrix.x4 for two
// n-tiles, an x2 for one); `brow` points at row (lm_mat & 1) * 8 + lane % 8
// of the 16. Callers step j by 2 over the D / 8 n-tiles.
template <typename T, int D>
__device__ __forceinline__ void mma_ntiles(float (*acc)[4], const uint32_t* a,
                                           const uint16_t* brow, int j, int lm_mat) {
  if (j + 1 < D / 8) {
    uint32_t b[4];
    ldmatrix_x4_trans(b, brow + (j + (lm_mat >> 1)) * 8);
    MmaOp<T>::run(acc[j], a, b);
    MmaOp<T>::run(acc[j + 1], a, b + 2);
  } else {
    uint32_t b[2];
    ldmatrix_x2_trans(b, brow + j * 8);
    MmaOp<T>::run(acc[j], a, b);
  }
}

// Zeroes columns [D, kDPad) of `rows` shared-memory rows of stride k_ld<D>:
// the padded part of the contraction, which cp.async never writes. A block
// of kNThreads threads calls it once before its first copy; nothing to do
// where D % 16 == 0.
template <int D, int kNThreads = kThreads>
__device__ __forceinline__ void zero_pad_columns(uint16_t* smem, int rows) {
  if constexpr (k_dpad<D>() > D) {
    static_assert((k_dpad<D>() - D) % 8 == 0, "pad is whole 16-byte chunks");
    for (int c = threadIdx.x; c < rows * (k_dpad<D>() - D) / 8; c += kNThreads) {
      const int per_row = (k_dpad<D>() - D) / 8;
      *reinterpret_cast<uint4*>(smem + (c / per_row) * k_ld<D>() + D + (c % per_row) * 8) =
          make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// 16-byte asynchronous copy global -> shared; zero-fills when !valid.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// A-operand fragments (m16k16, one per k-step of 16 columns of the padded
// head dim) of the 16 rows [row0, row0 + 16) of a row-major [rows, D]
// slice, read straight from device memory by a warp (g = lane / 4,
// t = lane % 4); rows at or past `rows`, and columns at or past D, read as
// 0. D % 8 == 0, so a column half is wholly in or out of the row, known at
// compile time.
template <int D>
__device__ __forceinline__ void load_a_fragments(uint32_t (*a)[4], const uint16_t* src,
                                                 long long row_stride, int row0, int rows,
                                                 int g, int t) {
  const int ra = row0 + g, rb = row0 + g + 8;
  const bool va = ra < rows, vb = rb < rows;
#pragma unroll
  for (int kk = 0; kk < k_dpad<D>() / 16; ++kk) {
    const int c = kk * 16 + t * 2;
    const bool hi = kk * 16 + 8 < D;  // columns c + 8, c + 9 inside the row
    a[kk][0] = va ? *reinterpret_cast<const uint32_t*>(src + ra * row_stride + c) : 0u;
    a[kk][1] = vb ? *reinterpret_cast<const uint32_t*>(src + rb * row_stride + c) : 0u;
    a[kk][2] = va && hi ? *reinterpret_cast<const uint32_t*>(src + ra * row_stride + c + 8) : 0u;
    a[kk][3] = vb && hi ? *reinterpret_cast<const uint32_t*>(src + rb * row_stride + c + 8) : 0u;
  }
}

// Start copying rows [row0, row0 + kRows) of one (batch, head) slice, D
// columns each, into a shared-memory tile of stride k_ld<D>, by a block of
// kNThreads threads; rows at or past `rows` are zero-filled so that masked
// columns contribute exactly 0.
template <int D, int kRows = kBlockN, int kNThreads = kThreads>
__device__ __forceinline__ void load_tile_async(uint16_t* dst, const uint16_t* src,
                                                long long row_stride, int row0,
                                                int rows) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < kRows * kChunks; c += kNThreads) {
    const int r = c / kChunks;
    const int col = (c % kChunks) * 8;
    const bool valid = row0 + r < rows;
    const uint16_t* from = valid ? src + (long long)(row0 + r) * row_stride + col : src;
    cp_async_16(dst + r * k_ld<D>() + col, from, valid);
  }
}

constexpr int kDefaultSmem = 48 * 1024;  // dynamic shared memory without opt-in
constexpr int kMaxDevices = 64;

// Runs `launch_fn` with `device` current, switching to it only if it is not
// current, and leaves the caller's current device as it was. Returns the
// first CUDA error.
template <typename F>
inline int on_device(int device, F launch_fn) {
  int prev = device;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch_fn();
  if (prev != device) {
    const cudaError_t restore = cudaSetDevice(prev);
    if (err == cudaSuccess) err = restore;
  }
  return static_cast<int>(err);
}

// Raises a kernel's dynamic shared-memory limit to `bytes` once per device
// (`opted_in` is the kernel's own flag array), the first time it launches
// there; kernels within the default 48 KB never call it.
template <typename Kernel>
inline cudaError_t opt_in_smem(Kernel kernel, int bytes, int device,
                               std::atomic<bool>* opted_in) {
  if (bytes <= kDefaultSmem) return cudaSuccess;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (opted_in[device].load(std::memory_order_acquire)) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) opted_in[device].store(true, std::memory_order_release);
  return err;
}

}  // namespace pea
