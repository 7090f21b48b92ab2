// B1 for Hopper at head dim 64: non-causal softmax attention on the
// projections' [B, S, H*D] layout, written for sm_90a's warpgroup matrix
// multiply (wgmma) and Tensor Memory Accelerator (TMA). Entry points:
// onepass_wgmma and onepass_wgmma_shipped (attention_fwd_sm90.cuh), which
// attention_fwd.cu's pea_onepass_attention_fwd (D = 64) and its S1 variant
// table call. It replaces the TPU kernels
// pea_diffusion_tpu/ops/onepass_attention.py::_kernel (:50) and
// _kernel_bb (:78), the same function (the batch block and exp2 are TPU
// tuning). D = 128 and B3 stay on attention_fwd.cu's mma.sync body.
//
// Bound on the H100. At the SDXL self-attention shapes (S = 1024 and 4096)
// the work is 4*B*H*S*S*64 operations on 8*B*S*H*64 bytes: S/2 operations
// per byte (512 and 2048), above the card's ~295, so it is bound by
// tensor-core operations (989 TFLOP/s in bf16 and fp16). The mma.sync body
// reached 18 % of that bound: mma.sync issues 16x8x16 products from one
// warp, with every B operand passed through registers by ldmatrix, and
// wgmma is the only way to the tensor cores' full rate. Here every product
// is a wgmma: a warpgroup (128 threads) issues 64-row products whose
// shared-memory operands the tensor cores read themselves.
//
// Design. A block of kWG consumer warpgroups (1 or 2) owns kWG * 64 query
// rows of one (batch, head). Its Q tile comes into shared memory once, by
// one TMA copy, and stays there for the whole walk over K/V, which comes in
// tiles of 128 rows through a ring of kST stages. One thread (thread 0; no
// producer warp) issues every copy: a stage's full mbarrier is armed with
// the tile's bytes (expect_tx) and the TMA copies complete it; the thread
// refills a stage only after every warpgroup has passed a named barrier
// that marks the stage as read. Per tile and warpgroup:
// - S = Q.K^T: 4 k-steps of wgmma m64n128k16, both operands from shared
//   memory; K's tile, row-major [kv, d], is the K-major B operand, so
//   nothing is transposed.
// - online softmax on the accumulator layout: each thread holds 2 rows
//   (warp*16 + g and + 8) of 32 columns; the row max and sum reduce over
//   the 4 threads of a quad.
// - O += P.V: 8 k-steps of wgmma m64n64k16 with A = P taken from registers
//   (the fp32 score accumulator packs pairwise into the A fragment, cast to
//   the input type) and B = V's tile, row-major [kv, d], the MN-major
//   operand (transpose bit set).
// Shared memory holds every tile in the 128-byte swizzle: a 64-wide row of
// 16-bit values is exactly 128 bytes, and the 16-byte chunk c of row r
// sits at chunk c ^ (r % 8), which is what TMA's SWIZZLE_128B writes and
// the wgmma descriptors' swizzle mode reads; each tile starts on 1024
// bytes. The tensor maps are 3-D over [B, S, H*D] (inner H*D, then S, then
// B), so a box past a batch's last row reads zeros and never the next
// batch's rows; zero fill is not a mask: KV columns >= skv still get -1e30.
// The tensor maps are encoded on the host for each call and passed as
// __grid_constant__ parameters; the encode function is the CUDA driver API's
// cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint (the
// library links no libcuda).
//
// The staged form (kCpAsync) fills the same swizzled layout with cp.async
// by every thread (a proxy fence makes the writes visible to wgmma), and
// syncs the block once per tile. It is kept as an S1 variant.
//
// Rounding points are those of attention_fwd.cu: fp32 scores times scale
// (scale * log2(e), for exp2), KV columns at or past skv set to -1e30, P =
// exp(S - m) summed in fp32 and cast to the input type for P.V, which
// accumulates in fp32, and the output divided by l at the end and stored
// in the input type. Only the order of the additions differs (128-column
// tiles).
#include <cuda.h>

#include "attention_common.cuh"
#include "attention_fwd_sm90.cuh"

namespace pea {
namespace sm90 {

constexpr int kD = 64;                       // head dim: one 128-byte row
constexpr int kRowsWG = 64;                  // query rows per warpgroup (wgmma's M)
constexpr int kBN = 128;                     // K/V rows per tile
constexpr int kRowBytes = kD * 2;            // 128, the swizzle's width
constexpr int kQBytes = kRowsWG * kRowBytes;  // 8 KB per warpgroup
constexpr int kTileBytes = kBN * kRowBytes;   // 16 KB per K or V tile

// 1 KB of alignment slack, Q, kST (K, V) stages, kST + 1 mbarriers.
template <int kWG, int kST>
constexpr int smem_bytes() {
  return 1024 + kWG * kQBytes + kST * 2 * kTileBytes + (kST + 1) * 8;
}

// Descriptor of a 128B-swizzled tile at shared address `addr` (1024-byte
// aligned, or advanced from such an address by whole k-steps): start
// address, leading and stride byte offsets of 1024 (one 8-row swizzle atom;
// only the stride between 8-row groups is used at these widths), swizzle
// mode 1 (128 bytes) in bits 62-63.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (uint64_t{1024 >> 4} << 16) |
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
    cp_async_16(dst + r * kRowBytes + ((chunk ^ (r & 7)) * 16), from, valid);
  }
}

// The two products of a tile as wgmma instructions, for bf16 and fp16.
template <typename T>
struct Wgmma;

// S (m64n128, fp32) = A . B^T over one k-step of 16: A and B from shared
// memory, both K-major; scale_d 0 overwrites d, 1 accumulates.
// O (m64n64, fp32) += A . B over one k-step: A from registers (the m16k16
// fragment of each warp's 16 rows), B from shared memory, MN-major.
#define PEA_WGMMA_OPS(TYPE, TY)                                                                \
  template <>                                                                                  \
  struct Wgmma<TYPE> {                                                                         \
  static __device__ __forceinline__ void qk(float (&d)[64], uint64_t desc_a, uint64_t desc_b,  \
                                             int scale_d) {                                    \
    asm volatile(                                                                              \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                                           \
        "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {"                          \
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "               \
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "     \
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "     \
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"       \
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"                                                     \
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]) \
        : "l"(desc_a), "l"(desc_b), "r"(scale_d));                                             \
  }                                                                                            \
                                                                                               \
  static __device__ __forceinline__ void pv(float (&d)[32], const uint32_t (&a)[4],            \
                                             uint64_t desc_b) {                                \
    asm volatile(                                                                              \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                                           \
        "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"                           \
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "               \
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"       \
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"                                       \
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]) \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));                    \
  }                                                                                            \
  };
PEA_WGMMA_OPS(__nv_bfloat16, "bf16")
PEA_WGMMA_OPS(__half, "f16")
#undef PEA_WGMMA_OPS

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int heads;
  int sq;
  int skv;
  float scale;
};

// S = Q.K^T for a warpgroup's 64 rows x 128 KV columns, fp32: 4 k-steps
// of 32 bytes (2 in descriptor units) along both tiles' rows.
template <typename T>
__device__ __forceinline__ void issue_qk(float (&s)[64], uint64_t desc_q, uint64_t desc_k) {
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) Wgmma<T>::qk(s, desc_q + 2 * kk, desc_k + 2 * kk, kk > 0);
}

// O += P.V: V's rows are the k index (KV row), its columns the n index
// (head-dim column); 16 rows of 128 bytes per k-step, 128 in descriptor
// units. P's k-step kk is its column blocks 2 * kk and 2 * kk + 1.
template <typename T>
__device__ __forceinline__ void issue_pv(float (&o)[32], const uint32_t (&pa)[kBN / 16][4],
                                         uint64_t desc_v) {
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk) Wgmma<T>::pv(o, pa[kk], desc_v + 128 * kk);
}

// One tile's scores into P. Thread element s[j * 4 + e] is row g + 8 *
// (e / 2), column n0 + 8 * j + 2 * t + e % 2: scale into the log2 domain,
// set columns at or past skv to -1e30, fold the tile's row max (over the
// quad) into m_run, with corr the factor that rescales what was summed
// under the old max (0 on the first tile); P = exp2(S - m) packed into the
// A fragments pa, and l_tile its row sums over the quad.
template <typename T>
__device__ __forceinline__ void tile_softmax(float (&s)[64], uint32_t (&pa)[kBN / 16][4],
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
__device__ __forceinline__ void rescale(float (&o)[32], float (&l_run)[2], const float (&corr)[2],
                                        const float (&l_tile)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * corr[r] + l_tile[r];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] *= corr[(i >> 1) & 1];  // o[j * 4 + e]: row e / 2
}

// One thread arms a stage's full barrier with the bytes of its K and V
// tiles and starts their TMA copies (KV rows from tile * 128).
__device__ __forceinline__ void refill(uint32_t k_addr, uint32_t bar, const CUtensorMap* tm_k,
                                       const CUtensorMap* tm_v, int head, int tile, int bidx) {
  mbar_expect_tx(bar, 2 * kTileBytes);
  tma_load(k_addr, tm_k, bar, head * kD, tile * kBN, bidx);
  tma_load(k_addr + kTileBytes, tm_v, bar, head * kD, tile * kBN, bidx);
}

// How a block fills its stages: cp.async by every thread (the staged form)
// or TMA from one thread.
constexpr int kCpAsync = 0, kTma = 1;

// kWG warpgroups of 64 query rows, kST stages of 128 K/V rows, filled as
// kMode says (kCpAsync, kTma).
template <typename T, int kWG, int kST, int kMode>
__global__ void __launch_bounds__(kWG * 128, 2)
onepass_wgmma_kernel(const Params p, const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v) {
  static_assert((kWG == 1 || kWG == 2) && kST >= 2, "block shape");
  static_assert(kMode == kCpAsync || kMode == kTma, "fill mode");
  constexpr int kNThreads = kWG * 128;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  // the tiles start on 1024 bytes, where the swizzle pattern starts
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const smem = smem_raw + (base - raw);
  const uint32_t q_addr = base;                          // [kWG * 64][64]
  const uint32_t kv_addr = base + kWG * kQBytes;         // stage s: K, then V
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
      mbar_expect_tx(q_bar, kWG * kQBytes);
      tma_load(q_addr, &tm_q, q_bar, head * kD, q0, bidx);
      for (int s = 0; s < kST && s < n_tiles; ++s) {
        const uint32_t stage = kv_addr + s * 2 * kTileBytes;
        mbar_expect_tx(bar_addr + 8 * s, 2 * kTileBytes);
        tma_load(stage, &tm_k, bar_addr + 8 * s, head * kD, s * kBN, bidx);
        tma_load(stage + kTileBytes, &tm_v, bar_addr + 8 * s, head * kD, s * kBN, bidx);
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
        uint8_t* stage = smem + kWG * kQBytes + s * 2 * kTileBytes;
        load_rows_sw128<kBN, kNThreads>(stage, kp, feat, s * kBN, p.skv);
        load_rows_sw128<kBN, kNThreads>(stage + kTileBytes, vp, feat, s * kBN, p.skv);
      }
      cp_async_commit();
    }
  }

  const uint64_t desc_q = desc_sw128(q_addr + wg * kQBytes);
  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  // rows g and g + 8 of this warp's 16: running max (log2 domain) and sum
  float m_run[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float l_run[2] = {0.f, 0.f};
  const float scale_log2 = p.scale * kLog2e;
  float s[64];                // the tile's scores, then exponents
  uint32_t pa[kBN / 16][4];   // P as the A fragments of P.V
  float corr[2], l_tile[2];

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int st = tile % kST;
    if constexpr (kMode == kTma) {
      mbar_wait(bar_addr + 8 * st, (tile / kST) & 1);
    } else {
      // prefetch tile + kST - 1 into the stage the previous tile read
      const int ahead = tile + kST - 1;
      if (ahead < n_tiles) {
        uint8_t* stage = smem + kWG * kQBytes + (ahead % kST) * 2 * kTileBytes;
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
    issue_qk<T>(s, desc_q, desc_sw128(k_addr));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    tile_softmax<T>(s, pa, m_run, corr, l_tile, tile * kBN, p.skv, scale_log2, t);
    rescale(o, l_run, corr, l_tile);

    fence_regs(o);
    wgmma_fence();
    issue_pv<T>(o, pa, desc_sw128(k_addr + kTileBytes));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);

    // the stage is read: refill it with tile + kST
    if constexpr (kMode == kTma) {
      asm volatile("bar.sync 1, %0;\n" ::"n"(kNThreads) : "memory");
      if (threadIdx.x == 0 && tile + kST < n_tiles) {
        refill(k_addr, bar_addr + 8 * st, &tm_k, &tm_v, head, tile + kST, bidx);
      }
    } else {
      __syncthreads();  // the next prefetch overwrites this stage
    }
  }

  // epilogue: divide by l, store in the input type at column head * 64 of
  // [B, S, H*D]; rows at or past sq are not stored
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
// swizzle, zeros past each bound. Returns 0 or kTensorMapError + CUresult.
inline int encode(CUtensorMap* map, const void* ptr, int dtype, int batch, int rows,
                  long long feat, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return kTensorMapError + CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(feat), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(feat) * 2,
                                 static_cast<cuuint64_t>(rows) * feat * 2};
  const cuuint32_t box[3] = {kD, static_cast<cuuint32_t>(box_rows), 1};
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
template <typename T, int kWG, int kST, int kMode>
int launch(const Params& p, int batch, int dtype, int device, cudaStream_t stream) {
  CUtensorMap maps[3] = {};
  if constexpr (kMode == kTma) {
    const long long feat = static_cast<long long>(p.heads) * kD;
    int err = encode(&maps[0], p.q, dtype, batch, p.sq, feat, kWG * kRowsWG);
    if (err == 0) err = encode(&maps[1], p.k, dtype, batch, p.skv, feat, kBN);
    if (err == 0) err = encode(&maps[2], p.v, dtype, batch, p.skv, feat, kBN);
    if (err != 0) return err;
  }
  constexpr int bytes = smem_bytes<kWG, kST>();
  static std::atomic<bool> opted_in[kMaxDevices];
  const auto kernel = onepass_wgmma_kernel<T, kWG, kST, kMode>;
  const cudaError_t err = opt_in_smem(kernel, bytes, device, opted_in);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.sq + kWG * kRowsWG - 1) / (kWG * kRowsWG), p.heads, batch);
  kernel<<<grid, kWG * 128, bytes, stream>>>(p, maps[0], maps[1], maps[2]);
  return static_cast<int>(cudaGetLastError());
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
// for S1, and the two shipped ones in fp16 too.
int onepass_wgmma(const void* q, const void* k, const void* v, void* o, int batch, int heads,
                  int sq, int skv, float scale, int dtype, int warpgroups, int stages, int mode,
                  int device, cudaStream_t stream) {
  using sm90::kCpAsync, sm90::kTma, sm90::launch;
  using bf16 = __nv_bfloat16;
  const sm90::Params p{q, k, v, o, heads, sq, skv, scale};
  const int shape = warpgroups * 100 + stages * 10 + mode;
  return on_device(device, [&]() -> cudaError_t {
    int err = static_cast<int>(cudaErrorInvalidValue);
    if (dtype == 0) {
      if (shape == 120 + kTma) err = launch<bf16, 1, 2, kTma>(p, batch, dtype, device, stream);
      if (shape == 220 + kTma) err = launch<bf16, 2, 2, kTma>(p, batch, dtype, device, stream);
      if (shape == 230 + kTma) err = launch<bf16, 2, 3, kTma>(p, batch, dtype, device, stream);
      if (shape == 120 + kCpAsync) {
        err = launch<bf16, 1, 2, kCpAsync>(p, batch, dtype, device, stream);
      }
    } else if (dtype == 1) {
      if (shape == 120 + kTma) err = launch<__half, 1, 2, kTma>(p, batch, dtype, device, stream);
      if (shape == 220 + kTma) err = launch<__half, 2, 2, kTma>(p, batch, dtype, device, stream);
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

}  // namespace pea
