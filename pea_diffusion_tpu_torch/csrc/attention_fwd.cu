// Non-causal softmax attention forward for Hopper (sm_90a), behind two C
// entry points built into one library:
//
// - pea_onepass_attention_fwd (B1) reads Q/K/V and writes O in place in
//   the projections' [B, S, H*D] layout. It replaces the TPU kernels
//   pea_diffusion_tpu/ops/onepass_attention.py::_kernel and _kernel_bb
//   (the same function; its batch block and exp2 are TPU tuning).
// - pea_flash_attention_fwd (B3) reads head-major [BH, S, D] and can also
//   store lse. It replaces pea_diffusion_tpu/ops/flash_attention.py::
//   _fwd_kernel.
//
// The two TPU kernels compute the same function on different layouts, so
// one kernel body serves both: each entry point passes the batch, head and
// row strides of its layout.
//
// Schedule. One block of 4 warps owns 64 query rows of one (batch, head);
// each warp owns 16 of them. The block walks K/V in tiles of 64 rows staged
// through shared memory, keeping a running row max m and row sum l in
// registers and rescaling the fp32 output accumulator when m grows (online
// softmax). The TPU kernels held a whole score row in VMEM instead; on
// Hopper a 64-row fp32 score block at S=4096 is 1 MB against 227 KB of
// shared memory, so the row is walked in tiles. The function is the same;
// only the order of the additions differs.
//
// Rounding points follow the JAX kernels: scores Q.K^T accumulate in fp32
// and are multiplied by `scale`; KV columns at or past kv_len are set to
// -1e30; P = exp(S - m) is summed into l in fp32 and cast to the input type
// for P.V, which accumulates in fp32; the output is divided by l at the end
// and stored in the input type. Optionally lse = m + log(l) is stored in
// fp32 (the flash forward's training output). The exponentials are taken
// as exp2 of scores pre-multiplied by scale*log2(e), the same function.
//
// Matrix products use bf16/fp16 mma.sync.m16n8k16 with fp32 accumulation,
// their B operands read from shared memory with ldmatrix (transposed for
// V). The P tile goes from the score accumulators straight into the A
// operand of P.V without leaving registers (the C layout of two adjacent
// m16n8 tiles is the A layout of one m16k16 tile). K/V tiles are copied
// with cp.async into two shared-memory stages, so the copy of tile i+1
// overlaps the math on tile i. wgmma and TMA are later work.
#include <atomic>

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace pea {

constexpr int kBlockM = 64;   // query rows per block (16 per warp)
constexpr int kBlockN = 64;   // K/V rows per shared-memory tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8;       // 16-bit elements of row padding: no bank conflicts
constexpr int kStages = 2;    // K/V tiles in flight
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct AttnParams {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;  // [batch * heads, sq] fp32, or nullptr
  long long q_batch_stride, q_head_stride, q_row_stride;
  long long k_batch_stride, k_head_stride, k_row_stride;
  long long v_batch_stride, v_head_stride, v_row_stride;
  long long o_batch_stride, o_head_stride, o_row_stride;
  int heads;
  int sq;
  int skv;
  float scale;
};

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

// Start copying rows [row0, row0 + kBlockN) of one (batch, head) K or V
// slice into a shared-memory tile; rows at or past `rows` are zero-filled so
// that masked columns contribute exactly 0 to P.V.
template <int D>
__device__ __forceinline__ void load_tile_async(uint16_t* dst, const uint16_t* src,
                                                long long row_stride, int row0,
                                                int rows) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < kBlockN * kChunks; c += kThreads) {
    const int r = c / kChunks;
    const int col = (c % kChunks) * 8;
    const bool valid = row0 + r < rows;
    const uint16_t* from = valid ? src + (long long)(row0 + r) * row_stride + col : src;
    cp_async_16(dst + r * (D + kPad) + col, from, valid);
  }
}

template <int D>
constexpr int smem_bytes() {
  return kStages * 2 * kBlockN * (D + kPad) * 2;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
attention_fwd_kernel(const AttnParams p) {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  constexpr int kKSteps = D / 16;      // k-steps of Q.K^T
  constexpr int kDTiles = D / 8;       // n-tiles of the output
  constexpr int kNTiles = kBlockN / 8; // n-tiles of the score tile
  constexpr int kLd = D + kPad;        // shared-memory row stride
  constexpr int kTile = kBlockN * kLd; // elements of one K or V tile

  extern __shared__ __align__(16) uint16_t smem[];  // [stage][K | V][row][kLd]

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // row within the 8-row group
  const int t = lane % 4;  // thread within the group
  const int bidx = blockIdx.z;
  const int head = blockIdx.y;
  const int row0 = blockIdx.x * kBlockM + warp * 16;

  const uint16_t* qp = static_cast<const uint16_t*>(p.q) + bidx * p.q_batch_stride + head * p.q_head_stride;
  const uint16_t* kp = static_cast<const uint16_t*>(p.k) + bidx * p.k_batch_stride + head * p.k_head_stride;
  const uint16_t* vp = static_cast<const uint16_t*>(p.v) + bidx * p.v_batch_stride + head * p.v_head_stride;

  const int n_tiles = (p.skv + kBlockN - 1) / kBlockN;
  load_tile_async<D>(smem, kp, p.k_row_stride, 0, p.skv);
  load_tile_async<D>(smem + kTile, vp, p.v_row_stride, 0, p.skv);
  cp_async_commit();

  // Q fragments stay in registers for the whole KV walk.
  uint32_t qa[kKSteps][4];
  {
    const int ra = row0 + g, rb = row0 + g + 8;
    const bool va = ra < p.sq, vb = rb < p.sq;
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
      const int c = kk * 16 + t * 2;
      qa[kk][0] = va ? *reinterpret_cast<const uint32_t*>(qp + ra * p.q_row_stride + c) : 0u;
      qa[kk][1] = vb ? *reinterpret_cast<const uint32_t*>(qp + rb * p.q_row_stride + c) : 0u;
      qa[kk][2] = va ? *reinterpret_cast<const uint32_t*>(qp + ra * p.q_row_stride + c + 8) : 0u;
      qa[kk][3] = vb ? *reinterpret_cast<const uint32_t*>(qp + rb * p.q_row_stride + c + 8) : 0u;
    }
  }

  float acc[kDTiles][4];
#pragma unroll
  for (int j = 0; j < kDTiles; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  // rows g and g + 8 of this warp's 16: running max (log2 domain) and sum
  float m_run[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float l_run[2] = {0.f, 0.f};
  const float scale_log2 = p.scale * kLog2e;

  // ldmatrix row addresses: lane i reads row i % 8 of matrix i / 8
  const int lm_row = lane % 8;
  const int lm_mat = lane / 8;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int n0 = tile * kBlockN;
    if (tile + 1 < n_tiles) {  // prefetch the next tile into the other stage
      uint16_t* next = smem + ((tile + 1) % kStages) * 2 * kTile;
      load_tile_async<D>(next, kp, p.k_row_stride, n0 + kBlockN, p.skv);
      load_tile_async<D>(next + kTile, vp, p.v_row_stride, n0 + kBlockN, p.skv);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint16_t* ks = smem + (tile % kStages) * 2 * kTile;
    const uint16_t* vs = ks + kTile;

    // S = Q.K^T for this warp's 16 rows x 64 KV columns, fp32. One
    // ldmatrix.x4 gives the B operands of one n-tile for two k-steps.
    float s[kNTiles][4];
#pragma unroll
    for (int j = 0; j < kNTiles; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kKSteps; kk += 2) {
        uint32_t b[4];
        ldmatrix_x4(b, ks + (j * 8 + lm_row) * kLd + kk * 16 + lm_mat * 8);
        MmaOp<T>::run(s[j], qa[kk], b);
        MmaOp<T>::run(s[j], qa[kk + 1], b + 2);
      }
    }

    // scale into the log2 domain, mask the KV tail, tile row max
    const bool ragged = n0 + kBlockN > p.skv;
    float m_tile[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int j = 0; j < kNTiles; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale_log2;
        if (ragged && n0 + j * 8 + t * 2 + (e & 1) >= p.skv) x = kNegInf;
        s[j][e] = x;
        m_tile[e >> 1] = fmaxf(m_tile[e >> 1], x);
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m_tile[r] = fmaxf(m_tile[r], __shfl_xor_sync(0xffffffffu, m_tile[r], 1));
      m_tile[r] = fmaxf(m_tile[r], __shfl_xor_sync(0xffffffffu, m_tile[r], 2));
      const float m_new = fmaxf(m_run[r], m_tile[r]);
      corr[r] = exp2f(m_run[r] - m_new);  // 0 on the first tile
      m_run[r] = m_new;
    }

    // P = exp(S - m), its row sums, and P in the A layout of P.V
    float l_tile[2] = {0.f, 0.f};
    uint32_t pa[kNTiles / 2][4];
#pragma unroll
    for (int j = 0; j < kNTiles; ++j) {
      const float p0 = exp2f(s[j][0] - m_run[0]);
      const float p1 = exp2f(s[j][1] - m_run[0]);
      const float p2 = exp2f(s[j][2] - m_run[1]);
      const float p3 = exp2f(s[j][3] - m_run[1]);
      l_tile[0] += p0 + p1;
      l_tile[1] += p2 + p3;
      pa[j / 2][(j & 1) * 2 + 0] = MmaOp<T>::pack(p0, p1);
      pa[j / 2][(j & 1) * 2 + 1] = MmaOp<T>::pack(p2, p3);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_tile[r] += __shfl_xor_sync(0xffffffffu, l_tile[r], 1);
      l_tile[r] += __shfl_xor_sync(0xffffffffu, l_tile[r], 2);
      l_run[r] = l_run[r] * corr[r] + l_tile[r];
    }
#pragma unroll
    for (int j = 0; j < kDTiles; ++j) {
      acc[j][0] *= corr[0];
      acc[j][1] *= corr[0];
      acc[j][2] *= corr[1];
      acc[j][3] *= corr[1];
    }

    // O += P.V: one transposed ldmatrix.x4 gives the B operands (k = KV
    // row, n = head-dim column) of two output n-tiles for one k-step
#pragma unroll
    for (int kk = 0; kk < kNTiles / 2; ++kk) {
#pragma unroll
      for (int j = 0; j < kDTiles; j += 2) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, vs + (kk * 16 + (lm_mat & 1) * 8 + lm_row) * kLd +
                                 (j + (lm_mat >> 1)) * 8);
        MmaOp<T>::run(acc[j], pa[kk], b);
        MmaOp<T>::run(acc[j + 1], pa[kk], b + 2);
      }
    }
    __syncthreads();  // the next prefetch overwrites this stage
  }

  // epilogue: divide by l, store in the input type, optional lse
  uint16_t* op = static_cast<uint16_t*>(p.o) + bidx * p.o_batch_stride + head * p.o_head_stride;
  const float inv[2] = {1.f / l_run[0], 1.f / l_run[1]};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + r * 8;
    if (row >= p.sq) continue;
#pragma unroll
    for (int j = 0; j < kDTiles; ++j) {
      const uint32_t v = MmaOp<T>::pack(acc[j][r * 2] * inv[r], acc[j][r * 2 + 1] * inv[r]);
      *reinterpret_cast<uint32_t*>(op + row * p.o_row_stride + j * 8 + t * 2) = v;
    }
    if (p.lse != nullptr && t == 0) {
      p.lse[((long long)bidx * p.heads + head) * p.sq + row] = m_run[r] * kLn2 + logf(l_run[r]);
    }
  }
}

constexpr int kDefaultSmem = 48 * 1024;  // dynamic shared memory without opt-in
constexpr int kMaxDevices = 64;

// Launches one instantiation on the current device (`device`). A kernel
// that needs more than 48 KB of dynamic shared memory (D = 128) opts in
// once per device, the first time it launches there; D = 64 needs 36 KB
// and never calls the attribute.
template <typename T, int D>
inline cudaError_t launch(const AttnParams& p, dim3 grid, int device, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<D>();
  if constexpr (bytes > kDefaultSmem) {
    static std::atomic<bool> opted_in[kMaxDevices];
    if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
    if (!opted_in[device].load(std::memory_order_acquire)) {
      const cudaError_t err = cudaFuncSetAttribute(
          attention_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
      if (err != cudaSuccess) return err;
      opted_in[device].store(true, std::memory_order_release);
    }
  }
  attention_fwd_kernel<T, D><<<grid, kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

// dtype: 0 = bfloat16, 1 = float16. Launches on `device`, switching to it
// only if it is not current, and leaves the caller's current device as it
// was. Returns the launch's CUDA error code.
inline int launch_attention_fwd(const AttnParams& p, int batch, int head_dim,
                                int dtype, int device, cudaStream_t stream) {
  int prev = device;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((p.sq + kBlockM - 1) / kBlockM, p.heads, batch);
  if (dtype == 0 && head_dim == 64) {
    err = launch<__nv_bfloat16, 64>(p, grid, device, stream);
  } else if (dtype == 0 && head_dim == 128) {
    err = launch<__nv_bfloat16, 128>(p, grid, device, stream);
  } else if (dtype == 1 && head_dim == 64) {
    err = launch<__half, 64>(p, grid, device, stream);
  } else if (dtype == 1 && head_dim == 128) {
    err = launch<__half, 128>(p, grid, device, stream);
  } else {
    err = cudaErrorInvalidValue;
  }
  if (prev != device) {
    const cudaError_t restore = cudaSetDevice(prev);
    if (err == cudaSuccess) err = restore;
  }
  return static_cast<int>(err);
}

}  // namespace pea

// B1: one-pass attention on [B, S, H*D]. The kernel reads head h of row s
// at offset s*H*D + h*D, so no head-major transpose touches device memory,
// which was the point of the TPU kernel.
//
// Bound on the H100: at the SDXL self-attention shapes (S = 1024 and 4096,
// D = 64) the work is 4*B*H*S*S*D operations on 8*B*S*H*D bytes, S/2
// operations per byte (512 and 2048), above the card's ~295: it is bound
// by tensor-core operations. The design keeps every score tile in
// registers (nothing of the S x S matrix reaches device memory) and feeds
// the tensor cores with mma.sync.
extern "C" int pea_onepass_attention_fwd(const void* q, const void* k, const void* v,
                                         void* o, int batch, int heads, int sq, int skv,
                                         int head_dim, float scale, int dtype, int device,
                                         void* stream) {
  const long long feat = static_cast<long long>(heads) * head_dim;
  pea::AttnParams p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.lse = nullptr;
  p.q_batch_stride = sq * feat;
  p.o_batch_stride = sq * feat;
  p.k_batch_stride = skv * feat;
  p.v_batch_stride = skv * feat;
  p.q_head_stride = p.k_head_stride = p.v_head_stride = p.o_head_stride = head_dim;
  p.q_row_stride = p.k_row_stride = p.v_row_stride = p.o_row_stride = feat;
  p.heads = heads;
  p.sq = sq;
  p.skv = skv;
  p.scale = scale;
  return pea::launch_attention_fwd(p, batch, head_dim, dtype, device,
                                   static_cast<cudaStream_t>(stream));
}

// B3: flash attention forward on head-major [BH, S, D], with the KV tail
// masked and an optional fp32 lse = m + log(l) per query row. The TPU-only
// parts are dropped: D is not padded to 128 lanes and lse is a plain
// [BH, Sq] array instead of the [BH, 8, Sq] lane layout.
//
// Bound on the H100: on the main path this runs the SDXL cross-attention,
// Sq = 1024 or 4096 query rows against Skv = 52 text tokens at D = 64. The
// work is 4*BH*Sq*Skv*D operations on 2*BH*(2*Sq + 2*Skv)*D bytes, about 50
// operations per byte, below the card's ~295: it is bound by device memory.
// Each query row is read once and written once, and K/V (52 rows, one
// tile) are read once per 64-row block and then hit in L2.
extern "C" int pea_flash_attention_fwd(const void* q, const void* k, const void* v,
                                       void* o, float* lse, int bh, int sq, int skv,
                                       int head_dim, float scale, int dtype, int device,
                                       void* stream) {
  pea::AttnParams p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.lse = lse;
  p.q_batch_stride = static_cast<long long>(sq) * head_dim;
  p.o_batch_stride = static_cast<long long>(sq) * head_dim;
  p.k_batch_stride = static_cast<long long>(skv) * head_dim;
  p.v_batch_stride = static_cast<long long>(skv) * head_dim;
  p.q_head_stride = p.k_head_stride = p.v_head_stride = p.o_head_stride = 0;
  p.q_row_stride = p.k_row_stride = p.v_row_stride = p.o_row_stride = head_dim;
  p.heads = 1;
  p.sq = sq;
  p.skv = skv;
  p.scale = scale;
  return pea::launch_attention_fwd(p, bh, head_dim, dtype, device,
                                   static_cast<cudaStream_t>(stream));
}
