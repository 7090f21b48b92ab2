// Non-causal softmax attention forward for Hopper (sm_90a), behind these C
// entry points built into one library:
//
// - pea_onepass_attention_fwd (B1) reads Q/K/V and writes O in place in
//   the projections' [B, S, H*D] layout. It replaces the TPU kernels
//   pea_diffusion_tpu/ops/onepass_attention.py::_kernel and _kernel_bb
//   (the same function; its batch block and exp2 are TPU tuning). At head
//   dim 64 (every B1 call of the paths) it runs the wgmma + TMA body of
//   attention_fwd_sm90_body.cuh; at 128, the mma.sync body below.
// - pea_flash_attention_fwd (B3) reads head-major [BH, S, D] and can also
//   store lse. It replaces pea_diffusion_tpu/ops/flash_attention.py::
//   _fwd_kernel. It runs the variant its shipped rule picks for the shape
//   (shipped_flash_variant): the wgmma + TMA body of
//   attention_fwd_sm90_body.cuh, or the mma.sync body below.
// - pea_flash_attention_fwd_variant runs B3 in one of a fixed set of
//   variants (the mma.sync body, the wgmma body's warpgroups and K/V tile),
//   for the smoke's timings; pea_flash_variant_count, pea_flash_variant_name
//   and pea_flash_shipped_variant list the set and the rule.
// - pea_onepass_attention_fwd_variant (S1) runs B1 in one of a fixed set
//   of tile shapes of either body, for the sweep tool
//   (tools/sweep_onepass.py of the port). It replaces the TPU tuning variants of tools/sweep_onepass.py
//   (_kernel_variant and _kernel_bb); pea_onepass_variant_count and
//   pea_onepass_variant_name list the set.
//
// The two TPU kernels compute the same function on different layouts, so
// one kernel body serves both: each entry point passes the batch, head and
// row strides of its layout.
//
// Schedule. One block of kBM / 16 warps owns kBM query rows of one (batch,
// head); each warp owns 16 of them. The block walks K/V in tiles of kBN
// rows staged through kST shared-memory stages, keeping a running row max m and row sum l in
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
// with cp.async into the stages, so the copies of tiles i+1 .. i+kST-1
// overlap the math on tile i. The shipped entry points run kBM = kBN = 64
// and kST = 2 (kBlockM, kBlockN, kStages); the variants are listed at
// pea_onepass_attention_fwd_variant. B1 at D = 64 and B3 run on wgmma and
// TMA instead (attention_fwd_sm90_body.cuh), except where B3's shipped rule
// keeps this body; B1 at D = 128 stays here.
//
// D = 160 (SD1.5's level 2 and mid block at 1024^2 and up) runs the same
// body as a B3 variant: its fp32 output accumulator is 80 registers a
// thread beside the Q fragments (40) and the score tile (32), and its two
// 64-row K/V stages are 86,016 bytes of shared memory, above the default
// 48 KB (opt-in).
#include "attention_common.cuh"
#include "attention_fwd_sm90.cuh"

namespace pea {

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

template <int D, int kBN, int kST>
constexpr int smem_bytes() {
  return kST * 2 * kBN * k_ld<D>() * 2;
}

// kBM query rows per block (kBM / 16 warps, 2 * kBM threads), kBN K/V rows
// per tile, kST stages.
template <typename T, int D, int kBM, int kBN, int kST>
__global__ void __launch_bounds__(2 * kBM)
attention_fwd_kernel(const AttnParams p) {
  static_assert(D % 8 == 0, "head_dim must be a multiple of 8");
  static_assert(kBM % 16 == 0 && kBN % 16 == 0 && kST >= 2, "tile shape");
  constexpr int kNThreads = 2 * kBM;
  constexpr int kKSteps = k_dpad<D>() / 16;  // k-steps of Q.K^T
  constexpr int kDTiles = D / 8;             // n-tiles of the output
  constexpr int kNTiles = kBN / 8;           // n-tiles of the score tile
  constexpr int kLd = k_ld<D>();             // shared-memory row stride
  constexpr int kTile = kBN * kLd;           // elements of one K or V tile

  extern __shared__ __align__(16) uint16_t smem[];  // [stage][K | V][row][kLd]

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // row within the 8-row group
  const int t = lane % 4;  // thread within the group
  const int bidx = blockIdx.z;
  const int head = blockIdx.y;
  const int row0 = blockIdx.x * kBM + warp * 16;

  const uint16_t* qp = static_cast<const uint16_t*>(p.q) + bidx * p.q_batch_stride + head * p.q_head_stride;
  const uint16_t* kp = static_cast<const uint16_t*>(p.k) + bidx * p.k_batch_stride + head * p.k_head_stride;
  const uint16_t* vp = static_cast<const uint16_t*>(p.v) + bidx * p.v_batch_stride + head * p.v_head_stride;

  const int n_tiles = (p.skv + kBN - 1) / kBN;
  zero_pad_columns<D, kNThreads>(smem, kST * 2 * kBN);
  // tiles 0 .. kST - 2 into their stages, one commit group each (empty
  // past the last tile, so that the group count stays tile + kST - 1)
#pragma unroll
  for (int st = 0; st < kST - 1; ++st) {
    if (st < n_tiles) {
      load_tile_async<D, kBN, kNThreads>(smem + st * 2 * kTile, kp, p.k_row_stride, st * kBN,
                                         p.skv);
      load_tile_async<D, kBN, kNThreads>(smem + st * 2 * kTile + kTile, vp, p.v_row_stride,
                                         st * kBN, p.skv);
    }
    cp_async_commit();
  }

  // Q fragments stay in registers for the whole KV walk.
  uint32_t qa[kKSteps][4];
  load_a_fragments<D>(qa, qp, p.q_row_stride, row0, p.sq, g, t);

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
    const int n0 = tile * kBN;
    // prefetch tile + kST - 1 into the stage the previous iteration read
    const int ahead = tile + kST - 1;
    if (ahead < n_tiles) {
      uint16_t* next = smem + (ahead % kST) * 2 * kTile;
      load_tile_async<D, kBN, kNThreads>(next, kp, p.k_row_stride, ahead * kBN, p.skv);
      load_tile_async<D, kBN, kNThreads>(next + kTile, vp, p.v_row_stride, ahead * kBN, p.skv);
    }
    cp_async_commit();
    cp_async_wait<kST - 1>();  // this tile's group has landed
    __syncthreads();
    const uint16_t* ks = smem + (tile % kST) * 2 * kTile;
    const uint16_t* vs = ks + kTile;

    // S = Q.K^T for this warp's 16 rows x kBN KV columns, fp32
    float s[kNTiles][4];
#pragma unroll
    for (int j = 0; j < kNTiles; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kKSteps; kk += 2)
        mma_ksteps<T, D>(s[j], qa, ks + (j * 8 + lm_row) * kLd, kk, lm_mat);
    }

    // scale into the log2 domain, mask the KV tail, tile row max
    const bool ragged = n0 + kBN > p.skv;
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

    // O += P.V: V's rows are the k index (KV row), its columns the n index
    // (head-dim column), read transposed
#pragma unroll
    for (int kk = 0; kk < kNTiles / 2; ++kk) {
#pragma unroll
      for (int j = 0; j < kDTiles; j += 2)
        mma_ntiles<T, D>(acc, pa[kk], vs + (kk * 16 + (lm_mat & 1) * 8 + lm_row) * kLd, j,
                         lm_mat);
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

// Launches one instantiation on the current device (`device`), `batch`
// blocks deep. Above the default 48 KB of dynamic shared memory (D = 128
// and 160 in the shipped shape, the variants with 128-row tiles or three
// stages) it opts in once per device; D = 40, 64 and 80 need 28, 36 and
// 44 KB.
template <typename T, int D, int kBM = kBlockM, int kBN = kBlockN, int kST = kStages>
inline cudaError_t launch(const AttnParams& p, int batch, int device, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<D, kBN, kST>();
  static std::atomic<bool> opted_in[kMaxDevices];
  const auto kernel = attention_fwd_kernel<T, D, kBM, kBN, kST>;
  const cudaError_t err = opt_in_smem(kernel, bytes, device, opted_in);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.sq + kBM - 1) / kBM, p.heads, batch);
  kernel<<<grid, 2 * kBM, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
inline cudaError_t launch_dim(const AttnParams& p, int batch, int head_dim, int device,
                              cudaStream_t stream) {
  if (head_dim == 40) return launch<T, 40>(p, batch, device, stream);
  if (head_dim == 64) return launch<T, 64>(p, batch, device, stream);
  if (head_dim == 80) return launch<T, 80>(p, batch, device, stream);
  if (head_dim == 128) return launch<T, 128>(p, batch, device, stream);
  if (head_dim == 160) return launch<T, 160>(p, batch, device, stream);
  return cudaErrorInvalidValue;
}

// dtype: 0 = bfloat16, 1 = float16. Launches on `device` and returns the
// launch's CUDA error code.
inline int launch_attention_fwd(const AttnParams& p, int batch, int head_dim,
                                int dtype, int device, cudaStream_t stream) {
  return on_device(device, [&]() -> cudaError_t {
    if (dtype == 0) return launch_dim<__nv_bfloat16>(p, batch, head_dim, device, stream);
    if (dtype == 1) return launch_dim<__half>(p, batch, head_dim, device, stream);
    return cudaErrorInvalidValue;
  });
}

// The strides of B1's [B, S, H*D] layout.
inline AttnParams onepass_params(const void* q, const void* k, const void* v, void* o,
                                 int heads, int sq, int skv, int head_dim, float scale) {
  const long long feat = static_cast<long long>(heads) * head_dim;
  AttnParams p;
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
  return p;
}

// S1: B1's tile variants at D = 64 in bf16, the CUDA counterpart of the TPU
// tool's axes. The mma.sync body above (q<rows>_kv<rows>_s<stages>): the
// query block (64 or 128 rows: 4 or 8 warps, the JAX tool's bq), the KV
// tile (64 or 128 rows: more work per step) and the copy depth (2 or 3
// stages); every combination fits in shared memory (at most 3 * 2 * 128
// rows * 144 bytes = 110,592); q64_kv64_s2 is its shipped tile shape (B1's
// at D = 128, and B3's mma_sync variant's). The wgmma body of attention_fwd_sm90_body.cuh
// (wg<warpgroups>_kv128_s<stages>, _cpasync for the staged form without
// TMA): 1 or 2 warpgroups of 64 query rows, 2 or 3 stages of 128 K/V rows;
// all give the bits of the instantiations B1 ships there. The TPU tool's other axes
// have no variant here: exp2 with log2(e) folded into the scale is already
// in the shipped kernel, and its two-head interleave (MXU and VPU work of
// two heads overlapped) and batch blocking (several batch rows per grid
// step) schedule a TPU core's units and its sequential grid; on Hopper the
// warps of a block and the blocks on an SM overlap by themselves.
struct Variant {
  const char* name;
  cudaError_t (*run)(const AttnParams&, int, int, cudaStream_t);
};
template <int kWG, int kST, int kMode>
cudaError_t wgmma_variant(const AttnParams& p, int batch, int device, cudaStream_t stream) {
  return static_cast<cudaError_t>(onepass_wgmma(p.q, p.k, p.v, p.o, batch, p.heads, p.sq, p.skv,
                                                p.scale, 0, kWG, kST, kMode, device, stream));
}
constexpr Variant kVariants[] = {
    {"q64_kv64_s2", launch<__nv_bfloat16, 64, 64, 64, 2>},
    {"q64_kv64_s3", launch<__nv_bfloat16, 64, 64, 64, 3>},
    {"q64_kv128_s2", launch<__nv_bfloat16, 64, 64, 128, 2>},
    {"q64_kv128_s3", launch<__nv_bfloat16, 64, 64, 128, 3>},
    {"q128_kv64_s2", launch<__nv_bfloat16, 64, 128, 64, 2>},
    {"q128_kv64_s3", launch<__nv_bfloat16, 64, 128, 64, 3>},
    {"q128_kv128_s2", launch<__nv_bfloat16, 64, 128, 128, 2>},
    {"q128_kv128_s3", launch<__nv_bfloat16, 64, 128, 128, 3>},
    {"wg1_kv128_s2", wgmma_variant<1, 2, 1>},
    {"wg2_kv128_s2", wgmma_variant<2, 2, 1>},
    {"wg2_kv128_s3", wgmma_variant<2, 3, 1>},
    {"wg1_kv128_s2_cpasync", wgmma_variant<1, 2, 0>},
};
constexpr int kNumVariants = sizeof(kVariants) / sizeof(kVariants[0]);

// B3's variants: the mma.sync body above at its shipped tile (kBlockM,
// kBlockN, kStages; B3's earlier body), kept as the yardstick, and the
// wgmma + TMA body (attention_fwd_sm90_body.cuh) with 1 or 2 warpgroups of
// 64 query rows and K/V tiles of 128 or 64 rows, at the head dims each is
// built for (each head dim's launch_dim; any other returns
// cudaErrorInvalidValue). All give the same function; B3 ships the one its
// rule picks, with the bits of that variant.
struct FlashVariant {
  const char* name;
  int warpgroups;  // 0: the mma.sync body
  int kv_tile;
};
constexpr FlashVariant kFlashVariants[] = {
    {"mma_sync", 0, kBlockN}, {"wg1_kv128", 1, 128}, {"wg2_kv128", 2, 128},
    {"wg1_kv64", 1, 64},      {"wg2_kv64", 2, 64},
};
constexpr int kNumFlashVariants = sizeof(kFlashVariants) / sizeof(kFlashVariants[0]);

// The index of the variant of kFlashVariants with this shape.
constexpr int flash_variant(int warpgroups, int kv_tile) {
  for (int i = 0; i < kNumFlashVariants; ++i) {
    if (kFlashVariants[i].warpgroups == warpgroups && kFlashVariants[i].kv_tile == kv_tile) {
      return i;
    }
  }
  return -1;
}

// B3 as it ships, from the smoke's times of every variant at the paths'
// shapes (PERF.md, B3): blocks of two warpgroups (one-warpgroup blocks ran
// 1.3-2x slower at every self-attention shape); at D = 40 K/V tiles of 128
// rows (64-row ones 5-14 % slower), but up to kFlashShortKv KV rows
// (cross-attention, one tile) the mma.sync body, measured up to 10 % faster
// there than the 64-row wgmma tiles; from D = 64 on K/V tiles of 64 rows
// (rows of two or three swizzle atoms: 128-row tiles leave one block an SM;
// at D = 64 the 128-row two-warpgroup instantiation is capped at 128
// registers and spills, the 64-row one takes 103 and measured within 5 %).
constexpr int kFlashShortKv = 64;

inline int shipped_flash_variant(int skv, int head_dim) {
  if (head_dim != 40) return flash_variant(2, 64);
  return skv <= kFlashShortKv ? flash_variant(0, kBlockN) : flash_variant(2, 128);
}

// B3 in variant `variant` of kFlashVariants (flash_params: head-major
// strides for the mma.sync body).
inline int flash_fwd_variant(const void* q, const void* k, const void* v, void* o, float* lse,
                             int bh, int sq, int skv, int head_dim, float scale, int dtype,
                             int variant, int device, cudaStream_t stream) {
  if (variant < 0 || variant >= kNumFlashVariants) return static_cast<int>(cudaErrorInvalidValue);
  const FlashVariant& var = kFlashVariants[variant];
  if (var.warpgroups > 0) {
    return flash_wgmma(q, k, v, o, lse, bh, sq, skv, head_dim, scale, dtype, var.warpgroups,
                       var.kv_tile, device, stream);
  }
  AttnParams p;
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
  return launch_attention_fwd(p, bh, head_dim, dtype, device, stream);
}

}  // namespace pea

// B1: one-pass attention on [B, S, H*D]. The kernel reads head h of row s
// at offset s*H*D + h*D, so no head-major transpose touches device memory,
// which was the point of the TPU kernel.
//
// Bound on the H100: at the SDXL self-attention shapes (S = 1024 and 4096,
// D = 64) the work is 4*B*H*S*S*D operations on 8*B*S*H*D bytes, S/2
// operations per byte (512 and 2048), above the card's ~295: it is bound
// by tensor-core operations. Both bodies keep every score tile in
// registers (nothing of the S x S matrix reaches device memory); D = 64
// feeds the tensor cores with wgmma (attention_fwd_sm90_body.cuh), D = 128 with
// mma.sync. Nothing falls back from one body to the other.
extern "C" int pea_onepass_attention_fwd(const void* q, const void* k, const void* v,
                                         void* o, int batch, int heads, int sq, int skv,
                                         int head_dim, float scale, int dtype, int device,
                                         void* stream) {
  if (head_dim == 64) {
    return pea::onepass_wgmma_shipped(q, k, v, o, batch, heads, sq, skv, scale, dtype, device,
                                      static_cast<cudaStream_t>(stream));
  }
  const pea::AttnParams p = pea::onepass_params(q, k, v, o, heads, sq, skv, head_dim, scale);
  return pea::launch_attention_fwd(p, batch, head_dim, dtype, device,
                                   static_cast<cudaStream_t>(stream));
}

// B3: flash attention forward on head-major [BH, S, D], with the KV tail
// masked and an optional fp32 lse = m + log(l) per query row. The TPU-only
// parts are dropped: D is not padded to 128 lanes and lse is a plain
// [BH, Sq] array instead of the [BH, 8, Sq] lane layout.
//
// Bound on the H100: the self-attention (Sq = Skv = S: SD1.5's levels 0-2
// at S = 1024 to 16384, D = 40, 80, 160; SDXL training's student at S =
// 1600, D = 64) is 4*BH*S*S*D operations on 8*BH*S*D bytes, S/2 operations
// per byte (512 to 8192), above the card's ~295: bound by tensor-core
// operations, and at D = 40 by the exponentials (2*BH*S*S exp2 on 16 MUFU
// lanes an SM a cycle), which the bound does not count. It runs the wgmma
// + TMA body (attention_fwd_sm90_body.cuh). The cross-attention (Skv = 52
// or 77 text tokens) is about 50 operations per byte, below the line:
// bound by device memory. Each query row is read once and written once,
// and K/V (one tile) are read once per block and then hit in L2.
extern "C" int pea_flash_attention_fwd(const void* q, const void* k, const void* v,
                                       void* o, float* lse, int bh, int sq, int skv,
                                       int head_dim, float scale, int dtype, int device,
                                       void* stream) {
  return pea::flash_fwd_variant(q, k, v, o, lse, bh, sq, skv, head_dim, scale, dtype,
                                pea::shipped_flash_variant(skv, head_dim), device,
                                static_cast<cudaStream_t>(stream));
}

// B3 in the variant `variant` (0 .. pea_flash_variant_count() - 1):
// cudaErrorInvalidValue where that variant is not built for the head dim or
// type, kTensorMapError + CUresult where a wgmma variant's tensor map cannot
// be encoded. Bound as B3.
extern "C" int pea_flash_attention_fwd_variant(const void* q, const void* k, const void* v,
                                               void* o, float* lse, int bh, int sq, int skv,
                                               int head_dim, float scale, int dtype,
                                               int variant, int device, void* stream) {
  return pea::flash_fwd_variant(q, k, v, o, lse, bh, sq, skv, head_dim, scale, dtype, variant,
                                device, static_cast<cudaStream_t>(stream));
}

extern "C" int pea_flash_variant_count() { return pea::kNumFlashVariants; }

// The name of B3's variant `variant`, or nullptr past the end.
extern "C" const char* pea_flash_variant_name(int variant) {
  return variant >= 0 && variant < pea::kNumFlashVariants ? pea::kFlashVariants[variant].name
                                                          : nullptr;
}

// The variant B3 ships for skv KV rows at head dim head_dim (its index).
extern "C" int pea_flash_shipped_variant(int skv, int head_dim) {
  return pea::shipped_flash_variant(skv, head_dim);
}

// S1: the variant `variant` (0 .. pea_onepass_variant_count() - 1) of B1 on
// [B, S, H*D]; head_dim 64 and bf16 (dtype 0) only, else
// cudaErrorInvalidValue (a wgmma variant can also return
// kTensorMapError + CUresult). Bound as B1.
extern "C" int pea_onepass_attention_fwd_variant(const void* q, const void* k, const void* v,
                                                 void* o, int batch, int heads, int sq,
                                                 int skv, int head_dim, float scale, int dtype,
                                                 int variant, int device, void* stream) {
  if (head_dim != 64 || dtype != 0 || variant < 0 || variant >= pea::kNumVariants) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const pea::AttnParams p = pea::onepass_params(q, k, v, o, heads, sq, skv, head_dim, scale);
  return pea::on_device(device, [&]() -> cudaError_t {
    return pea::kVariants[variant].run(p, batch, device, static_cast<cudaStream_t>(stream));
  });
}

extern "C" int pea_onepass_variant_count() { return pea::kNumVariants; }

// The name of variant `variant`, or nullptr past the end.
extern "C" const char* pea_onepass_variant_name(int variant) {
  return variant >= 0 && variant < pea::kNumVariants ? pea::kVariants[variant].name : nullptr;
}
