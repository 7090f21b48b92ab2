// GroupNorm forward for Hopper (sm_90a), behind two C entry points:
//
// - pea_group_norm_fwd (B6): y = GN(x) [+ SiLU]. It replaces the TPU kernel
//   pea_diffusion_tpu/ops/groupnorm.py::_gn_kernel.
// - pea_group_norm_bias_fwd (B6-b): y = GN(x + t) [+ SiLU], with t one value
//   per (sample, channel): the resnet's time embedding. It replaces
//   pea_diffusion_tpu/ops/groupnorm.py::_gn_bias_kernel.
//
// Function (the TPU kernels' _gn_body): per (sample, group), the mean and
// E[v^2] of v = x (+ t) in fp32, var = max(E[v^2] - mean^2, 0), rstd =
// 1/sqrt(var + eps); per channel one affine y = x*A + B with A = rstd *
// scale and B = bias - mean*A (+ t*A); optionally SiLU in fp32; the output
// rounded once to x's type. t is added in fp32 as x is read and never
// stored (the TPU kernel folds it into the moments analytically instead:
// the same function). x, y: bfloat16, float16 or float32; scale, bias and
// t: fp32 or x's type.
//
// Bound on the H100: one read of x and one write of y, 2 * N*C*H*W *
// sizeof(T) bytes at 3.35 TB/s (about 10 operations per element, far below
// the card's ~295 per byte): device memory. SDXL's maps run from
// 2x1280x32x32 (5 MB in bf16) to the VAE decoder's 1x128x1024x1024 (268 MB).
//
// Two variants compute it, listed in kGnVariants and picked per call by the
// wrapper (shipped_gn_variant below, or by name for a comparison):
// `persistent` (groupnorm_sm90.cu), one cooperative launch that keeps the
// map in shared memory where it fits, and `three_pass`, this file's kernels.
//
// three_pass. The TPU kernel held one sample's whole map in VMEM, walked it
// twice (statistics, then the affine) and ran one grid step per sample. A
// Hopper block holds 227 KB, a group of the VAE's last level is 4 M
// elements, and one block per (sample, group) would be 32-64 blocks for 132
// SMs. So the work is cut into chunks that fill the card (about 8 blocks of
// 256 threads per SM) and takes three launches:
//   1. statistics: each block sums v and v^2 over its chunk in fp32 and
//      writes the partial sums of each group it covers;
//   2. finalize: one warp per (sample, group) adds that group's partial
//      sums in a fixed order and stores mean and rstd;
//   3. apply: each block computes A and B for its channels and rewrites its
//      chunk, a second read of x that comes mostly from L2 for maps under
//      its 50 MB.
// Every sum runs in a fixed order (no atomics), so a request's image does
// not change from run to run. Two dense layouts, chosen by the wrapper:
//   - contiguous NCHW: a group is one slab of cg*H*W elements; blocks are
//     (chunk, group, sample) and walk the slab in 16-byte vectors (the
//     channel of a vector is its row of H*W);
//   - channels-last NHWC, the TPU kernel's own layout and the one every
//     GroupNorm of the port's models receives (they take NHWC and permute
//     it, and the convolutions keep it): blocks are (chunk,
//     sample) and walk whole pixel rows of C channels, each thread owning
//     fixed channel vectors so that its sums stay per channel in registers;
//     the block adds them per channel in shared memory (row-parallel
//     threads in a fixed order), then per group.
// Loads and stores are vectors of `V` elements (16 bytes where the row and
// the pointer allow), chosen by the wrapper.
#include "groupnorm_common.cuh"

namespace pea {
namespace gn {

constexpr int kThreads = 256;
constexpr int kMaxCols = 2;  // channels-last: channel vectors a thread owns

struct GnParams {
  const void* x;
  const void* t;  // [N, C] or nullptr (B6)
  const void* scale;
  const void* bias;
  void* y;
  float* partials;  // [N, G, chunks, 2] partial sums of v and v^2
  float* stats;     // [N, G, 2] mean and rstd
  int n, c, hw, groups, cg, chunks;
  float eps;
  int silu;
  int scale_f32, bias_f32, t_f32;
};

__device__ __forceinline__ float* partial_at(const GnParams& p, int n, int g, int chunk) {
  return p.partials + ((static_cast<long long>(n) * p.groups + g) * p.chunks + chunk) * 2;
}

// The channel-by-channel affine of group g of sample n: A and B.
template <typename T>
__device__ __forceinline__ void affine(const GnParams& p, int n, int ch, float& a, float& b) {
  const int g = ch / p.cg;
  const float* st = p.stats + (static_cast<long long>(n) * p.groups + g) * 2;
  a = st[1] * param<T>(p.scale, ch, p.scale_f32);
  b = param<T>(p.bias, ch, p.bias_f32) - st[0] * a;
  if (p.t) b += param<T>(p.t, static_cast<long long>(n) * p.c + ch, p.t_f32) * a;
}

// ---- contiguous NCHW: blocks (chunk, group, sample) over one group's slab

template <typename T, int V>
__global__ void __launch_bounds__(kThreads) stats_nchw(GnParams p) {
  const int chunk = blockIdx.x, g = blockIdx.y, n = blockIdx.z;
  const int per_row = p.hw / V;  // vectors of one channel
  const int total = p.cg * per_row;  // the group's channels, one slab
  const int per_chunk = (total + p.chunks - 1) / p.chunks;
  const int j0 = chunk * per_chunk, j1 = min(total, j0 + per_chunk);
  const long long first = static_cast<long long>(n) * p.c + static_cast<long long>(g) * p.cg;
  const Pack<T, V>* x = reinterpret_cast<const Pack<T, V>*>(static_cast<const T*>(p.x) + first * p.hw);
  float s1 = 0.f, s2 = 0.f;
  for (int j = j0 + threadIdx.x; j < j1; j += kThreads) {
    const Pack<T, V> pk = x[j];
    const float tv = p.t ? param<T>(p.t, first + j / per_row, p.t_f32) : 0.f;
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float v = to_float(pk.v[e]) + tv;
      s1 += v;
      s2 += v * v;
    }
  }
  __shared__ float sh[2][kThreads / 32];
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    sh[0][warp] = s1;
    sh[1][warp] = s2;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float a = 0.f, b = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) {
      a += sh[0][w];
      b += sh[1][w];
    }
    float* out = partial_at(p, n, g, chunk);
    out[0] = a;
    out[1] = b;
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads) apply_nchw(GnParams p) {
  extern __shared__ float ab[];  // A then B of the group's cg channels
  const int chunk = blockIdx.x, g = blockIdx.y, n = blockIdx.z;
  for (int k = threadIdx.x; k < p.cg; k += kThreads) {
    affine<T>(p, n, g * p.cg + k, ab[k], ab[p.cg + k]);
  }
  __syncthreads();
  const int per_row = p.hw / V;
  const int total = p.cg * per_row;
  const int per_chunk = (total + p.chunks - 1) / p.chunks;
  const int j0 = chunk * per_chunk, j1 = min(total, j0 + per_chunk);
  const long long offset = (static_cast<long long>(n) * p.c + static_cast<long long>(g) * p.cg) * p.hw;
  const Pack<T, V>* x = reinterpret_cast<const Pack<T, V>*>(static_cast<const T*>(p.x) + offset);
  Pack<T, V>* y = reinterpret_cast<Pack<T, V>*>(static_cast<T*>(p.y) + offset);
  for (int j = j0 + threadIdx.x; j < j1; j += kThreads) {
    const int k = j / per_row;
    const float a = ab[k], b = ab[p.cg + k];
    const Pack<T, V> in = x[j];
    Pack<T, V> out;
#pragma unroll
    for (int e = 0; e < V; ++e) {
      float v = to_float(in.v[e]) * a + b;
      if (p.silu) v = silu(v);
      out.v[e] = from_float<T>(v);
    }
    y[j] = out;
  }
}

// ---- channels-last NHWC: blocks (chunk, sample) over whole pixel rows

__device__ __forceinline__ void row_range(const GnParams& p, int chunk, int& r0, int& r1) {
  const int per_chunk = (p.hw + p.chunks - 1) / p.chunks;
  r0 = chunk * per_chunk;
  r1 = min(p.hw, r0 + per_chunk);
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads) stats_nhwc(GnParams p) {
  extern __shared__ float sums[];  // [2, C]: sums of v, then of v^2, per channel
  const int chunk = blockIdx.x, n = blockIdx.z;
  const RowSplit<kThreads> rs(p.c, V);
  int r0, r1;
  row_range(p, chunk, r0, r1);
  const T* x = static_cast<const T*>(p.x) + static_cast<long long>(n) * p.hw * p.c;
  float s1[kMaxCols][V], s2[kMaxCols][V], tv[kMaxCols][V];
#pragma unroll
  for (int m = 0; m < kMaxCols; ++m) {
#pragma unroll
    for (int e = 0; e < V; ++e) {
      s1[m][e] = s2[m][e] = 0.f;
      tv[m][e] = (p.t && rs.owns(m))
                     ? param<T>(p.t, static_cast<long long>(n) * p.c + rs.col(m) * V + e, p.t_f32)
                     : 0.f;
    }
  }
  if (rs.active) {
    for (int r = r0 + rs.sub; r < r1; r += rs.rows_par) {
      const Pack<T, V>* row = reinterpret_cast<const Pack<T, V>*>(x + static_cast<long long>(r) * p.c);
#pragma unroll
      for (int m = 0; m < kMaxCols; ++m) {
        if (!rs.owns(m)) continue;
        const Pack<T, V> pk = row[rs.col(m)];
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float v = to_float(pk.v[e]) + tv[m][e];
          s1[m][e] += v;
          s2[m][e] += v * v;
        }
      }
    }
  }
  for (int i = threadIdx.x; i < 2 * p.c; i += kThreads) sums[i] = 0.f;
  __syncthreads();
  for (int sub = 0; sub < rs.rows_par; ++sub) {  // row-parallel threads in order
    if (rs.sub == sub) {
#pragma unroll
      for (int m = 0; m < kMaxCols; ++m) {
        if (!rs.owns(m)) continue;
#pragma unroll
        for (int e = 0; e < V; ++e) {
          sums[rs.col(m) * V + e] += s1[m][e];
          sums[p.c + rs.col(m) * V + e] += s2[m][e];
        }
      }
    }
    __syncthreads();
  }
  for (int g = threadIdx.x; g < p.groups; g += kThreads) {
    float a = 0.f, b = 0.f;
    for (int k = g * p.cg; k < (g + 1) * p.cg; ++k) {
      a += sums[k];
      b += sums[p.c + k];
    }
    float* out = partial_at(p, n, g, chunk);
    out[0] = a;
    out[1] = b;
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads) apply_nhwc(GnParams p) {
  extern __shared__ float ab_c[];  // A then B of all C channels
  const int chunk = blockIdx.x, n = blockIdx.z;
  for (int ch = threadIdx.x; ch < p.c; ch += kThreads) {
    affine<T>(p, n, ch, ab_c[ch], ab_c[p.c + ch]);
  }
  __syncthreads();
  const RowSplit<kThreads> rs(p.c, V);
  int r0, r1;
  row_range(p, chunk, r0, r1);
  float a[kMaxCols][V], b[kMaxCols][V];
#pragma unroll
  for (int m = 0; m < kMaxCols; ++m) {
#pragma unroll
    for (int e = 0; e < V; ++e) {
      a[m][e] = rs.owns(m) ? ab_c[rs.col(m) * V + e] : 0.f;
      b[m][e] = rs.owns(m) ? ab_c[p.c + rs.col(m) * V + e] : 0.f;
    }
  }
  if (!rs.active) return;
  const long long offset = static_cast<long long>(n) * p.hw * p.c;
  const T* __restrict__ x = static_cast<const T*>(p.x) + offset;
  T* __restrict__ y = static_cast<T*>(p.y) + offset;
  for (int r = r0 + rs.sub; r < r1; r += rs.rows_par) {
    const Pack<T, V>* in_row = reinterpret_cast<const Pack<T, V>*>(x + static_cast<long long>(r) * p.c);
    Pack<T, V>* out_row = reinterpret_cast<Pack<T, V>*>(y + static_cast<long long>(r) * p.c);
#pragma unroll
    for (int m = 0; m < kMaxCols; ++m) {
      if (!rs.owns(m)) continue;
      const Pack<T, V> in = in_row[rs.col(m)];
      Pack<T, V> out;
#pragma unroll
      for (int e = 0; e < V; ++e) {
        float v = to_float(in.v[e]) * a[m][e] + b[m][e];
        if (p.silu) v = silu(v);
        out.v[e] = from_float<T>(v);
      }
      out_row[rs.col(m)] = out;
    }
  }
}

// ---- both layouts: one warp per (sample, group) folds the partial sums,
// each lane the chunks lane, lane + 32, ... in order, then a fixed tree

constexpr int kFinalizeWarps = 4;

__global__ void __launch_bounds__(kFinalizeWarps * 32) finalize(GnParams p) {
  const int i = blockIdx.x * kFinalizeWarps + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (i >= p.n * p.groups) return;  // the whole warp leaves together
  const float* part = p.partials + static_cast<long long>(i) * p.chunks * 2;
  float s1 = 0.f, s2 = 0.f;
  for (int k = lane; k < p.chunks; k += 32) {
    s1 += part[2 * k];
    s2 += part[2 * k + 1];
  }
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  if (lane == 0) {
    const float count = static_cast<float>(static_cast<double>(p.cg) * p.hw);
    const float mean = s1 / count;
    const float var = fmaxf(s2 / count - mean * mean, 0.f);
    p.stats[2 * i] = mean;
    p.stats[2 * i + 1] = rsqrtf(var + p.eps);
  }
}

template <typename T, int V>
inline cudaError_t launch(const GnParams& p, bool nhwc, cudaStream_t stream) {
  if (nhwc) {
    const int bytes = 2 * p.c * static_cast<int>(sizeof(float));
    if (p.c / V > kMaxCols * kThreads || bytes > kDefaultSmem) return cudaErrorInvalidValue;
    stats_nhwc<T, V><<<dim3(p.chunks, 1, p.n), kThreads, bytes, stream>>>(p);
  } else {
    stats_nchw<T, V><<<dim3(p.chunks, p.groups, p.n), kThreads, 0, stream>>>(p);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  finalize<<<(p.n * p.groups + kFinalizeWarps - 1) / kFinalizeWarps, kFinalizeWarps * 32, 0,
             stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (nhwc) {
    const int bytes = 2 * p.c * static_cast<int>(sizeof(float));
    apply_nhwc<T, V><<<dim3(p.chunks, 1, p.n), kThreads, bytes, stream>>>(p);
  } else {
    const int bytes = 2 * p.cg * static_cast<int>(sizeof(float));
    if (bytes > kDefaultSmem) return cudaErrorInvalidValue;
    apply_nchw<T, V><<<dim3(p.chunks, p.groups, p.n), kThreads, bytes, stream>>>(p);
  }
  return cudaGetLastError();
}

template <typename T>
inline cudaError_t launch_vec(const GnParams& p, bool nhwc, int vec, cudaStream_t stream) {
  if (vec == 1) return launch<T, 1>(p, nhwc, stream);
  if (vec == 2) return launch<T, 2>(p, nhwc, stream);
  if (vec == 4) return launch<T, 4>(p, nhwc, stream);
  if (vec == 8 && sizeof(T) == 2) return launch<T, (sizeof(T) == 2 ? 8 : 4)>(p, nhwc, stream);
  return cudaErrorInvalidValue;
}

// dtype: 0 = bfloat16, 1 = float16, 2 = float32. The scratch holds the
// partial sums, then mean and rstd: N*G*(chunks + 1)*2 floats.
inline int launch_three_pass(const void* x, const void* t, const void* scale, const void* bias,
                             void* y, float* scratch, int n, int c, int hw, int groups,
                             int chunks, float eps, int silu, int channels_last, int vec,
                             int dtype, int scale_f32, int bias_f32, int t_f32, int device,
                             void* stream) {
  if (n < 1 || c < 1 || hw < 1 || groups < 1 || c % groups || chunks < 1 || vec < 1 ||
      (channels_last ? c : hw) % vec) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  GnParams p;
  p.x = x;
  p.t = t;
  p.scale = scale;
  p.bias = bias;
  p.y = y;
  p.partials = scratch;
  p.stats = scratch + static_cast<long long>(n) * groups * chunks * 2;
  p.n = n;
  p.c = c;
  p.hw = hw;
  p.groups = groups;
  p.cg = c / groups;
  p.chunks = chunks;
  p.eps = eps;
  p.silu = silu;
  p.scale_f32 = scale_f32;
  p.bias_f32 = bias_f32;
  p.t_f32 = t_f32;
  const bool nhwc = channels_last != 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return on_device(device, [&]() -> cudaError_t {
    if (dtype == 0) return launch_vec<__nv_bfloat16>(p, nhwc, vec, s);
    if (dtype == 1) return launch_vec<__half>(p, nhwc, vec, s);
    if (dtype == 2) return launch_vec<float>(p, nhwc, vec, s);
    return cudaErrorInvalidValue;
  });
}

// The variants, in the order of the wrapper's GN_VARIANTS.
constexpr const char* kGnVariants[] = {"three_pass", "persistent"};
constexpr int kGnVariantCount = sizeof(kGnVariants) / sizeof(kGnVariants[0]);

// Channels-last, the persistent variant's vector: the most of 16 bytes
// that divides C and the alignment `align` (bytes) and spans at most two
// groups of cg channels (V <= cg + 1).
inline int nhwc_vector(int c, int cg, int size, int align) {
  int vec = 16 / size;
  while (vec > 1 && (c % vec || align % (vec * size) || vec - 1 > cg)) vec /= 2;
  return vec;
}

// The variant B6 and B6-b run for a shape: `persistent` wherever it takes
// the map, `three_pass` elsewhere. It takes channels-last maps of at most
// 1024 groups whose rows split into at most 512 vectors (nhwc_vector), and
// contiguous maps of at most 1023 channels a group. On the card it was the
// faster of the two at every channels-last shape of the paths: by 1.1-2.3x
// at batch 1 and 2 (chip_smoke.py's GroupNorm rows, where it also won 27 of
// the 29 contiguous ones), and by 1.03-2.2x at every GroupNorm of the
// SDXL UNet at CFG batch 16, the SD1.5 UNet at batch 40 and the fp32 VAE
// decoder and encoder (tools/sweep_groupnorm.py).
inline int shipped_variant(int n, int c, int hw, int groups, int channels_last, int dtype,
                           int align) {
  const int size = dtype == 2 ? 4 : 2;
  if (n < 1 || hw < 1 || groups < 1 || c % groups) return 0;
  const int cg = c / groups;
  if (!channels_last) return cg <= 1023 ? 1 : 0;
  return groups <= 1024 && c / nhwc_vector(c, cg, size, align) <= 512 ? 1 : 0;
}

// variant: an index of kGnVariants. three_pass takes `chunks` and a scratch
// of N*G*(chunks + 1)*2 floats; persistent takes `width` (a row's elements:
// C channels-last, a divisor of H*W contiguous), `tile_rows`, `slots` and
// `blocks` (the wrapper's plan) and a work buffer that keeps its first 16
// bytes (the grid barrier's word, zero at first) from launch to launch.
inline int launch_group_norm(const void* x, const void* t, const void* scale, const void* bias,
                             void* y, float* work, int n, int c, int hw, int groups, float eps,
                             int silu, int channels_last, int vec, int dtype, int scale_f32,
                             int bias_f32, int t_f32, int variant, int chunks, int width,
                             int tile_rows, int slots, int blocks, int device, void* stream) {
  if (variant == 0) {
    return launch_three_pass(x, t, scale, bias, y, work, n, c, hw, groups, chunks, eps, silu,
                             channels_last, vec, dtype, scale_f32, bias_f32, t_f32, device,
                             stream);
  }
  if (variant != 1 || n < 1 || c < 1 || hw < 1 || groups < 1 || c % groups) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_persistent(x, t, scale, bias, y, work, n, c, hw, groups, eps, silu,
                           channels_last, vec, dtype, scale_f32, bias_f32, t_f32, width,
                           tile_rows, slots, blocks, device, static_cast<cudaStream_t>(stream));
}

}  // namespace gn
}  // namespace pea

extern "C" int pea_gn_variant_count() { return pea::gn::kGnVariantCount; }

extern "C" const char* pea_gn_variant_name(int i) {
  return i >= 0 && i < pea::gn::kGnVariantCount ? pea::gn::kGnVariants[i] : "";
}

extern "C" int pea_gn_shipped_variant(int n, int c, int hw, int groups, int channels_last,
                                      int dtype, int align) {
  return pea::gn::shipped_variant(n, c, hw, groups, channels_last, dtype, align);
}

// B6: y = GN(x) [+ SiLU] on [N, C, H, W], contiguous (channels_last 0) or
// channels-last (1), in the variant `variant` on `stream`.
extern "C" int pea_group_norm_fwd(const void* x, const void* scale, const void* bias, void* y,
                                  float* work, int n, int c, int hw, int groups, float eps,
                                  int silu, int channels_last, int vec, int dtype, int scale_f32,
                                  int bias_f32, int variant, int chunks, int width,
                                  int tile_rows, int slots, int blocks, int device,
                                  void* stream) {
  return pea::gn::launch_group_norm(x, nullptr, scale, bias, y, work, n, c, hw, groups, eps,
                                    silu, channels_last, vec, dtype, scale_f32, bias_f32, 0,
                                    variant, chunks, width, tile_rows, slots, blocks, device,
                                    stream);
}

// B6-b: y = GN(x + t) [+ SiLU], t [N, C]; otherwise as B6.
extern "C" int pea_group_norm_bias_fwd(const void* x, const void* t, const void* scale,
                                       const void* bias, void* y, float* work, int n, int c,
                                       int hw, int groups, float eps, int silu,
                                       int channels_last, int vec, int dtype, int scale_f32,
                                       int bias_f32, int t_f32, int variant, int chunks,
                                       int width, int tile_rows, int slots, int blocks,
                                       int device, void* stream) {
  return pea::gn::launch_group_norm(x, t, scale, bias, y, work, n, c, hw, groups, eps, silu,
                                    channels_last, vec, dtype, scale_f32, bias_f32, t_f32,
                                    variant, chunks, width, tile_rows, slots, blocks, device,
                                    stream);
}
