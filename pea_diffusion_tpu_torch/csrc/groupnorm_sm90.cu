// GroupNorm forward for Hopper (sm_90a), the `persistent` variant of B6 and
// B6-b (pea_group_norm_fwd / pea_group_norm_bias_fwd in groupnorm.cu, which
// replace pea_diffusion_tpu/ops/groupnorm.py::_gn_kernel and
// ::_gn_bias_kernel): the same function as the `three_pass` kernels, in one
// launch.
//
// Bound: one read of x and one write of y (device memory). The three-pass
// form pays three dependent launches a call, per-block set-up as large as
// the work at the UNet's 32² and 64² maps, and a second read of x. Here:
//
// - One cooperative launch of one block per SM (512 threads), so that a grid
//   barrier is legal. The map is a list of tiles, each `tile_rows` rows of
//   one segment; block b takes the q = ceil(tiles / grid) tiles from b * q
//   on, in order (so the blocks that cover a segment are consecutive and
//   none of them is empty).
//   - channels-last: a segment is one sample, a row one pixel's C channels;
//   - contiguous: a segment is one (sample, group) slab of cg * H * W
//     elements, cut into rows of `width` elements (width divides H * W, so
//     a row lies in one channel).
// - Tiles come into a ring of `slots` shared-memory slots by 1-D bulk copies
//   (cp.async.bulk, completing an mbarrier) where rows are whole 16-byte
//   chunks and x is 16-byte aligned, else by the threads' vector loads.
// - Statistics: each thread owns one vector of a row (a row has at most 512
//   vectors) and sums v = x (+ t) and v^2 per element in registers over the
//   block's tiles of a segment. Channels-last, a vector holds V channels
//   (16 bytes wherever C and x's alignment allow) that may straddle two
//   groups, as at 10, 20, 30 and 60 channels a group: the thread folds its
//   sums into its part of each of the two, and the block folds the parts
//   per group in a fixed order into its own slot of the partial sums
//   [segment, group, block] (no atomics on sums). The thread's weight, bias
//   and t are loaded before the barrier, to arrive while it waits.
// - One grid barrier (arrivals and a generation in one word that persists
//   between launches: no memset launch). Then every block folds the partials
//   of each group it covers, the covering blocks in order, so every block
//   gets the same mean and rstd bits, and computes A and B for its own
//   channels only.
// - Apply: the block walks its tiles in reverse order. The last `slots`
//   tiles of the statistics pass are still in shared memory, so a map whose
//   tiles all fit the grid's slots (resident) is read from device memory
//   once; the others are read again, newest first, so that the re-read
//   finds them in L2 as far as it holds them. y is stored from registers in
//   V-element vectors (16 bytes where the channels allow).
// Every sum runs in a fixed order: two launches give the same bits.
#include "groupnorm_common.cuh"
#include "sm90_common.cuh"

namespace pea {
namespace gn {

constexpr int kPThreads = 512;
constexpr int kPWarps = kPThreads / 32;
constexpr int kRedFloats = 2048;  // the block's fold buffer: 4 floats a thread, 2 a group
constexpr int kMaxSlots = 32;
constexpr int kPersistentSmem = 227 * 1024;  // an H100 block's opt-in maximum
constexpr int kSmemFixed = kRedFloats * 4 + kMaxSlots * 8;
constexpr int kFoldGroups = 2;  // groups a warp folds at once after the barrier
constexpr int kFoldBlocks = 5;  // partials a lane loads at once: 160 blocks a segment

struct PParams {
  const void* x;
  const void* t;  // [N, C] or nullptr (B6)
  const void* scale;
  const void* bias;
  void* y;
  unsigned long long* barrier;  // generation << 32 | arrivals
  float* partials;        // [segs, gs, gridDim.x, 2]: sums of v and v^2
  int c, hw, cg;
  int segs, seg_rows, width, gs;  // segments, their rows, a row's elements, groups
  int tile_rows, tps, slots, slot_bytes;
  long long tiles;  // segs * tps
  float eps;
  int silu, scale_f32, bias_f32, t_f32, bulk;
};

__device__ __forceinline__ unsigned long long ld_acquire(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];\n" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long atom_add(unsigned long long* p,
                                                       unsigned long long v) {
  unsigned long long old;
  asm volatile("atom.add.acq_rel.gpu.global.u64 %0, [%1], %2;\n"
               : "=l"(old)
               : "l"(p), "l"(v)
               : "memory");
  return old;
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// SiLU, v * sigmoid(v), as the output type needs it: for 16-bit outputs with
// one tanh.approx (sigmoid(v) = (1 + tanh(v / 2)) / 2, relative error about
// 2^-11 against bf16's 2^-9 rounding), for fp32 with one exp and a fast
// reciprocal. The plain form (a full division) kept the apply pass's
// arithmetic, not its memory, on the critical path at the path's maps.
template <typename T>
__device__ __forceinline__ float silu_out(float v) {
  if constexpr (sizeof(T) == 2) {
    const float h = 0.5f * v;
    float th;
    asm("tanh.approx.f32 %0, %1;\n" : "=f"(th) : "f"(h));
    return fmaf(h, th, h);
  } else {
    return __fdividef(v, 1.f + __expf(-v));
  }
}

// Every block of the grid arrives on one word, generation << 32 | arrivals:
// the last to arrive sets the arrivals back to 0 and moves the generation
// on in one atomic, the others wait for the generation to move. Arrival
// releases the block's partial sums (written before the __syncthreads) and
// the wait acquires everyone's.
__device__ __forceinline__ void grid_barrier(unsigned long long* barrier) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned long long old = atom_add(barrier, 1ull);
    const unsigned gen = static_cast<unsigned>(old >> 32);
    if (static_cast<unsigned>(old) == gridDim.x - 1) {
      atom_add(barrier, (1ull << 32) - gridDim.x);
    } else {
      while (static_cast<unsigned>(ld_acquire(barrier) >> 32) == gen) __nanosleep(32);
    }
  }
  __syncthreads();
}

template <typename T, int V, bool kNhwc>
__global__ void __launch_bounds__(kPThreads, 1) gn_persistent(PParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* red = reinterpret_cast<float*>(smem + static_cast<size_t>(p.slots) * p.slot_bytes);
  uint64_t* bars = reinterpret_cast<uint64_t*>(red + kRedFloats);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // A thread owns vector `col` of rows sub, sub + rows_par, ... of each tile
  // (every row has at most kPThreads vectors).
  const RowSplit<kPThreads> rs(p.width, V);
  const int col = rs.col0;
  // Channels-last: the vector's first `split` channels lie in group `glo`,
  // the rest in glo + 1 (V <= cg + 1: at most two groups). Contiguous: one
  // channel, one group.
  const int glo = kNhwc ? col * V / p.cg : 0;
  const int split = kNhwc ? min(V, (glo + 1) * p.cg - col * V) : V;
  const long long per_block = (p.tiles + gridDim.x - 1) / gridDim.x;
  const long long first = min(p.tiles, blockIdx.x * per_block);
  const int count = static_cast<int>(min(p.tiles, first + per_block) - first);
  const int slots = p.slots;
  const T* x = static_cast<const T*>(p.x);
  T* y = static_cast<T*>(p.y);
  if (p.bulk && tid == 0) {
    for (int s = 0; s < slots; ++s) sm90::mbar_init(smem_addr(bars + s), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Tile i: rows [r0, r0 + rows) of segment seg, `offset` elements into x.
  struct Tile {
    int seg, r0, rows;
    long long offset;
  };
  auto tile_at = [&](long long i) {
    Tile tl;
    tl.seg = static_cast<int>(i / p.tps);
    tl.r0 = static_cast<int>(i % p.tps) * p.tile_rows;
    tl.rows = min(p.tile_rows, p.seg_rows - tl.r0);
    tl.offset = (static_cast<long long>(tl.seg) * p.seg_rows + tl.r0) * p.width;
    return tl;
  };
  auto slot = [&](int s) {
    return reinterpret_cast<Pack<T, V>*>(smem + static_cast<size_t>(s) * p.slot_bytes);
  };
  // The block that takes tile i.
  auto owner = [&](long long i) { return static_cast<int>(i / per_block); };
  auto issue = [&](long long i, int s) {  // start tile i's copy into slot s
    if (!p.bulk || tid != 0) return;
    const Tile tl = tile_at(i);
    const uint32_t bytes = static_cast<uint32_t>(tl.rows) * p.width * sizeof(T);
    const uint32_t bar = smem_addr(bars + s);
    sm90::mbar_expect_tx(bar, bytes);
    bulk_load(smem_addr(slot(s)), x + tl.offset, bytes, bar);
  };
  uint32_t parity = 0;  // bit s: the phase slot s's next copy completes
  auto wait = [&](long long i, int s) {  // tile i is in slot s after this
    if (p.bulk) {
      sm90::mbar_wait(smem_addr(bars + s), (parity >> s) & 1u);
      parity ^= 1u << s;
      return;
    }
    const Tile tl = tile_at(i);
    const Pack<T, V>* src = reinterpret_cast<const Pack<T, V>*>(x + tl.offset);
    Pack<T, V>* dst = slot(s);
    for (int k = tid, packs = tl.rows * rs.per_row; k < packs; k += kPThreads) dst[k] = src[k];
    __syncthreads();
  };
  // Contiguous layout: the channel within its group of a segment's row.
  auto row_channel = [&](int row) {
    return static_cast<int>(static_cast<long long>(row) * p.width / p.hw);
  };
  // Channels-last: t of the thread's channels in segment seg (0 for B6).
  auto load_t = [&](float (&out)[V], int seg) {
#pragma unroll
    for (int e = 0; e < V; ++e) {
      out[e] = (kNhwc && p.t && rs.active)
                   ? param<T>(p.t, static_cast<long long>(seg) * p.c + col * V + e, p.t_f32)
                   : 0.f;
    }
  };

  // ---- statistics: sums per element of the thread's vector
  float s1[V], s2[V], tv[V];
  // The block's sums of segment seg, folded per group into its partials:
  // each thread's parts of its (at most two) groups in red[4 tid, +4), then
  // per group the parts of the vectors that hold its channels, row-parallel
  // threads in order.
  auto flush = [&](int seg) {
    float l1 = 0.f, l2 = 0.f, h1 = 0.f, h2 = 0.f;
#pragma unroll
    for (int e = 0; e < V; ++e) {
      if (e < split) {
        l1 += s1[e];
        l2 += s2[e];
      } else {
        h1 += s1[e];
        h2 += s2[e];
      }
    }
    red[4 * tid] = l1;
    red[4 * tid + 1] = l2;
    red[4 * tid + 2] = h1;
    red[4 * tid + 3] = h2;
    __syncthreads();
    for (int g = warp; g < p.gs; g += kPWarps) {
      // the vectors [v0, v0 + nv) of a row that hold channels of group g
      const int v0 = kNhwc ? g * p.cg / V : 0;
      const int nv = kNhwc ? ((g + 1) * p.cg - 1) / V - v0 + 1 : rs.per_row;
      float a = 0.f, b = 0.f;
      for (int j = lane; j < rs.rows_par * nv; j += 32) {
        const int v = v0 + j % nv;
        const int part = (kNhwc && v * V / p.cg != g) ? 2 : 0;
        const int owner_tid = (j / nv) * rs.per_row + v;
        a += red[4 * owner_tid + part];
        b += red[4 * owner_tid + part + 1];
      }
      a = warp_sum(a);
      b = warp_sum(b);
      if (lane == 0) {
        float* out = p.partials +
                     ((static_cast<long long>(seg) * p.gs + g) * gridDim.x + blockIdx.x) * 2;
        out[0] = a;
        out[1] = b;
      }
    }
    __syncthreads();
  };

  for (int j = 0; j < min(count, slots); ++j) issue(first + j, j);
  int cur = -1;
  for (int j = 0; j < count; ++j) {
    const long long i = first + j;
    const int s = j % slots;
    const Tile tl = tile_at(i);
    if (tl.seg != cur) {
      if (cur >= 0) flush(cur);
      cur = tl.seg;
#pragma unroll
      for (int e = 0; e < V; ++e) s1[e] = s2[e] = 0.f;
      load_t(tv, cur);
    }
    wait(i, s);
    const Pack<T, V>* tile = slot(s);
    if (rs.active) {
      for (int r = rs.sub; r < tl.rows; r += rs.rows_par) {
        const Pack<T, V> pk = tile[r * rs.per_row + col];
        // contiguous: one t a row (the row's channel); channels-last: per column
        const float tr = (!kNhwc && p.t)
                             ? param<T>(p.t, static_cast<long long>(cur) * p.cg +
                                                 row_channel(tl.r0 + r), p.t_f32)
                             : 0.f;
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float v = to_float(pk.v[e]) + (kNhwc ? tv[e] : tr);
          s1[e] += v;
          s2[e] = fmaf(v, v, s2[e]);
        }
      }
    }
    __syncthreads();  // slot s is read: it may take the next tile
    if (j + slots < count) issue(i + slots, s);
  }
  if (cur >= 0) flush(cur);

  // Channels-last: the weight, bias and t of the thread's channels, loaded
  // now so that they arrive while the block waits at the barrier. t is that
  // of the segment the apply pass starts with (the block's last tile's).
  float sc[V], bi[V], tb[V];
  int t_seg = count > 0 ? tile_at(first + count - 1).seg : 0;
#pragma unroll
  for (int e = 0; e < V; ++e) {
    const int ch = col * V + e;
    sc[e] = (kNhwc && rs.active) ? param<T>(p.scale, ch, p.scale_f32) : 0.f;
    bi[e] = (kNhwc && rs.active) ? param<T>(p.bias, ch, p.bias_f32) : 0.f;
  }
  load_t(tb, t_seg);

  grid_barrier(p.barrier);

  // ---- apply, tiles in reverse order
  const float count_f = static_cast<float>(static_cast<double>(p.cg) * p.hw);
  float a[V], b[V];
  cur = -1;
  for (int j = count - 1; j >= 0; --j) {
    const long long i = first + j;
    const int s = j % slots;
    const Tile tl = tile_at(i);
    if (tl.seg != cur) {
      cur = tl.seg;
      // mean and rstd of the segment's groups: every covering block's
      // partial, in block order, into red[2g], red[2g + 1]. (A warp takes
      // kFoldGroups groups at once and a lane the blocks lo + lane + 32 k,
      // all loads issued before the first add.)
      const int lo = owner(static_cast<long long>(cur) * p.tps);
      const int hi = owner((static_cast<long long>(cur) + 1) * p.tps - 1);
      for (int g0 = warp; g0 < p.gs; g0 += kFoldGroups * kPWarps) {
        float sa[kFoldGroups][kFoldBlocks], sb[kFoldGroups][kFoldBlocks];
#pragma unroll
        for (int q = 0; q < kFoldGroups; ++q) {
          const int g = g0 + q * kPWarps;
          const float* part =
              p.partials + (static_cast<long long>(cur) * p.gs + g) * gridDim.x * 2;
#pragma unroll
          for (int k = 0; k < kFoldBlocks; ++k) {
            const int blk = lo + lane + 32 * k;
            const bool take = g < p.gs && blk <= hi;
            sa[q][k] = take ? __ldcg(part + 2 * blk) : 0.f;
            sb[q][k] = take ? __ldcg(part + 2 * blk + 1) : 0.f;
          }
          for (int blk = lo + lane + 32 * kFoldBlocks; g < p.gs && blk <= hi; blk += 32) {
            sa[q][kFoldBlocks - 1] += __ldcg(part + 2 * blk);  // grids over 32 k blocks
            sb[q][kFoldBlocks - 1] += __ldcg(part + 2 * blk + 1);
          }
        }
#pragma unroll
        for (int q = 0; q < kFoldGroups; ++q) {
          const int g = g0 + q * kPWarps;
          float a1 = 0.f, a2 = 0.f;
#pragma unroll
          for (int k = 0; k < kFoldBlocks; ++k) {
            a1 += sa[q][k];
            a2 += sb[q][k];
          }
          a1 = warp_sum(a1);
          a2 = warp_sum(a2);
          if (lane == 0 && g < p.gs) {
            const float mean = a1 / count_f;
            const float var = fmaxf(a2 / count_f - mean * mean, 0.f);
            red[2 * g] = mean;
            red[2 * g + 1] = rsqrtf(var + p.eps);
          }
        }
      }
      __syncthreads();
      if (kNhwc) {  // A and B of the thread's own channels (groups glo, glo + 1)
        if (cur != t_seg) {
          t_seg = cur;
          load_t(tb, cur);
        }
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const int g = e < split ? glo : glo + 1;
          a[e] = red[2 * g + 1] * sc[e];
          b[e] = bi[e] - red[2 * g] * a[e] + tb[e] * a[e];
        }
      } else {  // A and B of the group's cg channels, after its mean and rstd
        const int g = cur % (p.c / p.cg);
        for (int k = tid; k < p.cg; k += kPThreads) {
          const int ch = g * p.cg + k;
          const float ak = red[1] * param<T>(p.scale, ch, p.scale_f32);
          float bk = param<T>(p.bias, ch, p.bias_f32) - red[0] * ak;
          if (p.t) bk += param<T>(p.t, static_cast<long long>(cur) * p.cg + k, p.t_f32) * ak;
          red[2 + 2 * k] = ak;
          red[3 + 2 * k] = bk;
        }
        __syncthreads();
      }
    }
    if (j < count - slots) wait(i, s);  // read again: no longer in its slot
    const Pack<T, V>* tile = slot(s);
    Pack<T, V>* out = reinterpret_cast<Pack<T, V>*>(y + tl.offset);
    if (rs.active) {
      for (int r = rs.sub; r < tl.rows; r += rs.rows_par) {
        const Pack<T, V> in = tile[r * rs.per_row + col];
        const int k = kNhwc ? 0 : row_channel(tl.r0 + r);
        Pack<T, V> o;
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float ae = kNhwc ? a[e] : red[2 + 2 * k];
          const float be = kNhwc ? b[e] : red[3 + 2 * k];
          float v = to_float(in.v[e]) * ae + be;
          if (p.silu) v = silu_out<T>(v);
          o.v[e] = from_float<T>(v);
        }
        out[r * rs.per_row + col] = o;
      }
    }
    __syncthreads();  // slot s is read: it may take tile j - slots
    if (j >= slots) issue(first + j - slots, s);
  }
}

template <typename T, int V, bool kNhwc>
cudaError_t launch_persistent_kernel(const PParams& p, int blocks, int device,
                                     cudaStream_t stream) {
  static std::atomic<bool> opted_in[kMaxDevices];
  auto kernel = gn_persistent<T, V, kNhwc>;
  cudaError_t err = opt_in_smem(kernel, kPersistentSmem, device, opted_in);
  if (err != cudaSuccess) return err;
  PParams args = p;
  void* argv[] = {&args};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(blocks),
                                    dim3(kPThreads), argv,
                                    static_cast<size_t>(p.slots) * p.slot_bytes + kSmemFixed,
                                    stream);
  const cudaError_t last = cudaGetLastError();  // clears a refused launch's error
  return err != cudaSuccess ? err : last;
}

template <typename T, bool kNhwc>
cudaError_t launch_persistent_vec(const PParams& p, int vec, int blocks, int device,
                                  cudaStream_t stream) {
  if (vec == 1) return launch_persistent_kernel<T, 1, kNhwc>(p, blocks, device, stream);
  if (vec == 2) return launch_persistent_kernel<T, 2, kNhwc>(p, blocks, device, stream);
  if (vec == 4) return launch_persistent_kernel<T, 4, kNhwc>(p, blocks, device, stream);
  if (vec == 8 && sizeof(T) == 2) {
    return launch_persistent_kernel<T, (sizeof(T) == 2 ? 8 : 4), kNhwc>(p, blocks, device,
                                                                      stream);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_persistent_layout(const PParams& p, bool nhwc, int vec, int blocks,
                                     int device, cudaStream_t stream) {
  return nhwc ? launch_persistent_vec<T, true>(p, vec, blocks, device, stream)
              : launch_persistent_vec<T, false>(p, vec, blocks, device, stream);
}

int launch_persistent(const void* x, const void* t, const void* scale, const void* bias,
                      void* y, float* work, int n, int c, int hw, int groups, float eps,
                      int silu, int channels_last, int vec, int dtype, int scale_f32,
                      int bias_f32, int t_f32, int width, int tile_rows, int slots,
                      int blocks, int device, cudaStream_t stream) {
  const int size = dtype == 2 ? 4 : 2;
  const bool nhwc = channels_last != 0;
  if (dtype < 0 || dtype > 2 || vec < 1 || width < vec || width % vec || tile_rows < 1 ||
      slots < 1 || slots > kMaxSlots || blocks < 1 || width / vec > kPThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  PParams p;
  p.x = x;
  p.t = t;
  p.scale = scale;
  p.bias = bias;
  p.y = y;
  p.barrier = reinterpret_cast<unsigned long long*>(work);
  p.partials = work + 4;
  p.c = c;
  p.hw = hw;
  p.cg = c / groups;
  if (nhwc) {  // a vector spans at most two groups; their mean and rstd fit `red`
    if (width != c || vec - 1 > p.cg || 2 * groups > kRedFloats) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    p.segs = n;
    p.seg_rows = hw;
    p.gs = groups;
  } else {  // a row lies in one channel; the group's A and B fit `red`
    if (hw % width || 2 + 2 * p.cg > kRedFloats) return static_cast<int>(cudaErrorInvalidValue);
    p.segs = n * groups;
    p.seg_rows = static_cast<int>(static_cast<long long>(p.cg) * hw / width);
    p.gs = 1;
  }
  p.width = width;
  p.tile_rows = tile_rows;
  p.tps = (p.seg_rows + tile_rows - 1) / tile_rows;
  p.tiles = static_cast<long long>(p.segs) * p.tps;
  p.slots = slots;
  p.slot_bytes = (tile_rows * width * size + 127) / 128 * 128;
  if (static_cast<long long>(slots) * p.slot_bytes + kSmemFixed > kPersistentSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  p.eps = eps;
  p.silu = silu;
  p.scale_f32 = scale_f32;
  p.bias_f32 = bias_f32;
  p.t_f32 = t_f32;
  p.bulk = (width * size) % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  return on_device(device, [&]() -> cudaError_t {
    if (dtype == 0) {
      return launch_persistent_layout<__nv_bfloat16>(p, nhwc, vec, blocks, device, stream);
    }
    if (dtype == 1) return launch_persistent_layout<__half>(p, nhwc, vec, blocks, device, stream);
    return launch_persistent_layout<float>(p, nhwc, vec, blocks, device, stream);
  });
}

}  // namespace gn
}  // namespace pea
