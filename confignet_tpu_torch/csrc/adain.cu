// Fused AdaIN, forward and backward, on a (B, P, C) channels-last view:
//     out = (x - mean) * rstd * (scale + 1) + bias,  rstd = rsqrt(var + eps),
// per (sample, channel) statistics over all P spatial positions in float32,
// var the biased variance mean((x - mean)^2), out in x's dtype.  The forward
// also writes stats (B, 2, C) float32 = (mean, rstd), which the backward
// reads:
//     dbias = sum_p g,  dscale = sum_p g * xhat,  xhat = (x - mean) * rstd,
//     dx = rstd * (scale + 1) * (g - dbias / P - xhat * dscale / P).
//
// Replaces the Pallas TPU kernel _adain_kernel
// (confignet_tpu/ops/adain_pallas.py, launched by _fused_adain_3dview) and
// the XLA backward _fused_adain_bwd of the same file.  The TPU kernel keeps
// one sample's whole (P, C) slab in VMEM.  A Hopper block has at most 227 KB
// of shared memory, the 256px slabs reach 2 MB (128^2 x 32 float32), and
// one block per sample would leave most of the 132 SMs idle.
//
// Bound: memory.  The least traffic is one read of x and one write of out
// (forward), one read of x and g and one write of dx (backward).
//
// Route 1, one pass (adain_fwd_cluster, adain_bwd_cluster).  The (P, group)
// slab of one sample and one group of channels is cut across the `parts`
// blocks of a thread block cluster.  Each block copies its rows into shared
// memory once (16-byte cp.async where the channel count allows) and keeps
// them there.  Forward: the block's per-channel sum, then the sum of squares
// about its own mean from the resident rows (no division per element, no
// E[x^2] - E[x]^2 cancellation).  Backward: sum g and sum g * xhat, each of
// four stages of the copy summed as it lands (the forward's centred sums
// need the whole block first; staging it measured no faster).  Each
// block leaves its partials in its own shared memory, the cluster
// synchronises, and every block reads all partials through distributed
// shared memory and merges them in rank order: every block, and every run,
// gets the same bits, without atomics.  Then each block writes its resident
// rows once.  That is the bound's traffic: x read once, out written once
// (forward); x and g read once, dx written once (backward).
//
// Route 2, one pass over co-resident blocks (adain_fwd_resident,
// adain_bwd_resident), for slabs that no cluster holds but the card's SMs
// do (the 512px site 256^2 x 16: 4 MB a sample in float32, 2 MB in
// bfloat16).  One sample's (P, group) slab is cut over `parts` ordinary
// blocks of up to the whole opt-in shared memory, one block per SM; the
// grid is launched cooperatively, so every block is resident and a block
// may wait for the others.  The blocks walk the (sample, group) work items
// persistently, `wave` items at a time.  Each block copies its rows into
// shared memory once, in four cp.async stages, and sums each stage as it
// lands (the forward's sums shifted by the thread's first value, one
// division per thread).  It writes its partials to a float32 scratch
// (B, parts, 2, C), raises the item's arrival counter with release
// semantics and waits with acquire loads until all `parts` have arrived
// (counters zeroed by the wrapper on every call).  Every block then merges
// the parts' partials in part order with the cluster route's formula, so
// every block, and every run, gets the same bits, without float atomics,
// and writes its resident rows once: the bound's traffic again.
//
// Both routes use the same thread layout: 256 threads, each owning `vec`
// neighbouring channels (16 bytes, or 1 channel where C does not allow
// that) of the group and every lanes-th row; per-channel sums over the rows
// of a block are a tree over the lanes in shared memory, in a fixed order.
// Which route and which (group, parts, wave) a shape takes is decided in
// Python (ops/adain_cuda.py adain_route) from the shape, the dtype, the
// card's shared memory per block and its SM count; adain_route refuses a
// slab that neither route holds.  shared_bytes() here repeats its
// arithmetic for the shared memory size.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDevices = 64;

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

// Rows a block covers at once: a power of two, lanes * (group / vec) <= 256.
__host__ __device__ inline int lanes_for(int group, int vec) {
  const int cols = group / vec;
  int lanes = 1;
  while (lanes * 2 * cols <= kThreads) lanes *= 2;
  return lanes;
}

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

__device__ __forceinline__ float load_param(const void* p, int dtype, size_t i) {
  return dtype == kBFloat16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
                            : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ void store_param(void* p, int dtype, size_t i, float v) {
  if (dtype == kBFloat16) {
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16(v);
  } else {
    static_cast<float*>(p)[i] = v;
  }
}

// Copy one pack from global to shared memory: cp.async for 16 bytes, a
// plain load and store otherwise (cp.async takes no 2-byte copies).
template <typename T, int VEC>
__device__ __forceinline__ void copy_pack(T* dst, const T* src) {
  if constexpr (sizeof(Pack<T, VEC>) == 16) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
  } else {
    *reinterpret_cast<Pack<T, VEC>*>(dst) = *reinterpret_cast<const Pack<T, VEC>*>(src);
  }
}

__device__ __forceinline__ void copies_done() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

constexpr int kStages = 4;

__device__ __forceinline__ void commit_stage() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until the thread's copies of stages 0 .. s have landed.
__device__ __forceinline__ void wait_stage(int s) {
  switch (kStages - 1 - s) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void load_f32(const T* p, float (&out)[VEC]) {
  const Pack<T, VEC> pack = *reinterpret_cast<const Pack<T, VEC>*>(p);
#pragma unroll
  for (int i = 0; i < VEC; ++i) out[i] = to_f32(pack.v[i]);
}

template <typename T, int VEC>
__device__ __forceinline__ void store_from_f32(T* p, const float (&in)[VEC]) {
  Pack<T, VEC> pack;
#pragma unroll
  for (int i = 0; i < VEC; ++i) pack.v[i] = from_f32<T>(in[i]);
  *reinterpret_cast<Pack<T, VEC>*>(p) = pack;
}

// Per-block thread layout: thread -> (column of `vec` channels, lane of rows).
struct Layout {
  int col, lane, lanes;
  bool active;  // the thread owns a column (tail threads beyond lanes * cols idle)
  __device__ Layout(int group, int vec) {
    const int cols = group / vec;
    lanes = lanes_for(group, vec);
    col = threadIdx.x % cols;
    lane = threadIdx.x / cols;
    active = lane < lanes;
  }
};

// Sum v over the lanes for every channel of the group: a tree in `red`
// (lanes x group floats), fixed order.  Every thread then reads the totals
// from red[0 .. group).  Ends with __syncthreads; the caller syncs again
// before reusing red.
template <int VEC>
__device__ __forceinline__ void lane_sum(const Layout& t, int group, float* red,
                                         const float (&v)[VEC]) {
  if (t.active) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) red[t.lane * group + t.col * VEC + i] = v[i];
  }
  __syncthreads();
  for (int stride = t.lanes / 2; stride > 0; stride >>= 1) {
    if (t.active && t.lane < stride) {
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        red[t.lane * group + t.col * VEC + i] += red[(t.lane + stride) * group + t.col * VEC + i];
    }
    __syncthreads();
  }
}

// Split cluster barrier: arrive once this block is done reading the other
// blocks' shared memory, wait before exiting (a block's shared memory must
// outlive every remote read of it).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// How many rows part `k` holds when P rows are cut into parts of `per` rows.
__host__ __device__ inline int part_rows(int P, int per, int k) {
  const int begin = k * per;
  const int end = P < begin + per ? P : begin + per;
  return end > begin ? end - begin : 0;
}

// ---------------------------------------------------------------------------
// Route 1: one pass per cluster.  grid (parts * groups, B), cluster (parts).
// Shared memory: tiles (per x 16-byte-aligned rows * group of T), then
// red (lanes * group floats), part (2 * group floats, read by the whole
// cluster) and merged (3 * group floats).
// ---------------------------------------------------------------------------

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
adain_fwd_cluster(const T* __restrict__ x, const void* __restrict__ scale,
                  const void* __restrict__ bias, T* __restrict__ out, float* __restrict__ stats,
                  int P, int C, int group, int parts, long long scale_stride,
                  long long bias_stride, int scale_dtype, int bias_dtype, float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int c0 = (blockIdx.x / parts) * group;
  const int b = blockIdx.y;
  const int per = (P + parts - 1) / parts;
  const int row0 = rank * per;
  const int rows = part_rows(P, per, rank);
  const Layout t(group, VEC);
  T* tile = reinterpret_cast<T*>(smem);
  float* red = reinterpret_cast<float*>(smem + align16((size_t)per * group * sizeof(T)));
  float* part = red + t.lanes * group;  // (sum, M2) per channel of the group
  float* merged = part + 2 * group;     // (mean, gain, shift) per channel, this block's copy
  const int c = c0 + t.col * VEC;       // first channel of this thread's column
  const bool live = t.active && c < C;  // C % VEC == 0, so a column is all in or all out

  const T* xb = x + ((size_t)b * P + row0) * C;
  if (live) {
    for (int r = t.lane; r < rows; r += t.lanes)
      copy_pack<T, VEC>(tile + (size_t)r * group + t.col * VEC, xb + (size_t)r * C + c);
  }
  copies_done();
  __syncthreads();

  // block sum, then the sum of squares about the block's mean
  float acc[VEC] = {};
  if (live) {
    for (int r = t.lane; r < rows; r += t.lanes) {
      float v[VEC];
      load_f32<T, VEC>(tile + (size_t)r * group + t.col * VEC, v);
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] += v[i];
    }
  }
  lane_sum<VEC>(t, group, red, acc);
  float local_mean[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) local_mean[i] = rows > 0 ? red[t.col * VEC + i] / rows : 0.f;
  if (t.active && t.lane == 0) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) part[t.col * VEC + i] = red[t.col * VEC + i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
  if (live) {
    for (int r = t.lane; r < rows; r += t.lanes) {
      float v[VEC];
      load_f32<T, VEC>(tile + (size_t)r * group + t.col * VEC, v);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float d = v[i] - local_mean[i];
        acc[i] += d * d;
      }
    }
  }
  lane_sum<VEC>(t, group, red, acc);
  if (t.active && t.lane == 0) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) part[group + t.col * VEC + i] = red[t.col * VEC + i];
  }
  cluster.sync();  // every block's partials are written and visible

  // one thread per channel merges the cluster's partials in rank order:
  // mean from the sums, then M2 = sum_k (M2_k + n_k (mean_k - mean)^2)
  const int j = threadIdx.x;
  if (j < group && c0 + j < C) {
    float total = 0.f, m2 = 0.f;
    for (int k = 0; k < parts; ++k) total += cluster.map_shared_rank(part, k)[j];
    const float mean = total / P;
    for (int k = 0; k < parts; ++k) {
      const int nk = part_rows(P, per, k);
      if (nk == 0) continue;
      const float* pk = cluster.map_shared_rank(part, k);
      const float d = pk[j] / nk - mean;
      m2 += pk[group + j] + nk * d * d;
    }
    const float rstd = rsqrtf(m2 / P + eps);
    merged[j] = mean;
    merged[group + j] = rstd * (load_param(scale, scale_dtype, b * scale_stride + c0 + j) + 1.f);
    merged[2 * group + j] = load_param(bias, bias_dtype, b * bias_stride + c0 + j);
    if (rank == 0) {
      stats[(size_t)b * 2 * C + c0 + j] = mean;
      stats[(size_t)b * 2 * C + C + c0 + j] = rstd;
    }
  }
  cluster_arrive();  // done reading the other blocks' shared memory
  __syncthreads();
  float mean[VEC], gain[VEC], shift[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    mean[i] = merged[t.col * VEC + i];
    gain[i] = merged[group + t.col * VEC + i];
    shift[i] = merged[2 * group + t.col * VEC + i];
  }

  if (live) {
    T* ob = out + ((size_t)b * P + row0) * C;
    for (int r = t.lane; r < rows; r += t.lanes) {
      float v[VEC];
      load_f32<T, VEC>(tile + (size_t)r * group + t.col * VEC, v);
#pragma unroll
      for (int i = 0; i < VEC; ++i) v[i] = (v[i] - mean[i]) * gain[i] + shift[i];
      store_from_f32<T, VEC>(ob + (size_t)r * C + c, v);
    }
  }
  cluster_wait();
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
adain_bwd_cluster(const T* __restrict__ x, const T* __restrict__ g,
                  const float* __restrict__ stats, const void* __restrict__ scale,
                  T* __restrict__ dx, void* __restrict__ dscale, void* __restrict__ dbias, int P,
                  int C, int group, int parts, long long scale_stride, int scale_dtype,
                  int dscale_dtype, int dbias_dtype) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int c0 = (blockIdx.x / parts) * group;
  const int b = blockIdx.y;
  const int per = (P + parts - 1) / parts;
  const int row0 = rank * per;
  const int rows = part_rows(P, per, rank);
  const Layout t(group, VEC);
  const size_t tile_bytes = align16((size_t)per * group * sizeof(T));
  T* xt = reinterpret_cast<T*>(smem);
  T* gt = reinterpret_cast<T*>(smem + tile_bytes);
  float* red = reinterpret_cast<float*>(smem + 2 * tile_bytes);
  float* part = red + t.lanes * group;  // (sum g, sum g * xhat) per channel
  float* merged = part + 2 * group;     // (k1, a, bcoef) per channel, this block's copy
  const int c = c0 + t.col * VEC;
  const bool live = t.active && c < C;

  const size_t base = ((size_t)b * P + row0) * C;
  float mean[VEC] = {}, rstd[VEC] = {}, sg[VEC] = {}, sgx[VEC] = {};
  if (live) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      mean[i] = stats[(size_t)b * 2 * C + c + i];
      rstd[i] = stats[(size_t)b * 2 * C + C + c + i];
    }
  }
  // copy in kStages stages of a multiple of lanes rows, summing each stage
  // as it lands: a thread reads back only what it copied itself
  const int stage_rows = ((rows + kStages - 1) / kStages + t.lanes - 1) / t.lanes * t.lanes;
  for (int st = 0; st < kStages; ++st) {
    if (live) {
      const int end = min(rows, (st + 1) * stage_rows);
      for (int r = st * stage_rows + t.lane; r < end; r += t.lanes) {
        const size_t s = (size_t)r * group + t.col * VEC, gidx = base + (size_t)r * C + c;
        copy_pack<T, VEC>(xt + s, x + gidx);
        copy_pack<T, VEC>(gt + s, g + gidx);
      }
    }
    commit_stage();
  }
  for (int st = 0; st < kStages; ++st) {
    wait_stage(st);
    if (!live) continue;
    const int end = min(rows, (st + 1) * stage_rows);
    for (int r = st * stage_rows + t.lane; r < end; r += t.lanes) {
      float xv[VEC], gv[VEC];
      load_f32<T, VEC>(xt + (size_t)r * group + t.col * VEC, xv);
      load_f32<T, VEC>(gt + (size_t)r * group + t.col * VEC, gv);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        sg[i] += gv[i];
        sgx[i] += gv[i] * ((xv[i] - mean[i]) * rstd[i]);
      }
    }
  }
  lane_sum<VEC>(t, group, red, sg);
  if (t.active && t.lane == 0) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) part[t.col * VEC + i] = red[t.col * VEC + i];
  }
  __syncthreads();
  lane_sum<VEC>(t, group, red, sgx);
  if (t.active && t.lane == 0) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) part[group + t.col * VEC + i] = red[t.col * VEC + i];
  }
  cluster.sync();

  // one thread per channel sums the cluster's partials in rank order
  const int j = threadIdx.x;
  if (j < group && c0 + j < C) {
    float db = 0.f, ds = 0.f;
    for (int k = 0; k < parts; ++k) {
      const float* pk = cluster.map_shared_rank(part, k);
      db += pk[j];
      ds += pk[group + j];
    }
    const float rstd_j = stats[(size_t)b * 2 * C + C + c0 + j];
    merged[j] = rstd_j * (load_param(scale, scale_dtype, b * scale_stride + c0 + j) + 1.f);
    merged[group + j] = db / P;
    merged[2 * group + j] = ds / P;
    if (rank == 0) {
      store_param(dbias, dbias_dtype, (size_t)b * C + c0 + j, db);
      store_param(dscale, dscale_dtype, (size_t)b * C + c0 + j, ds);
    }
  }
  cluster_arrive();
  __syncthreads();
  float k1[VEC], a[VEC], bcoef[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    k1[i] = merged[t.col * VEC + i];
    a[i] = merged[group + t.col * VEC + i];
    bcoef[i] = merged[2 * group + t.col * VEC + i];
  }

  if (live) {
    for (int r = t.lane; r < rows; r += t.lanes) {
      float xv[VEC], gv[VEC];
      load_f32<T, VEC>(xt + (size_t)r * group + t.col * VEC, xv);
      load_f32<T, VEC>(gt + (size_t)r * group + t.col * VEC, gv);
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        gv[i] = k1[i] * (gv[i] - a[i] - (xv[i] - mean[i]) * rstd[i] * bcoef[i]);
      store_from_f32<T, VEC>(dx + base + (size_t)r * C + c, gv);
    }
  }
  cluster_wait();
}

// ---------------------------------------------------------------------------
// Route 2: one pass over co-resident blocks.  grid (wave * parts), launched
// cooperatively; block -> (slot = blockIdx.x / parts, part k = blockIdx.x %
// parts), and slot s takes the work items (sample, group) s, s + wave, ...
// partial (B, parts, 2, C) float32; arrived (B * groups) uint32, zero at
// launch.  Shared memory: tiles (per x 16-byte-aligned rows * group of T),
// then red (lanes * group floats), merged (3 * group floats) and gathered
// (parts * 2 * group floats).  A thread reads back only the rows it copied,
// and a part has the same rows in every item, so while a thread writes out
// one item's rows it copies the next item's into the same places.
// ---------------------------------------------------------------------------

// Publish this block's partials of one item (stored before the call) and
// wait until all `parts` blocks of the item have published theirs.
__device__ __forceinline__ void arrive_and_wait(unsigned* arrived, int parts) {
  __syncthreads();  // every thread's partial stores precede the release
  if (threadIdx.x == 0) {
    __threadfence();
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n" ::"l"(arrived) : "memory");
    unsigned seen = 0;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(seen) : "l"(arrived) : "memory");
    } while (seen < static_cast<unsigned>(parts));
    __threadfence();
  }
  __syncthreads();
}

// Copy every part's (2, group) partials of sample b, channels c0 .., into
// gathered (parts, 2, group), through L2: one round trip for all parts.
__device__ __forceinline__ void gather_partials(const float* partial, float* gathered, int b,
                                                int parts, int C, int c0, int group) {
  const int n = parts * 2 * group;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int kk = i / (2 * group), s = (i / group) % 2, j = i % group;
    gathered[i] = c0 + j < C ? __ldcg(partial + ((size_t)(b * parts + kk) * 2 + s) * C + c0 + j)
                             : 0.f;
  }
  __syncthreads();
}

// Sum one of the gathered partials (sel 0 or 1) of channel m.col over the
// parts in a fixed order: lane l takes parts l, l + lanes, ... and the
// lanes are summed as a tree (lane_sum); every thread then reads the
// totals from red[0 .. group).  m is the one-channel layout Layout(group, 1).
__device__ __forceinline__ void sum_parts(const Layout& m, int group, int parts, int sel,
                                          const float* gathered, float* red) {
  float v[1] = {0.f};
  if (m.active) {
    for (int kk = m.lane; kk < parts; kk += m.lanes) v[0] += gathered[(kk * 2 + sel) * group + m.col];
  }
  lane_sum<1>(m, group, red, v);
}

// Rows per copy stage: a multiple of lanes, kStages stages cover `rows`.
__device__ __forceinline__ int stage_rows_for(int rows, int lanes) {
  return ((rows + kStages - 1) / kStages + lanes - 1) / lanes * lanes;
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads, 1)
adain_fwd_resident(const T* __restrict__ x, const void* __restrict__ scale,
                   const void* __restrict__ bias, T* __restrict__ out, float* __restrict__ stats,
                   float* __restrict__ partial, unsigned* __restrict__ arrived, int B, int P, int C,
                   int group, int parts, long long scale_stride, long long bias_stride,
                   int scale_dtype, int bias_dtype, float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout t(group, VEC);
  const Layout m(group, 1);
  const int groups = (C + group - 1) / group, items = B * groups;
  const int wave = gridDim.x / parts, slot = blockIdx.x / parts, k = blockIdx.x % parts;
  const int per = (P + parts - 1) / parts;
  const int row0 = k * per;
  const int rows = part_rows(P, per, k);
  const int stage_rows = stage_rows_for(rows, t.lanes);
  T* tile = reinterpret_cast<T*>(smem);
  float* red = reinterpret_cast<float*>(smem + align16((size_t)per * group * sizeof(T)));
  float* merged = red + t.lanes * group;  // (mean, gain, shift) per channel
  float* gathered = merged + 3 * group;   // (parts, sum / M2, group)
  auto source = [&](int item) {
    return x + ((size_t)(item / groups) * P + row0) * C;
  };
  auto live_in = [&](int item) { return t.active && (item % groups) * group + t.col * VEC < C; };

  if (slot < items) {  // the first item's rows, in kStages committed groups
    const int c = (slot % groups) * group + t.col * VEC;
    const bool live = live_in(slot);
    for (int st = 0; st < kStages; ++st) {
      if (live) {
        const int end = min(rows, (st + 1) * stage_rows);
        for (int r = st * stage_rows + t.lane; r < end; r += t.lanes)
          copy_pack<T, VEC>(tile + (size_t)r * group + t.col * VEC, source(slot) + (size_t)r * C + c);
      }
      commit_stage();
    }
  }
  for (int item = slot; item < items; item += wave) {
    const int b = item / groups, c0 = (item % groups) * group;
    const int c = c0 + t.col * VEC;
    const bool live = live_in(item);
    __syncthreads();  // the previous item is done with red, merged and gathered
    // the thread's sums shifted by its first value, each stage as it lands
    float shift[VEC] = {}, s1[VEC] = {}, s2[VEC] = {};
    int n = 0;
    for (int st = 0; st < kStages; ++st) {
      wait_stage(st);
      if (!live) continue;
      const int end = min(rows, (st + 1) * stage_rows);
      for (int r = st * stage_rows + t.lane; r < end; r += t.lanes) {
        float v[VEC];
        load_f32<T, VEC>(tile + (size_t)r * group + t.col * VEC, v);
        if (n == 0) {
#pragma unroll
          for (int i = 0; i < VEC; ++i) shift[i] = v[i];
        }
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const float d = v[i] - shift[i];
          s1[i] += d;
          s2[i] += d * d;
        }
        ++n;
      }
    }
    // the block's (sum, M2): sum = n s + s1, M2 = s2 - s1^2 / n
    float sum[VEC], m2[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      sum[i] = n * shift[i] + s1[i];
      m2[i] = n > 0 ? s2[i] - s1[i] * s1[i] / n : 0.f;
    }
    lane_sum<VEC>(t, group, red, sum);
    float block_mean[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) block_mean[i] = rows > 0 ? red[t.col * VEC + i] / rows : 0.f;
    float* mine = partial + ((size_t)b * parts + k) * 2 * C;
    if (live && t.lane == 0) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) mine[c + i] = red[t.col * VEC + i];
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float d = n > 0 ? sum[i] / n - block_mean[i] : 0.f;
      m2[i] += n * d * d;
    }
    lane_sum<VEC>(t, group, red, m2);
    if (live && t.lane == 0) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) mine[C + c + i] = red[t.col * VEC + i];
    }
    arrive_and_wait(arrived + item, parts);
    gather_partials(partial, gathered, b, parts, C, c0, group);

    // merge the parts in a fixed order (the cluster route's formula): the
    // mean from the sums, then M2 = sum_k (M2_k + n_k (mean_k - mean)^2);
    // every block of the item gets the same bits
    sum_parts(m, group, parts, 0, gathered, red);
    const float mean_j = red[m.col] / P;
    __syncthreads();
    float v[1] = {0.f};
    if (m.active) {
      for (int kk = m.lane; kk < parts; kk += m.lanes) {
        const int nk = part_rows(P, per, kk);
        if (nk == 0) continue;
        const float d = gathered[kk * 2 * group + m.col] / nk - mean_j;
        v[0] += gathered[(kk * 2 + 1) * group + m.col] + nk * d * d;
      }
    }
    lane_sum<1>(m, group, red, v);
    const int j = threadIdx.x;
    if (j < group && c0 + j < C) {
      const float rstd = rsqrtf(red[j] / P + eps);
      merged[j] = mean_j;  // thread j < group has m.col == j
      merged[group + j] = rstd * (load_param(scale, scale_dtype, b * scale_stride + c0 + j) + 1.f);
      merged[2 * group + j] = load_param(bias, bias_dtype, b * bias_stride + c0 + j);
      if (k == 0) {
        stats[(size_t)b * 2 * C + c0 + j] = mean_j;
        stats[(size_t)b * 2 * C + C + c0 + j] = rstd;
      }
    }
    __syncthreads();

    // write this item's rows; behind each, copy the next item's row in
    const int next = item + wave;
    const bool live_next = next < items && live_in(next);
    const T* next_src = source(next < items ? next : item);
    const int c_next = (next % groups) * group + t.col * VEC;
    float mean[VEC], gain[VEC], bshift[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      mean[i] = merged[t.col * VEC + i];
      gain[i] = merged[group + t.col * VEC + i];
      bshift[i] = merged[2 * group + t.col * VEC + i];
    }
    T* ob = out + ((size_t)b * P + row0) * C;
    for (int st = 0; st < kStages; ++st) {
      const int end = min(rows, (st + 1) * stage_rows);
      for (int r = st * stage_rows + t.lane; r < end; r += t.lanes) {
        T* row = tile + (size_t)r * group + t.col * VEC;
        if (live) {
          float w[VEC];
          load_f32<T, VEC>(row, w);
#pragma unroll
          for (int i = 0; i < VEC; ++i) w[i] = (w[i] - mean[i]) * gain[i] + bshift[i];
          store_from_f32<T, VEC>(ob + (size_t)r * C + c, w);  // issued after the row is read
        }
        if (live_next) copy_pack<T, VEC>(row, next_src + (size_t)r * C + c_next);
      }
      commit_stage();
    }
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads, 1)
adain_bwd_resident(const T* __restrict__ x, const T* __restrict__ g,
                   const float* __restrict__ stats, const void* __restrict__ scale,
                   T* __restrict__ dx, void* __restrict__ dscale, void* __restrict__ dbias,
                   float* __restrict__ partial, unsigned* __restrict__ arrived, int B, int P, int C,
                   int group, int parts, long long scale_stride, int scale_dtype,
                   int dscale_dtype, int dbias_dtype) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout t(group, VEC);
  const Layout m(group, 1);
  const int groups = (C + group - 1) / group, items = B * groups;
  const int wave = gridDim.x / parts, slot = blockIdx.x / parts, k = blockIdx.x % parts;
  const int per = (P + parts - 1) / parts;
  const int row0 = k * per;
  const int rows = part_rows(P, per, k);
  const int stage_rows = stage_rows_for(rows, t.lanes);
  const size_t tile_bytes = align16((size_t)per * group * sizeof(T));
  T* xt = reinterpret_cast<T*>(smem);
  T* gt = reinterpret_cast<T*>(smem + tile_bytes);
  float* red = reinterpret_cast<float*>(smem + 2 * tile_bytes);
  float* merged = red + t.lanes * group;  // (k1, a, bcoef) per channel
  float* gathered = merged + 3 * group;   // (parts, sum g / sum g * xhat, group)
  auto offset = [&](int item) { return ((size_t)(item / groups) * P + row0) * C; };
  auto live_in = [&](int item) { return t.active && (item % groups) * group + t.col * VEC < C; };

  if (slot < items) {
    const int c = (slot % groups) * group + t.col * VEC;
    const bool live = live_in(slot);
    for (int st = 0; st < kStages; ++st) {
      if (live) {
        const int end = min(rows, (st + 1) * stage_rows);
        for (int r = st * stage_rows + t.lane; r < end; r += t.lanes) {
          const size_t s = (size_t)r * group + t.col * VEC, gidx = offset(slot) + (size_t)r * C + c;
          copy_pack<T, VEC>(xt + s, x + gidx);
          copy_pack<T, VEC>(gt + s, g + gidx);
        }
      }
      commit_stage();
    }
  }
  for (int item = slot; item < items; item += wave) {
    const int b = item / groups, c0 = (item % groups) * group;
    const int c = c0 + t.col * VEC;
    const bool live = live_in(item);
    const size_t base = offset(item);
    __syncthreads();  // the previous item is done with red, merged and gathered
    float mean[VEC] = {}, rstd[VEC] = {}, sg[VEC] = {}, sgx[VEC] = {};
    if (live) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        mean[i] = stats[(size_t)b * 2 * C + c + i];
        rstd[i] = stats[(size_t)b * 2 * C + C + c + i];
      }
    }
    for (int st = 0; st < kStages; ++st) {
      wait_stage(st);
      if (!live) continue;
      const int end = min(rows, (st + 1) * stage_rows);
      for (int r = st * stage_rows + t.lane; r < end; r += t.lanes) {
        float xv[VEC], gv[VEC];
        load_f32<T, VEC>(xt + (size_t)r * group + t.col * VEC, xv);
        load_f32<T, VEC>(gt + (size_t)r * group + t.col * VEC, gv);
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          sg[i] += gv[i];
          sgx[i] += gv[i] * ((xv[i] - mean[i]) * rstd[i]);
        }
      }
    }
    float* mine = partial + ((size_t)b * parts + k) * 2 * C;
    lane_sum<VEC>(t, group, red, sg);
    if (live && t.lane == 0) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) mine[c + i] = red[t.col * VEC + i];
    }
    __syncthreads();
    lane_sum<VEC>(t, group, red, sgx);
    if (live && t.lane == 0) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) mine[C + c + i] = red[t.col * VEC + i];
    }
    arrive_and_wait(arrived + item, parts);
    gather_partials(partial, gathered, b, parts, C, c0, group);

    // sum the parts in a fixed order: every block of the item gets the same bits
    sum_parts(m, group, parts, 0, gathered, red);
    const float db = red[m.col];
    __syncthreads();
    sum_parts(m, group, parts, 1, gathered, red);
    const int j = threadIdx.x;
    if (j < group && c0 + j < C) {
      const float ds = red[j];
      const float rstd_j = stats[(size_t)b * 2 * C + C + c0 + j];
      merged[j] = rstd_j * (load_param(scale, scale_dtype, b * scale_stride + c0 + j) + 1.f);
      merged[group + j] = db / P;  // thread j < group has m.col == j
      merged[2 * group + j] = ds / P;
      if (k == 0) {
        store_param(dbias, dbias_dtype, (size_t)b * C + c0 + j, db);
        store_param(dscale, dscale_dtype, (size_t)b * C + c0 + j, ds);
      }
    }
    __syncthreads();

    // write this item's rows; behind each, copy the next item's row in
    const int next = item + wave;
    const bool live_next = next < items && live_in(next);
    const size_t next_base = offset(next < items ? next : item);
    const int c_next = (next % groups) * group + t.col * VEC;
    float k1[VEC], a[VEC], bcoef[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      k1[i] = merged[t.col * VEC + i];
      a[i] = merged[group + t.col * VEC + i];
      bcoef[i] = merged[2 * group + t.col * VEC + i];
    }
    for (int st = 0; st < kStages; ++st) {
      const int end = min(rows, (st + 1) * stage_rows);
      for (int r = st * stage_rows + t.lane; r < end; r += t.lanes) {
        const size_t s = (size_t)r * group + t.col * VEC;
        if (live) {
          float xv[VEC], gv[VEC];
          load_f32<T, VEC>(xt + s, xv);
          load_f32<T, VEC>(gt + s, gv);
#pragma unroll
          for (int i = 0; i < VEC; ++i)
            gv[i] = k1[i] * (gv[i] - a[i] - (xv[i] - mean[i]) * rstd[i] * bcoef[i]);
          store_from_f32<T, VEC>(dx + base + (size_t)r * C + c, gv);  // after both rows are read
        }
        if (live_next) {
          const size_t gidx = next_base + (size_t)r * C + c_next;
          copy_pack<T, VEC>(xt + s, x + gidx);
          copy_pack<T, VEC>(gt + s, g + gidx);
        }
      }
      commit_stage();
    }
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

enum Route : int { kOnePass = 0, kResident = 1 };

// Dynamic shared memory of a launch (ops/adain_cuda.py _shared_bytes repeats it).
size_t shared_bytes(int route, int tensors, int P, int group, int vec, int parts, int elem) {
  const size_t red = (size_t)lanes_for(group, vec) * group * sizeof(float);
  const int per = (P + parts - 1) / parts;
  const size_t tiles = tensors * align16((size_t)per * group * elem) + red;
  if (route == kResident) return tiles + (3 + 2 * (size_t)parts) * group * sizeof(float);
  return tiles + 5 * group * sizeof(float);
}

// Opt in once per device to the largest dynamic shared memory for a kernel
// and, for a cluster kernel, to 16-block clusters (one flag array per
// kernel instantiation).
template <auto kernel, bool kCluster>
cudaError_t prepare() {
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (err == cudaSuccess && kCluster)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return err;
}

template <auto kernel, typename... Args>
cudaError_t launch_cluster(dim3 grid, int cluster, size_t smem, cudaStream_t s, Args... args) {
  cudaError_t err = prepare<kernel, true>();
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// A cooperative launch: refused (cudaErrorCooperativeLaunchTooLarge) unless
// every block of the grid can be resident at once, so a block may wait for
// the others without deadlock.
template <auto kernel, typename... Args>
cudaError_t launch_cooperative(int blocks, size_t smem, cudaStream_t s, Args... args) {
  cudaError_t err = prepare<kernel, false>();
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

struct Shape {
  int B, P, C, route, group, vec, parts, wave;
  bool valid(int elem) const {
    if (B < 1 || P < 1 || C < 1 || group < 1 || parts < 1 || B > 65535) return false;
    if (vec != 1 && vec != 16 / elem) return false;
    if (group % vec || C % vec) return false;
    if (route == kOnePass) return parts <= 16;
    return route == kResident && wave >= 1 && (long long)wave * parts <= 65535;
  }
  int groups() const { return (C + group - 1) / group; }
};

template <typename T, int VEC>
cudaError_t run_forward(const Shape& sh, const void* x, const void* scale, const void* bias, void* out,
                    float* stats, float* partial, unsigned* arrived, long long scale_stride,
                    long long bias_stride, int scale_dtype, int bias_dtype, float eps,
                    cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  const size_t smem = shared_bytes(sh.route, 1, sh.P, sh.group, VEC, sh.parts, sizeof(T));
  if (sh.route == kOnePass) {
    return launch_cluster<adain_fwd_cluster<T, VEC>>(
        dim3(sh.parts * sh.groups(), sh.B), sh.parts, smem, s, xt, scale, bias, ot, stats, sh.P,
        sh.C, sh.group, sh.parts, scale_stride, bias_stride, scale_dtype, bias_dtype, eps);
  }
  return launch_cooperative<adain_fwd_resident<T, VEC>>(
      sh.wave * sh.parts, smem, s, xt, scale, bias, ot, stats, partial, arrived, sh.B, sh.P, sh.C,
      sh.group, sh.parts, scale_stride, bias_stride, scale_dtype, bias_dtype, eps);
}

template <typename T, int VEC>
cudaError_t run_backward(const Shape& sh, const void* x, const void* g, const float* stats,
                     const void* scale, void* dx, void* dscale, void* dbias, float* partial,
                     unsigned* arrived, long long scale_stride, int scale_dtype, int dscale_dtype,
                     int dbias_dtype, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(g);
  T* dxt = static_cast<T*>(dx);
  const size_t smem = shared_bytes(sh.route, 2, sh.P, sh.group, VEC, sh.parts, sizeof(T));
  if (sh.route == kOnePass) {
    return launch_cluster<adain_bwd_cluster<T, VEC>>(
        dim3(sh.parts * sh.groups(), sh.B), sh.parts, smem, s, xt, gt, stats, scale, dxt, dscale,
        dbias, sh.P, sh.C, sh.group, sh.parts, scale_stride, scale_dtype, dscale_dtype,
        dbias_dtype);
  }
  return launch_cooperative<adain_bwd_resident<T, VEC>>(
      sh.wave * sh.parts, smem, s, xt, gt, stats, scale, dxt, dscale, dbias, partial, arrived,
      sh.B, sh.P, sh.C, sh.group, sh.parts, scale_stride, scale_dtype, dscale_dtype, dbias_dtype);
}

}  // namespace

// The card's SM count and opt-in shared memory per block.
extern "C" int adain_device_limits(int device, int* sms, int* smem_per_block) {
  cudaError_t err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(smem_per_block, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return (int)err;
}

// x/out: (B, P, C) contiguous, 16-byte aligned when vec > 1, float32 or
// bfloat16 (x_dtype code); scale/bias: (B, C) float32 or bfloat16 with unit
// channel stride and the given row strides; stats: (B, 2, C) float32
// (mean, rstd), written.  route 0: one pass, `parts` blocks per cluster
// (<= 16), partial and arrived unused; route 1: one pass over `parts`
// co-resident blocks per (sample, group), `wave` of them at a time, partial
// (B, parts, 2, C) float32 scratch and arrived (B * groups) uint32
// counters, zero.  Returns cudaErrorInvalidValue for any other route or
// arguments out of range, else the launch's cudaError_t.
extern "C" int adain_forward(const void* x, const void* scale, const void* bias, void* out,
                             float* stats, float* partial, unsigned* arrived, int B, int P, int C,
                             int route, int group, int vec, int parts, int wave,
                             long long scale_stride, long long bias_stride, int x_dtype,
                             int scale_dtype, int bias_dtype, float eps, void* stream) {
  const Shape sh{B, P, C, route, group, vec, parts, wave};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (x_dtype == kBFloat16 && sh.valid(2)) {
    err = vec == 1 ? run_forward<__nv_bfloat16, 1>(sh, x, scale, bias, out, stats, partial, arrived,
                                               scale_stride, bias_stride, scale_dtype, bias_dtype,
                                               eps, s)
                   : run_forward<__nv_bfloat16, 8>(sh, x, scale, bias, out, stats, partial, arrived,
                                               scale_stride, bias_stride, scale_dtype, bias_dtype,
                                               eps, s);
  } else if (x_dtype == kFloat32 && sh.valid(4)) {
    err = vec == 1 ? run_forward<float, 1>(sh, x, scale, bias, out, stats, partial, arrived,
                                       scale_stride, bias_stride, scale_dtype, bias_dtype, eps, s)
                   : run_forward<float, 4>(sh, x, scale, bias, out, stats, partial, arrived,
                                       scale_stride, bias_stride, scale_dtype, bias_dtype, eps, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// x/g/dx: (B, P, C) contiguous in x's dtype; stats: the forward's (B, 2, C)
// float32; scale: (B, C), unit channel stride, row stride given; dscale,
// dbias: (B, C) contiguous, written in their dtype codes.  route, parts,
// wave, partial and arrived as for adain_forward.
extern "C" int adain_backward(const void* x, const void* g, const float* stats, const void* scale,
                              void* dx, void* dscale, void* dbias, float* partial,
                              unsigned* arrived, int B, int P, int C, int route, int group,
                              int vec, int parts, int wave, long long scale_stride, int x_dtype,
                              int scale_dtype, int dscale_dtype, int dbias_dtype, void* stream) {
  const Shape sh{B, P, C, route, group, vec, parts, wave};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (x_dtype == kBFloat16 && sh.valid(2)) {
    err = vec == 1 ? run_backward<__nv_bfloat16, 1>(sh, x, g, stats, scale, dx, dscale, dbias, partial,
                                                arrived, scale_stride, scale_dtype, dscale_dtype,
                                                dbias_dtype, s)
                   : run_backward<__nv_bfloat16, 8>(sh, x, g, stats, scale, dx, dscale, dbias, partial,
                                                arrived, scale_stride, scale_dtype, dscale_dtype,
                                                dbias_dtype, s);
  } else if (x_dtype == kFloat32 && sh.valid(4)) {
    err = vec == 1 ? run_backward<float, 1>(sh, x, g, stats, scale, dx, dscale, dbias, partial,
                                        arrived, scale_stride, scale_dtype, dscale_dtype,
                                        dbias_dtype, s)
                   : run_backward<float, 4>(sh, x, g, stats, scale, dx, dscale, dbias, partial,
                                        arrived, scale_stride, scale_dtype, dscale_dtype,
                                        dbias_dtype, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}
