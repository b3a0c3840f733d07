// Trilinear rotation resample of a (B, S, S, S, C) channels-last volume, and
// its transpose (the gradient with respect to the volume).
//
// Forward: replaces the Pallas TPU kernel _rotate_kernel_full
// (confignet_tpu/ops/rotate_pallas.py:65, launched by rotate_3d_grid_pallas).
// Transpose: replaces _rotate_kernel_grad_grid (rotate_pallas.py:95, launched
// by _rotate_grad_grid through the rotate_3d_grid_fused custom VJP).  The TPU
// kernels build one-hot interpolation matrices for the matrix unit because
// gathers scalarise on a TPU; here a gather is an ordinary load, and both
// kernels work on the 8 trilinear corners directly.  Both compute each
// point's source cell themselves (source_cell below, the float32 formula of
// core/transforms._source_coords), so they pick exactly the cells the plain
// versions pick.
//
// Bound: memory.  The forward must read the volume once and write the output
// once; the transpose must read ct once and write the gradient once.  At the
// generator's shape (S=16, C=128) an x-slab of the volume, the S^2 x C block
// at one source x, is contiguous, and every point's 8 corners lie in two
// adjacent x-slabs, floor_x and ceil_x.
//
// Forward, slab route (rotate3d_slab_forward_kernel).  One block = (sample,
// window of `window` output-x planes, group of `group` channels).  The
// block first computes every point's source cell into shared memory and
// buckets the points by floor_x (a counting sort over S buckets), then walks
// the source slabs s over the window's range [smin, smax].  A ring of three
// slab buffers holds slabs s and s+1 while slab s+2 arrives by 16-byte
// cp.async; bucket s reads its 8 corners from shared memory, interpolates in
// float32 in the gather form's order (x, then y, then z) and writes its
// channel rows with 16-byte stores.  For the reference poses (yaw +-30deg,
// pitch +-10deg) a window of a few output planes spans a few more source
// slabs, so the volume passes through L2 about 1.5-3x instead of 8x (one
// read per corner).  Any 3x3 transform is correct: a degenerate one only
// widens the range (up to all S slabs) or fills one bucket.
//
// Transpose, owner-computes route (rotate3d_owner_transpose_kernel).  One
// block = (sample, source x-slab s, channel group); it owns grad[b, s, :, :,
// group], S^2 cells, and writes them once, in the grid's dtype: no memset, no
// float32 scratch, no cast kernel, no float atomics.  The points that reach
// slab s are those with floor_x in {s-1, s}; the block finds them by
// computing floor_x for all S^3 points and compacts them in point order.  In
// chunks of 512 it computes their cells and lists them per source column z
// in point order (warp ballots, no atomics), with each point's weights for
// its (up to) four cells: the sum, in the plain version's corner order, of
// the weights (wz * wy) * wx of its corners in the cell (two at a clamped
// border, as autodiff adds them).  Warp z owns column z: it walks its list
// in order, loading 8 points' ct rows at once (4 channels a lane), and adds
// ct * weight to the cells (floor_y, z) and (ceil_y, z) of a float32 slab
// accumulator in shared memory.  Every cell sums its points in point order,
// so two launches agree bit for bit.  The block holds the whole 128-channel
// slab accumulator (128 KiB of its 150 KiB) to find and list the points once
// for all channels, so one block runs on an SM; each warp's per-point
// instructions and shared-memory read-modify-writes, not bytes, set its time.
//
// Route "v1" (rotate3d_forward_kernel, rotate3d_transpose_kernel) keeps the
// first kernels: one block per 32 lattice points of a sample, the 8 corners
// read straight from global memory; the transpose adds with float32 atomics
// into a zeroed accumulator (a float32 scratch and a cast kernel for bf16),
// so its last bits vary from run to run.  Only measurements and tests take
// it, as a second reference; ops/rotate_cuda.rotate_plan picks it only for a
// shape the slab kernels cannot take (S > 32 forward, S > 16 transpose).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;        // forward and route v1
constexpr int kPointsPerBlock = 32;  // route v1
constexpr int kRing = 3;             // forward: slab buffers (s, s+1 in use, s+2 arriving)
constexpr int kOwnerThreads = 512;   // transpose: one warp per source column z
constexpr int kOwnerWarps = kOwnerThreads / 32;
constexpr int kChunk = kOwnerThreads;  // transpose: contributing points per chunk, one a thread
constexpr int kMaxSize = 32;         // forward: bucket starts scanned by one warp
constexpr int kMaxOwnerSize = 16;    // transpose: 4-bit cell coordinates, 12-bit point index
constexpr int kMaxDevices = 64;

enum Route : int { kRouteSlab = 0, kRouteV1 = 1 };

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

// One axis of a lattice point's source coordinate: the clamped floor f, the
// clamped ceil c and the fraction w.  Every product and sum is rounded
// separately (no FMA contraction), as in the plain versions.
__device__ __forceinline__ void source_axis(const float* __restrict__ t, int i, const float* rel,
                                            int S, int& f, int& c, float& w) {
  const float center = 0.5f * (float)(S - 1);
  const float last = (float)(S - 1);
  float src = __fadd_rn(__fadd_rn(__fmul_rn(t[3 * i], rel[0]), __fmul_rn(t[3 * i + 1], rel[1])),
                        __fmul_rn(t[3 * i + 2], rel[2]));
  src = fminf(fmaxf(__fadd_rn(src, center), 0.f), last);
  const float fl = fminf(fmaxf(floorf(src), 0.f), last);
  f = (int)fl;
  c = min(f + 1, S - 1);
  w = __fsub_rn(src, fl);
}

__device__ __forceinline__ void lattice_rel(int p, int S, float* rel) {
  const float center = 0.5f * (float)(S - 1);
  rel[0] = (float)(p / (S * S)) - center;
  rel[1] = (float)((p / S) % S) - center;
  rel[2] = (float)(p % S) - center;
}

// Source cell of lattice point p under the 3x3 transform t, applied about the
// grid center: floors f, ceils c and fractions w per axis (x, y, z).  The
// float32 formula of core/transforms._source_coords.
__device__ __forceinline__ void source_cell(const float* __restrict__ t, int p, int S, int* f,
                                            int* c, float* w) {
  float rel[3];
  lattice_rel(p, S, rel);
  for (int i = 0; i < 3; ++i) source_axis(t, i, rel, S, f[i], c[i], w[i]);
}

// floor_x of source_cell for the point at (x, y, z), alone (the same
// arithmetic, so the same answer).
__device__ __forceinline__ int source_floor_x(const float* __restrict__ t, int x, int y, int z,
                                              int S) {
  const float center = 0.5f * (float)(S - 1);
  const float rel[3] = {(float)x - center, (float)y - center, (float)z - center};
  float w;
  int f, c;
  source_axis(t, 0, rel, S, f, c, w);
  return f;
}

// The 8 corner offsets of source_cell in corner order 000, 100, 001, 101,
// 010, 110, 011, 111 (x, z, y bits from the lowest).
__device__ __forceinline__ void corner_offsets(const int* f, const int* c, int S, int* off) {
  const int xs[2] = {f[0], c[0]}, ys[2] = {f[1], c[1]}, zs[2] = {f[2], c[2]};
  for (int k = 0; k < 8; ++k) {
    const int xi = k & 1, zi = (k >> 1) & 1, yi = (k >> 2) & 1;
    off[k] = (xs[xi] * S + ys[yi]) * S + zs[zi];
  }
}

// Copy VEC elements from global to shared memory: cp.async for 16 bytes, a
// plain load and store otherwise.
template <typename T, int VEC>
__device__ __forceinline__ void copy_pack(T* dst, const T* src) {
  if constexpr (sizeof(Pack<T, VEC>) == 16) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
  } else {
    *reinterpret_cast<Pack<T, VEC>*>(dst) = *reinterpret_cast<const Pack<T, VEC>*>(src);
  }
}

__device__ __forceinline__ void commit_copies() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// All but the newest committed group of this thread's copies have landed.
__device__ __forceinline__ void wait_all_but_newest() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

template <typename T, int VEC>
__device__ __forceinline__ void load_f32(const T* p, float* v) {
  const Pack<T, VEC> x = *reinterpret_cast<const Pack<T, VEC>*>(p);
#pragma unroll
  for (int e = 0; e < VEC; ++e) v[e] = to_f32(x.v[e]);
}

template <typename T, int VEC>
__device__ __forceinline__ void store_from_f32(T* p, const float* v) {
  Pack<T, VEC> x;
#pragma unroll
  for (int e = 0; e < VEC; ++e) x.v[e] = from_f32<T>(v[e]);
  *reinterpret_cast<Pack<T, VEC>*>(p) = x;
}

// Bump allocator over the block's dynamic shared memory, 16-byte aligned.
struct Carve {
  unsigned char* cur;
  template <typename U>
  __host__ __device__ U* take(size_t n) {
    U* p = reinterpret_cast<U*>(cur);
    cur += align16(n * sizeof(U));
    return p;
  }
};

// Shared bytes of the slab forward (mirrored by ops/rotate_cuda.py).
__host__ __device__ inline size_t forward_smem(int S, int window, int group, int elem) {
  const size_t plane = (size_t)S * S, npb = (size_t)window * plane;
  return kRing * align16(plane * group * elem) + 4 * align16(npb * 4) + align16(npb * 2) +
         align16(npb) + align16((size_t)(3 * S + 4) * 4);
}

// Shared bytes of the owner-computes transpose (mirrored by ops/rotate_cuda.py).
__host__ __device__ inline size_t transpose_smem(int S, int group) {
  return align16((size_t)S * S * group * 4) + align16((size_t)S * S * S * 2) +
         align16((size_t)kChunk * 4) + align16((size_t)kChunk * 16) + align16(2 * kChunk * 2) +
         2 * align16((size_t)kOwnerWarps * S * 4) + align16((S + 1) * 4) +
         align16((kOwnerWarps + 1) * 4);
}

// ---------------------------------------------------------------------------
// Forward, slab route
// ---------------------------------------------------------------------------

// VEC: channels per 16-byte access, or 1 (scalar copies and stores).
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
rotate3d_slab_forward_kernel(const T* __restrict__ grid, const float* __restrict__ transform,
                             T* __restrict__ out, int S, int C, int window, int group) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int plane = S * S, P = plane * S, npb = window * plane;
  const int windows = (S + window - 1) / window;
  const int b = blockIdx.y;
  const int p0 = (blockIdx.x % windows) * npb;
  const int g0 = (blockIdx.x / windows) * group;
  const int n = min(npb, P - p0);
  const int gw = min(group, C - g0);  // channels of this group (the last may be ragged)
  const int tid = threadIdx.x, lane = tid & 31;

  Carve carve{smem};
  const size_t slab = align16((size_t)plane * group * sizeof(T)) / sizeof(T);
  T* ring = carve.take<T>(kRing * slab);
  float* s_dx = carve.take<float>(npb);
  float* s_dy = carve.take<float>(npb);
  float* s_dz = carve.take<float>(npb);
  // floor_y | ceil_y << 8 | floor_z << 16 | ceil_z << 24
  unsigned* s_yz = carve.take<unsigned>(npb);
  unsigned short* s_order = carve.take<unsigned short>(npb);  // points sorted by floor_x
  unsigned char* s_fx = carve.take<unsigned char>(npb);
  int* s_count = carve.take<int>(3 * S + 4);
  int* s_start = s_count + S;        // S + 1
  int* s_cursor = s_start + S + 1;   // S
  int* s_range = s_cursor + S;       // smin, smax

  float tr[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) tr[i] = __ldg(transform + (size_t)b * 9 + i);
  if (tid < S) s_count[tid] = 0;
  if (tid == 0) {
    s_range[0] = S;
    s_range[1] = -1;
  }
  __syncthreads();

  int lo = S, hi = -1;
  for (int i = tid; i < n; i += kThreads) {
    int f[3], c[3];
    float w[3];
    source_cell(tr, p0 + i, S, f, c, w);
    s_dx[i] = w[0];
    s_dy[i] = w[1];
    s_dz[i] = w[2];
    s_yz[i] = (unsigned)f[1] | ((unsigned)c[1] << 8) | ((unsigned)f[2] << 16) |
              ((unsigned)c[2] << 24);
    s_fx[i] = (unsigned char)f[0];
    atomicAdd(&s_count[f[0]], 1);
    lo = min(lo, f[0]);
    hi = max(hi, f[0]);
  }
  for (int o = 16; o > 0; o >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  if (lane == 0) {
    atomicMin(&s_range[0], lo);
    atomicMax(&s_range[1], hi);
  }
  __syncthreads();

  const int smin = s_range[0], smax = s_range[1];
  const int last = min(smax + 1, S - 1);  // the highest slab a ceil corner reads
  const int gv = gw / VEC;                // packs per row of this group
  const T* src0 = grid + (size_t)b * P * C + g0;
  auto load_slab = [&](int s) {
    T* dst = ring + (size_t)(s % kRing) * slab;
    const T* src = src0 + (size_t)s * plane * C;
    for (int k = tid; k < plane * gv; k += kThreads) {
      const int r = k / gv, v = k - r * gv;
      copy_pack<T, VEC>(dst + (size_t)r * group + v * VEC, src + (size_t)r * C + v * VEC);
    }
  };
  // the first two slabs start arriving while the points are bucketed
  if (smin <= last) load_slab(smin);
  commit_copies();
  if (smin + 1 <= last) load_slab(smin + 1);
  commit_copies();

  if (tid < 32) {  // bucket starts: an exclusive scan of the counts (S <= 32)
    const int cnt = tid < S ? s_count[tid] : 0;
    int x = cnt;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    if (tid < S) {
      s_start[tid] = x - cnt;
      s_cursor[tid] = x - cnt;
    }
    if (tid == S - 1) s_start[S] = x;
  }
  __syncthreads();
  for (int i = tid; i < n; i += kThreads) s_order[atomicAdd(&s_cursor[s_fx[i]], 1)] = i;

  const int lpp = group / VEC;          // threads per point row
  const int ppp = kThreads / lpp;       // points per pass
  const int slot = tid / lpp, v = tid - slot * lpp;
  T* out_b = out + ((size_t)b * P + p0) * C + g0 + v * VEC;
  for (int s = smin; s <= smax; ++s) {
    if (s + 2 <= last) load_slab(s + 2);
    commit_copies();
    wait_all_but_newest();  // slabs s and s + 1
    __syncthreads();
    if (slot < ppp && v < gv) {
      const T* fl = ring + (size_t)(s % kRing) * slab + v * VEC;
      const T* ce = ring + (size_t)(min(s + 1, S - 1) % kRing) * slab + v * VEC;
      for (int k = s_start[s] + slot; k < s_start[s + 1]; k += ppp) {
        const int i = s_order[k];
        const unsigned yz = s_yz[i];
        const int fy = yz & 255, cy = (yz >> 8) & 255, fz = (yz >> 16) & 255, cz = yz >> 24;
        const size_t r00 = (size_t)(fy * S + fz) * group, r01 = (size_t)(fy * S + cz) * group;
        const size_t r10 = (size_t)(cy * S + fz) * group, r11 = (size_t)(cy * S + cz) * group;
        float c000[VEC], c100[VEC], c001[VEC], c101[VEC], c010[VEC], c110[VEC], c011[VEC],
            c111[VEC];
        load_f32<T, VEC>(fl + r00, c000);
        load_f32<T, VEC>(ce + r00, c100);
        load_f32<T, VEC>(fl + r01, c001);
        load_f32<T, VEC>(ce + r01, c101);
        load_f32<T, VEC>(fl + r10, c010);
        load_f32<T, VEC>(ce + r10, c110);
        load_f32<T, VEC>(fl + r11, c011);
        load_f32<T, VEC>(ce + r11, c111);
        const float dx = s_dx[i], dy = s_dy[i], dz = s_dz[i];
        float o[VEC];
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float c00 = c000[e] * (1.f - dx) + c100[e] * dx;
          const float c01 = c001[e] * (1.f - dx) + c101[e] * dx;
          const float c10 = c010[e] * (1.f - dx) + c110[e] * dx;
          const float c11 = c011[e] * (1.f - dx) + c111[e] * dx;
          const float c0 = c00 * (1.f - dy) + c10 * dy;
          const float c1 = c01 * (1.f - dy) + c11 * dy;
          o[e] = c0 * (1.f - dz) + c1 * dz;
        }
        store_from_f32<T, VEC>(out_b + (size_t)i * C, o);
      }
    }
    __syncthreads();  // slab s's buffer is refilled next iteration
  }
}

// ---------------------------------------------------------------------------
// Transpose, owner-computes route
// ---------------------------------------------------------------------------

// Exclusive prefix sum of v over the block; *total gets the block's sum.
__device__ __forceinline__ int block_exclusive_scan(int v, int* scratch, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) scratch[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kOwnerWarps ? scratch[lane] : 0;
    for (int o = 1; o < kOwnerWarps; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    if (lane < kOwnerWarps) scratch[lane] = w;
  }
  __syncthreads();
  const int before = warp ? scratch[warp - 1] : 0;
  *total = scratch[kOwnerWarps - 1];
  __syncthreads();  // scratch is free for the next scan
  return before + x - v;
}

// The weight of a point for gradient cell (y, z) of slab s: the sum, in the
// plain version's corner order (y bit, then z bit, then x bit), of the
// weights (wz * wy) * wx of the point's corners that fall in the cell.
__device__ __forceinline__ float cell_weight(const int* f, const int* c, const float* d, int s,
                                             int y, int z) {
  const int ys[2] = {f[1], c[1]}, zs[2] = {f[2], c[2]}, xs[2] = {f[0], c[0]};
  const float wx[2] = {1.f - d[0], d[0]}, wy[2] = {1.f - d[1], d[1]}, wz[2] = {1.f - d[2], d[2]};
  float w = 0.f;
#pragma unroll
  for (int yi = 0; yi < 2; ++yi)
#pragma unroll
    for (int zi = 0; zi < 2; ++zi)
#pragma unroll
      for (int xi = 0; xi < 2; ++xi)
        if (ys[yi] == y && zs[zi] == z && xs[xi] == s) w += wz[zi] * wy[yi] * wx[xi];
  return w;
}

// LV channels of a row between global memory and float32 registers: one
// vector access where CV > 1 (the row and the channel count 16-byte
// aligned), else scalar accesses to the channels below gw.
template <typename T, int CV, int LV>
__device__ __forceinline__ void store_channels(T* row, int ch, int gw, const float* v) {
  if constexpr (CV > 1) {
    store_from_f32<T, LV>(row + ch, v);
  } else {
#pragma unroll
    for (int k = 0; k < LV; ++k)
      if (ch + k < gw) row[ch + k] = from_f32<T>(v[k]);
  }
}

template <typename T, int CV, int LV>
__device__ __forceinline__ void load_channels(const T* row, int ch, int gw, float* v) {
  if constexpr (CV > 1) {
    load_f32<T, LV>(row + ch, v);
  } else {
#pragma unroll
    for (int k = 0; k < LV; ++k) v[k] = ch + k < gw ? to_f32(row[ch + k]) : 0.f;
  }
}

// CV: channels per 16-byte access, or 1 (scalar).  LV: channels per lane
// (group <= 32 * LV).
template <typename T, int CV, int LV>
__global__ void __launch_bounds__(kOwnerThreads, LV == 4 ? 1 : 2)
rotate3d_owner_transpose_kernel(const T* __restrict__ ct, const float* __restrict__ transform,
                                T* __restrict__ grad, int S, int C, int group) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int plane = S * S, P = plane * S;
  const int b = blockIdx.y;
  const int s = blockIdx.x % S;
  const int g0 = (blockIdx.x / S) * group;
  const int gw = min(group, C - g0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // ct rows a warp loads at once: 8 with 4 channels a lane (one block an SM),
  // 4 otherwise (registers for two blocks an SM)
  constexpr int kRows = LV == 4 ? 8 : 4;

  Carve carve{smem};
  float* acc = carve.take<float>((size_t)plane * group);  // [z][y][channel]
  unsigned short* s_contrib = carve.take<unsigned short>((size_t)P);
  // per chunk point: floor_y | ceil_y << 4 | floor_z << 8 | ceil_z << 12 |
  // point << 16, and the weights of its cells (floor_y, floor_z),
  // (ceil_y, floor_z), (floor_y, ceil_z), (ceil_y, ceil_z)
  unsigned* s_cell = carve.take<unsigned>(kChunk);
  float4* s_weight = carve.take<float4>(kChunk);
  unsigned short* s_list = carve.take<unsigned short>(2 * kChunk);  // chunk points by column
  int* s_wcount = carve.take<int>(kOwnerWarps * S);
  int* s_woff = carve.take<int>(kOwnerWarps * S);
  int* s_cstart = carve.take<int>(S + 1);
  int* s_scan = carve.take<int>(kOwnerWarps + 1);

  float tr[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) tr[i] = __ldg(transform + (size_t)b * 9 + i);
  for (int k = tid; k < plane * group; k += kOwnerThreads) acc[k] = 0.f;

  // The points that reach slab s (floor_x in {s-1, s}), in point order: each
  // thread tests a run of consecutive points, walking z, then y, then x.
  int total = 0;
  for (int base = 0; base < P; base += kOwnerThreads * 32) {
    const int ppt = min(32, (P - base + kOwnerThreads - 1) / kOwnerThreads);
    const int first = base + tid * ppt;
    int x = first / plane, y = (first / S) % S, z = first % S;
    unsigned mask = 0;
    for (int i = 0; i < ppt && first + i < P; ++i) {
      const int fx = source_floor_x(tr, x, y, z, S);
      if (fx == s || fx == s - 1) mask |= 1u << i;
      if (++z == S) {
        z = 0;
        if (++y == S) {
          y = 0;
          ++x;
        }
      }
    }
    int round_total;
    int pos = total + block_exclusive_scan(__popc(mask), s_scan, &round_total);
    while (mask) {
      const int i = __ffs(mask) - 1;
      mask &= mask - 1;
      s_contrib[pos++] = (unsigned short)(first + i);
    }
    total += round_total;
  }

  // Warp w owns column z = w of the slab: its S cells (y, z), LV channels a
  // lane, summed in shared memory across the chunks.
  const int z = warp;
  const int ch = lane * LV;
  const T* ct_b = ct + (size_t)b * P * C + g0;
  const unsigned lanes_below = (1u << lane) - 1;
  for (int cbase = 0; cbase < total; cbase += kChunk) {
    const int n = min(kChunk, total - cbase);
    __syncthreads();  // s_contrib written; the previous chunk's tables are free
    int fz = -1, cz = -1;
    if (tid < n) {
      int f[3], c[3];
      float w[3];
      const int p = s_contrib[cbase + tid];
      source_cell(tr, p, S, f, c, w);
      s_cell[tid] = (unsigned)f[1] | ((unsigned)c[1] << 4) | ((unsigned)f[2] << 8) |
                    ((unsigned)c[2] << 12) | ((unsigned)p << 16);
      s_weight[tid] =
          make_float4(cell_weight(f, c, w, s, f[1], f[2]), cell_weight(f, c, w, s, c[1], f[2]),
                      cell_weight(f, c, w, s, f[1], c[2]), cell_weight(f, c, w, s, c[1], c[2]));
      fz = f[2];
      cz = c[2];
    }
    // the chunk's points by column, in point order: each point's rank among
    // the points of its warp in a column, then per-warp offsets
    int rank_f = 0, rank_c = 0;
    for (int zz = 0; zz < S; ++zz) {
      const unsigned m = __ballot_sync(0xffffffffu, fz == zz || cz == zz);
      if (lane == 0) s_wcount[warp * S + zz] = __popc(m);
      if (fz == zz) rank_f = __popc(m & lanes_below);
      if (cz == zz) rank_c = __popc(m & lanes_below);
    }
    __syncthreads();
    if (warp == 0) {  // column starts and each warp's offset within a column (S <= 32)
      int tot = 0;
      if (lane < S) {
        for (int w = 0; w < kOwnerWarps; ++w) {
          s_woff[w * S + lane] = tot;
          tot += s_wcount[w * S + lane];
        }
      }
      int x = tot;
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, x, o);
        if (lane >= o) x += y;
      }
      if (lane < S) s_cstart[lane] = x - tot;
      if (lane == S - 1) s_cstart[S] = x;
    }
    __syncthreads();
    if (tid < n) {
      s_list[s_cstart[fz] + s_woff[warp * S + fz] + rank_f] = (unsigned short)tid;
      if (cz != fz) s_list[s_cstart[cz] + s_woff[warp * S + cz] + rank_c] = (unsigned short)tid;
    }
    __syncthreads();

    // Warp z walks its column's points in point order, kRows at a time: it
    // loads their ct rows together, then adds each point, ct * weight, to
    // its cells (floor_y, z) and (ceil_y, z) (one cell when they coincide).
    // So every cell sums its points in point order.
    if (z < S && ch < gw) {
      float* column = acc + (size_t)z * S * group + ch;
      const int e1 = s_cstart[z + 1];
      for (int e = s_cstart[z]; e < e1; e += kRows) {
        unsigned cell[kRows];
        float4 wt[kRows];
        float v[kRows][LV];
#pragma unroll
        for (int q = 0; q < kRows; ++q) {
          if (e + q < e1) {
            const int j = s_list[e + q];
            cell[q] = s_cell[j];
            wt[q] = s_weight[j];
            load_channels<T, CV, LV>(ct_b + (size_t)(cell[q] >> 16) * C, ch, gw, v[q]);
          }
        }
#pragma unroll
        for (int q = 0; q < kRows; ++q) {
          if (e + q >= e1) break;
          const int y0 = cell[q] & 15, y1 = (cell[q] >> 4) & 15;
          const bool floor_z = ((cell[q] >> 8) & 15) == (unsigned)z;
          const float w0 = floor_z ? wt[q].x : wt[q].z, w1 = floor_z ? wt[q].y : wt[q].w;
          float a0[LV];
          load_f32<float, LV>(column + (size_t)y0 * group, a0);
#pragma unroll
          for (int k = 0; k < LV; ++k) a0[k] += v[q][k] * w0;
          store_from_f32<float, LV>(column + (size_t)y0 * group, a0);
          if (y1 != y0) {
            float a1[LV];
            load_f32<float, LV>(column + (size_t)y1 * group, a1);
#pragma unroll
            for (int k = 0; k < LV; ++k) a1[k] += v[q][k] * w1;
            store_from_f32<float, LV>(column + (size_t)y1 * group, a1);
          }
        }
      }
    }
  }

  // Each warp writes its column's cells once, in the grid's dtype, as soon as
  // it has summed them (no other warp writes to them).
  if (z < S && ch < gw) {
    T* out = grad + ((size_t)b * P + (size_t)s * plane + z) * C + g0;
    const float* column = acc + (size_t)z * S * group + ch;
    for (int y = 0; y < S; ++y) {
      float a[LV];
      load_f32<float, LV>(column + (size_t)y * group, a);
      store_channels<T, CV, LV>(out + (size_t)y * S * C, ch, gw, a);
    }
  }
}

// ---------------------------------------------------------------------------
// Route v1
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
rotate3d_forward_kernel(const T* __restrict__ grid, const float* __restrict__ transform,
                        T* __restrict__ out, int S, int C) {
  __shared__ int s_off[kPointsPerBlock][8];
  __shared__ float s_w[kPointsPerBlock][3];
  const int P = S * S * S;
  const int b = blockIdx.y;
  const int p0 = blockIdx.x * kPointsPerBlock;
  const int np = min(kPointsPerBlock, P - p0);
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  if (tid < np) {
    int f[3], c[3];
    source_cell(transform + (size_t)b * 9, p0 + tid, S, f, c, s_w[tid]);
    corner_offsets(f, c, S, s_off[tid]);
  }
  __syncthreads();

  const T* g = grid + (size_t)b * P * C;
  T* o = out + ((size_t)b * P + p0) * C;
  for (int lp = threadIdx.y; lp < np; lp += blockDim.y) {
    const int* off = s_off[lp];
    const float dx = s_w[lp][0], dy = s_w[lp][1], dz = s_w[lp][2];
    for (int ch = threadIdx.x; ch < C; ch += blockDim.x) {
      auto at = [&](int k) -> float { return to_f32(g[(size_t)off[k] * C + ch]); };
      const float c000 = at(0), c100 = at(1), c001 = at(2), c101 = at(3);
      const float c010 = at(4), c110 = at(5), c011 = at(6), c111 = at(7);
      const float c00 = c000 * (1.f - dx) + c100 * dx;
      const float c01 = c001 * (1.f - dx) + c101 * dx;
      const float c10 = c010 * (1.f - dx) + c110 * dx;
      const float c11 = c011 * (1.f - dx) + c111 * dx;
      const float c0 = c00 * (1.f - dy) + c10 * dy;
      const float c1 = c01 * (1.f - dy) + c11 * dy;
      o[(size_t)lp * C + ch] = from_f32<T>(c0 * (1.f - dz) + c1 * dz);
    }
  }
}

// acc: (B, S, S, S, C) float32, zeroed before the launch.
template <typename T>
__global__ void __launch_bounds__(kThreads)
rotate3d_transpose_kernel(const T* __restrict__ ct, const float* __restrict__ transform,
                          float* __restrict__ acc, int S, int C) {
  __shared__ int s_off[kPointsPerBlock][8];
  __shared__ float s_w[kPointsPerBlock][3];
  const int P = S * S * S;
  const int b = blockIdx.y;
  const int p0 = blockIdx.x * kPointsPerBlock;
  const int np = min(kPointsPerBlock, P - p0);
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  if (tid < np) {
    int f[3], c[3];
    source_cell(transform + (size_t)b * 9, p0 + tid, S, f, c, s_w[tid]);
    corner_offsets(f, c, S, s_off[tid]);
  }
  __syncthreads();

  const T* g = ct + ((size_t)b * P + p0) * C;
  float* a = acc + (size_t)b * P * C;
  for (int lp = threadIdx.y; lp < np; lp += blockDim.y) {
    const int* off = s_off[lp];
    const float dx = s_w[lp][0], dy = s_w[lp][1], dz = s_w[lp][2];
    for (int ch = threadIdx.x; ch < C; ch += blockDim.x) {
      const float v = to_f32(g[(size_t)lp * C + ch]);
      // cotangents of the forward's c0/c1, then of c00, c10, c01, c11
      const float g0 = v * (1.f - dz), g1 = v * dz;
      const float g00 = g0 * (1.f - dy), g10 = g0 * dy;
      const float g01 = g1 * (1.f - dy), g11 = g1 * dy;
      atomicAdd(a + (size_t)off[0] * C + ch, g00 * (1.f - dx));  // c000
      atomicAdd(a + (size_t)off[1] * C + ch, g00 * dx);          // c100
      atomicAdd(a + (size_t)off[2] * C + ch, g01 * (1.f - dx));  // c001
      atomicAdd(a + (size_t)off[3] * C + ch, g01 * dx);          // c101
      atomicAdd(a + (size_t)off[4] * C + ch, g10 * (1.f - dx));  // c010
      atomicAdd(a + (size_t)off[5] * C + ch, g10 * dx);          // c110
      atomicAdd(a + (size_t)off[6] * C + ch, g11 * (1.f - dx));  // c011
      atomicAdd(a + (size_t)off[7] * C + ch, g11 * dx);          // c111
    }
  }
}

__global__ void cast_to_bf16_kernel(const float* __restrict__ in, __nv_bfloat16* __restrict__ out,
                                    size_t n) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    out[i] = __float2bfloat16(in[i]);
  }
}

dim3 block_shape(int C) {
  int lanes = ((C + 31) / 32) * 32;
  if (lanes > 128) lanes = 128;
  return dim3(lanes, kThreads / lanes);
}

cudaError_t forward_v1(const void* grid, const float* transform, void* out, int B, int S, int C,
                       int dtype, cudaStream_t s) {
  const int P = S * S * S;
  const dim3 blocks((P + kPointsPerBlock - 1) / kPointsPerBlock, B);
  if (dtype == kBFloat16) {
    rotate3d_forward_kernel<__nv_bfloat16><<<blocks, block_shape(C), 0, s>>>(
        static_cast<const __nv_bfloat16*>(grid), transform, static_cast<__nv_bfloat16*>(out), S, C);
  } else if (dtype == kFloat32) {
    rotate3d_forward_kernel<float><<<blocks, block_shape(C), 0, s>>>(
        static_cast<const float*>(grid), transform, static_cast<float*>(out), S, C);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

cudaError_t transpose_v1(const void* ct, const float* transform, void* grad, float* scratch, int B,
                         int S, int C, int dtype, cudaStream_t s) {
  const int P = S * S * S;
  const size_t n = (size_t)B * P * C;
  const dim3 blocks((P + kPointsPerBlock - 1) / kPointsPerBlock, B);
  float* acc;
  if (dtype == kFloat32) {
    acc = static_cast<float*>(grad);
  } else if (dtype == kBFloat16 && scratch != nullptr) {
    acc = scratch;
  } else {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaMemsetAsync(acc, 0, n * sizeof(float), s);
  if (err != cudaSuccess) return err;
  if (dtype == kFloat32) {
    rotate3d_transpose_kernel<float><<<blocks, block_shape(C), 0, s>>>(
        static_cast<const float*>(ct), transform, acc, S, C);
    return cudaGetLastError();
  }
  rotate3d_transpose_kernel<__nv_bfloat16><<<blocks, block_shape(C), 0, s>>>(
      static_cast<const __nv_bfloat16*>(ct), transform, acc, S, C);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int threads = 256;
  const size_t want = (n + threads - 1) / threads;
  const int cast_blocks = (int)(want < 4096 ? want : 4096);
  cast_to_bf16_kernel<<<cast_blocks, threads, 0, s>>>(acc, static_cast<__nv_bfloat16*>(grad), n);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Launchers of the slab kernels
// ---------------------------------------------------------------------------

// Opt in once per device to the largest dynamic shared memory for a kernel.
template <auto kernel>
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
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return err;
}

template <typename T, int VEC>
cudaError_t launch_slab_forward(const void* grid, const float* transform, void* out, int B, int S,
                                int C, int window, int group, cudaStream_t s) {
  cudaError_t err = prepare<rotate3d_slab_forward_kernel<T, VEC>>();
  if (err != cudaSuccess) return err;
  const dim3 blocks(((S + window - 1) / window) * ((C + group - 1) / group), B);
  const size_t smem = forward_smem(S, window, group, sizeof(T));
  rotate3d_slab_forward_kernel<T, VEC><<<blocks, kThreads, smem, s>>>(
      static_cast<const T*>(grid), transform, static_cast<T*>(out), S, C, window, group);
  return cudaGetLastError();
}

template <typename T, int CV, int LV>
cudaError_t launch_owner_transpose(const void* ct, const float* transform, void* grad, int B,
                                   int S, int C, int group, cudaStream_t s) {
  cudaError_t err = prepare<rotate3d_owner_transpose_kernel<T, CV, LV>>();
  if (err != cudaSuccess) return err;
  const dim3 blocks(S * ((C + group - 1) / group), B);
  rotate3d_owner_transpose_kernel<T, CV, LV><<<blocks, kOwnerThreads, transpose_smem(S, group),
                                               s>>>(static_cast<const T*>(ct), transform,
                                                    static_cast<T*>(grad), S, C, group);
  return cudaGetLastError();
}

template <typename T, int CV>
cudaError_t owner_transpose_lanes(const void* ct, const float* transform, void* grad, int B, int S,
                                  int C, int group, cudaStream_t s) {
  if (group <= 32) return launch_owner_transpose<T, CV, 1>(ct, transform, grad, B, S, C, group, s);
  if (group <= 64) return launch_owner_transpose<T, CV, 2>(ct, transform, grad, B, S, C, group, s);
  if (group <= 128) return launch_owner_transpose<T, CV, 4>(ct, transform, grad, B, S, C, group, s);
  return cudaErrorInvalidValue;
}

// What the slab kernels take: 1 <= S <= 32, a group of whole vectors.
bool slab_args_ok(int S, int C, int group, int vec, int dtype) {
  const int wide = dtype == kBFloat16 ? 8 : 4;  // channels per 16 bytes
  return S >= 1 && S <= kMaxSize && group >= 1 && C >= 1 && (vec == 1 || vec == wide) &&
         group % vec == 0 && C % vec == 0;
}

}  // namespace

// The card's SM count and opt-in shared memory per block.
extern "C" int rotate3d_device_limits(int device, int* sms, int* smem_per_block) {
  cudaError_t err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(smem_per_block, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return (int)err;
}

// grid/out: (B, S, S, S, C) contiguous, float32 or bfloat16 (dtype code);
// transform: (B, 3, 3) float32 contiguous, applied about the grid center.
// route 0 (slab): `window` output-x planes and `group` channels per block,
// `vec` channels per 16-byte access (or 1); route 1 (v1) ignores those.
// Returns cudaGetLastError() after the launch.
extern "C" int rotate3d_forward(const void* grid, const float* transform, void* out, int B, int S,
                                int C, int dtype, int route, int window, int group, int vec,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == kRouteV1) return (int)forward_v1(grid, transform, out, B, S, C, dtype, s);
  if (route != kRouteSlab || !slab_args_ok(S, C, group, vec, dtype) || window < 1 ||
      (size_t)window * S * S > 65535 || group / vec > kThreads)
    return (int)cudaErrorInvalidValue;
  if (dtype == kFloat32) {
    return (int)(vec == 1 ? launch_slab_forward<float, 1>(grid, transform, out, B, S, C, window,
                                                           group, s)
                          : launch_slab_forward<float, 4>(grid, transform, out, B, S, C, window,
                                                           group, s));
  }
  if (dtype == kBFloat16) {
    return (int)(vec == 1 ? launch_slab_forward<__nv_bfloat16, 1>(grid, transform, out, B, S, C,
                                                                   window, group, s)
                          : launch_slab_forward<__nv_bfloat16, 8>(grid, transform, out, B, S, C,
                                                                   window, group, s));
  }
  return (int)cudaErrorInvalidValue;
}

// ct/grad: (B, S, S, S, C) contiguous, float32 or bfloat16 (dtype code);
// transform as for rotate3d_forward.  Writes grad = the transpose of
// rotate3d_forward applied to ct.  route 0 (owner-computes): `group`
// channels per block, `vec` channels per 16-byte access (or 1); scratch is
// unused.  route 1 (v1): scratch is B*S^3*C float32 for a bfloat16 ct
// (unused, may be null, for float32).  Returns the first CUDA error.
extern "C" int rotate3d_transpose(const void* ct, const float* transform, void* grad,
                                  float* scratch, int B, int S, int C, int dtype, int route,
                                  int group, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == kRouteV1) return (int)transpose_v1(ct, transform, grad, scratch, B, S, C, dtype, s);
  if (route != kRouteSlab || !slab_args_ok(S, C, group, vec, dtype) || S > kMaxOwnerSize)
    return (int)cudaErrorInvalidValue;
  using bf16 = __nv_bfloat16;
  if (dtype == kFloat32) {
    return (int)(vec == 1 ? owner_transpose_lanes<float, 1>(ct, transform, grad, B, S, C, group, s)
                          : owner_transpose_lanes<float, 4>(ct, transform, grad, B, S, C, group, s));
  }
  if (dtype == kBFloat16) {
    return (int)(vec == 1 ? owner_transpose_lanes<bf16, 1>(ct, transform, grad, B, S, C, group, s)
                          : owner_transpose_lanes<bf16, 8>(ct, transform, grad, B, S, C, group, s));
  }
  return (int)cudaErrorInvalidValue;
}
