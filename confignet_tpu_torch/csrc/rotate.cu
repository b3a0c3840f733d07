// Trilinear rotation resample of a (B, S, S, S, C) channels-last volume, and
// its transpose (the gradient with respect to the volume).
//
// Forward: replaces the Pallas TPU kernel _rotate_kernel_full
// (confignet_tpu/ops/rotate_pallas.py, launched by rotate_3d_grid_pallas).
// The TPU kernel builds one-hot interpolation matrices and runs them on the
// matrix unit because gathers scalarise on a TPU; on Hopper a gather is an
// ordinary load, so this kernel reads the 8 trilinear corners directly.
//
// Bound: memory.  Each output element costs 8 corner reads and ~21 float32
// operations, and every corner row of C channels is contiguous.  At the
// generator's shape (S=16, C=128) one sample's volume is 1 MiB in bf16
// (2 MiB in f32), so the 8x re-reads hit L2 when the blocks of one sample
// run together: blockIdx.x walks the points of a sample and blockIdx.y the
// samples, and CUDA issues blocks x-fastest.  What has to reach device memory
// is then one read of the volume and one write of the output.
//
// Design: one block per (tile of kPointsPerBlock lattice points, sample).
// The block first computes each point's source cell from the 3x3 transform
// (source_cell below) and keeps the 8 corner offsets and 3 weights in shared
// memory.  Then threadIdx.x runs across channels (coalesced corner rows) and
// threadIdx.y across the tile's points.  The interpolation runs in float32 in
// the gather form's order (x, then y, then z) with one cast to the output
// dtype.
//
// Transpose: replaces _rotate_kernel_grad_grid (rotate_pallas.py, launched
// by _rotate_grad_grid through the rotate_3d_grid_fused custom VJP).  For
// every point p and corner k it adds w_k(p) * ct[b, p, c] into
// grad[b, corner_k(p), c] -- the gather form's autodiff, not the TPU's
// one-hot matmul over x-slabs.  It uses the same source_cell as the forward,
// so it scatters into exactly the cells the forward read, and it forms each
// corner weight in autodiff's order (z, then y, then x).  At a clamped border
// two corners are the same cell; both contributions are added, as autodiff
// adds them.
//
// Bound: memory -- read ct once, write grad once.  Design: the forward's
// block layout; each thread atomically adds its 8 weighted values into a
// zeroed float32 accumulator (one sample's volume, 2 MiB, stays in the 50 MB
// L2).  For a bf16 grid the accumulator is a float32 scratch and one cast
// kernel writes the bf16 gradient.  Float atomics make the summation order,
// and so the last bits, vary from run to run; a deterministic gather-style
// transpose is a later redesign.
#include "common.cuh"

namespace {

constexpr int kPointsPerBlock = 32;
constexpr int kThreads = 256;

// Source cell of lattice point p under the 3x3 transform t, applied about the
// grid center: the 8 corner offsets (corner order 000, 100, 001, 101, 010,
// 110, 011, 111 in x, y, z bits) and the fractional weights (dx, dy, dz).
// The float32 formula of core/transforms._source_coords, with every product
// and sum rounded separately (no FMA contraction), so that the kernels and
// the plain versions pick the same cells.
__device__ __forceinline__ void source_cell(const float* __restrict__ t, int p, int S, int* off,
                                            float* w) {
  const float center = 0.5f * (float)(S - 1);
  const float last = (float)(S - 1);
  const float rel[3] = {(float)(p / (S * S)) - center, (float)((p / S) % S) - center,
                        (float)(p % S) - center};
  int f[3], c[3];
  for (int i = 0; i < 3; ++i) {
    float src = __fadd_rn(__fadd_rn(__fmul_rn(t[3 * i], rel[0]), __fmul_rn(t[3 * i + 1], rel[1])),
                          __fmul_rn(t[3 * i + 2], rel[2]));
    src = fminf(fmaxf(__fadd_rn(src, center), 0.f), last);
    const float fl = fminf(fmaxf(floorf(src), 0.f), last);
    f[i] = (int)fl;
    c[i] = min(f[i] + 1, S - 1);
    w[i] = __fsub_rn(src, fl);
  }
  const int xs[2] = {f[0], c[0]}, ys[2] = {f[1], c[1]}, zs[2] = {f[2], c[2]};
  for (int k = 0; k < 8; ++k) {
    const int xi = k & 1, zi = (k >> 1) & 1, yi = (k >> 2) & 1;
    off[k] = (xs[xi] * S + ys[yi]) * S + zs[zi];
  }
}

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
  if (tid < np) source_cell(transform + (size_t)b * 9, p0 + tid, S, s_off[tid], s_w[tid]);
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
  if (tid < np) source_cell(transform + (size_t)b * 9, p0 + tid, S, s_off[tid], s_w[tid]);
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

}  // namespace

// grid/out: (B, S, S, S, C) contiguous, float32 or bfloat16 (dtype code);
// transform: (B, 3, 3) float32 contiguous, applied about the grid center.
// Returns cudaGetLastError() after the launch.
extern "C" int rotate3d_forward(const void* grid, const float* transform, void* out, int B, int S,
                                int C, int dtype, void* stream) {
  const int P = S * S * S;
  const dim3 blocks((P + kPointsPerBlock - 1) / kPointsPerBlock, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16) {
    rotate3d_forward_kernel<__nv_bfloat16><<<blocks, block_shape(C), 0, s>>>(
        static_cast<const __nv_bfloat16*>(grid), transform, static_cast<__nv_bfloat16*>(out), S, C);
  } else if (dtype == kFloat32) {
    rotate3d_forward_kernel<float><<<blocks, block_shape(C), 0, s>>>(
        static_cast<const float*>(grid), transform, static_cast<float*>(out), S, C);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// ct/grad: (B, S, S, S, C) contiguous, float32 or bfloat16 (dtype code);
// transform as for rotate3d_forward; scratch: B*S^3*C float32 for a bfloat16
// ct (unused, may be null, for float32).  Writes grad = the transpose of
// rotate3d_forward applied to ct.  Returns the first CUDA error.
extern "C" int rotate3d_transpose(const void* ct, const float* transform, void* grad,
                                  float* scratch, int B, int S, int C, int dtype, void* stream) {
  const int P = S * S * S;
  const size_t n = (size_t)B * P * C;
  const dim3 blocks((P + kPointsPerBlock - 1) / kPointsPerBlock, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* acc;
  if (dtype == kFloat32) {
    acc = static_cast<float*>(grad);
  } else if (dtype == kBFloat16 && scratch != nullptr) {
    acc = scratch;
  } else {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaMemsetAsync(acc, 0, n * sizeof(float), s);
  if (err != cudaSuccess) return (int)err;
  if (dtype == kFloat32) {
    rotate3d_transpose_kernel<float><<<blocks, block_shape(C), 0, s>>>(
        static_cast<const float*>(ct), transform, acc, S, C);
    return (int)cudaGetLastError();
  }
  rotate3d_transpose_kernel<__nv_bfloat16><<<blocks, block_shape(C), 0, s>>>(
      static_cast<const __nv_bfloat16*>(ct), transform, acc, S, C);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int threads = 256;
  const size_t want = (n + threads - 1) / threads;
  const int cast_blocks = (int)(want < 4096 ? want : 4096);
  cast_to_bf16_kernel<<<cast_blocks, threads, 0, s>>>(acc, static_cast<__nv_bfloat16*>(grad), n);
  return (int)cudaGetLastError();
}
