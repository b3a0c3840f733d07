// Trilinear rotation resample of a (B, S, S, S, C) channels-last volume.
//
// Replaces the Pallas TPU kernel _rotate_kernel_full
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
// The block first computes each point's source coordinates from the 3x3
// transform -- the float32 formula of core/transforms._source_coords, with
// every product and sum rounded separately (no FMA contraction) so that the
// kernel and its plain version pick the same cells -- and keeps the 8 corner
// offsets and 3 weights in shared memory.  Then threadIdx.x runs across
// channels (coalesced corner rows) and threadIdx.y across the tile's points.
// The interpolation runs in float32 in the gather form's order (x, then y,
// then z) with one cast to the output dtype.
#include "common.cuh"

namespace {

constexpr int kPointsPerBlock = 32;
constexpr int kThreads = 256;

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
    const int p = p0 + tid;
    const float* t = transform + (size_t)b * 9;
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
      s_w[tid][i] = __fsub_rn(src, fl);
    }
    // corner order: 000, 100, 001, 101, 010, 110, 011, 111 (x, y, z bits)
    const int xs[2] = {f[0], c[0]}, ys[2] = {f[1], c[1]}, zs[2] = {f[2], c[2]};
    for (int k = 0; k < 8; ++k) {
      const int xi = k & 1, zi = (k >> 1) & 1, yi = (k >> 2) & 1;
      s_off[tid][k] = (xs[xi] * S + ys[yi]) * S + zs[zi];
    }
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

}  // namespace

// grid/out: (B, S, S, S, C) contiguous, float32 or bfloat16 (dtype code);
// transform: (B, 3, 3) float32 contiguous, applied about the grid center.
// Returns cudaGetLastError() after the launch.
extern "C" int rotate3d_forward(const void* grid, const float* transform, void* out, int B, int S,
                                int C, int dtype, void* stream) {
  const int P = S * S * S;
  int lanes = ((C + 31) / 32) * 32;
  if (lanes > 128) lanes = 128;
  const dim3 threads(lanes, kThreads / lanes);
  const dim3 blocks((P + kPointsPerBlock - 1) / kPointsPerBlock, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16) {
    rotate3d_forward_kernel<__nv_bfloat16><<<blocks, threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(grid), transform, static_cast<__nv_bfloat16*>(out), S, C);
  } else if (dtype == kFloat32) {
    rotate3d_forward_kernel<float><<<blocks, threads, 0, s>>>(
        static_cast<const float*>(grid), transform, static_cast<float*>(out), S, C);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
