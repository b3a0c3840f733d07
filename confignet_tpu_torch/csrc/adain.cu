// Fused AdaIN forward: per (sample, channel) instance norm over all spatial
// positions, then the latent modulation,
//     out = (x - mean) * rsqrt(var + eps) * (scale + 1) + bias,
// on a (B, P, C) channels-last view; statistics in float32, output in x's
// dtype, var the biased variance mean((x - mean)^2).
//
// Replaces the Pallas TPU kernel _adain_kernel
// (confignet_tpu/ops/adain_pallas.py, launched by _fused_adain_3dview).  The
// TPU kernel keeps one sample's whole (P, C) slab in VMEM and runs the
// samples in order; a Hopper block has at most 227 KB of shared memory, the
// largest site (P = 65536 at 512px) does not fit, and one block per sample
// would leave most of the 132 SMs idle (the 256px sites with C = 32 give
// only B blocks).  So the positions are cut into chunks across blocks and
// the reduction across chunks takes a second kernel.
//
// Bound: memory.  The least traffic is one read of x and one write of out;
// this pair of kernels reads x twice (statistics, then normalise), so it can
// reach at best two thirds of the bandwidth bound.
//
// Design: blocks of (lanes <= 32 channels) x (rows) threads, one per
// (channel group, chunk of positions, sample); threadIdx.x runs across
// channels (coalesced rows).
// 1. adain_stats_kernel: each thread keeps a Welford (count, mean, M2) over
//    its rows of the chunk; the block merges them with Chan's formula (a
//    tree, rows a power of two) and writes the chunk's (mean, M2) per
//    channel.  As exact as two passes (mean, then centred variance), and it
//    avoids the cancellation of E[x^2] - E[x]^2.
// 2. adain_apply_kernel: each block merges the chunks' partials (spread
//    over its rows, then the same tree, in a fixed order: every block and
//    every run gets the same statistics), then normalises and modulates its
//    chunk.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void chan_merge(float& n, float& mean, float& m2, float nb, float mean_b,
                                           float m2_b) {
  if (nb == 0.f) return;
  const float total = n + nb;
  const float delta = mean_b - mean;
  const float weight = nb / total;
  mean += delta * weight;
  m2 += m2_b + delta * delta * n * weight;
  n = total;
}

// Merge the (count, mean, M2) of the threads that share threadIdx.x, a tree
// over threadIdx.y (blockDim.y a power of two); every thread ends with its
// channel's result.  The merge order is fixed, so every block gets the same
// bits.
__device__ __forceinline__ void block_merge(float& n, float& mean, float& m2) {
  __shared__ float s_n[kThreads], s_mean[kThreads], s_m2[kThreads];
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  s_n[tid] = n;
  s_mean[tid] = mean;
  s_m2[tid] = m2;
  __syncthreads();
  for (int stride = blockDim.y / 2; stride > 0; stride >>= 1) {
    if (threadIdx.y < stride) {
      const int other = tid + stride * blockDim.x;
      chan_merge(s_n[tid], s_mean[tid], s_m2[tid], s_n[other], s_mean[other], s_m2[other]);
    }
    __syncthreads();
  }
  n = s_n[threadIdx.x];
  mean = s_mean[threadIdx.x];
  m2 = s_m2[threadIdx.x];
}

__device__ __forceinline__ float load_param(const void* p, int dtype, size_t i) {
  return dtype == kBFloat16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
                            : static_cast<const float*>(p)[i];
}

// partial: (B, chunks, 2, C) float32 -- each chunk's (mean, M2) per channel
template <typename T>
__global__ void __launch_bounds__(kThreads)
adain_stats_kernel(const T* __restrict__ x, float* __restrict__ partial, int P, int C,
                   int chunk_rows) {
  const int b = blockIdx.z, chunk = blockIdx.y, chunks = gridDim.y;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int p_end = min(P, (chunk + 1) * chunk_rows);
  const T* xb = x + (size_t)b * P * C;

  float n = 0.f, mean = 0.f, m2 = 0.f;
  if (c < C) {
    for (int p = chunk * chunk_rows + threadIdx.y; p < p_end; p += blockDim.y) {
      const float v = to_f32(xb[(size_t)p * C + c]);
      n += 1.f;
      const float delta = v - mean;
      mean += delta / n;
      m2 += delta * (v - mean);
    }
  }
  block_merge(n, mean, m2);
  if (threadIdx.y == 0 && c < C) {
    float* out = partial + ((size_t)b * chunks + chunk) * 2 * C;
    out[c] = mean;
    out[C + c] = m2;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
adain_apply_kernel(const T* __restrict__ x, const float* __restrict__ partial,
                   const void* __restrict__ scale, const void* __restrict__ bias, T* __restrict__ out,
                   int P, int C, int chunk_rows, long long scale_stride, long long bias_stride,
                   int scale_dtype, int bias_dtype, float eps) {
  __shared__ float s_mu[32], s_gain[32], s_shift[32];
  const int b = blockIdx.z, chunk = blockIdx.y, chunks = gridDim.y;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  float n = 0.f, mean = 0.f, m2 = 0.f;
  if (c < C) {
    const float* part = partial + (size_t)b * chunks * 2 * C;
    for (int k = threadIdx.y; k < chunks; k += blockDim.y) {
      const float nk = (float)max(0, min(P, (k + 1) * chunk_rows) - k * chunk_rows);
      chan_merge(n, mean, m2, nk, part[(size_t)k * 2 * C + c], part[(size_t)k * 2 * C + C + c]);
    }
  }
  block_merge(n, mean, m2);
  if (threadIdx.y == 0 && c < C) {
    const float rstd = rsqrtf(m2 / (float)P + eps);
    s_mu[threadIdx.x] = mean;
    s_gain[threadIdx.x] = rstd * (load_param(scale, scale_dtype, b * scale_stride + c) + 1.f);
    s_shift[threadIdx.x] = load_param(bias, bias_dtype, b * bias_stride + c);
  }
  __syncthreads();
  if (c >= C) return;
  const float mu = s_mu[threadIdx.x], gain = s_gain[threadIdx.x], shift = s_shift[threadIdx.x];
  const T* xb = x + (size_t)b * P * C;
  T* ob = out + (size_t)b * P * C;
  const int p_end = min(P, (chunk + 1) * chunk_rows);
  for (int p = chunk * chunk_rows + threadIdx.y; p < p_end; p += blockDim.y) {
    const size_t i = (size_t)p * C + c;
    ob[i] = from_f32<T>((to_f32(xb[i]) - mu) * gain + shift);
  }
}

template <typename T>
void launch(const void* x, const void* scale, const void* bias, void* out, float* partial, int B,
            int P, int C, int chunks, long long scale_stride, long long bias_stride,
            int scale_dtype, int bias_dtype, float eps, cudaStream_t s) {
  const int lanes = C < 32 ? C : 32;
  int rows = 1;
  while (rows * 2 * lanes <= kThreads) rows *= 2;
  const dim3 threads(lanes, rows);
  const dim3 blocks((C + lanes - 1) / lanes, chunks, B);
  const int chunk_rows = (P + chunks - 1) / chunks;
  adain_stats_kernel<T><<<blocks, threads, 0, s>>>(static_cast<const T*>(x), partial, P, C,
                                                    chunk_rows);
  adain_apply_kernel<T><<<blocks, threads, 0, s>>>(
      static_cast<const T*>(x), partial, scale, bias, static_cast<T*>(out), P, C, chunk_rows,
      scale_stride, bias_stride, scale_dtype, bias_dtype, eps);
}

}  // namespace

// x/out: (B, P, C) contiguous, float32 or bfloat16 (x_dtype code);
// scale/bias: (B, C) float32 or bfloat16 with unit channel stride and the
// given row strides; partial: (B, chunks, 2, C) float32 scratch; chunks >= 1
// and at most P.  Returns cudaGetLastError() after the launches.
extern "C" int adain_forward(const void* x, const void* scale, const void* bias, void* out,
                             float* partial, int B, int P, int C, int chunks,
                             long long scale_stride, long long bias_stride, int x_dtype,
                             int scale_dtype, int bias_dtype, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (chunks < 1 || chunks > P || chunks > 65535) return (int)cudaErrorInvalidValue;
  if (x_dtype == kBFloat16) {
    launch<__nv_bfloat16>(x, scale, bias, out, partial, B, P, C, chunks, scale_stride, bias_stride,
                          scale_dtype, bias_dtype, eps, s);
  } else if (x_dtype == kFloat32) {
    launch<float>(x, scale, bias, out, partial, B, P, C, chunks, scale_stride, bias_stride,
                  scale_dtype, bias_dtype, eps, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
