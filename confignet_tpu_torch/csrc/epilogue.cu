// The epilogue of a convolution whose bias was left out, in one pass, in
// place on its float32 NCHW-contiguous output y (B, C, H, W):
//     form 0:  y = relu(y + b[c])
//     form 1:  y = relu((y + b[c]) + r)                 r: the identity shortcut
//     form 2:  y = relu((y + b[c]) + (s + bs[c]))       s: the projection
//                                                       shortcut's raw output
// with relu(v) = v < 0 ? 0 : v, so a NaN passes as torch.relu passes it.
// These are the float32 additions, in the same order, that the ResNet50
// trunk's folded blocks made as separate passes (the convolution's bias
// add, the residual add, ReLU), so the result is the same to the bit.  The
// file is built without fast-math: nothing is reassociated.
//
// Replaces no TPU kernel: on the TPU, XLA fuses these elementwise ops with
// the convolutions; PyTorch's eager trunk ran them as three generic passes
// over device memory.
//
// Bound: bytes.  Each element of y is read once and written once, r or s
// read once; one add or two and a compare per element, far below the
// card's float32 rate.  Design: a block of 256 threads covers 256 / tx
// whole (batch, channel) planes along threadIdx.y (tx is the power of two
// that covers a plane's vectors, at most 256, so small planes share a
// block), and blockIdx.y cuts a large plane into slices along threadIdx.x.
// So a thread's channel, and with it the bias, is one scalar it reads once:
// no division per element.  Where the plane size is a multiple of 4 and
// every pointer is 16-byte aligned each thread moves float4s (16-byte loads
// and stores, neighbouring threads on neighbouring addresses), else floats.
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float relu(float v) { return v < 0.f ? 0.f : v; }

// `other` is r (form 1) or s (form 2)
template <int Form>
__device__ __forceinline__ float epilogue(float y, float bias, float other, float sbias) {
  const float v = y + bias;
  if (Form == 0) return relu(v);
  if (Form == 1) return relu(v + other);
  return relu(v + (other + sbias));
}

template <int Form, int Vec>
__global__ void __launch_bounds__(kThreads)
    conv_epilogue_kernel(float* __restrict__ y, const float* __restrict__ bias,
                         const float* __restrict__ residual, const float* __restrict__ shortcut,
                         const float* __restrict__ shortcut_bias, long long planes, int channels,
                         int plane_vectors) {
  using V = typename std::conditional<Vec == 4, float4, float>::type;
  const long long plane = (long long)blockIdx.x * blockDim.y + threadIdx.y;
  if (plane >= planes) return;
  const int c = (int)(plane % channels);
  const float b = bias[c];
  const float sb = Form == 2 ? shortcut_bias[c] : 0.f;
  const long long base = plane * plane_vectors;
  V* yv = reinterpret_cast<V*>(y) + base;
  const float* other = Form == 1 ? residual : shortcut;
  for (int i = blockIdx.y * blockDim.x + threadIdx.x; i < plane_vectors;
       i += gridDim.y * blockDim.x) {
    V v = yv[i];
    V o = {};
    if constexpr (Form != 0) o = reinterpret_cast<const V*>(other)[base + i];
    if constexpr (Vec == 4) {
      v.x = epilogue<Form>(v.x, b, o.x, sb);
      v.y = epilogue<Form>(v.y, b, o.y, sb);
      v.z = epilogue<Form>(v.z, b, o.z, sb);
      v.w = epilogue<Form>(v.w, b, o.w, sb);
    } else {
      v = epilogue<Form>(v, b, o, sb);
    }
    yv[i] = v;
  }
}

template <int Form, int Vec>
cudaError_t launch(float* y, const float* bias, const float* residual, const float* shortcut,
                   const float* shortcut_bias, long long planes, int channels,
                   long long plane_size, cudaStream_t stream) {
  const long long vectors = plane_size / Vec;
  // threads along a plane: the power of two covering it, at most a block
  int tx = 1;
  while (tx < kThreads && tx < vectors) tx *= 2;
  const int ty = kThreads / tx;
  const long long slices = (vectors + tx - 1) / tx;
  dim3 grid((unsigned)((planes + ty - 1) / ty), (unsigned)(slices < 65535 ? slices : 65535));
  conv_epilogue_kernel<Form, Vec><<<grid, dim3(tx, ty), 0, stream>>>(
      y, bias, residual, shortcut, shortcut_bias, planes, channels, (int)vectors);
  return cudaGetLastError();
}

template <int Form>
cudaError_t launch_form(float* y, const float* bias, const float* residual, const float* shortcut,
                        const float* shortcut_bias, long long planes, int channels,
                        long long plane_size, cudaStream_t stream) {
  const auto aligned = [](const void* p) { return p == nullptr || (uintptr_t)p % 16 == 0; };
  if (plane_size % 4 == 0 && aligned(y) && aligned(residual) && aligned(shortcut))
    return launch<Form, 4>(y, bias, residual, shortcut, shortcut_bias, planes, channels,
                           plane_size, stream);
  return launch<Form, 1>(y, bias, residual, shortcut, shortcut_bias, planes, channels,
                         plane_size, stream);
}

}  // namespace

// y: (planes / channels, channels, plane_size) contiguous float32, updated
// in place; bias: (channels,) float32.  The form follows the pointers given:
// neither residual nor shortcut (form 0), residual (form 1: same shape as
// y), or shortcut and shortcut_bias (form 2: shortcut the shape of y,
// shortcut_bias (channels,)).  Returns cudaErrorInvalidValue for arguments
// outside that (an empty tensor, a plane over 2^30 elements, over 2^31 - 1
// planes, both residual and shortcut, a shortcut without its bias), else
// cudaGetLastError() after the launch.
extern "C" int conv_epilogue(void* y, const void* bias, const void* residual,
                             const void* shortcut, const void* shortcut_bias, long long planes,
                             int channels, long long plane_size, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (planes < 1 || channels < 1 || plane_size < 1 || plane_size > (1LL << 30) ||
      planes > 0x7fffffffLL || (residual && shortcut) ||
      (shortcut != nullptr) != (shortcut_bias != nullptr))
    return (int)cudaErrorInvalidValue;
  float* yf = static_cast<float*>(y);
  const float* b = static_cast<const float*>(bias);
  const float* r = static_cast<const float*>(residual);
  const float* sc = static_cast<const float*>(shortcut);
  const float* sb = static_cast<const float*>(shortcut_bias);
  if (sc) return (int)launch_form<2>(yf, b, r, sc, sb, planes, channels, plane_size, s);
  if (r) return (int)launch_form<1>(yf, b, r, sc, sb, planes, channels, plane_size, s);
  return (int)launch_form<0>(yf, b, r, sc, sb, planes, channels, plane_size, s);
}
