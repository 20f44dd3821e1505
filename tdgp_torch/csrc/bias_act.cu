// Kernel K5: bias + activation + gain + clamp over a channels-last tensor.
//
// Replaces the TPU kernel `_bias_act_kernel` / `bias_act_pallas` in
// tdgp/ops/pallas_kernels.py:41/52. For every element x[..., c]:
//   y = clamp(act(x + b[c], alpha) * gain, -clamp, clamp)
// with act one of the nine of tdgp/ops/bias_act.py:30-39 (linear, relu,
// lrelu, tanh, sigmoid, elu, selu, softplus, swish). clamp = +inf is no
// clamp. Forward only, as the TPU kernel.
//
// What bounds it on an H100: device memory. One read and one write of 4
// bytes per element and 4 bytes per channel of bias, a handful of flops per
// element: at the largest served call, [4, 512, 512, 64] float32, 8 * 67.1 M
// = 537 MB, about 0.16 ms at 3.35 TB/s.
//
// What the design does about it: one pass over the tensor in memory order,
// 16-byte loads and stores where the layout allows, the bias through the
// read-only cache, the activation a template parameter. The tensor need not
// be contiguous in [.., C] order: it must be dense, and the channel of the
// element at memory offset m is (m / inner) % C, where inner is the
// channel's stride (1 for a contiguous NHWC tensor, H * W for an NHWC view of
// an NCHW convolution output). The output has the input's strides. So a
// view is never copied to make it contiguous, which would double the bytes.
//   mode 0: one element per thread (any inner, any C);
//   mode 1: four elements per thread that are four consecutive channels
//           (inner == 1, C % 4 == 0), the bias as one float4;
//   mode 2: four elements per thread that share a channel (inner % 4 == 0).
// 32-bit index arithmetic: the wrapper refuses tensors of 2^31 elements or more.

#include <cuda_runtime.h>
#include <math.h>

namespace {

enum Act { kLinear = 0, kRelu, kLrelu, kTanh, kSigmoid, kElu, kSelu, kSoftplus, kSwish };

constexpr int kThreads = 256;
constexpr float kSeluAlpha = 1.6732632423543772848170429916717f;
constexpr float kSeluScale = 1.0507009873554804934193349852946f;

template <int ACT>
__device__ __forceinline__ float activate(float x, float alpha) {
  if (ACT == kLinear) return x;
  if (ACT == kRelu) return x < 0.f ? 0.f : x;
  if (ACT == kLrelu) return x >= 0.f ? x : x * alpha;
  if (ACT == kTanh) return tanhf(x);
  if (ACT == kSigmoid) return 1.f / (1.f + expf(-x));
  if (ACT == kElu) return x > 0.f ? x : expm1f(x);
  if (ACT == kSelu) return kSeluScale * (x > 0.f ? x : kSeluAlpha * expm1f(x));
  if (ACT == kSoftplus) return x > 20.f ? x : log1pf(expf(x));  // torch's threshold of 20
  return x * (1.f / (1.f + expf(-x)));                            // swish
}

template <int ACT>
__device__ __forceinline__ float apply(float x, float b, float alpha, float gain, float clamp) {
  float y = activate<ACT>(x + b, alpha) * gain;
  return y > clamp ? clamp : (y < -clamp ? -clamp : y);
}

template <int ACT>
__global__ void __launch_bounds__(kThreads)
bias_act_scalar(const float* __restrict__ x, const float* __restrict__ b, float* __restrict__ y,
                unsigned n, unsigned inner, unsigned channels, float alpha, float gain,
                float clamp) {
  for (unsigned i = blockIdx.x * kThreads + threadIdx.x; i < n; i += gridDim.x * kThreads) {
    const float bias = b ? __ldg(b + (i / inner) % channels) : 0.f;
    y[i] = apply<ACT>(x[i], bias, alpha, gain, clamp);
  }
}

// Four consecutive channels per thread: inner == 1 and channels % 4 == 0.
template <int ACT>
__global__ void __launch_bounds__(kThreads)
bias_act_vec_channels(const float4* __restrict__ x, const float* __restrict__ b,
                      float4* __restrict__ y, unsigned n4, unsigned channels, float alpha,
                      float gain, float clamp) {
  for (unsigned v = blockIdx.x * kThreads + threadIdx.x; v < n4; v += gridDim.x * kThreads) {
    const float4 xv = x[v];
    const float4 bv = b ? __ldg(reinterpret_cast<const float4*>(b + (4 * v) % channels))
                        : make_float4(0.f, 0.f, 0.f, 0.f);
    y[v] = make_float4(apply<ACT>(xv.x, bv.x, alpha, gain, clamp),
                       apply<ACT>(xv.y, bv.y, alpha, gain, clamp),
                       apply<ACT>(xv.z, bv.z, alpha, gain, clamp),
                       apply<ACT>(xv.w, bv.w, alpha, gain, clamp));
  }
}

// Four elements of one channel per thread: inner % 4 == 0.
template <int ACT>
__global__ void __launch_bounds__(kThreads)
bias_act_vec_inner(const float4* __restrict__ x, const float* __restrict__ b,
                   float4* __restrict__ y, unsigned n4, unsigned inner, unsigned channels,
                   float alpha, float gain, float clamp) {
  for (unsigned v = blockIdx.x * kThreads + threadIdx.x; v < n4; v += gridDim.x * kThreads) {
    const float4 xv = x[v];
    const float bias = b ? __ldg(b + (4 * v / inner) % channels) : 0.f;
    y[v] = make_float4(apply<ACT>(xv.x, bias, alpha, gain, clamp),
                       apply<ACT>(xv.y, bias, alpha, gain, clamp),
                       apply<ACT>(xv.z, bias, alpha, gain, clamp),
                       apply<ACT>(xv.w, bias, alpha, gain, clamp));
  }
}

unsigned grid_for(unsigned work) {
  const unsigned blocks = (work + kThreads - 1) / kThreads;
  return blocks < 132u * 32u ? blocks : 132u * 32u;  // the rest by the grid-stride loop
}

template <int ACT>
void launch(const float* x, const float* b, float* y, unsigned n, unsigned inner,
            unsigned channels, float alpha, float gain, float clamp, int mode,
            cudaStream_t stream) {
  if (mode == 1) {
    bias_act_vec_channels<ACT><<<grid_for(n / 4), kThreads, 0, stream>>>(
        reinterpret_cast<const float4*>(x), b, reinterpret_cast<float4*>(y), n / 4, channels,
        alpha, gain, clamp);
  } else if (mode == 2) {
    bias_act_vec_inner<ACT><<<grid_for(n / 4), kThreads, 0, stream>>>(
        reinterpret_cast<const float4*>(x), b, reinterpret_cast<float4*>(y), n / 4, inner,
        channels, alpha, gain, clamp);
  } else {
    bias_act_scalar<ACT><<<grid_for(n), kThreads, 0, stream>>>(x, b, y, n, inner, channels,
                                                                alpha, gain, clamp);
  }
}

}  // namespace

extern "C" {

// y = clamp(act(x + b[c]) * gain), c = (m / inner) % channels for the element
// at memory offset m; b may be null (no bias). act: 0 linear, 1 relu,
// 2 lrelu, 3 tanh, 4 sigmoid, 5 elu, 6 selu, 7 softplus, 8 swish. mode as in
// the note above; modes 1 and 2 need 16-byte aligned x and y and n % 4 == 0.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
int tdgp_bias_act(const float* x, const float* b, float* y, long long n, long long inner,
                  int channels, int act, float alpha, float gain, float clamp, int mode,
                  void* stream) {
  if (n < 1 || n >= (1LL << 31) || inner < 1 || channels < 1 || mode < 0 || mode > 2 ||
      (mode == 1 && (inner != 1 || channels % 4 != 0)) || (mode == 2 && inner % 4 != 0))
    return (int)cudaErrorInvalidValue;
  const unsigned un = (unsigned)n, ui = (unsigned)inner, uc = (unsigned)channels;
  cudaStream_t s = (cudaStream_t)stream;
  switch (act) {
    case kLinear: launch<kLinear>(x, b, y, un, ui, uc, alpha, gain, clamp, mode, s); break;
    case kRelu: launch<kRelu>(x, b, y, un, ui, uc, alpha, gain, clamp, mode, s); break;
    case kLrelu: launch<kLrelu>(x, b, y, un, ui, uc, alpha, gain, clamp, mode, s); break;
    case kTanh: launch<kTanh>(x, b, y, un, ui, uc, alpha, gain, clamp, mode, s); break;
    case kSigmoid: launch<kSigmoid>(x, b, y, un, ui, uc, alpha, gain, clamp, mode, s); break;
    case kElu: launch<kElu>(x, b, y, un, ui, uc, alpha, gain, clamp, mode, s); break;
    case kSelu: launch<kSelu>(x, b, y, un, ui, uc, alpha, gain, clamp, mode, s); break;
    case kSoftplus: launch<kSoftplus>(x, b, y, un, ui, uc, alpha, gain, clamp, mode, s); break;
    case kSwish: launch<kSwish>(x, b, y, un, ui, uc, alpha, gain, clamp, mode, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* tdgp_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
