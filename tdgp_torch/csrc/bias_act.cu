// Kernel K5: bias + activation + gain + clamp over a channels-last tensor,
// in float32 or bfloat16.
//
// Replaces the TPU kernel `_bias_act_kernel` / `bias_act_pallas` in
// tdgp/ops/pallas_kernels.py:41/52. For every element x[..., c]:
//   y = clamp(act(x + b[c], alpha) * gain, -clamp, clamp)
// with act one of the nine of tdgp/ops/bias_act.py:30-39 (linear, relu,
// lrelu, tanh, sigmoid, elu, selu, softplus, swish). clamp = +inf is no
// clamp. Forward only, as the TPU kernel.
//
// bfloat16 (the bf16 blocks of the generator and the discriminator) follows
// the JAX package, which computes in x's dtype: the bias is bf16, alpha, gain
// and clamp come rounded to bf16 from the host, the arithmetic is float32 and
// the result is rounded to bf16 after every operation that JAX rounds: the
// bias add, the activation's operations (sigmoid, softplus, selu and swish as
// JAX's chains of them), the gain product. The gain product is skipped when
// the gain is 1, as in JAX.
//
// What bounds it on an H100: device memory. One read and one write per
// element and the bias per channel, a handful of flops per element. At the
// largest served call, [4, 512, 512, 64] (67.1 M elements): float32 8 bytes
// an element, 537 MB, about 0.16 ms at 3.35 TB/s; bfloat16 2 + 2 bytes an
// element, 268 MB, about 0.080 ms.
//
// What the design does about it: one pass over the tensor in memory order,
// 16-byte loads and stores where the layout allows (4 float32 or 8 bf16
// elements), the bias through the read-only cache, the activation and the
// dtype template parameters. The tensor need not be contiguous in [.., C]
// order: it must be dense, and the channel of the element at memory offset m
// is (m / inner) % C, where inner is the channel's stride (1 for a contiguous
// NHWC tensor, H * W for an NHWC view of an NCHW convolution output). The
// output has the input's strides. So a view is never copied to make it
// contiguous, which would double the bytes. With V the elements of a
// 16-byte access (4 float32, 8 bf16):
//   mode 0: one element per thread (any inner, any C);
//   mode 1: V elements per thread that are V consecutive channels
//           (inner == 1, C % V == 0), the bias as one 16-byte load;
//   mode 2: V elements per thread that share a channel (inner % V == 0).
// 32-bit index arithmetic: the wrapper refuses tensors of 2^31 elements or more.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

namespace {

enum Act { kLinear = 0, kRelu, kLrelu, kTanh, kSigmoid, kElu, kSelu, kSoftplus, kSwish };
enum Dtype { kFloat32 = 0, kBfloat16 = 1 };

constexpr int kThreads = 256;
constexpr float kSeluAlpha = 1.6732632423543772848170429916717f;
constexpr float kSeluScale = 1.0507009873554804934193349852946f;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// v rounded to T: what an operation computed in T returns.
template <typename T>
__device__ __forceinline__ float rnd(float v) { return to_float(from_float<T>(v)); }

// XLA's logistic below float32: 1 / (exp(-x) + 1), rounded per operation.
template <typename T>
__device__ __forceinline__ float sigmoid(float x) {
  return rnd<T>(1.f / rnd<T>(rnd<T>(expf(-x)) + 1.f));
}

template <typename T, int ACT>
__device__ __forceinline__ float activate(float x, float alpha) {
  constexpr bool kWide = sizeof(T) == 4;  // float32: PyTorch's functions, one rounding
  if (ACT == kLinear) return x;
  if (ACT == kRelu) return x < 0.f ? 0.f : x;
  if (ACT == kLrelu) return x >= 0.f ? x : rnd<T>(x * alpha);
  if (ACT == kTanh) return rnd<T>(tanhf(x));
  if (ACT == kSigmoid) return sigmoid<T>(x);
  if (ACT == kElu) return x > 0.f ? x : rnd<T>(expm1f(x));
  if (ACT == kSelu) {
    if (kWide) return kSeluScale * (x > 0.f ? x : kSeluAlpha * expm1f(x));
    const float neg = rnd<T>(rnd<T>(expm1f(fminf(x, 0.f))) * rnd<T>(kSeluAlpha));
    return rnd<T>((x > 0.f ? x : neg) * rnd<T>(kSeluScale));
  }
  if (ACT == kSoftplus) {
    if (kWide) return x > 20.f ? x : log1pf(expf(x));  // torch's threshold of 20
    return rnd<T>(fmaxf(x, 0.f) + rnd<T>(log1pf(rnd<T>(expf(-fabsf(x))))));
  }
  return rnd<T>(sigmoid<T>(x) * x);  // swish
}

template <typename T, int ACT>
__device__ __forceinline__ T apply(T x, float b, float alpha, float gain, float clamp) {
  float y = activate<T, ACT>(rnd<T>(to_float(x) + b), alpha);
  if (gain != 1.f) y = rnd<T>(y * gain);
  return from_float<T>(y > clamp ? clamp : (y < -clamp ? -clamp : y));
}

// 16 bytes of T, loaded and stored in one access.
template <typename T>
struct alignas(16) Pack {
  static constexpr int kSize = 16 / sizeof(T);
  T v[kSize];
};

template <typename T, int ACT>
__global__ void __launch_bounds__(kThreads)
bias_act_scalar(const T* __restrict__ x, const T* __restrict__ b, T* __restrict__ y,
                unsigned n, unsigned inner, unsigned channels, float alpha, float gain,
                float clamp) {
  for (unsigned i = blockIdx.x * kThreads + threadIdx.x; i < n; i += gridDim.x * kThreads) {
    const float bias = b ? to_float(__ldg(b + (i / inner) % channels)) : 0.f;
    y[i] = apply<T, ACT>(x[i], bias, alpha, gain, clamp);
  }
}

// V consecutive channels per thread: inner == 1 and channels % V == 0.
template <typename T, int ACT>
__global__ void __launch_bounds__(kThreads)
bias_act_vec_channels(const Pack<T>* __restrict__ x, const T* __restrict__ b,
                      Pack<T>* __restrict__ y, unsigned nv, unsigned channels, float alpha,
                      float gain, float clamp) {
  constexpr int V = Pack<T>::kSize;
  for (unsigned v = blockIdx.x * kThreads + threadIdx.x; v < nv; v += gridDim.x * kThreads) {
    const Pack<T> xv = x[v];
    Pack<T> bv, yv;
    if (b) bv = *reinterpret_cast<const Pack<T>*>(b + (V * v) % channels);
#pragma unroll
    for (int k = 0; k < V; ++k)
      yv.v[k] = apply<T, ACT>(xv.v[k], b ? to_float(bv.v[k]) : 0.f, alpha, gain, clamp);
    y[v] = yv;
  }
}

// V elements of one channel per thread: inner % V == 0.
template <typename T, int ACT>
__global__ void __launch_bounds__(kThreads)
bias_act_vec_inner(const Pack<T>* __restrict__ x, const T* __restrict__ b,
                   Pack<T>* __restrict__ y, unsigned nv, unsigned inner, unsigned channels,
                   float alpha, float gain, float clamp) {
  constexpr int V = Pack<T>::kSize;
  for (unsigned v = blockIdx.x * kThreads + threadIdx.x; v < nv; v += gridDim.x * kThreads) {
    const Pack<T> xv = x[v];
    const float bias = b ? to_float(__ldg(b + (V * v / inner) % channels)) : 0.f;
    Pack<T> yv;
#pragma unroll
    for (int k = 0; k < V; ++k) yv.v[k] = apply<T, ACT>(xv.v[k], bias, alpha, gain, clamp);
    y[v] = yv;
  }
}

unsigned grid_for(unsigned work) {
  const unsigned blocks = (work + kThreads - 1) / kThreads;
  return blocks < 132u * 32u ? blocks : 132u * 32u;  // the rest by the grid-stride loop
}

template <typename T, int ACT>
void launch(const void* xp, const void* bp, void* yp, unsigned n, unsigned inner,
            unsigned channels, float alpha, float gain, float clamp, int mode,
            cudaStream_t stream) {
  constexpr unsigned V = Pack<T>::kSize;
  const T* x = static_cast<const T*>(xp);
  const T* b = static_cast<const T*>(bp);
  T* y = static_cast<T*>(yp);
  if (mode == 1) {
    bias_act_vec_channels<T, ACT><<<grid_for(n / V), kThreads, 0, stream>>>(
        reinterpret_cast<const Pack<T>*>(x), b, reinterpret_cast<Pack<T>*>(y), n / V,
        channels, alpha, gain, clamp);
  } else if (mode == 2) {
    bias_act_vec_inner<T, ACT><<<grid_for(n / V), kThreads, 0, stream>>>(
        reinterpret_cast<const Pack<T>*>(x), b, reinterpret_cast<Pack<T>*>(y), n / V, inner,
        channels, alpha, gain, clamp);
  } else {
    bias_act_scalar<T, ACT><<<grid_for(n), kThreads, 0, stream>>>(x, b, y, n, inner, channels,
                                                                   alpha, gain, clamp);
  }
}

template <typename T>
int dispatch(const void* x, const void* b, void* y, unsigned n, unsigned inner,
             unsigned channels, int act, float alpha, float gain, float clamp, int mode,
             cudaStream_t s) {
  const auto run = [&](auto code) {
    launch<T, decltype(code)::value>(x, b, y, n, inner, channels, alpha, gain, clamp, mode, s);
  };
  switch (act) {
    case kLinear: run(std::integral_constant<int, kLinear>()); break;
    case kRelu: run(std::integral_constant<int, kRelu>()); break;
    case kLrelu: run(std::integral_constant<int, kLrelu>()); break;
    case kTanh: run(std::integral_constant<int, kTanh>()); break;
    case kSigmoid: run(std::integral_constant<int, kSigmoid>()); break;
    case kElu: run(std::integral_constant<int, kElu>()); break;
    case kSelu: run(std::integral_constant<int, kSelu>()); break;
    case kSoftplus: run(std::integral_constant<int, kSoftplus>()); break;
    case kSwish: run(std::integral_constant<int, kSwish>()); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// y = clamp(act(x + b[c]) * gain), c = (m / inner) % channels for the element
// at memory offset m; b may be null (no bias), else of x's dtype. act: 0
// linear, 1 relu, 2 lrelu, 3 tanh, 4 sigmoid, 5 elu, 6 selu, 7 softplus,
// 8 swish. dtype: 0 float32, 1 bfloat16 (alpha, gain and clamp already
// rounded to it). mode as in the note above; modes 1 and 2 need 16-byte
// aligned x, y and b and n a multiple of V. Launches on `stream` and returns
// cudaGetLastError() (0 on success).
int tdgp_bias_act(const void* x, const void* b, void* y, long long n, long long inner,
                  int channels, int act, float alpha, float gain, float clamp, int mode,
                  int dtype, void* stream) {
  const long long v = dtype == kBfloat16 ? 8 : 4;
  if (n < 1 || n >= (1LL << 31) || inner < 1 || channels < 1 || mode < 0 || mode > 2 ||
      (dtype != kFloat32 && dtype != kBfloat16) ||
      (mode == 1 && (inner != 1 || channels % v != 0)) || (mode == 2 && inner % v != 0))
    return (int)cudaErrorInvalidValue;
  const unsigned un = (unsigned)n, ui = (unsigned)inner, uc = (unsigned)channels;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == kBfloat16)
    return dispatch<__nv_bfloat16>(x, b, y, un, ui, uc, act, alpha, gain, clamp, mode, s);
  return dispatch<float>(x, b, y, un, ui, uc, act, alpha, gain, clamp, mode, s);
}

const char* tdgp_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
