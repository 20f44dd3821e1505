// Kernel K4: the 2-layer tri-plane MLP, forward.
//
// Replaces the TPU kernel `_triplane_mlp_kernel` / `triplane_mlp_pallas` in
// tdgp/ops/pallas_kernels.py:305/316. For every point p with plane-averaged
// features x [F]:
//   h = lrelu(x . w0 + b0, 0.2) * sqrt(2)        [HID]
//   y = h . w1 + b1                              [OUT]
//   rgb[p] = y[0 .. OUT-2], sigma[p] = y[OUT-1]
// with the equalized-lr scales folded into w0 [F, HID], b0, w1 [HID, OUT],
// b1 by the caller, as the TPU kernel takes them. Float32 on the CUDA cores,
// no TF32: serving runs in full float32.
//
// What bounds it on an H100: the arithmetic. Per point it reads 4 F bytes
// and writes 4 OUT bytes, and does 2 F HID + 2 HID OUT flops: at the
// flagship's F = 32, HID = 64, OUT = 4, 144 bytes and 4,608 flops. A served
// render pass of one ray chunk is 4 x 16,384 rays x 32 samples = 2,097,152
// points: 302 MB (0.090 ms at 3.35 TB/s) and 9.66 GFLOP (0.144 ms at
// 67 TFLOP/s float32), so about 0.144 ms.
//
// What the design does about it: the MLP never leaves the chip. The [P, HID]
// hidden tensor, which the two-layer PyTorch path writes and reads back
// several times, lives in registers one value at a time. A block of 128
// threads stages the weights (9.5 KB at the flagship widths) in shared
// memory once and then walks tiles of 256 points: the tile comes in with
// coalesced 16-byte loads into rows padded to F + 4 floats (so the
// per-thread 16-byte row reads are free of bank conflicts), each thread
// keeps two points' features in registers, and for each hidden unit j reads
// row j of w0 (stored transposed) and of w1 as warp-wide broadcasts: one
// shared load serves 2 x 4 multiply-adds. Each point's sums run over k in
// order, then the bias, as x @ w0 + b0 computes them.
// Instantiated for (F, HID, OUT) = (32, 64, 4), the 256^2 configs, (16, 32, 4),
// the 64^2 configs, and (8, 16, 4), the test config; the wrapper refuses others.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kPointsPerThread = 2;
constexpr int kTile = kThreads * kPointsPerThread;
constexpr int kBlocksPerSm = 4;
constexpr float kSqrt2 = 1.41421356237309504880f;

template <int F, int HID, int OUT>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
triplane_mlp_kernel(const float* __restrict__ feats,  // [T, F]
                    const float* __restrict__ w0,     // [F, HID]
                    const float* __restrict__ b0,     // [HID]
                    const float* __restrict__ w1,     // [HID, OUT]
                    const float* __restrict__ b1,     // [OUT]
                    float* __restrict__ rgb,          // [T, OUT - 1]
                    float* __restrict__ sigma,        // [T]
                    long long n_points) {
  constexpr int kRow = F + 4;  // padded tile row, in floats
  __shared__ __align__(16) float s_w0t[HID * F];  // w0 transposed: row j = w0[:, j]
  __shared__ __align__(16) float s_w1[HID * OUT];
  __shared__ float s_b0[HID];
  __shared__ float s_b1[OUT];
  __shared__ __align__(16) float s_x[kTile * kRow];

  const int tid = threadIdx.x;
  for (int i = tid; i < F * HID; i += kThreads) s_w0t[(i % HID) * F + i / HID] = w0[i];
  for (int i = tid; i < HID * OUT; i += kThreads) s_w1[i] = w1[i];
  for (int i = tid; i < HID; i += kThreads) s_b0[i] = b0[i];
  if (tid < OUT) s_b1[tid] = b1[tid];

  const long long n_tiles = (n_points + kTile - 1) / kTile;
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long first = tile * kTile;
    __syncthreads();  // the weights are staged; the previous tile is consumed
    // the tile's features, 16 bytes per thread and load, consecutive threads
    // on consecutive addresses
    const float4* src = reinterpret_cast<const float4*>(feats + first * F);
    const long long avail4 = (n_points - first) * (F / 4);
#pragma unroll
    for (int i = 0; i < kTile * F / 4 / kThreads; ++i) {
      const int q = tid + i * kThreads;
      const float4 v = q < avail4 ? src[q] : make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<float4*>(s_x + (q / (F / 4)) * kRow + (q % (F / 4)) * 4) = v;
    }
    __syncthreads();

    float x[kPointsPerThread][F];
#pragma unroll
    for (int p = 0; p < kPointsPerThread; ++p) {
      const float* row = s_x + (tid + p * kThreads) * kRow;
#pragma unroll
      for (int k = 0; k < F; k += 4) {
        const float4 v = *reinterpret_cast<const float4*>(row + k);
        x[p][k] = v.x; x[p][k + 1] = v.y; x[p][k + 2] = v.z; x[p][k + 3] = v.w;
      }
    }
    float y[kPointsPerThread][OUT];
#pragma unroll
    for (int p = 0; p < kPointsPerThread; ++p)
#pragma unroll
      for (int o = 0; o < OUT; ++o) y[p][o] = 0.f;

#pragma unroll 4
    for (int j = 0; j < HID; ++j) {
      float h[kPointsPerThread];
#pragma unroll
      for (int p = 0; p < kPointsPerThread; ++p) h[p] = 0.f;
      const float* wrow = s_w0t + j * F;
#pragma unroll
      for (int k = 0; k < F; k += 4) {
        const float4 w = *reinterpret_cast<const float4*>(wrow + k);
#pragma unroll
        for (int p = 0; p < kPointsPerThread; ++p) {
          h[p] = fmaf(x[p][k], w.x, h[p]);
          h[p] = fmaf(x[p][k + 1], w.y, h[p]);
          h[p] = fmaf(x[p][k + 2], w.z, h[p]);
          h[p] = fmaf(x[p][k + 3], w.w, h[p]);
        }
      }
      const float bj = s_b0[j];
#pragma unroll
      for (int p = 0; p < kPointsPerThread; ++p) {
        const float a = h[p] + bj;
        const float act = (a >= 0.f ? a : 0.2f * a) * kSqrt2;
#pragma unroll
        for (int o = 0; o < OUT; ++o) y[p][o] = fmaf(act, s_w1[j * OUT + o], y[p][o]);
      }
    }

#pragma unroll
    for (int p = 0; p < kPointsPerThread; ++p) {
      const long long point = first + tid + p * kThreads;
      if (point < n_points) {
#pragma unroll
        for (int o = 0; o < OUT - 1; ++o) rgb[point * (OUT - 1) + o] = y[p][o] + s_b1[o];
        sigma[point] = y[p][OUT - 1] + s_b1[OUT - 1];
      }
    }
  }
}

template <int F, int HID, int OUT>
int launch(const float* feats, const float* w0, const float* b0, const float* w1,
           const float* b1, float* rgb, float* sigma, long long n_points, cudaStream_t stream) {
  static int n_sms = 0;
  if (n_sms == 0) {
    int device = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&n_sms, cudaDevAttrMultiProcessorCount, device);
  }
  const long long n_tiles = (n_points + kTile - 1) / kTile;
  const long long most = (long long)n_sms * kBlocksPerSm;
  const unsigned blocks = (unsigned)(n_tiles < most ? n_tiles : most);
  triplane_mlp_kernel<F, HID, OUT><<<blocks, kThreads, 0, stream>>>(
      feats, w0, b0, w1, b1, rgb, sigma, n_points);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// feats [n_points, f] (16-byte aligned), w0 [f, hid], b0 [hid], w1 [hid, out],
// b1 [out], all float32 and contiguous -> rgb [n_points, out - 1], sigma
// [n_points]. (f, hid, out) must be one of the instantiated widths.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
int tdgp_triplane_mlp(const float* feats, const float* w0, const float* b0, const float* w1,
                      const float* b1, float* rgb, float* sigma, long long n_points, int f,
                      int hid, int out, void* stream) {
  if (n_points < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (f == 32 && hid == 64 && out == 4)
    return launch<32, 64, 4>(feats, w0, b0, w1, b1, rgb, sigma, n_points, s);
  if (f == 16 && hid == 32 && out == 4)
    return launch<16, 32, 4>(feats, w0, b0, w1, b1, rgb, sigma, n_points, s);
  if (f == 8 && hid == 16 && out == 4)
    return launch<8, 16, 4>(feats, w0, b0, w1, b1, rgb, sigma, n_points, s);
  return (int)cudaErrorInvalidValue;
}

const char* tdgp_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
