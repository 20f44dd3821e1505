// Kernel K4: the 2-layer tri-plane MLP, forward.
//
// Replaces the TPU kernel `_triplane_mlp_kernel` / `triplane_mlp_pallas` in
// tdgp/ops/pallas_kernels.py:305/316. For every point p with plane-averaged
// features x [F]:
//   h = lrelu(x . w0 + b0, 0.2) * sqrt(2)        [HID]
//   y = h . w1 + b1                              [OUT]
//   rgb[p] = y[0 .. OUT-2], sigma[p] = y[OUT-1]
// with the equalized-lr scales folded into w0 [F, HID], b0, w1 [HID, OUT],
// b1 by the caller, as the TPU kernel takes them. Float32 accuracy: serving
// runs with TF32 off.
//
// What bounds it on an H100: device memory. Per point it reads 4 F bytes
// and writes 4 OUT bytes, and does 2 F HID + 2 HID OUT flops: at the
// flagship's F = 32, HID = 64, OUT = 4, 144 bytes and 4,608 flops. A served
// render pass of one ray chunk is 4 x 16,384 rays x 32 samples = 2,097,152
// points: 302 MB, 0.090 ms at 3.35 TB/s. On the CUDA cores the 9.66 GFLOP
// would take 0.144 ms at 67 TFLOP/s; on the tensor cores, even three times
// over, 0.059 ms at 495 TFLOP/s TF32.
//
// What the design does about it: the first product, 94 % of the flops, runs
// on the tensor cores (mma.sync m16n8k8 TF32) as 3xTF32: each float32
// operand is split into a TF32 high part (cvt.rna) and a TF32 low part (the
// rounded remainder), and x w = x_lo w_hi + x_hi w_lo + x_hi w_hi, summed in
// float32, leaves out only x_lo w_lo (about 2^-22 of each product), so the
// result keeps float32 accuracy, as the TPU kernel's matrix-unit product at
// its highest precision did. The weights are split once per block and
// kept in shared memory in the fragments' order, one 16-byte load per
// (k-step, n-tile) and thread. A persistent block of 4 warps streams tiles
// of 128 points through a double buffer filled with cp.async (16 bytes per
// thread and copy, rows padded to F + 4 floats so the fragments' loads are
// free of bank conflicts); each warp takes 32 points as two 16-row
// m-tiles. The bias, the leaky ReLU and sqrt 2 are applied to the
// accumulator fragments in registers; the [P, HID] hidden tensor never
// leaves them. The second product (HID x OUT, 6 % of the flops) runs on the
// CUDA cores in float32 straight from the fragments: with OUT = 4 a tensor
// core tile of width 8 would be half padding and would need its own split,
// while here each thread sums its 2 x HID/8 hidden units for its rows and
// the four threads of a fragment row group add their sums with two shuffles;
// thread t of the group then writes output t of its rows. Instantiated for
// (F, HID, OUT) = (32, 64, 4), the 256^2 configs, (16, 32, 4), the 64^2
// configs, and (8, 16, 4), the test config; the wrapper refuses others.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMTiles = 2;                 // 16-row m-tiles per warp and tile
constexpr int kTile = kWarps * kMTiles * 16;  // points per tile: 128
constexpr int kBlocksPerSm = 4;
constexpr float kSqrt2 = 1.41421356237309504880f;

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x -> (hi, lo), both TF32, x ~ hi + lo to about 2^-22 relative
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  const int bytes = valid ? 16 : 0;  // 0: fill with zeros, read nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(bytes));
}

template <int F>
__device__ __forceinline__ void load_tile(float* s_x, const float* feats, long long first,
                                          long long n_points) {
  constexpr int kRow = F + 4;
  constexpr int kChunks = kTile * F / 4;
  for (int q = threadIdx.x; q < kChunks; q += kThreads) {
    const int row = q / (F / 4), col = (q % (F / 4)) * 4;
    const bool valid = first + row < n_points;
    const float* src = valid ? feats + (first + row) * F + col : feats;
    cp_async16(s_x + row * kRow + col, src, valid);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int F, int HID, int OUT>
struct Smem {
  static constexpr int kRow = F + 4;
  uint4 w0[F / 8][HID / 8][32];   // per (k-step, n-tile, lane): b0 hi, b1 hi, b0 lo, b1 lo
  float b0[HID];
  float w1[HID][OUT];
  float b1[OUT];
  alignas(16) float x[2][kTile * kRow];  // the double buffer of feature tiles (cp.async)
};

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
  static_assert(F % 8 == 0 && HID % 8 == 0 && OUT <= 4, "widths");
  constexpr int kK = F / 8, kN = HID / 8, kRow = F + 4;
  extern __shared__ uint4 smem_raw[];
  auto& s = *reinterpret_cast<Smem<F, HID, OUT>*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int group = lane >> 2, tig = lane & 3;  // fragment row group, thread in group

  const long long n_tiles = (n_points + kTile - 1) / kTile;
  long long tile = blockIdx.x;
  if (tile < n_tiles) load_tile<F>(s.x[0], feats, tile * kTile, n_points);

  // B fragment of w0 for k-step k, n-tile j: rows (k) 8k + tig and 8k + tig + 4,
  // column (n) 8j + group
  for (int i = tid; i < kK * kN * 32; i += kThreads) {
    const int k = i / (kN * 32), j = (i / 32) % kN, l = i % 32;
    const int kr = 8 * k + (l & 3), n = 8 * j + (l >> 2);
    uint32_t h0, l0, h1, l1;
    split(w0[kr * HID + n], h0, l0);
    split(w0[(kr + 4) * HID + n], h1, l1);
    s.w0[k][j][l] = make_uint4(h0, h1, l0, l1);
  }
  for (int i = tid; i < HID; i += kThreads) s.b0[i] = b0[i];
  for (int i = tid; i < HID * OUT; i += kThreads) s.w1[i / OUT][i % OUT] = w1[i];
  if (tid < OUT) s.b1[tid] = b1[tid];

  for (int buf = 0; tile < n_tiles; tile += gridDim.x, buf ^= 1) {
    const long long next = tile + gridDim.x;
    if (next < n_tiles) {
      load_tile<F>(s.x[buf ^ 1], feats, next * kTile, n_points);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();  // tile `buf` (and, the first time, the weights) in place

    float acc[kMTiles][kN][4];
#pragma unroll
    for (int m = 0; m < kMTiles; ++m)
#pragma unroll
      for (int j = 0; j < kN; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[m][j][c] = 0.f;

#pragma unroll
    for (int k = 0; k < kK; ++k) {
      uint32_t a_hi[kMTiles][4], a_lo[kMTiles][4];
#pragma unroll
      for (int m = 0; m < kMTiles; ++m) {
        // A fragment: rows group, group + 8; columns tig, tig + 4 of k-step k
        const float* x = s.x[buf] + (warp * kMTiles * 16 + m * 16 + group) * kRow + 8 * k + tig;
        split(x[0], a_hi[m][0], a_lo[m][0]);
        split(x[8 * kRow], a_hi[m][1], a_lo[m][1]);
        split(x[4], a_hi[m][2], a_lo[m][2]);
        split(x[8 * kRow + 4], a_hi[m][3], a_lo[m][3]);
      }
#pragma unroll
      for (int j = 0; j < kN; ++j) {
        const uint4 b = s.w0[k][j][lane];
#pragma unroll
        for (int m = 0; m < kMTiles; ++m) {
          mma_tf32(acc[m][j], a_lo[m], b.x, b.y);
          mma_tf32(acc[m][j], a_hi[m], b.z, b.w);
          mma_tf32(acc[m][j], a_hi[m], b.x, b.y);
        }
      }
    }

    // hidden unit of acc[m][j][c]: 8 j + 2 tig + (c & 1); row group + 8 (c >> 1)
    float y[kMTiles][2][OUT];
#pragma unroll
    for (int m = 0; m < kMTiles; ++m)
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int o = 0; o < OUT; ++o) y[m][r][o] = 0.f;
#pragma unroll
    for (int j = 0; j < kN; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int unit = 8 * j + 2 * tig + c;
        const float bj = s.b0[unit];
        float wo[OUT];
#pragma unroll
        for (int o = 0; o < OUT; ++o) wo[o] = s.w1[unit][o];
#pragma unroll
        for (int m = 0; m < kMTiles; ++m)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float a = acc[m][j][2 * r + c] + bj;
            const float act = (a >= 0.f ? a : 0.2f * a) * kSqrt2;
#pragma unroll
            for (int o = 0; o < OUT; ++o) y[m][r][o] = fmaf(act, wo[o], y[m][r][o]);
          }
      }
    }
#pragma unroll
    for (int m = 0; m < kMTiles; ++m)
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int o = 0; o < OUT; ++o) {
          y[m][r][o] += __shfl_xor_sync(0xffffffffu, y[m][r][o], 1);
          y[m][r][o] += __shfl_xor_sync(0xffffffffu, y[m][r][o], 2);
        }
    if (tig < OUT) {
#pragma unroll
      for (int m = 0; m < kMTiles; ++m)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const long long point = tile * kTile + warp * kMTiles * 16 + m * 16 + 8 * r + group;
          float v = y[m][r][0];
#pragma unroll
          for (int o = 1; o < OUT; ++o) v = tig == o ? y[m][r][o] : v;
          v += s.b1[tig];
          if (point < n_points) {
            if (tig < OUT - 1) rgb[point * (OUT - 1) + tig] = v;
            else sigma[point] = v;
          }
        }
    }
    __syncthreads();  // every warp is done with tile `buf` before it is refilled
  }
}

template <int F, int HID, int OUT>
int launch(const float* feats, const float* w0, const float* b0, const float* w1,
           const float* b1, float* rgb, float* sigma, long long n_points, cudaStream_t stream) {
  static int n_sms = 0;
  const int smem = (int)sizeof(Smem<F, HID, OUT>);
  if (n_sms == 0) {
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&n_sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(triplane_mlp_kernel<F, HID, OUT>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) {
      n_sms = 0;
      return (int)err;
    }
  }
  const long long n_tiles = (n_points + kTile - 1) / kTile;
  const long long most = (long long)n_sms * kBlocksPerSm;
  const unsigned blocks = (unsigned)(n_tiles < most ? n_tiles : most);
  triplane_mlp_kernel<F, HID, OUT><<<blocks, kThreads, smem, stream>>>(
      feats, w0, b0, w1, b1, rgb, sigma, n_points);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// feats [n_points, f] (16-byte aligned), w0 [f, hid], b0 [hid], w1 [hid, out],
// b1 [out], all float32 and contiguous -> rgb [n_points, out - 1], sigma
// [n_points]. (f, hid, out) must be one of the instantiated widths.
// Launches on `stream` and returns the first CUDA error (0 on success).
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
