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
//
// The bf16 entry (triplane_mlp_bf16_kernel) is the MLP of the bf16 render
// views (generator.render_bf16). It replaces no TPU kernel: there the JAX
// package runs the two FullyConnected layers in bf16 in XLA
// (tdgp/models/epigraf.py:287-289, tdgp/models/layers.py:38-52), and this
// entry computes what they compute, from bf16 features and the weights
// folded in bf16 by the caller (cast, then scaled by the gain rounded to
// bf16):
//   h = bf16(x . w0)                   (float32 sum of exact products)
//   h = bf16(h + b0); h = h >= 0 ? h : bf16(h * bf16(0.2)); h = bf16(h * bf16(sqrt 2))
//   y = bf16(bf16(h . w1) + b1)
// with rgb and sigma stored in bf16. Bound on an H100: device memory. Per
// point it reads 2 F bytes and writes 2 OUT bytes: at F = 32, OUT = 4, 72
// bytes, 151 MB for a served pass of 2,097,152 points, 0.045 ms at 3.35
// TB/s; its 9.66 GFLOP take 0.010 ms at 989 TFLOP/s bf16. Its first design,
// the float32 kernel's with bf16 products, took the float32 kernel's 0.19 ms
// on an H100 (tdgp_torch/probe_kernels.py): its loads alone took 0.050 ms
// and its loads and stores 0.061, so the per-point arithmetic held it
// (~1,000 instructions a thread and tile for the roundings and the second
// product on the CUDA cores, behind block-wide barriers). The design now:
//  - both products on the tensor cores (mma.sync m16n8k16 bf16): the first
//    product's accumulator fragments of n-tiles 2kk and 2kk + 1, rounded,
//    are the A fragment of k-step kk of the second, against w1 padded to 8
//    columns with zeros; bf16 x bf16 products are exact in the float32
//    accumulator, so only the order of the sums differs from XLA's;
//  - the rounding chain in bf16 pairs, one instruction a step for two
//    values: cvt.rn.bf16x2 of the sums, fma.rn.bf16x2 with 1 for the bias
//    add and with -0 for the products (each one rounding of the exact
//    result, what a float32 add or product of two bf16 values rounded to
//    bf16 gives), the leaky ReLU as max.bf16x2(h, h alpha);
//  - each warp on its own tiles of 32 points, with its own ring of 4 tiles
//    in shared memory filled by cp.async (rows of F + 8 bf16: the A
//    fragments' 4-byte loads hit 32 distinct banks), so no block barrier;
//    the weights' fragments in registers; a tile's outputs staged in
//    shared memory and stored as 64-byte runs.
// Instantiated for (F, HID, OUT) = (32, 64, 4) and (16, 32, 4).

#include <cuda_bf16.h>
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

// ------------------------------------------------------------ the bf16 entry

constexpr int kStages = 4;     // tiles a warp has in flight: a ring in shared memory
constexpr int kWarpTile = 32;  // points a warp tile: two 16-row m-tiles
constexpr uint32_t kOneBf16x2 = 0x3f803f80u, kNegZeroBf16x2 = 0x80008000u;

// two bf16 values in one register, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// two floats rounded to bf16 (to nearest) in one register, `lo` in the low half
__device__ __forceinline__ uint32_t cvt_bf16x2(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// a * b + c on two bf16 pairs, each rounded once: a + c with b = 1, a * b
// with c = -0 (both exactly what a float32 add or product of two bf16
// values rounded to bf16 gives)
__device__ __forceinline__ uint32_t fma_bf16x2(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}

__device__ __forceinline__ uint32_t max_bf16x2(uint32_t a, uint32_t b) {
  uint32_t r;
  asm("max.bf16x2 %0, %1, %2;\n" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

// The hidden layer's chain on two units of one row, in bf16 pairs: the
// float32 sums rounded, the bias added, the leaky ReLU as max(h, h alpha)
// (equal to h >= 0 ? h : h alpha in bf16, since |h alpha| rounds below
// |h|, and -0 stays -0), the gain; each step rounded once.
__device__ __forceinline__ uint32_t hidden_bf16x2(float c0, float c1, uint32_t bias,
                                                  uint32_t alpha, uint32_t gain) {
  const uint32_t h = fma_bf16x2(cvt_bf16x2(c0, c1), kOneBf16x2, bias);
  return fma_bf16x2(max_bf16x2(h, fma_bf16x2(h, alpha, kNegZeroBf16x2)), gain, kNegZeroBf16x2);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void commit_group() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One warp's copies of the 32 feature rows from point `first` into a stage
// of its ring (rows of F + 8 bf16), 16 bytes a copy; rows past the end zeroed.
template <int F>
__device__ __forceinline__ void load_warp_tile(__nv_bfloat16* s_x, const __nv_bfloat16* feats,
                                               long long first, long long n_points, int lane) {
  constexpr int kRow = F + 8, kChunks = kWarpTile * F / 8;
#pragma unroll
  for (int q = lane; q < kChunks; q += 32) {
    const int row = q / (F / 8), col = (q % (F / 8)) * 8;
    const bool valid = first + row < n_points;
    cp_async16(s_x + row * kRow + col, valid ? feats + (first + row) * F + col : feats, valid);
  }
}

template <int F, int HID, int OUT>
struct SmemBf16 {
  static constexpr int kRow = F + 8;
  alignas(16) __nv_bfloat16 x[kWarps][kStages][kWarpTile * kRow];  // each warp's ring
  uint32_t y[kWarps][kWarpTile * 2];  // a warp tile's outputs, pairs (r, g) and (b, sigma)
};

template <int F, int HID, int OUT>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
triplane_mlp_bf16_kernel(const __nv_bfloat16* __restrict__ feats,  // [T, F]
                         const __nv_bfloat16* __restrict__ w0,     // [F, HID], folded
                         const __nv_bfloat16* __restrict__ b0,     // [HID]
                         const __nv_bfloat16* __restrict__ w1,     // [HID, OUT], folded
                         const __nv_bfloat16* __restrict__ b1,     // [OUT]
                         __nv_bfloat16* __restrict__ rgb,          // [T, OUT - 1]
                         __nv_bfloat16* __restrict__ sigma,        // [T]
                         long long n_points) {
  static_assert(F % 16 == 0 && HID % 16 == 0 && OUT == 4, "widths");
  constexpr int kK = F / 16, kN = HID / 8, kK2 = HID / 16, kRow = F + 8;
  constexpr int kStage = kWarpTile * kRow;
  extern __shared__ uint4 smem_raw[];
  auto& s = *reinterpret_cast<SmemBf16<F, HID, OUT>*>(smem_raw);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int group = lane >> 2, tig = lane & 3;  // fragment row group, thread in group
  __nv_bfloat16* const ring = s.x[warp][0];
  uint32_t* const ys = s.y[warp];

  const long long n_tiles = (n_points + kWarpTile - 1) / kWarpTile;
  const long long stride = (long long)gridDim.x * kWarps;
  long long tile = (long long)blockIdx.x * kWarps + warp;
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {  // the first tiles in flight
    if (tile + st * stride < n_tiles)
      load_warp_tile<F>(ring + st * kStage, feats, (tile + st * stride) * kWarpTile, n_points,
                        lane);
    commit_group();
  }

  // The weights, in registers. w0's B fragment for k-step k, n-tile j: rows
  // 16k + 2 tig (+1) and 16k + 2 tig + 8 (+1), column 8j + group; w1's for
  // k-step kk: rows 16kk + 2 tig (+1) and (+8, +9), column group, padded to
  // 8 columns with zeros; b0 for units 8j + 2 tig (+1); b1 for outputs
  // 2 tig (+1).
  uint32_t bw0[kK][kN][2], bw1[kK2][2], bb0[kN];
#pragma unroll
  for (int k = 0; k < kK; ++k)
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      const int kr = 16 * k + 2 * tig, n = 8 * j + group;
      bw0[k][j][0] = pack_bf16(w0[kr * HID + n], w0[(kr + 1) * HID + n]);
      bw0[k][j][1] = pack_bf16(w0[(kr + 8) * HID + n], w0[(kr + 9) * HID + n]);
    }
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
#pragma unroll
  for (int kk = 0; kk < kK2; ++kk) {
    const int kr = 16 * kk + 2 * tig;
    auto w = [&](int row) { return group < OUT ? w1[row * OUT + group] : zero; };
    bw1[kk][0] = pack_bf16(w(kr), w(kr + 1));
    bw1[kk][1] = pack_bf16(w(kr + 8), w(kr + 9));
  }
#pragma unroll
  for (int j = 0; j < kN; ++j) bb0[j] = pack_bf16(b0[8 * j + 2 * tig], b0[8 * j + 2 * tig + 1]);
  const uint32_t bb1 = tig < 2 ? pack_bf16(b1[2 * tig], b1[2 * tig + 1]) : 0u;
  const __nv_bfloat16 alpha1 = __float2bfloat16_rn(0.2f), gain1 = __float2bfloat16_rn(kSqrt2);
  const uint32_t alpha = pack_bf16(alpha1, alpha1), gain = pack_bf16(gain1, gain1);

  for (int i = 0; tile < n_tiles; ++i, tile += stride) {
    const long long ahead = tile + (kStages - 1) * stride;
    if (ahead < n_tiles)
      load_warp_tile<F>(ring + ((i + kStages - 1) % kStages) * kStage, feats, ahead * kWarpTile,
                        n_points, lane);
    commit_group();
    wait_group<kStages - 1>();  // this lane's copies of tile i have landed
    __syncwarp();               // and every lane's are visible
    const __nv_bfloat16* xs = ring + (i % kStages) * kStage;
    const long long first = tile * kWarpTile;
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      uint32_t a[kK][4];  // A fragments: rows group, group + 8; columns 2 tig (+1), 2 tig + 8 (+1)
#pragma unroll
      for (int k = 0; k < kK; ++k) {
        const __nv_bfloat16* x = xs + (16 * m + group) * kRow + 16 * k + 2 * tig;
        a[k][0] = *reinterpret_cast<const uint32_t*>(x);
        a[k][1] = *reinterpret_cast<const uint32_t*>(x + 8 * kRow);
        a[k][2] = *reinterpret_cast<const uint32_t*>(x + 8);
        a[k][3] = *reinterpret_cast<const uint32_t*>(x + 8 * kRow + 8);
      }
      float y[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < kK2; ++kk) {
        // n-tiles 2kk and 2kk + 1 of the first product: hidden units 16kk .. 16kk + 15,
        // whose accumulator fragments, rounded, are the A fragment of k-step kk of the second
        float c0[4] = {0.f, 0.f, 0.f, 0.f}, c1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int k = 0; k < kK; ++k) {
          mma_bf16(c0, a[k], bw0[k][2 * kk][0], bw0[k][2 * kk][1]);
          mma_bf16(c1, a[k], bw0[k][2 * kk + 1][0], bw0[k][2 * kk + 1][1]);
        }
        const uint32_t h[4] = {hidden_bf16x2(c0[0], c0[1], bb0[2 * kk], alpha, gain),
                               hidden_bf16x2(c0[2], c0[3], bb0[2 * kk], alpha, gain),
                               hidden_bf16x2(c1[0], c1[1], bb0[2 * kk + 1], alpha, gain),
                               hidden_bf16x2(c1[2], c1[3], bb0[2 * kk + 1], alpha, gain)};
        mma_bf16(y, h, bw1[kk][0], bw1[kk][1]);
      }
      if (tig < 2) {  // outputs 2 tig, 2 tig + 1 of rows group, group + 8: rounded, b1 added
        ys[(16 * m + group) * 2 + tig] = fma_bf16x2(cvt_bf16x2(y[0], y[1]), kOneBf16x2, bb1);
        ys[(16 * m + group + 8) * 2 + tig] = fma_bf16x2(cvt_bf16x2(y[2], y[3]), kOneBf16x2, bb1);
      }
    }
    __syncwarp();
    // the warp's 32 sigmas and 96 rgb values, each store 64 contiguous bytes
    const __nv_bfloat16* yb = reinterpret_cast<const __nv_bfloat16*>(ys);  // [32][r, g, b, sigma]
    if (first + lane < n_points) sigma[first + lane] = yb[4 * lane + OUT - 1];
#pragma unroll
    for (int c = 0; c < OUT - 1; ++c) {
      const int e = 32 * c + lane, row = e / (OUT - 1);
      if (first + row < n_points) rgb[first * (OUT - 1) + e] = yb[4 * row + e % (OUT - 1)];
    }
    __syncwarp();  // the stage and the outputs are read before they are written again
  }
  wait_group<0>();
}

template <int F, int HID, int OUT>
int launch_bf16(const __nv_bfloat16* feats, const __nv_bfloat16* w0, const __nv_bfloat16* b0,
                const __nv_bfloat16* w1, const __nv_bfloat16* b1, __nv_bfloat16* rgb,
                __nv_bfloat16* sigma, long long n_points, cudaStream_t stream) {
  static int n_sms = 0;
  const int smem = (int)sizeof(SmemBf16<F, HID, OUT>);
  if (n_sms == 0) {
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&n_sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(triplane_mlp_bf16_kernel<F, HID, OUT>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) {
      n_sms = 0;
      return (int)err;
    }
  }
  const long long n_tiles = (n_points + kWarpTile - 1) / kWarpTile;
  const long long want = (n_tiles + kWarps - 1) / kWarps;
  const long long most = (long long)n_sms * kBlocksPerSm;
  const unsigned blocks = (unsigned)(want < most ? want : most);
  triplane_mlp_bf16_kernel<F, HID, OUT><<<blocks, kThreads, smem, stream>>>(
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

// The bf16 entry: every tensor bf16 and contiguous, the weights folded in
// bf16; (f, hid, out) one of (32, 64, 4) and (16, 32, 4). Same return value.
int tdgp_triplane_mlp_bf16(const __nv_bfloat16* feats, const __nv_bfloat16* w0,
                           const __nv_bfloat16* b0, const __nv_bfloat16* w1,
                           const __nv_bfloat16* b1, __nv_bfloat16* rgb, __nv_bfloat16* sigma,
                           long long n_points, int f, int hid, int out, void* stream) {
  if (n_points < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (f == 32 && hid == 64 && out == 4)
    return launch_bf16<32, 64, 4>(feats, w0, b0, w1, b1, rgb, sigma, n_points, s);
  if (f == 16 && hid == 32 && out == 4)
    return launch_bf16<16, 32, 4>(feats, w0, b0, w1, b1, rgb, sigma, n_points, s);
  return (int)cudaErrorInvalidValue;
}

const char* tdgp_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
