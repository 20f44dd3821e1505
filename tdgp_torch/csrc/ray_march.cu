// Kernel K3: reduced classical volume integration of the final render pass,
// and its first-order gradient.
//
// Replaces the TPU kernel `_ray_march_kernel` / `ray_march_pallas` in
// tdgp/ops/pallas_kernels.py:86/136. For each ray it computes what the
// classical marcher (tdgp/rendering/renderer.py:62-105) followed by a sum of
// the weights computes, and writes only the per-ray results:
//   sigma_i = softplus(beta * x_i) / beta   or   max(x_i, 0)
//   delta_i = t_{i+1} - t_i,  delta_{S-1} = last_delta (1e10 or 1e-3)
//   alpha_i = 1 - exp(-delta_i * sigma_i)
//   T_i     = prod_{j<i} ((1 - alpha_j) + 1e-10)       (exclusive)
//   w_i     = alpha_i * T_i
//   rgb = sum_i w_i c_i, depth = sum_i w_i t_i, wsum = sum_i w_i,
//   ftrans = T_S; with last_back, w_{S-1} += 1 - sum_i w_i.
//
// What bounds it on an H100: device memory. It does ~20 flops per 20 bytes
// read; at the serving shape (batch 4 x 16,384 rays per chunk, S = 64, C = 3)
// one call reads 4*16384*64*(3+2)*4 B = 84 MB and writes 1.6 MB, about
// 25 us at 3.35 TB/s.
//
// What the design does about it: one warp per ray. Lane l takes samples
// l, l+32, ..., so every load of a warp is one coalesced run of the ray's
// samples; the exclusive transmittance is a product scan over the lanes
// (shuffles) carried from one round of 32 samples to the next; each lane
// keeps its partial sums in registers and a shuffle reduction gives the
// ray's totals. No [N, S] intermediate reaches device memory. The TPU
// kernel's exp-of-masked-matmul prefix product (a workaround for a missing
// cumprod) has no counterpart here.

// The backward (ray_march_reduced_bwd_kernel) replaces the JAX package's
// analytic VJP `_ray_march_bwd` (tdgp/ops/pallas_kernels.py:251, written in
// jnp there). From the three saved inputs and the four cotangents it
// computes, per ray, with a_i = <c_i, g_rgb> + t_i g_depth + g_wsum:
//   g (uncorrected w_i) = a_i, or a_i - a_{S-1} (0 at S-1) with last_back
//   gf_i    = -g_i T_i + (sum_{k>i} g_k w_k + g_ftrans T_S) / ((1-alpha_i) + 1e-10)
//   g_x_i   = gf_i * (-delta_i e^{-delta_i sigma_i}) * dsigma_i/dx_i
//   g_c_i   = w'_i g_rgb        (w' with the last_back correction)
//   g_t_i   = w'_i g_depth - gd_i [i < S-1] + gd_{i-1} [i > 0],
//             gd_i = gf_i * (-sigma_i e^{-delta_i sigma_i})
// It is bound by memory like the forward: it reads the inputs twice (once
// for the ray's totals, once for the per-sample gradients) and writes the
// three gradients, 2*(S*(C+2)) + S*(C+2) floats per ray. The same
// warp-per-ray layout serves it: the transmittance is the forward's product
// scan, and sum_{k>i} is the ray total minus a shuffle prefix sum.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxChannels = 4;
constexpr int kRaysPerBlock = 8;  // one warp per ray
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float clamp_density(float x, int clamp_mode, float beta) {
  if (clamp_mode == 0) {
    // torch.nn.functional.softplus: linear above a threshold of 20
    const float y = beta * x;
    return (y > 20.f ? y : log1pf(expf(y))) / beta;
  }
  return fmaxf(x, 0.f);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(kFullMask, v, off);
  return v;
}

__global__ void __launch_bounds__(32 * kRaysPerBlock)
ray_march_reduced_kernel(const float* __restrict__ colors,     // [N, S, C]
                         const float* __restrict__ densities,  // [N, S]
                         const float* __restrict__ depths,     // [N, S]
                         float* __restrict__ rgb_out,          // [N, C]
                         float* __restrict__ depth_out,        // [N]
                         float* __restrict__ wsum_out,         // [N]
                         float* __restrict__ ftrans_out,       // [N]
                         long long n_rays, int n_steps, int n_channels,
                         int clamp_mode, float sp_beta, float last_delta,
                         int last_back) {
  const int lane = threadIdx.x & 31;
  const long long ray = (long long)blockIdx.x * kRaysPerBlock + (threadIdx.x >> 5);
  if (ray >= n_rays) return;  // the whole warp leaves together
  const long long base = ray * n_steps;

  float carry = 1.f;  // transmittance in front of this round of 32 samples
  float acc_rgb[kMaxChannels] = {0.f, 0.f, 0.f, 0.f};
  float acc_depth = 0.f, acc_w = 0.f;

  for (int s0 = 0; s0 < n_steps; s0 += 32) {
    const int s = s0 + lane;
    const bool valid = s < n_steps;
    float t = 0.f, alpha = 0.f;
    if (valid) {
      t = depths[base + s];
      const float delta = (s + 1 < n_steps) ? depths[base + s + 1] - t : last_delta;
      const float sigma = clamp_density(densities[base + s], clamp_mode, sp_beta);
      alpha = 1.f - expf(-delta * sigma);
    }
    const float factor = valid ? (1.f - alpha) + 1e-10f : 1.f;

    float incl = factor;  // inclusive product scan over the lanes
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float up = __shfl_up_sync(kFullMask, incl, off);
      if (lane >= off) incl *= up;
    }
    float excl = __shfl_up_sync(kFullMask, incl, 1);
    if (lane == 0) excl = 1.f;

    const float w = alpha * carry * excl;
    acc_w += w;
    acc_depth += w * t;
    if (valid) {
      const float* c = colors + (base + s) * n_channels;
#pragma unroll
      for (int k = 0; k < kMaxChannels; ++k)
        if (k < n_channels) acc_rgb[k] += w * c[k];
    }
    carry *= __shfl_sync(kFullMask, incl, 31);
  }

  acc_w = warp_sum(acc_w);
  acc_depth = warp_sum(acc_depth);
#pragma unroll
  for (int k = 0; k < kMaxChannels; ++k) acc_rgb[k] = warp_sum(acc_rgb[k]);

  if (lane == 0) {
    float wsum = acc_w;
    if (last_back) {
      const long long last = base + n_steps - 1;
      const float corr = 1.f - acc_w;
      acc_depth += corr * depths[last];
#pragma unroll
      for (int k = 0; k < kMaxChannels; ++k)
        if (k < n_channels) acc_rgb[k] += corr * colors[last * n_channels + k];
      wsum += corr;
    }
#pragma unroll
    for (int k = 0; k < kMaxChannels; ++k)
      if (k < n_channels) rgb_out[ray * n_channels + k] = acc_rgb[k];
    depth_out[ray] = acc_depth;
    wsum_out[ray] = wsum;
    ftrans_out[ray] = carry;
  }
}

struct Sample {
  float t, delta, sigma, dsigma, e, alpha, factor;
};

__device__ __forceinline__ Sample load_sample(const float* densities, const float* depths,
                                              long long base, int s, int n_steps,
                                              int clamp_mode, float beta, float last_delta) {
  Sample r;
  r.t = depths[base + s];
  r.delta = (s + 1 < n_steps) ? depths[base + s + 1] - r.t : last_delta;
  const float x = densities[base + s];
  if (clamp_mode == 0) {
    const float y = beta * x;
    r.sigma = (y > 20.f ? y : log1pf(expf(y))) / beta;
    r.dsigma = 1.f / (1.f + expf(-y));
  } else {
    r.sigma = fmaxf(x, 0.f);
    r.dsigma = x > 0.f ? 1.f : 0.f;
  }
  r.e = expf(-r.delta * r.sigma);
  r.alpha = 1.f - r.e;
  r.factor = (1.f - r.alpha) + 1e-10f;
  return r;
}

// inclusive product scan over the lanes; returns the exclusive one
__device__ __forceinline__ float exclusive_product(float factor, int lane, float* incl_out) {
  float incl = factor;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float up = __shfl_up_sync(kFullMask, incl, off);
    if (lane >= off) incl *= up;
  }
  float excl = __shfl_up_sync(kFullMask, incl, 1);
  if (lane == 0) excl = 1.f;
  *incl_out = incl;
  return excl;
}

__global__ void __launch_bounds__(32 * kRaysPerBlock)
ray_march_reduced_bwd_kernel(const float* __restrict__ colors,     // [N, S, C]
                             const float* __restrict__ densities,  // [N, S]
                             const float* __restrict__ depths,     // [N, S]
                             const float* __restrict__ g_rgb,      // [N, C]
                             const float* __restrict__ g_depth,    // [N]
                             const float* __restrict__ g_wsum,     // [N]
                             const float* __restrict__ g_ftrans,   // [N]
                             float* __restrict__ g_colors,         // [N, S, C]
                             float* __restrict__ g_densities,      // [N, S]
                             float* __restrict__ g_depths,         // [N, S]
                             long long n_rays, int n_steps, int n_channels,
                             int clamp_mode, float sp_beta, float last_delta,
                             int last_back) {
  const int lane = threadIdx.x & 31;
  const long long ray = (long long)blockIdx.x * kRaysPerBlock + (threadIdx.x >> 5);
  if (ray >= n_rays) return;  // the whole warp leaves together
  const long long base = ray * n_steps;

  float grgb[kMaxChannels] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int k = 0; k < kMaxChannels; ++k)
    if (k < n_channels) grgb[k] = g_rgb[ray * n_channels + k];
  const float gdep = g_depth[ray], gws = g_wsum[ray], gft = g_ftrans[ray];

  auto cot = [&](long long s) {  // a_s
    float a = depths[base + s] * gdep + gws;
    const float* c = colors + (base + s) * n_channels;
#pragma unroll
    for (int k = 0; k < kMaxChannels; ++k)
      if (k < n_channels) a += c[k] * grgb[k];
    return a;
  };
  const float a_last = cot(n_steps - 1);

  // pass 1: the ray's totals: T_S, sum_i w_i and sum_i g_i w_i
  float carry = 1.f, acc_w = 0.f, acc_gw = 0.f;
  for (int s0 = 0; s0 < n_steps; s0 += 32) {
    const int s = s0 + lane;
    const bool valid = s < n_steps;
    Sample p{0.f, 0.f, 0.f, 0.f, 1.f, 0.f, 1.f};  // an empty lane: factor 1
    float g = 0.f;
    if (valid) {
      p = load_sample(densities, depths, base, s, n_steps, clamp_mode, sp_beta, last_delta);
      g = cot(s);
      if (last_back) g = (s == n_steps - 1) ? 0.f : g - a_last;
    }
    float incl;
    const float excl = exclusive_product(valid ? p.factor : 1.f, lane, &incl);
    const float w = valid ? p.alpha * carry * excl : 0.f;
    acc_w += w;
    acc_gw += g * w;
    carry *= __shfl_sync(kFullMask, incl, 31);
  }
  const float ftrans = carry;
  const float wsum = warp_sum(acc_w);
  const float gw_total = __shfl_sync(kFullMask, warp_sum(acc_gw), 0);
  const float corr = __shfl_sync(kFullMask, 1.f - wsum, 0);

  // pass 2: per-sample gradients
  carry = 1.f;
  float gw_before = 0.f;   // sum_{k < first sample of this round} g_k w_k
  float gd_prev = 0.f;     // gd of the sample before this round's first
  for (int s0 = 0; s0 < n_steps; s0 += 32) {
    const int s = s0 + lane;
    const bool valid = s < n_steps;
    Sample p{0.f, 0.f, 0.f, 0.f, 1.f, 0.f, 1.f};  // an empty lane: factor 1
    float g = 0.f;
    if (valid) {
      p = load_sample(densities, depths, base, s, n_steps, clamp_mode, sp_beta, last_delta);
      g = cot(s);
      if (last_back) g = (s == n_steps - 1) ? 0.f : g - a_last;
    }
    float incl;
    const float excl = exclusive_product(valid ? p.factor : 1.f, lane, &incl);
    const float t_excl = carry * excl;
    const float w = valid ? p.alpha * t_excl : 0.f;
    float gw_incl = g * w;  // inclusive prefix sum over the lanes
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float up = __shfl_up_sync(kFullMask, gw_incl, off);
      if (lane >= off) gw_incl += up;
    }
    const float suffix = gw_total - (gw_before + gw_incl);
    const float gf = -g * t_excl + (suffix + gft * ftrans) / p.factor;
    const float gd = valid ? gf * (-p.sigma * p.e) : 0.f;
    float gd_left = __shfl_up_sync(kFullMask, gd, 1);
    if (lane == 0) gd_left = gd_prev;
    if (valid) {
      const float w_corr = (last_back && s == n_steps - 1) ? w + corr : w;
      g_densities[base + s] = gf * (-p.delta * p.e) * p.dsigma;
      float gt = w_corr * gdep + (s > 0 ? gd_left : 0.f);
      if (s < n_steps - 1) gt -= gd;
      g_depths[base + s] = gt;
      float* gc = g_colors + (base + s) * n_channels;
#pragma unroll
      for (int k = 0; k < kMaxChannels; ++k)
        if (k < n_channels) gc[k] = w_corr * grgb[k];
    }
    gw_before += __shfl_sync(kFullMask, gw_incl, 31);
    gd_prev = __shfl_sync(kFullMask, gd, 31);
    carry *= __shfl_sync(kFullMask, incl, 31);
  }
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// clamp_mode: 0 = softplus, 1 = relu. Requires 1 <= n_channels <= 4, n_steps >= 1.
int tdgp_ray_march_reduced(const float* colors, const float* densities,
                           const float* depths, float* rgb, float* depth,
                           float* wsum, float* ftrans, long long n_rays,
                           int n_steps, int n_channels, int clamp_mode,
                           float sp_beta, float last_delta, int last_back,
                           void* stream) {
  if (n_channels < 1 || n_channels > kMaxChannels || n_steps < 1 || n_rays < 1)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (n_rays + kRaysPerBlock - 1) / kRaysPerBlock;
  ray_march_reduced_kernel<<<(unsigned)blocks, 32 * kRaysPerBlock, 0,
                             (cudaStream_t)stream>>>(
      colors, densities, depths, rgb, depth, wsum, ftrans, n_rays, n_steps,
      n_channels, clamp_mode, sp_beta, last_delta, last_back);
  return (int)cudaGetLastError();
}

// The backward. Same requirements and return value as the forward.
int tdgp_ray_march_reduced_bwd(const float* colors, const float* densities,
                               const float* depths, const float* g_rgb,
                               const float* g_depth, const float* g_wsum,
                               const float* g_ftrans, float* g_colors,
                               float* g_densities, float* g_depths, long long n_rays,
                               int n_steps, int n_channels, int clamp_mode,
                               float sp_beta, float last_delta, int last_back,
                               void* stream) {
  if (n_channels < 1 || n_channels > kMaxChannels || n_steps < 1 || n_rays < 1)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (n_rays + kRaysPerBlock - 1) / kRaysPerBlock;
  ray_march_reduced_bwd_kernel<<<(unsigned)blocks, 32 * kRaysPerBlock, 0,
                                 (cudaStream_t)stream>>>(
      colors, densities, depths, g_rgb, g_depth, g_wsum, g_ftrans, g_colors,
      g_densities, g_depths, n_rays, n_steps, n_channels, clamp_mode, sp_beta,
      last_delta, last_back);
  return (int)cudaGetLastError();
}

const char* tdgp_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
