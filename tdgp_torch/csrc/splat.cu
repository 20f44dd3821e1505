// Kernel K1: the backward of tri-plane bilinear sampling.
//
// Replaces the TPU kernel `_splat_kernel` (tdgp/ops/splat.py:258, launched
// by `_splat_table` :451) and its wide-window variant `_splat_kernel_wide`
// (:365, K2), which compute the same function. The forward, sampled in both
// packages outside any kernel, is
//   out[n,p,:] = 1/3 sum_k sum_c w_c(n,k,p) * planes[3n+k, y_c, x_c, :]
// over the planes k = xy, xz, yz and the 4 bilinear corners c of each
// (align_corners=True; a corner outside the plane has weight 0, as
// `_corner_meta` :153-175 masks it). Given the cotangent g[n,p,:] this
// kernel computes
//   g_planes[3n+k, y_c, x_c, :] += w_c * g[n,p,:] / 3        (the splat)
//   g_coords[n,p,:]  from d out / d (gx, gy) of each plane, with the corner
//                    values read again from the planes (`_coords_grad`
//                    :973-999), chained through gx = (c/scale + 1)(W-1)/2.
//
// What bounds it on an H100: device memory. Per point it reads the
// cotangent row, the 12 corner rows of the planes and writes 12 rows of
// atomics; over the call it must at least read the cotangent and the
// coordinates once, read each plane texel that some point's corners touch
// once (the coordinate gradient needs them; the other texels are never
// read), and write g_planes and g_coords once. At batch 16, 64^2 x 32
// samples per pass and planes 48 x 512^2 x 32 float32, g_planes alone is
// 1.61 GB (~0.5 ms at 3.35 TB/s); the texels read depend on where the
// points fall (~80 % of them for points spread uniformly over the cube,
// fewer where rays cluster on an object).
//
// What the design does about it: one warp per point, lane f on feature f,
// so each corner's 32 features are one coalesced 128-byte run for the
// reads and for the float32 atomicAdd (red.global) into the zeroed
// g_planes, which the L2 resolves. The three planes are walked by the same
// warp, so the coordinate gradient of a point is reduced with shuffles
// and written once, with no atomics. The TPU's sorted worklist, window
// tables and one-hot MXU products, which turned a scatter into dense
// matmuls because the TPU has no fast scatter, have no counterpart: the
// atomics are the scatter. Their order changes from run to run, so the
// float32 sums do too, by rounding.

#include <cuda_runtime.h>

namespace {

constexpr int kPointsPerBlock = 8;  // one warp per point
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFullMask, v, off);
  return v;
}

// Splats one plane's share of a point and returns d out / d (gx, gy),
// reduced over the warp, in plane-pixel units.
__device__ __forceinline__ float2 splat_plane(const float* __restrict__ planes,
                                              const float* __restrict__ grow,
                                              float* __restrict__ g_planes, bool coords_grad,
                                              long long plane, float u, float v, int height,
                                              int width, int feats, int lane) {
  const float gx = (u + 1.f) * 0.5f * (width - 1);
  const float gy = (v + 1.f) * 0.5f * (height - 1);
  const float fx0 = floorf(gx), fy0 = floorf(gy);
  const float tx = gx - fx0, ty = gy - fy0;
  const int x0 = (int)fx0, y0 = (int)fy0;
  const bool vx0 = x0 >= 0 && x0 < width, vx1 = x0 + 1 >= 0 && x0 + 1 < width;
  const bool vy0 = y0 >= 0 && y0 < height, vy1 = y0 + 1 >= 0 && y0 + 1 < height;
  const bool m00 = vy0 && vx0, m01 = vy0 && vx1, m10 = vy1 && vx0, m11 = vy1 && vx1;
  const float w00 = (1.f - tx) * (1.f - ty), w01 = tx * (1.f - ty);
  const float w10 = (1.f - tx) * ty, w11 = tx * ty;
  const long long r00 = ((plane * height + y0) * width + x0) * feats;  // corner (y0, x0)
  const long long r01 = r00 + feats;
  const long long r10 = r00 + (long long)width * feats;
  const long long r11 = r10 + feats;

  float dtx = 0.f, dty = 0.f;
  for (int f = lane; f < feats; f += 32) {
    const float gv = grow[f] / 3.f;
    if (m00) atomicAdd(g_planes + r00 + f, w00 * gv);
    if (m01) atomicAdd(g_planes + r01 + f, w01 * gv);
    if (m10) atomicAdd(g_planes + r10 + f, w10 * gv);
    if (m11) atomicAdd(g_planes + r11 + f, w11 * gv);
    if (coords_grad) {
      const float v00 = m00 ? planes[r00 + f] : 0.f;
      const float v01 = m01 ? planes[r01 + f] : 0.f;
      const float v10 = m10 ? planes[r10 + f] : 0.f;
      const float v11 = m11 ? planes[r11 + f] : 0.f;
      dtx += gv * ((1.f - ty) * (v01 - v00) + ty * (v11 - v10));
      dty += gv * ((1.f - tx) * (v10 - v00) + tx * (v11 - v01));
    }
  }
  return make_float2(warp_sum(dtx), warp_sum(dty));
}

__global__ void __launch_bounds__(32 * kPointsPerBlock)
triplane_splat_kernel(const float* __restrict__ planes,  // [3N, H, W, F] or null
                      const float* __restrict__ coords,  // [N, P, 3]
                      const float* __restrict__ g,       // [N, P, F]
                      float* __restrict__ g_planes,      // [3N, H, W, F], zeroed
                      float* __restrict__ g_coords,      // [N, P, 3] or null
                      long long n_points, long long points_per_batch, int height,
                      int width, int feats, float scale) {
  const int lane = threadIdx.x & 31;
  const long long point = (long long)blockIdx.x * kPointsPerBlock + (threadIdx.x >> 5);
  if (point >= n_points) return;  // the whole warp leaves together
  const long long plane = (point / points_per_batch) * 3;
  const float cx = coords[point * 3] / scale, cy = coords[point * 3 + 1] / scale;
  const float cz = coords[point * 3 + 2] / scale;
  const float* grow = g + point * feats;
  const bool coords_grad = g_coords != nullptr;
  // planes x/y, x/z, y/z
  const float2 dxy = splat_plane(planes, grow, g_planes, coords_grad, plane, cx, cy,
                                 height, width, feats, lane);
  const float2 dxz = splat_plane(planes, grow, g_planes, coords_grad, plane + 1, cx, cz,
                                 height, width, feats, lane);
  const float2 dyz = splat_plane(planes, grow, g_planes, coords_grad, plane + 2, cy, cz,
                                 height, width, feats, lane);
  if (coords_grad && lane == 0) {
    const float sx = 0.5f * (width - 1) / scale, sy = 0.5f * (height - 1) / scale;
    g_coords[point * 3] = dxy.x * sx + dxz.x * sx;
    g_coords[point * 3 + 1] = dxy.y * sy + dyz.x * sx;
    g_coords[point * 3 + 2] = dxz.y * sy + dyz.y * sy;
  }
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// g_planes must be zeroed by the caller. planes and g_coords are both null
// when the coordinate gradient is not wanted.
int tdgp_triplane_splat(const float* planes, const float* coords, const float* g,
                        float* g_planes, float* g_coords, long long n_batch,
                        long long points_per_batch, int height, int width, int feats,
                        float scale, void* stream) {
  if (n_batch < 1 || points_per_batch < 1 || height < 1 || width < 1 || feats < 1 ||
      (g_coords != nullptr && planes == nullptr))
    return (int)cudaErrorInvalidValue;
  const long long n_points = n_batch * points_per_batch;
  const long long blocks = (n_points + kPointsPerBlock - 1) / kPointsPerBlock;
  triplane_splat_kernel<<<(unsigned)blocks, 32 * kPointsPerBlock, 0, (cudaStream_t)stream>>>(
      planes, coords, g, g_planes, g_coords, n_points, points_per_batch, height, width,
      feats, scale);
  return (int)cudaGetLastError();
}

const char* tdgp_splat_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
