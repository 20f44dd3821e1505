// Kernel K1: the backward of tri-plane bilinear sampling, as a binned splat.
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
//   g_planes[3n+k, y_c, x_c, :] = sum of w_c * g[n,p,:] / 3   (the splat)
//   g_coords[n,p,:]  from d out / d (gx, gy) of each plane, with the corner
//                    values of the planes (`_coords_grad` :973-999),
//                    chained through gx = (c/scale + 1)(W-1)/2.
//
// What bounds it on an H100: device memory, through gathers. The least it
// must move is the cotangent and the coordinates read once, each plane texel
// that some point's corners touch read once (for the coordinate gradient),
// and g_planes and g_coords written once. At batch 16, 64^2 x 32 samples per
// pass and planes 48 x 512^2 x 32 float32, g_planes alone is 1.61 GB
// (~0.5 ms at 3.35 TB/s). A warp per point with float32 atomics into a
// zeroed g_planes (the design before this one) adds the zero fill and the
// atomics' read and write-back of 25 M scattered 128-byte rows of a buffer
// 30 times the L2.
//
// What the design does about it: as the TPU kernel sorted its entries by
// window, this one bins them by strip, a STRIP_H x STRIP_W = 4 x 8 texel
// region of one plane, and gives each strip one warp, which sums the strip
// in its own shared memory and writes it to g_planes once, with 16-byte
// stores, empty strips included (they read nothing and write zeros). No
// zero fill, no global atomic into g_planes, and no texel written twice.
//  - Bins: a histogram kernel counts the entries of each strip, torch sums
//    the counts into offsets, and a scatter kernel writes the entries to
//    their strips (`ops/splat.py` `_bins` is the same arithmetic in torch).
//    Both gather a block's entries by strip in a shared-memory table first,
//    so that the samples of neighbouring rays, which fall on the same
//    strips, cost one global atomic per strip and block.
//    An entry goes to the strip of its base corner (its home) and, where
//    its 2x2 footprint reaches into them, to the strips on the right, below
//    and diagonally below, so that every warp walks its own bin only (the
//    halo choice: copies of the edge entries, in place of a side buffer and
//    a second pass; `chip_smoke.py` prints how many).
//  - Why a warp per strip and not a block per 16 x 16 tile: a float
//    atomicAdd to shared memory is a compare-and-swap loop on this card, so
//    the warps of a block cannot share an accumulator cheaply; a block whose
//    warps own rows of a tile has to stage its bin chunk by chunk between
//    barriers and idles on the busiest warp; and a 17 x 17 x F halo of the
//    planes in shared memory (37 KB) costs more occupancy than the 5 x 9
//    texels a strip's entries read again and again cost through the L1.
//    Each of these was slower on the training step's points, and so were
//    strips of other shapes (2 x 16, 4 x 16, 8 x 8).
//  - The warp streams its bin 32 entries at a time, lane l computing entry
//    l's corners while the next 32 entries and their coordinates load; then
//    4 entries at a time, their cotangent rows in flight, lane f on feature
//    f, it sums a run of entries with the same corners (the samples of a ray
//    that fall on one texel, which the bins keep together) in registers and
//    adds the run to the strip once. For the entries whose home the strip is
//    it forms (dtx, dty) from the run's corner texels, read once per run,
//    and reduces the 4 entries' 8 sums over the warp at once; a second,
//    small kernel combines each point's three (dtx, dty) into g_coords.
//    Without the coordinate gradient nothing of `planes` is read.
// The order of the bins' atomics changes from run to run, so the order of
// the float32 sums does too, and they change by rounding.
//
// The bf16 entry (tdgp_triplane_splat_bf16) is the backward of sampling bf16
// planes, the bf16 render views' (generator.render_bf16, in Gmain under
// training.gmain_render_bf16). It is the same kernel reading bf16 planes
// (for the coordinate gradient) and a bf16 cotangent, each row g / 3
// rounded to bf16 as the plain version's bf16 division rounds it, summing
// in float32 as above, and storing g_planes in bf16, rounded once, or in
// float32; it may add a float32 addend (another pass's sum, read once) to
// each strip before the store. A render's fine pass stores its float32 sum,
// and its coarse pass adds it and rounds the total: one rounding for both
// passes, as the JAX package's TPU route rounds its merged coarse + fine
// table once (tdgp/ops/splat.py:1030-1033, merged_splat). Its least traffic
// on the training step's points is the float32 entry's with the cotangent
// and the touched texels in 2 bytes, the float32 addend read and g_planes
// written in 2 bytes (ops/splat.py and chip_smoke.py count it).

// Second order (a gradient of a gradient through the sampler: the 3DGP
// model's path-length regularization, loss.pl_weight > 0). The JAX package
// differentiates its sampler's backward again by autodiff; here the
// backward (g_planes, g_coords) = B(planes, coords, g) is differentiated by
// two entries, given the cotangents U_planes [3N, H, W, F] and U_coords
// [N, P, 3] of its outputs. With w_c the bilinear weights of an entry, m_c
// its corner masks, and (du, dv) = (U_coords on the plane's two axes) x
// (sx, sy):
//  - tdgp_triplane_splat_gather: per point, d/dg = 1/3 sum over the planes
//    of sum_c m_c (w_c U_planes[c] + (du dw_c/dtx + dv dw_c/dty) planes[c])
//    (a bilinear gather of U_planes, and one of the planes with the weights'
//    derivatives), and d/dcoords from d/dtx = <g/3, sum_c m_c dw_c/dtx
//    U_planes[c]> + dv X and d/dty = <g/3, sum_c m_c dw_c/dty U_planes[c]>
//    + du X, X = <g/3, v00 - v01 - v10 + v11> the weights' cross term
//    d^2/dtx dty (the terms in tx^2 and ty^2 are zero, the masks and floor
//    have no derivative). A warp per point, lane f on feature f, the three
//    planes in turn; without U_coords nothing of `planes` is read.
//  - tdgp_triplane_splat_dcoords: d/dplanes = the scatter of g/3 with the
//    derivative weights du dw_c/dtx + dv dw_c/dty: K1's strip kernel on the
//    same bins, with those weights in place of w_c, float32 out (plane
//    gradients accumulate in float32). It is zero where U_coords is (as in
//    the path-length phase, whose coordinates do not depend on ws), and
//    then not launched.
// Both are bound by device memory, as K1 is: at PL's points (8 x 64^2 x 32 a
// pass, planes 24 x 512^2 x 32) the gather must read the touched texels of
// U_planes, g and the coordinates and write g's and the coordinates'
// cotangents (0.95 GB, 0.28 ms at 3.35 TB/s); the scatter writes the whole
// plane gradient once (0.96 GB). The gather reads each of its 12 corner rows
// per point through the L1 (neighbouring samples of a ray share texels);
// the scatter inherits K1's strips, which write each texel once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kStripH = 4, kStripW = 8;  // texels of a strip (ops/splat.py STRIP_H, STRIP_W)
constexpr int kWarps = 2;      // strips of a block, one warp each
constexpr unsigned kFullMask = 0xffffffffu;

struct Geometry {
  int points_per_batch, height, width, strips_y, tiles_x;
  float inv_scale;  // float32(1 / scale)
};

// The plane-pixel coordinates (gx, gy) of a point whose coordinates on the
// plane's two axes are (u, v), rounded step by step as ops/splat.py
// `_plane_coords` computes them with PyTorch on the card (it divides by the
// scalar scale as a product with its float32 reciprocal), so that the
// kernels and the plain versions see the same corners.
__device__ __forceinline__ float2 pixel_xy(float u, float v, const Geometry& geo) {
  const float gx = __fmul_rn(__fmul_rn(__fadd_rn(__fmul_rn(u, geo.inv_scale), 1.f), 0.5f),
                             (float)(geo.width - 1));
  const float gy = __fmul_rn(__fmul_rn(__fadd_rn(__fmul_rn(v, geo.inv_scale), 1.f), 0.5f),
                             (float)(geo.height - 1));
  return make_float2(gx, gy);
}

// The same for point `row` of coords [., 3] on plane k (x/y, x/z, y/z).
__device__ __forceinline__ float2 plane_xy(const float* __restrict__ coords, long long row, int k,
                                           const Geometry& geo) {
  const float* c = coords + row * 3;
  return pixel_xy(c[k == 2 ? 1 : 0], c[k == 0 ? 1 : 2], geo);
}

// The bins of entry (plane, gx, gy), as ops/splat.py `_bins` keys them: its
// home strip, then the strips on the right, below and diagonally below where
// its footprint reaches into them; -1 for none.
__device__ __forceinline__ void entry_keys(float2 q, int plane, const Geometry& geo,
                                           int (&keys)[4]) {
  keys[0] = keys[1] = keys[2] = keys[3] = -1;
  if (!(q.x >= -1.f && q.x < (float)geo.width && q.y >= -1.f && q.y < (float)geo.height))
    return;  // no corner in the plane
  const int x0 = (int)floorf(q.x), y0 = (int)floorf(q.y);
  const int home =
      (plane * geo.strips_y + max(y0, 0) / kStripH) * geo.tiles_x + max(x0, 0) / kStripW;
  const bool cross_x = x0 >= 0 && x0 % kStripW == kStripW - 1 && x0 + 1 < geo.width;
  const bool cross_y = y0 >= 0 && y0 % kStripH == kStripH - 1 && y0 + 1 < geo.height;
  keys[0] = home;
  if (cross_x) keys[1] = home + 1;
  if (cross_y) keys[2] = home + geo.tiles_x;
  if (cross_x && cross_y) keys[3] = home + geo.tiles_x + 1;
}

__device__ __forceinline__ void keys_of(const float* __restrict__ coords, long long e,
                                        long long n_entries, const Geometry& geo,
                                        int (&keys)[4]) {
  keys[0] = keys[1] = keys[2] = keys[3] = -1;
  if (e >= n_entries) return;
  const int plane = (int)(e / geo.points_per_batch);
  const long long point = e - (long long)plane * geo.points_per_batch;
  entry_keys(plane_xy(coords, (long long)(plane / 3) * geo.points_per_batch + point, plane % 3,
                      geo),
             plane, geo, keys);
}

// A block's distinct bins in shared memory: open addressing over kSlots
// slots, each a bin and how many of the block's entries it holds. A block of
// kBinThreads entries has at most 4 kBinThreads keys, under kSlots, so the
// table never fills. Integer atomics in shared memory are native.
constexpr int kBinThreads = 256;
constexpr int kSlots = 2048;

struct BinTable {
  int key[kSlots], count[kSlots], base[kSlots];
};

__device__ __forceinline__ void clear(BinTable& t) {
  for (int i = threadIdx.x; i < kSlots; i += blockDim.x) {
    t.key[i] = -1;
    t.count[i] = 0;
  }
}

// The slot of bin k, claimed if new.
__device__ __forceinline__ int slot_of(BinTable& t, int k) {
  int h = (int)(((unsigned)k * 2654435761u) >> 21) & (kSlots - 1);
  while (true) {
    const int prev = atomicCAS(&t.key[h], -1, k);
    if (prev == -1 || prev == k) return h;
    h = (h + 1) & (kSlots - 1);
  }
}

// For each key of the thread's entry: its slot and its rank among the
// block's entries of that bin. Lanes of a warp with the same key make one
// shared atomic (the samples of one ray often share a bin).
__device__ __forceinline__ void insert_keys(BinTable& t, const int (&keys)[4], int (&slot)[4],
                                            int (&rank)[4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const unsigned peers = __match_any_sync(kFullMask, keys[i]);
    const int leader = __ffs(peers) - 1;
    int s = 0, first = 0;
    if (keys[i] >= 0 && lane == leader) {
      s = slot_of(t, keys[i]);
      first = atomicAdd(&t.count[s], __popc(peers));
    }
    slot[i] = __shfl_sync(kFullMask, s, leader);
    rank[i] = __shfl_sync(kFullMask, first, leader) + __popc(peers & ((1u << lane) - 1u));
  }
}

// counts[b] = the entries of bin b: one global atomic per bin and block.
__global__ void __launch_bounds__(kBinThreads)
bin_count_kernel(const float* __restrict__ coords, int* __restrict__ counts,
                 long long n_entries, Geometry geo) {
  __shared__ BinTable t;
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  clear(t);
  __syncthreads();
  int keys[4], slot[4], rank[4];
  keys_of(coords, e, n_entries, geo, keys);
  insert_keys(t, keys, slot, rank);
  __syncthreads();
  for (int i = threadIdx.x; i < kSlots; i += blockDim.x)
    if (t.key[i] >= 0) atomicAdd(counts + t.key[i], t.count[i]);
}

// entries[cursor[b]++] = e for every bin b of entry e; cursor starts at the
// bins' offsets. Each block reserves one range per bin with one global
// atomic; the order within a bin is that of the blocks' atomics.
__global__ void __launch_bounds__(kBinThreads)
bin_scatter_kernel(const float* __restrict__ coords, int* __restrict__ cursor,
                   int* __restrict__ entries, long long n_entries, Geometry geo) {
  __shared__ BinTable t;
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  clear(t);
  __syncthreads();
  int keys[4], slot[4], rank[4];
  keys_of(coords, e, n_entries, geo, keys);
  insert_keys(t, keys, slot, rank);
  __syncthreads();
  for (int i = threadIdx.x; i < kSlots; i += blockDim.x)
    if (t.key[i] >= 0) t.base[i] = atomicAdd(cursor + t.key[i], t.count[i]);
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (keys[i] >= 0) entries[t.base[slot[i]] + rank[i]] = (int)e;
}

// An entry as the strip kernel sees it: its local corner (ly, lx), ly in
// [-1, kStripH), lx in [-1, kStripW), which of its four corners lie in the
// plane, and whether this strip is its home.
__device__ __forceinline__ int pack_entry(int ly, int lx, bool m00, bool m01, bool m10, bool m11,
                                          bool home) {
  return (ly + 1) | (lx + 1) << 6 | m00 << 12 | m01 << 13 | m10 << 14 | m11 << 15 | home << 16;
}

// v[N] per lane -> in lane l, the sum over the warp of v[(l >> s) & (N - 1)],
// s = log2(32 / N): N sums in N - 1 + s shuffles, where one at a time take 5 N.
template <int N>
__device__ __forceinline__ float reduce_scatter(float (&v)[N], int lane) {
#pragma unroll
  for (int h = N / 2, o = 16; h >= 1; h >>= 1, o >>= 1) {
    const bool upper = lane & o;
#pragma unroll
    for (int j = 0; j < h; ++j) {
      const float send = upper ? v[j] : v[j + h];
      const float keep = upper ? v[j + h] : v[j];
      v[j] = keep + __shfl_xor_sync(kFullMask, send, o);
    }
  }
#pragma unroll
  for (int o = 16 / N; o >= 1; o >>= 1) v[0] += __shfl_xor_sync(kFullMask, v[0], o);
  return v[0];
}

bool make_geometry(long long n_batch, long long points_per_batch, int height, int width,
                   float inv_scale, Geometry* geo, long long* n_bins) {
  if (n_batch < 1 || points_per_batch < 1 || height < 1 || width < 1 ||
      3 * n_batch * points_per_batch >= (1ll << 31))
    return false;
  geo->points_per_batch = (int)points_per_batch;
  geo->height = height;
  geo->width = width;
  geo->strips_y = (height + kStripH - 1) / kStripH;
  geo->tiles_x = (width + kStripW - 1) / kStripW;
  geo->inv_scale = inv_scale;
  *n_bins = 3 * n_batch * geo->strips_y * geo->tiles_x;
  return *n_bins < (1ll << 31);
}

// One warp per strip of one plane (see the note at the top), kWarps strips
// per block: small blocks, since a block holds its slot until its busiest
// warp is done.
__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

// a cotangent row's share of one plane: g / 3, rounded to bf16 for bf16 input
__device__ __forceinline__ float third(float g) { return g * (1.f / 3.f); }
__device__ __forceinline__ float third(__nv_bfloat16 g) {
  return __bfloat162float(__float2bfloat16_rn(__bfloat162float(g) * (1.f / 3.f)));
}

__device__ __forceinline__ void store4(float* dst, float4 v) {
  *reinterpret_cast<float4*>(dst) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* dst, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<unsigned*>(&lo);
  u.y = *reinterpret_cast<unsigned*>(&hi);
  *reinterpret_cast<uint2*>(dst) = u;
}

// TP: the planes' and the cotangent's type (float or bf16); TO: g_planes'.
// Deriv: the second-order scatter, each entry's weights the derivative ones
// of its point's u_coords (scaled by sx, sy) in place of the bilinear ones.
template <int F, typename TP = float, typename TO = float, bool Deriv = false>
__global__ void __launch_bounds__(32 * kWarps)
splat_strip_kernel(const TP* __restrict__ planes,      // [3N, H, W, F] or null
                   const TP* __restrict__ g,           // [N, P, F]
                   const float* __restrict__ coords,   // [N, P, 3]
                   const int* __restrict__ entries,    // plane * P + point, by bin
                   const int* __restrict__ offsets,    // [n_bins + 1]
                   const float* __restrict__ addend,   // [3N, H, W, F] float32 or null
                   TO* __restrict__ g_planes,          // [3N, H, W, F]
                   float2* __restrict__ d_plane,       // [3N, P] (dtx, dty) or null
                   Geometry geo, int n_bins,
                   const float* __restrict__ u_coords = nullptr,  // [N, P, 3], with Deriv
                   float sx = 0.f, float sy = 0.f) {
  static_assert(F % 4 == 0 && F <= 32, "a lane per feature");
  constexpr int kF4 = F / 4, kTexels = kStripH * kStripW;
  __shared__ __align__(16) float s_acc[kWarps][kTexels * F];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int bin = blockIdx.x * kWarps + warp;
  if (bin >= n_bins) return;  // the whole warp
  float* acc = s_acc[warp];
  const int height = geo.height, width = geo.width;
  const int plane = bin / (geo.strips_y * geo.tiles_x);
  const int t = bin - plane * geo.strips_y * geo.tiles_x;
  const int y_base = (t / geo.tiles_x) * kStripH, x_base = (t % geo.tiles_x) * kStripW;
  const int first = offsets[bin], last = offsets[bin + 1];
  const bool coords_grad = d_plane != nullptr, active = lane < F;
  const long long batch_row =  // + entry: the point's row of coords and g
      (long long)(plane / 3) * geo.points_per_batch - (long long)plane * geo.points_per_batch;
  const int k = plane % 3, iu = k == 2 ? 1 : 0, iv = k == 0 ? 1 : 2;  // the plane's two axes
  const TP* plane_base = planes + (long long)plane * height * width * F + lane;

  for (int i = lane; i < kTexels * kF4; i += 32)
    reinterpret_cast<float4*>(acc)[i] = make_float4(0.f, 0.f, 0.f, 0.f);

  int next_e = 0;
  float next_u = 0.f, next_v = 0.f, next_du = 0.f, next_dv = 0.f;
  auto fetch = [&](int base) {
    if (base + lane < last) {
      next_e = entries[base + lane];
      const float* c = coords + (batch_row + next_e) * 3;
      next_u = c[iu];
      next_v = c[iv];
      if constexpr (Deriv) {
        const float* u = u_coords + (batch_row + next_e) * 3;
        next_du = u[iu] * sx;
        next_dv = u[iv] * sy;
      }
    }
  };
  int run = -1;  // the corners (pack_entry & 0xffff) of the run being summed
  float r00 = 0.f, r01 = 0.f, r10 = 0.f, r11 = 0.f;
  float v00 = 0.f, v01 = 0.f, v10 = 0.f, v11 = 0.f;  // the run's corner texels, at its home
  auto flush = [&]() {
    if (run < 0 || !active) return;
    const int ly = (run & 63) - 1, lx = (run >> 6 & 63) - 1;
    float* a = acc + (ly * kStripW + lx) * F + lane;  // corner 00; used only in the strip
    const bool y0_in = ly >= 0, y1_in = ly + 1 < kStripH, x0_in = lx >= 0, x1_in = lx + 1 < kStripW;
    if (y0_in && x0_in && (run >> 12 & 1)) a[0] += r00;
    if (y0_in && x1_in && (run >> 13 & 1)) a[F] += r01;
    if (y1_in && x0_in && (run >> 14 & 1)) a[kStripW * F] += r10;
    if (y1_in && x1_in && (run >> 15 & 1)) a[(kStripW + 1) * F] += r11;
  };
  __syncwarp();

  fetch(first);
  for (int base = first; base < last; base += 32) {
    const int count = min(32, last - base);
    // entry base + lane: its corners
    const int my_e = next_e;
    const float my_du = next_du, my_dv = next_dv;
    const float2 q = pixel_xy(next_u, next_v, geo);
    fetch(base + 32);
    const float fx0 = floorf(q.x), fy0 = floorf(q.y);
    const int x0 = (int)fx0, y0 = (int)fy0;
    const int hy = max(y0, 0) - y_base, hx = max(x0, 0) - x_base;
    const int my_pos = pack_entry(y0 - y_base, x0 - x_base, y0 >= 0 && x0 >= 0,
                                  y0 >= 0 && x0 + 1 < width, y0 + 1 < height && x0 >= 0,
                                  y0 + 1 < height && x0 + 1 < width,
                                  coords_grad && hy >= 0 && hy < kStripH && hx >= 0 && hx < kStripW);
    const float my_tx = q.x - fx0, my_ty = q.y - fy0;

    for (int j = 0; j < count; j += 4) {
      float gv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {  // 4 cotangent rows in flight
        const int e = __shfl_sync(kFullMask, my_e, (j + u) & 31);
        gv[u] = j + u < count && active ? third(g[(batch_row + e) * F + lane]) : 0.f;
      }  // (1/3: as torch's g / 3 on the card)
      float v[8];
      bool any_home = false;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int src = (j + u) & 31;
        const int pos = j + u < count ? __shfl_sync(kFullMask, my_pos, src) : 0;
        const float tx = __shfl_sync(kFullMask, my_tx, src);
        const float ty = __shfl_sync(kFullMask, my_ty, src);
        float du = 0.f, dv = 0.f;
        if constexpr (Deriv) {
          du = __shfl_sync(kFullMask, my_du, src);
          dv = __shfl_sync(kFullMask, my_dv, src);
        }
        const bool home = pos >> 16 & 1;  // the same for the whole warp
        if (j + u < count) {
          if ((pos & 0xffff) != run) {  // a new run: flush the last, read the corners
            flush();
            run = pos & 0xffff;
            r00 = r01 = r10 = r11 = 0.f;
            if (home) {
              const int ly = (pos & 63) - 1, lx = (pos >> 6 & 63) - 1;
              const TP* pv = plane_base + ((long long)(y_base + ly) * width + x_base + lx) * F;
              v00 = active && (pos >> 12 & 1) ? widen(__ldg(pv)) : 0.f;
              v01 = active && (pos >> 13 & 1) ? widen(__ldg(pv + F)) : 0.f;
              v10 = active && (pos >> 14 & 1) ? widen(__ldg(pv + (long long)width * F)) : 0.f;
              v11 = active && (pos >> 15 & 1) ? widen(__ldg(pv + (long long)(width + 1) * F)) : 0.f;
            }
          }
          if constexpr (Deriv) {  // du dw/dtx + dv dw/dty of each corner
            r00 += (-du * (1.f - ty) - dv * (1.f - tx)) * gv[u];
            r01 += (du * (1.f - ty) - dv * tx) * gv[u];
            r10 += (-du * ty + dv * (1.f - tx)) * gv[u];
            r11 += (du * ty + dv * tx) * gv[u];
          } else {
            r00 += (1.f - tx) * (1.f - ty) * gv[u];
            r01 += tx * (1.f - ty) * gv[u];
            r10 += (1.f - tx) * ty * gv[u];
            r11 += tx * ty * gv[u];
          }
        }
        any_home |= home;
        v[2 * u] = home ? gv[u] * ((1.f - ty) * (v01 - v00) + ty * (v11 - v10)) : 0.f;
        v[2 * u + 1] = home ? gv[u] * ((1.f - tx) * (v10 - v00) + tx * (v11 - v01)) : 0.f;
      }
      if (any_home) {
        const float sum = reduce_scatter(v, lane);  // of entry j + lane / 8, (dtx, dty)[lane / 4 % 2]
        const int src = (j + (lane >> 3)) & 31;
        const int e = __shfl_sync(kFullMask, my_e, src);
        const int p = __shfl_sync(kFullMask, my_pos, src);
        if ((lane & 3) == 0 && j + (lane >> 3) < count && (p >> 16 & 1))
          reinterpret_cast<float*>(d_plane)[2 * (long long)e + (lane >> 2 & 1)] = sum;
      }
    }
  }
  flush();
  __syncwarp();

  const int rows = min(kStripH, height - y_base), cols = min(kStripW, width - x_base);
  const long long origin = (((long long)plane * height + y_base) * width + x_base) * F;
  for (int i = lane; i < rows * cols * kF4; i += 32) {
    const int r = i / (cols * kF4), rest = i - r * cols * kF4;
    const long long at = origin + ((long long)r * width * kF4 + rest) * 4;
    float4 v = reinterpret_cast<float4*>(acc)[r * kStripW * kF4 + rest];
    if (addend != nullptr) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(addend + at));
      v = make_float4(v.x + a.x, v.y + a.y, v.z + a.z, v.w + a.w);
    }
    store4(g_planes + at, v);
  }
}

// g_coords[n, p] from the (dtx, dty) of the point's x/y, x/z and y/z entries.
__global__ void coords_grad_kernel(const float2* __restrict__ d_plane, float* __restrict__ g_coords,
                                   long long n_points, long long points_per_batch, float sx,
                                   float sy) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_points) return;
  const long long n = i / points_per_batch, point = i - n * points_per_batch;
  const long long e = 3 * n * points_per_batch + point;
  const float2 dxy = d_plane[e], dxz = d_plane[e + points_per_batch];
  const float2 dyz = d_plane[e + 2 * points_per_batch];
  g_coords[i * 3] = dxy.x * sx + dxz.x * sx;
  g_coords[i * 3 + 1] = dxy.y * sy + dyz.x * sx;
  g_coords[i * 3 + 2] = dxz.y * sy + dyz.y * sy;
}

// The second order's gather entry (see the note at the top): a warp per
// point (n, p), lane f on feature f. u_planes, u_coords and planes may be
// null: a zero cotangent, or (planes) not read; planes is needed with
// u_coords.
template <int F>
__global__ void __launch_bounds__(256)
splat_gather_kernel(const float* __restrict__ planes,    // [3N, H, W, F] or null
                    const float* __restrict__ coords,    // [N, P, 3]
                    const float* __restrict__ g,         // [N, P, F]
                    const float* __restrict__ u_planes,  // [3N, H, W, F] or null
                    const float* __restrict__ u_coords,  // [N, P, 3] or null
                    float* __restrict__ b_g,             // [N, P, F]
                    float* __restrict__ b_coords,        // [N, P, 3]
                    long long n_points, Geometry geo, float sx, float sy) {
  const int lane = threadIdx.x & 31;
  const long long point = (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (point >= n_points) return;  // the whole warp
  const bool active = lane < F;
  const int height = geo.height, width = geo.width;
  const long long n = point / geo.points_per_batch;
  const float gp = active ? g[point * F + lane] * (1.f / 3.f) : 0.f;
  float bg = 0.f, bc[3] = {0.f, 0.f, 0.f};
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int iu = k == 2 ? 1 : 0, iv = k == 0 ? 1 : 2;
    const float2 q = plane_xy(coords, point, k, geo);
    const float fx0 = floorf(q.x), fy0 = floorf(q.y);
    const int x0 = (int)fx0, y0 = (int)fy0;
    const float tx = q.x - fx0, ty = q.y - fy0;
    const bool in[4] = {y0 >= 0 && y0 < height && x0 >= 0 && x0 < width,
                        y0 >= 0 && y0 < height && x0 + 1 >= 0 && x0 + 1 < width,
                        y0 + 1 >= 0 && y0 + 1 < height && x0 >= 0 && x0 < width,
                        y0 + 1 >= 0 && y0 + 1 < height && x0 + 1 >= 0 && x0 + 1 < width};
    const long long plane_row = (3 * n + k) * (long long)height * width;
    const long long at[4] = {plane_row + (long long)y0 * width + x0,
                             plane_row + (long long)y0 * width + x0 + 1,
                             plane_row + (long long)(y0 + 1) * width + x0,
                             plane_row + (long long)(y0 + 1) * width + x0 + 1};
    const float w[4] = {(1.f - tx) * (1.f - ty), tx * (1.f - ty), (1.f - tx) * ty, tx * ty};
    const float dwx[4] = {-(1.f - ty), 1.f - ty, -ty, ty};  // d w_c / d tx
    const float dwy[4] = {-(1.f - tx), -tx, 1.f - tx, tx};  // d w_c / d ty
    float du = 0.f, dv = 0.f;
    if (u_coords != nullptr) {
      du = u_coords[point * 3 + iu] * sx;
      dv = u_coords[point * 3 + iv] * sy;
    }
    float ux = 0.f, uy = 0.f, cross = 0.f;  // per lane: d/dtx and d/dty of <g/3, U gather>, X
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (!(active && in[c])) continue;
      if (u_planes != nullptr) {
        const float u = __ldg(u_planes + at[c] * F + lane);
        bg += w[c] * u;
        ux += dwx[c] * u;
        uy += dwy[c] * u;
      }
      if (u_coords != nullptr) {
        const float v = __ldg(planes + at[c] * F + lane);
        bg += (du * dwx[c] + dv * dwy[c]) * v;
        cross += (c == 0 || c == 3 ? v : -v);
      }
    }
    float btx = gp * ux + dv * gp * cross, bty = gp * uy + du * gp * cross;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      btx += __shfl_xor_sync(kFullMask, btx, off);
      bty += __shfl_xor_sync(kFullMask, bty, off);
    }
    bc[iu] += btx * sx;
    bc[iv] += bty * sy;
  }
  if (active) b_g[point * F + lane] = bg * (1.f / 3.f);
  if (lane == 0) {
    b_coords[point * 3] = bc[0];
    b_coords[point * 3 + 1] = bc[1];
    b_coords[point * 3 + 2] = bc[2];
  }
}

template <int F, typename TP, typename TO>
int launch_strips(const TP* planes, const TP* g, const float* coords, const int* entries,
                  const int* offsets, const float* addend, TO* g_planes, float2* d_plane,
                  long long n_bins, const Geometry& geo, cudaStream_t s) {
  splat_strip_kernel<F, TP, TO><<<(unsigned)((n_bins + kWarps - 1) / kWarps), 32 * kWarps, 0,
                                  s>>>(planes, g, coords, entries, offsets, addend, g_planes,
                                       d_plane, geo, (int)n_bins);
  return (int)cudaGetLastError();
}

// The splat of either entry, then the coordinate gradient.
template <typename TP, typename TO>
int splat(const TP* planes, const TP* g, const float* coords, const int* entries,
          const int* offsets, const float* addend, TO* g_planes, float* d_scratch,
          float* g_coords, long long n_batch, long long points_per_batch, int height, int width,
          int feats, float inv_scale, float sx, float sy, cudaStream_t s) {
  Geometry geo;
  long long n_bins;
  const bool coords_grad = g_coords != nullptr;
  if (!make_geometry(n_batch, points_per_batch, height, width, inv_scale, &geo, &n_bins) ||
      (coords_grad && (planes == nullptr || d_scratch == nullptr)))
    return (int)cudaErrorInvalidValue;
  const long long n_entries = 3 * n_batch * points_per_batch;
  float2* d_plane = coords_grad ? reinterpret_cast<float2*>(d_scratch) : nullptr;
  if (coords_grad) {  // entries with no corner in their plane add nothing
    const cudaError_t err = cudaMemsetAsync(d_scratch, 0, n_entries * sizeof(float2), s);
    if (err != cudaSuccess) return (int)err;
  }
  int err;
  if (feats == 32)
    err = launch_strips<32>(planes, g, coords, entries, offsets, addend, g_planes, d_plane, n_bins,
                            geo, s);
  else if (feats == 16)
    err = launch_strips<16>(planes, g, coords, entries, offsets, addend, g_planes, d_plane, n_bins,
                            geo, s);
  else if (feats == 8)
    err = launch_strips<8>(planes, g, coords, entries, offsets, addend, g_planes, d_plane, n_bins,
                           geo, s);
  else
    return (int)cudaErrorInvalidValue;
  if (err != 0 || !coords_grad) return err;
  const long long n_points = n_batch * points_per_batch;
  coords_grad_kernel<<<(unsigned)((n_points + 255) / 256), 256, 0, s>>>(d_plane, g_coords,
                                                                        n_points, points_per_batch,
                                                                        sx, sy);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The bins' sizes: counts [n_bins] (zeroed here) for coords [N, P, 3].
// Returns the first CUDA error (0 on success); so do the functions below.
int tdgp_splat_bin_counts(const float* coords, int* counts, long long n_batch,
                          long long points_per_batch, int height, int width, float inv_scale,
                          void* stream) {
  Geometry geo;
  long long n_bins;
  if (!make_geometry(n_batch, points_per_batch, height, width, inv_scale, &geo, &n_bins))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(counts, 0, n_bins * sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  const long long n_entries = 3 * n_batch * points_per_batch;
  bin_count_kernel<<<(unsigned)((n_entries + kBinThreads - 1) / kBinThreads), kBinThreads, 0, s>>>(
      coords, counts, n_entries, geo);
  return (int)cudaGetLastError();
}

// The bins' entries: cursor [n_bins] holds each bin's offset on entry and
// its end on return; entries [>= offsets[n_bins]] gets plane * P + point.
int tdgp_splat_bin_entries(const float* coords, int* cursor, int* entries, long long n_batch,
                           long long points_per_batch, int height, int width, float inv_scale,
                           void* stream) {
  Geometry geo;
  long long n_bins;
  if (!make_geometry(n_batch, points_per_batch, height, width, inv_scale, &geo, &n_bins))
    return (int)cudaErrorInvalidValue;
  const long long n_entries = 3 * n_batch * points_per_batch;
  bin_scatter_kernel<<<(unsigned)((n_entries + kBinThreads - 1) / kBinThreads), kBinThreads, 0,
                       (cudaStream_t)stream>>>(coords, cursor, entries, n_entries, geo);
  return (int)cudaGetLastError();
}

// The splat over the bins of `tdgp_splat_bin_entries`: g_planes [3N, H, W, F]
// (needs no zeroing) and, where g_coords is not null, g_coords [N, P, 3]
// through d_scratch [3N, P, 2]; planes is then read, and only then.
// sx = (W - 1) / (2 scale), sy = (H - 1) / (2 scale). F is 8, 16 or 32.
int tdgp_triplane_splat(const float* planes, const float* g, const float* coords,
                        const int* entries, const int* offsets, float* g_planes, float* d_scratch,
                        float* g_coords, long long n_batch, long long points_per_batch, int height,
                        int width, int feats, float inv_scale, float sx, float sy, void* stream) {
  return splat(planes, g, coords, entries, offsets, (const float*)nullptr, g_planes, d_scratch,
               g_coords, n_batch, points_per_batch, height, width, feats, inv_scale, sx, sy,
               (cudaStream_t)stream);
}

// The bf16 entry: planes and g bf16; addend float32 [3N, H, W, F] or null,
// added to each texel's sum; g_planes bf16 where out_bf16 is not 0, else
// float32. Otherwise as tdgp_triplane_splat.
int tdgp_triplane_splat_bf16(const __nv_bfloat16* planes, const __nv_bfloat16* g,
                             const float* coords, const int* entries, const int* offsets,
                             const float* addend, void* g_planes, float* d_scratch,
                             float* g_coords, long long n_batch, long long points_per_batch,
                             int height, int width, int feats, float inv_scale, float sx, float sy,
                             int out_bf16, void* stream) {
  if (out_bf16)
    return splat(planes, g, coords, entries, offsets, addend,
                 static_cast<__nv_bfloat16*>(g_planes), d_scratch, g_coords, n_batch,
                 points_per_batch, height, width, feats, inv_scale, sx, sy, (cudaStream_t)stream);
  return splat(planes, g, coords, entries, offsets, addend, static_cast<float*>(g_planes),
               d_scratch, g_coords, n_batch, points_per_batch, height, width, feats, inv_scale, sx,
               sy, (cudaStream_t)stream);
}

// The second order's gather entry: b_g [N, P, F] and b_coords [N, P, 3]
// from planes (read only with u_coords), coords [N, P, 3], g [N, P, F] and
// the cotangents u_planes [3N, H, W, F] and u_coords [N, P, 3] (either may be
// null, for zero). sx, sy as tdgp_triplane_splat's. F is 8, 16 or 32.
int tdgp_triplane_splat_gather(const float* planes, const float* coords, const float* g,
                               const float* u_planes, const float* u_coords, float* b_g,
                               float* b_coords, long long n_batch, long long points_per_batch,
                               int height, int width, int feats, float inv_scale, float sx,
                               float sy, void* stream) {
  Geometry geo;
  long long n_bins;
  if (!make_geometry(n_batch, points_per_batch, height, width, inv_scale, &geo, &n_bins) ||
      (u_coords != nullptr && planes == nullptr))
    return (int)cudaErrorInvalidValue;
  const long long n_points = n_batch * points_per_batch;
  const unsigned blocks = (unsigned)((n_points + 7) / 8);
  auto launch = [&](auto kernel) {
    kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(planes, coords, g, u_planes, u_coords, b_g,
                                                     b_coords, n_points, geo, sx, sy);
    return (int)cudaGetLastError();
  };
  if (feats == 32) return launch(splat_gather_kernel<32>);
  if (feats == 16) return launch(splat_gather_kernel<16>);
  if (feats == 8) return launch(splat_gather_kernel<8>);
  return (int)cudaErrorInvalidValue;
}

// The second order's scatter entry over the bins of tdgp_splat_bin_entries:
// g_planes [3N, H, W, F] (float32, needs no zeroing) = the scatter of g / 3
// with the derivative weights of u_coords [N, P, 3]. F is 8, 16 or 32.
int tdgp_triplane_splat_dcoords(const float* g, const float* coords, const float* u_coords,
                                const int* entries, const int* offsets, float* g_planes,
                                long long n_batch, long long points_per_batch, int height,
                                int width, int feats, float inv_scale, float sx, float sy,
                                void* stream) {
  Geometry geo;
  long long n_bins;
  if (!make_geometry(n_batch, points_per_batch, height, width, inv_scale, &geo, &n_bins) ||
      u_coords == nullptr)
    return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((n_bins + kWarps - 1) / kWarps);
  auto launch = [&](auto kernel) {
    kernel<<<blocks, 32 * kWarps, 0, (cudaStream_t)stream>>>(
        nullptr, g, coords, entries, offsets, nullptr, g_planes, nullptr, geo, (int)n_bins,
        u_coords, sx, sy);
    return (int)cudaGetLastError();
  };
  if (feats == 32) return launch(splat_strip_kernel<32, float, float, true>);
  if (feats == 16) return launch(splat_strip_kernel<16, float, float, true>);
  if (feats == 8) return launch(splat_strip_kernel<8, float, float, true>);
  return (int)cudaErrorInvalidValue;
}

const char* tdgp_splat_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
