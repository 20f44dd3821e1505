// The marcher's clamp of a raw density, shared by K3 (csrc/ray_march.cu)
// and the quantile cut's select (csrc/quantile.cu), so that the select
// takes its threshold over the very values the cut march compares with it.
#pragma once

// clamp_mode 0: torch.nn.functional.softplus(beta x) / beta, linear above a
// threshold of 20; any other mode: relu. At beta = 1 (RenderOptions.sp_beta)
// the division, exact there, is left out: a division checks for its slow
// path in every sample, and the bits are the same without it.
__device__ __forceinline__ float clamp_density(float x, int clamp_mode, float beta) {
  if (clamp_mode == 0) {
    const float y = beta * x;
    const float sp = y > 20.f ? y : log1pf(expf(y));
    return beta == 1.f ? sp : sp / beta;
  }
  return fmaxf(x, 0.f);
}
