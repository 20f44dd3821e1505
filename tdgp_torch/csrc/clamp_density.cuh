// The marcher's clamp of a raw density, shared by K3 (csrc/ray_march.cu)
// and the quantile cut's select (csrc/quantile.cu), so that the select
// takes its threshold over the very values the cut march compares with it.
#pragma once

// clamp_mode 0: torch.nn.functional.softplus(beta x) / beta, linear above a
// threshold of 20; any other mode: relu.
__device__ __forceinline__ float clamp_density(float x, int clamp_mode, float beta) {
  if (clamp_mode == 0) {
    const float y = beta * x;
    return (y > 20.f ? y : log1pf(expf(y))) / beta;
  }
  return fmaxf(x, 0.f);
}
