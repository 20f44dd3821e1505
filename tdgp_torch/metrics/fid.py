"""Frechet distance between feature statistics (a copy of `tdgp/metrics/fid.py`)."""
from __future__ import annotations

import numpy as np
import scipy.linalg


def frechet_distance(mu_real: np.ndarray, sigma_real: np.ndarray,
                     mu_gen: np.ndarray, sigma_gen: np.ndarray) -> float:
    m = np.square(mu_gen - mu_real).sum()
    # the error estimate of sqrtm is ignored: near-singular products are
    # expected for small N
    s = scipy.linalg.sqrtm(np.dot(sigma_gen, sigma_real))
    return float(np.real(m + np.trace(sigma_gen + sigma_real - s * 2)))


def compute_fid(real_stats, gen_stats) -> float:
    mu_r, sig_r = real_stats.get_mean_cov()
    mu_g, sig_g = gen_stats.get_mean_cov()
    return frechet_distance(mu_r, sig_r, mu_g, sig_g)
