"""Frechet distance between feature statistics (port of `tdgp/metrics/fid.py`)."""
from __future__ import annotations

import numpy as np


def frechet_distance(mu_real: np.ndarray, sigma_real: np.ndarray,
                     mu_gen: np.ndarray, sigma_gen: np.ndarray) -> float:
    """|mu_g - mu_r|^2 + tr(S_g) + tr(S_r) - 2 tr(sqrtm(S_g S_r)).

    The JAX package takes sqrtm(S_g S_r) with `scipy.linalg.sqrtm` (a Schur
    decomposition of the product). Its trace is the sum of the square roots
    of the product's eigenvalues, which are those of the symmetric
    D^1/2 V^T S_g V D^1/2 (S_r = V D V^T): two symmetric eigendecompositions,
    a few times faster at 2048 features, and real by construction. The
    eigenvalues of the covariances, positive semi-definite, are clipped at 0
    (sqrtm's imaginary parts of rounding, which the JAX package drops)."""
    m = np.square(mu_gen - mu_real).sum()
    ev, vecs = np.linalg.eigh(sigma_real)
    root = vecs * np.sqrt(np.clip(ev, 0.0, None))
    product = np.linalg.eigvalsh(root.T @ sigma_gen @ root)
    trace_sqrt = np.sqrt(np.clip(product, 0.0, None)).sum()
    return float(m + np.trace(sigma_gen) + np.trace(sigma_real) - 2.0 * trace_sqrt)


def compute_fid(real_stats, gen_stats) -> float:
    mu_r, sig_r = real_stats.get_mean_cov()
    mu_g, sig_g = gen_stats.get_mean_cov()
    return frechet_distance(mu_r, sig_r, mu_g, sig_g)
