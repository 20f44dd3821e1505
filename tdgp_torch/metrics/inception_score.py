"""Inception Score (a copy of `tdgp/metrics/inception_score.py`)."""
from __future__ import annotations

from typing import Tuple

import numpy as np


def compute_is(gen_probs: np.ndarray, num_splits: int = 10) -> Tuple[float, float]:
    """(mean, std) over `num_splits` splits of exp(E[KL(p(y|x) || p(y))]),
    `gen_probs` taken as class probabilities [N, classes]. Like the JAX
    package's, it takes what it is given: with features that are not
    probabilities (negative entries) the logarithms make it NaN."""
    num_gen = gen_probs.shape[0]
    scores = []
    for i in range(num_splits):
        part = gen_probs[i * num_gen // num_splits: (i + 1) * num_gen // num_splits]
        kl = part * (np.log(part + 1e-12) - np.log(np.mean(part, axis=0, keepdims=True) + 1e-12))
        scores.append(np.exp(np.mean(np.sum(kl, axis=1))))
    return float(np.mean(scores)), float(np.std(scores))
