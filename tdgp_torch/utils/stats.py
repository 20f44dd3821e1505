"""Scalar statistics of the loop: moment-triple accumulation (a copy of
`tdgp/utils/stats.py`).

Each reported name accumulates (count, sum, sum-of-squares) on the host
between ticks and exposes mean and std; `JsonlLogger` appends one line per
tick to stats.jsonl, with the keys the JAX loop writes.
"""
from __future__ import annotations

import json
import time
from typing import Dict, Iterable, Optional

import numpy as np


class StatsCollector:
    """Accumulates (num, sum, sumsq) per name between flushes."""

    def __init__(self):
        self._moments: Dict[str, np.ndarray] = {}

    def report(self, name: str, value) -> None:
        arr = np.asarray(value, dtype=np.float64).ravel()
        arr = arr[np.isfinite(arr)]
        m = self._moments.setdefault(name, np.zeros(3))
        m += np.array([arr.size, arr.sum(), np.square(arr).sum()])

    def report_dict(self, values: Dict[str, object]) -> None:
        for k, v in values.items():
            self.report(k, v)

    def names(self) -> Iterable[str]:
        return self._moments.keys()

    def num(self, name: str) -> int:
        return int(self._moments.get(name, np.zeros(3))[0])

    def mean(self, name: str) -> float:
        m = self._moments.get(name)
        if m is None or m[0] == 0:
            return float('nan')
        return float(m[1] / m[0])

    def std(self, name: str) -> float:
        m = self._moments.get(name)
        if m is None or m[0] == 0:
            return float('nan')
        if m[0] == 1:
            return 0.0
        mean = m[1] / m[0]
        raw_var = m[2] / m[0] - mean * mean
        return float(np.sqrt(max(raw_var, 0.0)))

    def as_dict(self) -> Dict[str, Dict[str, float]]:
        """ref training_stats.py Collector.as_dict: {name: {num, mean, std}}."""
        return {name: {'num': self.num(name), 'mean': self.mean(name),
                       'std': self.std(name)} for name in self._moments}

    def reset(self) -> None:
        self._moments.clear()


class JsonlLogger:
    """Append-per-tick stats.jsonl writer (ref training_loop.py:509-514)."""

    def __init__(self, path: str):
        self._f = open(path, 'at')

    def write(self, stats: Dict[str, Dict[str, float]], timestamp: Optional[float] = None) -> None:
        payload = dict(stats)
        payload['timestamp'] = timestamp if timestamp is not None else time.time()
        self._f.write(json.dumps(payload) + '\n')
        self._f.flush()

    def close(self) -> None:
        self._f.close()
