"""The tracking workload that the port's smoke run and profiler drive.

`BENCH_SETTINGS` are the JAX package's headline tracking settings
(bench.py:130-165): tanh gelu, the dense matcher at radius 3 over dilations
(2, 1) (configs/base.yaml), a 3D gate wide open, and the keyframe gates
opened so that random-weight pointmaps keep tracking. `drift_frames` makes a
numpy-seeded sequence that drifts 2 px per frame over a random base image.
"""

from __future__ import annotations

import numpy as np

BENCH_SETTINGS = {
    "runtime": {"gelu_impl": "tanh"},
    "matching": {"method": "dense", "dense_radius": 3, "dense_dilations": (2, 1),
                 "dist_thresh": 1e6},
    "tracking": {"min_match_frac": 0.0, "match_frac_thresh": 0.0, "Q_conf": 0.0},
}


def drift_frames(base: np.ndarray, n: int, rng: np.random.Generator) -> np.ndarray:
    """[n, H, W, 3] float32 in [0, 1]: `base` rolled 2 px per frame plus noise."""
    return np.stack([
        np.clip(np.roll(base, 2 * (j + 1), axis=1)
                + rng.normal(0, 0.01, base.shape).astype(np.float32), 0, 1)
        for j in range(n)
    ]).astype(np.float32)
