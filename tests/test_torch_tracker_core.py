"""Port tracking core (`tracker._track_core_rays`) vs the JAX core on the same
numpy-seeded inputs: confidence gates, the pose GN, the fusion input Xkk and
the selection statistics. Run both with the matcher's payload and hit mask
and without them (the packed gather and scatter-max fallback).

Bands: statistics exact (the same booleans averaged); the pose atol 1e-5
and Xkk atol 1e-4 at |X| ~ 3 (f32 sum-order noise through 10 GN steps).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mast3r_slam_tpu.config import TrackingConfig as JaxTrackingConfig
from mast3r_slam_tpu.lie import core as jlie
from mast3r_slam_tpu.tracker import _rays_cfg_key as jax_cfg_key
from mast3r_slam_tpu.tracker import _track_core_rays as jax_core
from mast3r_slam_torch.config import TrackingConfig
from mast3r_slam_torch.tracker import _rays_cfg_key, _track_core_rays


def _inputs(seed, n=2048):
    rng = np.random.default_rng(seed)
    Xk = (rng.normal(size=(n, 3)) * [1.0, 0.7, 0.5] + [0, 0, 3]).astype(np.float32)
    T_rel = np.asarray(jlie.sim3_exp(jnp.asarray([0.03, -0.02, 0.01, 0.01, 0.02, -0.01, 0.02],
                                                 jnp.float32)))
    Xf_at_k = np.asarray(jlie.sim3_act(jlie.sim3_inv(T_rel), jnp.asarray(Xk)))
    # frame pixel i sees keyframe pixel idx[i] (a local shuffle of the grid)
    idx = np.clip(np.arange(n) + rng.integers(-3, 4, n), 0, n - 1).astype(np.int32)
    Xf = np.empty_like(Xk)
    Xf[idx] = Xf_at_k[idx] + rng.normal(0, 1e-3, (n, 3)).astype(np.float32)
    valid = rng.uniform(size=(n, 1)) < 0.9
    Qff, Qkf = rng.uniform(0.5, 4.0, size=(2, n, 1)).astype(np.float32)
    Cf, Ck = rng.uniform(0.5, 4.0, size=(2, n, 1)).astype(np.float32)
    Xkf = (Xk + rng.normal(0, 1e-2, Xk.shape)).astype(np.float32)
    T_WCk = np.asarray(jlie.sim3_exp(jnp.asarray([0.1, 0, 0, 0, 0.05, 0, 0.0], jnp.float32)))
    T_WCf = T_WCk.copy()
    return [idx, valid, Qff, Qkf, Xf, Cf, Xk, Ck, Xkf, T_WCf, T_WCk]


@pytest.mark.parametrize("with_extras", [True, False])
@pytest.mark.parametrize("robust", ["huber", "tukey"])
def test_track_core_matches_jax(with_extras, robust):
    args = _inputs(0)
    idx, valid = args[0], args[1]
    n = idx.shape[0]
    extras_np = {}
    if with_extras:
        pay = np.concatenate([args[2], args[5], args[4]], -1)[idx]
        hit = np.zeros(n, bool)
        hit[idx[valid[:, 0]]] = True
        extras_np = dict(pay_g=pay.astype(np.float32), unique_hit=hit)
    key = dict(Q_conf=1.5, robust=robust)
    jout = jax_core(*map(jnp.asarray, args), cfg_key=jax_cfg_key(JaxTrackingConfig(**key)),
                    **{k: jnp.asarray(v) for k, v in extras_np.items()})
    tout = _track_core_rays(*[torch.from_numpy(np.array(a)) for a in args],
                            _rays_cfg_key(TrackingConfig(**key)),
                            **{k: torch.from_numpy(v) for k, v in extras_np.items()})
    np.testing.assert_array_equal(tout["stats"].numpy(), np.asarray(jout["stats"]))
    assert 0.3 < float(tout["stats"][0]) < 1.0  # the gates select a real subset
    np.testing.assert_allclose(tout["T_CkCf"].numpy(), np.asarray(jout["T_CkCf"]), atol=1e-5)
    np.testing.assert_allclose(tout["T_WCf"].numpy(), np.asarray(jout["T_WCf"]), atol=1e-5)
    np.testing.assert_allclose(tout["Xkk"].numpy(), np.asarray(jout["Xkk"]), atol=1e-4)
    np.testing.assert_allclose(tout["Qk"].numpy(), np.asarray(jout["Qk"]), rtol=1e-6)
    np.testing.assert_allclose(tout["cost"].numpy(), np.asarray(jout["cost"]), rtol=1e-4)
