"""Shared helpers of the tests/test_torch_*.py parity tests: the same seeded
weights and configs in the JAX package and in its PyTorch port."""

from __future__ import annotations

import contextlib
import dataclasses

import jax
import numpy as np

from mast3r_slam_tpu import config as jax_config
from mast3r_slam_tpu.models import MASt3RConfig as JaxMASt3RConfig
from mast3r_slam_tpu.models import MASt3RModel as JaxMASt3RModel
from mast3r_slam_torch import config as torch_config
from mast3r_slam_torch.models import MASt3RConfig, MASt3RModel
from mast3r_slam_torch.models.io import params_from_flax
from mast3r_slam_torch.workload import BENCH_SETTINGS  # noqa: F401  (bench.py's settings)


@contextlib.contextmanager
def both_configs(d: dict):
    """Install the same config dict in both packages (the port's is reset on
    exit; tests/conftest.py resets the JAX one after every test)."""
    jax_config.set_config(jax_config.Config.from_dict(d))
    cfg = torch_config.set_config(torch_config.Config.from_dict(d))
    try:
        yield cfg
    finally:
        torch_config.reset_config()


def flax_tree(params) -> dict:
    return jax.tree_util.tree_map(np.asarray, params)


def tiny_pair(head_type: str = "linear", resolution: int = 64):
    """The JAX tiny model (flax init, seed 0) and the port's tiny model on the
    CPU carrying the same weights through `params_from_flax`."""
    jcfg = dataclasses.replace(JaxMASt3RConfig.tiny(), head_type=head_type)
    jm = JaxMASt3RModel.create(resolution=resolution, _test_cfg=jcfg)
    tm = MASt3RModel.create(cfg=MASt3RConfig.tiny(), head_type=head_type,
                            resolution=resolution, device="cpu")
    tm.load_state_dict(params_from_flax(flax_tree(jm.params)))
    return jm, tm


def slam_settings(extra: dict, sync_every: int = 2) -> dict:
    """bench.py's settings updated by `extra`, with the windowed chained path
    on (windows of `sync_every`)."""
    import copy

    settings = copy.deepcopy(BENCH_SETTINGS)
    for key, value in extra.items():
        if isinstance(value, dict):
            settings.setdefault(key, {}).update(value)
        else:
            settings[key] = value
    settings["runtime"].update(sync_every=sync_every, pipeline=True)
    return settings


def tiny_frames(n: int, seed: int = 0, hw: tuple = (48, 64)) -> list:
    """n uint8 frames [H, W, 3]: a seeded image drifting 2 px per frame."""
    from mast3r_slam_torch.workload import drift_frames

    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 1, hw + (3,)).astype(np.float32)
    return list((drift_frames(base, n, rng) * 255).astype(np.uint8))


def run_tiny_slam_pair(extra: dict, n_frames: int, sync_every: int = 2, seed: int = 0):
    """`SLAM.run` of the JAX package and of the port over the same in-memory
    frames (a seeded image drifting 2 px per frame, at the tiny model's 48x64
    so the loaders pass it through unchanged), with the same tiny weights,
    under bench.py's settings updated by `extra`, the windowed chained path
    on. -> (jax SLAM, jax results, port SLAM, port results)."""
    from mast3r_slam_tpu.dataloader import Dataset as JaxDataset
    from mast3r_slam_tpu.slam import SLAM as JaxSLAM
    from mast3r_slam_torch.dataloader import Dataset
    from mast3r_slam_torch.slam import SLAM

    class JaxFrames(JaxDataset):
        def __init__(self, imgs):
            self.imgs = imgs

        def __len__(self):
            return len(self.imgs)

        def __getitem__(self, i):
            return float(i), self.imgs[i]

    class Frames(JaxFrames, Dataset):
        pass

    settings = slam_settings(extra, sync_every)
    with both_configs(settings):
        jm, tm = tiny_pair("linear")
        h, w = jm._out_hw
        imgs = tiny_frames(n_frames, seed, (h, w))
        jslam = JaxSLAM(model=jm, resolution=w)
        jres = jslam.run(JaxFrames(imgs))
        tslam = SLAM(model=tm, resolution=w)
        tres = tslam.run(Frames(imgs))
    return jslam, jres, tslam, tres
