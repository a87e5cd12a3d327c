"""SLAM snapshots across the two packages (`mast3r_slam_torch.utils.snapshot`
against `mast3r_slam_tpu.utils.snapshot`, the same file format).

A snapshot that JAX writes loads into the port with JAX's state, one that
the port writes loads into JAX with the port's, and both continue tracking
alike; the state that is easy to lose (ASMK, fitted whitening, pending
backend tasks, keyframe mirrors, K in calibrated mode) survives a round trip
through either loader; a mismatched `img_downsample` raises; periodic
snapshots are written. Bands: restored state exact (a file round trip);
poses after a resume within 5e-4 of JAX's, the band of
tests/test_torch_slam_run.py for the tiny random model.
"""

import numpy as np
import pytest
import torch

from mast3r_slam_tpu.dataloader import Dataset as JaxDataset
from mast3r_slam_tpu.frame import create_frame as jax_create_frame
from mast3r_slam_tpu.models.retrieval import RetrievalModel as JaxRetrievalModel
from mast3r_slam_tpu.slam import SLAM as JaxSLAM
from mast3r_slam_torch.dataloader import Dataset
from mast3r_slam_torch.frame import create_frame
from mast3r_slam_torch.models import MASt3RConfig, MASt3RModel
from mast3r_slam_torch.models.io import params_from_flax
from mast3r_slam_torch.models.retrieval import RetrievalModel
from mast3r_slam_torch.slam import SLAM
from test_torch_helpers import both_configs, flax_tree, slam_settings, tiny_frames, tiny_pair

PAIR = {"tracking": {"match_frac_thresh": 1.0}, "runtime": {"keyframe_capacity": 4}}
SIMPLE = {"runtime": {"keyframe_capacity": 16}, "local_opt": {"max_edges": 16},
          "matching": {"use_simple": True}}


class JaxFrames(JaxDataset):
    def __init__(self, imgs):
        self.imgs = imgs

    def __len__(self):
        return len(self.imgs)

    def __getitem__(self, i):
        return float(i), self.imgs[i]


class Frames(JaxFrames, Dataset):
    pass


@pytest.fixture(scope="module")
def port_model(tiny_model):
    tm = MASt3RModel.create(cfg=MASt3RConfig.tiny(), resolution=64, device="cpu")
    tm.load_state_dict(params_from_flax(flax_tree(tiny_model.params)))
    return tm


def _np(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def assert_same_state(t, j):
    """The port's SLAM `t` holds the JAX SLAM `j`'s state, exactly."""
    tk, jk = t.keyframes, j.keyframes
    for name in ("X", "C", "T_WC", "N", "_feat", "_pos"):
        np.testing.assert_array_equal(_np(getattr(tk, name)), _np(getattr(jk, name)), name)
    assert (tk.K is None) == (jk.K is None)
    if tk.K is not None:
        np.testing.assert_array_equal(_np(tk.K), _np(jk.K))
    assert tk.frame_ids == jk.frame_ids and tk._n_host == jk._n_host
    assert tk._nups_host == jk._nups_host and tk._score_host == jk._score_host
    assert len(tk.imgs) == len(jk.imgs)
    for a, b in zip(tk.imgs, jk.imgs):
        np.testing.assert_array_equal(_np(a), _np(b))
    tg, jg = t.factor_graph, j.factor_graph
    e = tg.n_edges
    assert e == jg.n_edges
    np.testing.assert_array_equal(tg.ii[:e], jg.ii[:e])
    np.testing.assert_array_equal(tg.jj[:e], jg.jj[:e])
    for name in ("idx_ii2jj", "idx_jj2ii", "valid_match_j", "valid_match_i", "Q_ii2jj",
                 "Q_jj2ii"):
        np.testing.assert_array_equal(_np(getattr(tg, name)), _np(getattr(jg, name)), name)
    tr, jr = t.retrieval_db, j.retrieval_db
    np.testing.assert_array_equal(_np(tr.signatures), _np(jr.signatures))
    assert tr.kf_ids == jr.kf_ids and tr._whitening_fitted == jr._whitening_fitted
    assert tr._asmk_fit_size == jr._asmk_fit_size
    np.testing.assert_array_equal(np.stack([_np(p) for p in t.poses]),
                                  np.stack([_np(p) for p in j.poses]))
    np.testing.assert_array_equal(t.timestamps, j.timestamps)
    assert t.state.mode.name == j.state.mode.name
    assert t.state.global_optimizer_tasks == j.state.global_optimizer_tasks
    assert t.state.reloc_pending == j.state.reloc_pending


def test_snapshots_cross_packages_and_resume_alike(tmp_path):
    """The port's SLAM.run over 6 frames (every frame promoted, an arena of 4:
    evictions, edges, a full graph) is saved; JAX loads it with the port's
    exact state and saves it again; the port loads JAX's file with JAX's
    exact state. Two port sessions and a JAX session resumed from JAX's file
    then track two more frames: the port's two bit-equal, and within the
    band of JAX's."""
    settings = slam_settings(PAIR)
    with both_configs(settings):
        # a JAX model of its own: JAX reads `runtime.gelu_impl` (tanh here)
        # when a jit traces, and the session model may have traced under erf
        tiny_model, port_model = tiny_pair("linear")
    tslam = _port_run(port_model, settings, n=6, seed=0)
    assert tslam.events["eviction"] == 2 and tslam.factor_graph.n_edges > 0
    jpath, tpath = tmp_path / "jax.npz", tmp_path / "port.npz"
    with both_configs(settings):
        tslam.save_state(tpath)
        jslam = JaxSLAM(model=tiny_model, resolution=64)
        jslam.load_state(tpath)
        assert_same_state(tslam, jslam)
        jslam.save_state(jpath)
        port = SLAM(model=port_model, resolution=64)
        port.load_state(jpath)
        assert_same_state(port, jslam)

        resumed = []
        for _ in range(2):
            again = SLAM(model=port_model, resolution=64)
            again.load_state(jpath)
            resumed.append(again)
        jres = JaxSLAM(model=tiny_model, resolution=64)
        jres.load_state(jpath)
        extra = tiny_frames(8)[6:]
        for i, img in enumerate(extra, start=6):
            for s in resumed:
                s._step_sync(create_frame(i, img), float(i))
            jres._step_sync(jax_create_frame(i, img), float(i))
    a, b = (torch.stack(s.poses) for s in resumed)
    assert torch.equal(a, b) and resumed[0].events == resumed[1].events
    assert len(a) == 8 and bool(torch.isfinite(a).all())
    np.testing.assert_allclose(a[6:].numpy(), np.stack([_np(p) for p in jres.poses[6:]]),
                               atol=5e-4, rtol=0)
    assert [k for k in resumed[0].keyframes.frame_ids] == list(jres.keyframes.frame_ids)


def _port_run(model, settings, n=3, seed=7):
    with both_configs(settings):
        slam = SLAM(model=model, resolution=64)
        slam.run(Frames(tiny_frames(n, seed)))
    return slam


def test_asmk_whitening_tasks_and_mirrors_roundtrip(tiny_model, port_model, tmp_path):
    """ASMK state, a fitted whitening head, pending backend tasks, the
    reloc counter and a score mirror: written by the port, read by JAX and
    by a fresh port session, equal; signatures of a query equal too."""
    settings = dict(SIMPLE, retrieval={"method": "asmk", "asmk_n_words": 8, "asmk_proj_dim": 4,
                                       "asmk_codebook_kf": 1})
    slam = _port_run(port_model, settings)
    rdb = slam.retrieval_db
    assert rdb.asmk.ready() and rdb.asmk.count >= 1
    rdb.retrieval = RetrievalModel(rdb.backbone_dim, rdb.backbone_dim, seed=3, device="cpu")
    rdb.use_simple, rdb._whitening_kf = False, 1
    feat = torch.from_numpy(np.random.default_rng(4).normal(size=(12, rdb.backbone_dim))
                            .astype(np.float32))
    rdb._maybe_fit_whitening(feat)
    assert rdb._whitening_fitted
    slam.state.global_optimizer_tasks = [0]
    slam.state.reloc_pending = 2
    slam.keyframes._score_host[0] = 0.75
    path = tmp_path / "v2.npz"
    with both_configs(settings):
        slam.save_state(path)
        back = SLAM(model=port_model, resolution=64)
        back.load_state(path)
        jslam = JaxSLAM(model=tiny_model, resolution=64)
        jslam.load_state(path)
    for other in (back, jslam):
        assert_same_state(slam, other)
        a, b = slam.retrieval_db.asmk, other.retrieval_db.asmk
        assert a.count == b.count
        for name in ("mu", "projection", "B", "present", "codebook"):
            np.testing.assert_array_equal(_np(getattr(a, name)), _np(getattr(b, name)), name)
        assert other.keyframes[0]._score == 0.75
        assert other.keyframes[0].N_updates == slam.keyframes[0].N_updates
    np.testing.assert_allclose(_np(jslam.retrieval_db.compute_signature(feat.numpy())),
                               rdb.compute_signature(feat).numpy(), rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(back.retrieval_db.compute_signature(feat),
                               rdb.compute_signature(feat), rtol=0, atol=0)


def test_jax_whitening_loads_into_port(tiny_model, port_model, tmp_path):
    """JAX's fitted whitening head (flax params under retp::) rebuilds the
    port's head on a session without one, with the same signatures."""
    with both_configs(SIMPLE):
        jslam = JaxSLAM(model=tiny_model, resolution=64)
        jslam.run(JaxFrames(tiny_frames(3, 5)))
        rdb = jslam.retrieval_db
        rdb.retrieval = JaxRetrievalModel(rdb.backbone_dim, rdb.backbone_dim, seed=3)
        rdb.use_simple, rdb._whitening_kf = False, 1
        feat = np.random.default_rng(5).normal(size=(12, rdb.backbone_dim)).astype(np.float32)
        rdb._maybe_fit_whitening(feat)
        path = tmp_path / "jax_white.npz"
        jslam.save_state(path)
        port = SLAM(model=port_model, resolution=64)
        assert port.retrieval_db is None or port.retrieval_db.retrieval is None
        port.load_state(path)
    assert_same_state(port, jslam)
    assert not port.retrieval_db.use_simple
    np.testing.assert_allclose(port.retrieval_db.compute_signature(torch.from_numpy(feat)).numpy(),
                               _np(rdb.compute_signature(feat)), rtol=1e-6, atol=1e-6)


def test_calibrated_intrinsics_roundtrip(tiny_model, port_model, tmp_path):
    """K in calibrated mode survives a port save into JAX and into the port,
    where the graph solve's K is restored with it."""
    settings = dict(SIMPLE, use_calib=True, dataset={"calib": [80.0, 80.0, 32.0, 24.0]})
    slam = _port_run(port_model, settings)
    assert slam.keyframes.K is not None
    path = tmp_path / "calib.npz"
    with both_configs(settings):
        slam.save_state(path)
        back = SLAM(model=port_model, resolution=64)
        back.load_state(path)
        jslam = JaxSLAM(model=tiny_model, resolution=64)
        jslam.load_state(path)
    assert_same_state(slam, back)
    assert_same_state(slam, jslam)
    torch.testing.assert_close(back.factor_graph.K, slam.keyframes.K, rtol=0, atol=0)


def test_img_downsample_mismatch_raises(port_model, tmp_path):
    slam = _port_run(port_model, SIMPLE, n=2)
    path = tmp_path / "ds.npz"
    slam.save_state(path)
    with both_configs(dict(SIMPLE, dataset={"img_downsample": 2})):
        other = SLAM(model=port_model, resolution=64)
        with pytest.raises(ValueError, match="img_downsample"):
            other.load_state(path)


def test_periodic_snapshot_written_and_resumes(port_model, tmp_path):
    """`runtime.snapshot_every` 2 over 4 frames through the chained path:
    the last periodic file holds all four poses."""
    snap = tmp_path / "auto.npz"
    settings = dict(SIMPLE, runtime={"keyframe_capacity": 16, "snapshot_every": 2,
                                     "snapshot_path": str(snap), "sync_every": 2})
    slam = _port_run(port_model, settings, n=4)
    assert snap.exists()
    with both_configs(settings):
        back = SLAM(model=port_model, resolution=64)
        back.load_state(snap)
    assert len(back.poses) == 4
    torch.testing.assert_close(torch.stack(back.poses), torch.stack(slam.poses), rtol=0, atol=0)
