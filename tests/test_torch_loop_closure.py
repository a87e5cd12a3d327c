"""Loop closure and the iterative matcher through the port's SLAM loop,
against the JAX `SLAM`, on the oracle worlds of tests/oracle.py, driven frame
by frame as the JAX package's own tests drive them.

* The teleport-and-revisit world of tests/test_reloc_oracle.py with ASMK
  retrieval (8 words, 4 whitened dims, the codebook fitted at the 3rd
  keyframe): the camera jumps behind the surface (tracking fails and
  relocalisation starts new keyframes), then returns near frame 1, where
  ASMK must retrieve the first keyframes and the graph solve snap the pose
  back. The port's k-means draws its initial rows with JAX's draw
  (monkeypatched), since the two packages draw different numbers from one
  seed.
* The smooth-trajectory world of tests/test_system_oracle.py with
  `matching.method: iterative` (test_torch_loop_closure_iterative.py).

Bands (those of tests/test_torch_slam.py): per-frame modes, the frames that
relocalise and the keyframe frame ids exact; poses within 1e-4 of JAX's; the
revisit frames within 0.1 of the truth (test_reloc_oracle.py).
"""

import numpy as np

from mast3r_slam_tpu.config import Config as JaxConfig
from mast3r_slam_tpu.config import set_config as jax_set_config
from mast3r_slam_tpu.frame import Mode as JaxMode
from mast3r_slam_tpu.frame import create_frame as jax_create_frame
from mast3r_slam_tpu.slam import SLAM as JaxSLAM
from mast3r_slam_torch import config as torch_config
from mast3r_slam_torch.frame import Mode, create_frame
from mast3r_slam_torch.models import asmk
from mast3r_slam_torch.slam import SLAM
from test_torch_asmk import _jax_draw
from test_torch_slam import TorchOracle, _drive
from tests.oracle import render_frame_image
from tests.test_reloc_oracle import _teleport_world


def _logging_reloc(slam, log):
    """Record the frame id of every relocalisation `slam` starts."""
    reloc = slam._process_reloc
    slam._process_reloc = lambda frame: (log.append(frame.frame_id), reloc(frame))[1]


def _run_both(model, frames, settings):
    """Both SLAM loops over `frames` -> (jax (poses, modes, relocalised
    frames), the port's, jax SLAM, port SLAM)."""
    jax_set_config(JaxConfig.from_dict(settings))
    jslam, j_reloc = JaxSLAM(model=model, resolution=frames[0].shape[1]), []
    _logging_reloc(jslam, j_reloc)
    j = _drive(jslam, frames, JaxMode, lambda i, img: jax_create_frame(i, img), np.asarray)
    torch_config.set_config(torch_config.Config.from_dict(settings))
    try:
        tslam, t_reloc = SLAM(model=TorchOracle(model), resolution=frames[0].shape[1]), []
        _logging_reloc(tslam, t_reloc)
        t = _drive(tslam, frames, Mode, lambda i, img: create_frame(i, img), lambda T: T.numpy())
    finally:
        torch_config.reset_config()
    return (*j, j_reloc), (*t, t_reloc), jslam, tslam


def test_teleport_and_revisit_with_asmk_matches_jax(monkeypatch):
    monkeypatch.setattr(asmk, "kmeans_init_indices", _jax_draw)
    rng = np.random.default_rng(0)
    h = w = 16
    model, gt = _teleport_world(rng)
    frames = [render_frame_image(i, h, w, rng) for i in range(9)]
    settings = {
        "runtime": {"keyframe_capacity": 16},
        "local_opt": {"max_edges": 32, "max_iters": 12},
        "matching": {"use_simple": True, "dist_thresh": 0.5},
        "tracking": {"min_match_frac": 0.3},
        "retrieval": {"method": "asmk", "min_thresh": 0.5, "asmk_n_words": 8,
                      "asmk_proj_dim": 4, "asmk_codebook_kf": 3},
        "reloc": {"min_match_frac": 0.3, "strict": True},
    }
    (j_poses, j_modes, j_reloc), (t_poses, t_modes, t_reloc), jslam, tslam = _run_both(
        model, frames, settings)

    assert t_modes == j_modes and t_reloc == j_reloc
    assert 7 in t_reloc, t_reloc  # the revisit went through relocalisation
    assert list(tslam.keyframes.frame_ids) == list(jslam.keyframes.frame_ids)
    db = tslam.retrieval_db
    assert db.asmk.ready() and db._asmk_fit_size == jslam.retrieval_db._asmk_fit_size >= 3
    assert db.asmk.count == jslam.retrieval_db.asmk.count
    assert tslam.events["reloc"] == len(t_reloc) and tslam.events["reloc_solve"] >= 1
    np.testing.assert_allclose(t_poses, j_poses, atol=1e-4, rtol=0)
    for i in (7, 8):
        assert np.linalg.norm(t_poses[i, :3] - gt[i, :3]) < 0.1, f"frame {i}"
