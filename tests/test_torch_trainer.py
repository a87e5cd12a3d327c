"""The port's training driver (`parallel.trainer`) against JAX's on the CPU:
the synthetic batch bit-equal to JAX's from one seed; resuming from a
checkpoint equal to a straight run (tests/test_train_loop.py's contract,
rtol 1e-5); a checkpoint written by JAX's `save_train_ckpt` resumed by the
port to JAX's next loss (rtol 1e-5: the same parameters and Adam state, f32
forwards ~1e-6 apart), and the port's file read by JAX's `load_train_ckpt`
bit-equal; the command line with ``--steps 2 --devices 2`` (two gloo
ranks, tp 2), its tensor-parallel parts gathered whole into the file."""

import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mast3r_slam_tpu.models import MASt3RConfig as JaxMASt3RConfig
from mast3r_slam_tpu.models import MASt3RModel as JaxMASt3RModel
from mast3r_slam_tpu.models.mast3r import MASt3RNet as JaxMASt3RNet
from mast3r_slam_tpu.parallel import make_mesh as jax_make_mesh
from mast3r_slam_tpu.parallel import make_train_step
from mast3r_slam_tpu.parallel import trainer as jtrainer
from mast3r_slam_torch.models.io import params_from_flax
from mast3r_slam_torch.parallel import trainer
from test_torch_helpers import flax_tree
from test_torch_parallel_workers import tiny_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for the port's training steps in this process:
    beside JAX's thread pool, torch's eight threads made a tiny-model step
    25x slower (0.19 s at one thread, 4.5 s at eight, on the 8-core CPU)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batch_fn(lib, h=48, w=64):
    return lambda i: lib.synthetic_pair_batch(np.random.default_rng(100 + i), 2, h, w, m=8)


def test_synthetic_batch_bit_equal_to_jax():
    want = jtrainer.synthetic_pair_batch(np.random.default_rng(7), 3, 48, 64, 16)
    got = trainer.synthetic_pair_batch(np.random.default_rng(7), 3, 48, 64, 16)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
        assert got[k].numpy().dtype == np.asarray(want[k]).dtype, k


@pytest.fixture(scope="module")
def jm():
    return JaxMASt3RModel.create(resolution=64, _test_cfg=JaxMASt3RConfig.tiny())


def test_resume_matches_straight_run(jm, tmp_path):
    model = tiny_model(params_from_flax(flax_tree(jm.params)), master_weights=True)
    before = {k: v.clone() for k, v in model.net.state_dict().items()}
    logs = []
    net_s, l_straight = trainer.train_loop(model, None, 3, _batch_fn(trainer), log=logs.append)
    ckpt = str(tmp_path / "ck.npz")
    trainer.train_loop(model, None, 2, _batch_fn(trainer), ckpt_path=ckpt, log=logs.append)
    net_r, l_resumed = trainer.train_loop(model, None, 3, _batch_fn(trainer), ckpt_path=ckpt,
                                          log=logs.append)
    assert len(l_straight) == 3 and len(l_resumed) == 1 and np.isfinite(l_straight).all()
    np.testing.assert_allclose(l_resumed, l_straight[2:], rtol=RTOL)
    assert any("resumed" in s for s in logs)
    for (name, a), b in zip(net_s.named_parameters(), net_r.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=RTOL, atol=1e-6,
                                   err_msg=name)
    for k, v in model.net.state_dict().items():  # train_loop trains a copy
        assert torch.equal(v, before[k]), k


def test_jax_checkpoint_resumes_in_the_port_and_back(jm, tmp_path):
    """JAX's step (`make_train_step`, as its train_loop runs it) twice, its
    file saved, then its third step; the port resumes from the file."""
    opt, mesh = optax.adamw(1e-4), jax_make_mesh(1)
    params = jax.tree.map(jnp.array, jm.params)
    opt_state = opt.init(params)
    step = make_train_step(JaxMASt3RNet(jm.cfg), opt, mesh, params)
    bf = _batch_fn(jtrainer)
    for i in range(2):
        params, opt_state, _, _ = step(params, opt_state, bf(i))
    ckpt = str(tmp_path / "jax.npz")
    jtrainer.save_train_ckpt(ckpt, params, opt_state, 2)
    j_next = float(step(params, opt_state, bf(2))[2])
    model = tiny_model(params_from_flax(flax_tree(jm.params)), master_weights=True)
    logs = []
    port_net, t_next = trainer.train_loop(model, None, 3, _batch_fn(trainer), ckpt_path=ckpt,
                                          log=logs.append)
    assert len(t_next) == 1 and "at step 2" in logs[0]
    np.testing.assert_allclose(t_next[0], j_next, rtol=RTOL)
    # The port's file after its step 3 in JAX's own loader: the same tree.
    params, opt_state, saved = jtrainer.load_train_ckpt(ckpt, jm.params, opt.init(jm.params))
    assert saved == 3 and int(opt_state[0].count) == 3
    mapped = params_from_flax(flax_tree(params))
    for name, p in port_net.named_parameters():
        np.testing.assert_array_equal(mapped[name].numpy(), p.detach().numpy(), err_msg=name)
    mu = params_from_flax(flax_tree(opt_state[0].mu))
    assert all(np.abs(v.numpy()).max() > 0 for v in mu.values())


def test_command_line_on_two_cpu_ranks(tmp_path):
    ckpt = tmp_path / "cli.npz"
    proc = subprocess.run(
        [sys.executable, "-m", "mast3r_slam_torch.parallel.trainer", "--steps", "2",
         "--devices", "2", "--ckpt", str(ckpt)],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": REPO})
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "final loss" in proc.stdout and "over 2 steps" in proc.stdout
    assert proc.stderr.count("[train] step") == 2  # rank 0 logs
    model = trainer.trainer_model(0, device="cpu")
    net = model.net
    opt = trainer.adamw(net.parameters())
    assert trainer.load_train_ckpt(str(ckpt), net, opt) == 2  # whole tensors, unsharded
    assert int(opt.state[next(net.parameters())]["step"]) == 2
