"""The port's keyframe arena and SLAM state (frame.py) against the JAX
package's: the same sequence of appends, slot writes, pose write-backs,
evictions and pops on both, from the same numpy-seeded frames.

Tolerance: exact, over every slot of every buffer (the dead slots past the
last live one included: both duplicate the tail after an eviction), the
host mirrors, the frame ids and the version counter.
"""

import numpy as np
import pytest
import torch

from mast3r_slam_tpu import frame as jax_frame
from mast3r_slam_torch import frame as torch_frame

H, W, S, D, CAP = 4, 6, 3, 8, 5


def _sim3(rng, n=None):
    shape = () if n is None else (n,)
    q = rng.normal(size=shape + (4,))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    t = rng.normal(size=shape + (3,))
    s = rng.uniform(0.5, 2.0, size=shape + (1,))
    return np.concatenate([t, q, s], axis=-1).astype(np.float32)


def _frame_data(rng, frame_id):
    return dict(
        frame_id=frame_id,
        img=rng.uniform(0, 1, (H, W, 3)).astype(np.float32),
        T_WC=_sim3(rng),
        X_canon=rng.normal(size=(H * W, 3)).astype(np.float32),
        C=rng.uniform(1, 3, (H * W, 1)).astype(np.float32),
        feat=rng.normal(size=(S, D)).astype(np.float32),
        pos=np.stack(np.meshgrid(np.arange(1), np.arange(S), indexing="ij"), -1)
        .reshape(S, 2).astype(np.int64),
        N=int(rng.integers(1, 4)),
        N_updates=int(rng.integers(1, 6)),
    )


def _frames(d):
    jf = jax_frame.Frame(**{k: v if isinstance(v, int) else np.asarray(v) for k, v in d.items()})
    tf = torch_frame.Frame(**{k: v if isinstance(v, int) else torch.from_numpy(v)
                              for k, v in d.items()})
    return jf, tf


def _assert_same_arena(j, t):
    for name in ("X", "C", "T_WC", "N", "_feat"):
        np.testing.assert_array_equal(getattr(t, name).numpy(), np.asarray(getattr(j, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(t._pos.numpy(), np.asarray(j._pos))
    assert t._n_host == j._n_host
    assert t._nups_host == j._nups_host
    assert t._score_host == j._score_host
    assert t.frame_ids == j.frame_ids
    assert t.version == j.version
    assert len(t) == len(j) and t.last_index() == j.last_index()
    for k in range(len(t)):
        fj, ft = j[k], t[k]
        assert (ft.frame_id, ft.N, ft.N_updates, ft._score) == (fj.frame_id, fj.N, fj.N_updates,
                                                                fj._score)
        np.testing.assert_array_equal(ft.X_canon.numpy(), np.asarray(fj.X_canon))
        np.testing.assert_array_equal(ft.T_WC.numpy(), np.asarray(fj.T_WC))
        np.testing.assert_array_equal(ft.img.numpy(), np.asarray(fj.img))


def test_arena_sequence_matches_jax():
    rng = np.random.default_rng(3)
    j = jax_frame.Keyframes(H, W, capacity=CAP)
    t = torch_frame.Keyframes(H, W, capacity=CAP, device="cpu")

    def both(op, *args_j, args_t=None):
        getattr(j, op)(*args_j)
        getattr(t, op)(*(args_t if args_t is not None else args_j))
        _assert_same_arena(j, t)

    for fid in range(10, 10 + CAP):
        jf, tf = _frames(_frame_data(rng, fid))
        assert j.append(jf) == t.append(tf)
        _assert_same_arena(j, t)
    with pytest.raises(AssertionError, match="full"):
        t.append(_frames(_frame_data(rng, 99))[1])

    X = rng.normal(size=(H * W, 3)).astype(np.float32)
    C = rng.uniform(1, 3, (H * W, 1)).astype(np.float32)
    j.write_pointmap(2, np.asarray(X), np.asarray(C), 3.0, n_updates=4, score=0.5)
    t.write_pointmap(2, torch.from_numpy(X), torch.from_numpy(C), 3.0, n_updates=4, score=0.5)
    _assert_same_arena(j, t)
    T = _sim3(rng)
    both("write_pose", 1, np.asarray(T), args_t=(1, torch.from_numpy(T)))
    Tb = _sim3(rng, 2)
    j.update_T_WCs(np.asarray(Tb), np.array([0, 3]))
    t.update_T_WCs(torch.from_numpy(Tb), [0, 3])
    _assert_same_arena(j, t)

    both("remove", 1)  # interior eviction: higher slots shift down
    both("pop_last")
    jf, tf = _frames(_frame_data(rng, 20))
    assert j.append(jf) == t.append(tf)
    _assert_same_arena(j, t)
    both("remove", 0)
    both("remove", len(t) - 1)  # the last live slot
    with pytest.raises(IndexError):
        t.remove(len(t))


@pytest.mark.parametrize("idx", [0, 2, 4])
def test_arena_remove_matches_jax(idx):
    buf = np.random.default_rng(idx).normal(size=(5, 7, 3)).astype(np.float32)
    t = torch.from_numpy(buf.copy())
    torch_frame._arena_remove(t, idx)
    np.testing.assert_array_equal(t.numpy(), np.asarray(jax_frame._arena_remove(buf.copy(), idx)))


def test_slam_state_queues_match_jax():
    j, t = jax_frame.SLAMState(), torch_frame.SLAMState()
    assert t.mode.name == j.mode.name == "INIT"
    for idx in (0, 3, 1):
        j.queue_global_optimization(idx)
        t.queue_global_optimization(idx)
    got_j = [j.dequeue_global_optimization() for _ in range(4)]
    got_t = [t.dequeue_global_optimization() for _ in range(4)]
    assert got_t == got_j == [0, 3, 1, None]
    assert [m.name for m in torch_frame.Mode] == [m.name for m in jax_frame.Mode]
