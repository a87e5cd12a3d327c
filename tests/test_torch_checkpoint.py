"""Checkpoint files through both packages' loaders (`mast3r_slam_torch.models.io`
against `mast3r_slam_tpu.models.io`), then the same encode and decode.

The files are synthetic and upstream-named, with the tiny model's full key
surface plus the documented-dead upstream keys (as tests/test_torch_twin.py
writes them for the JAX loader): safetensors, .npz, and a naver-style .pth
``{"model": state with module. prefixes, "args": argparse.Namespace}``; a
file written by each package's `save_checkpoint` and read by the other; a
naver retrieval head, folded by both; strict-mode errors. Bands: the encode
and decode bands of tests/test_torch_model.py; loaded weights exact.
"""

import argparse
import copy

import jax
import numpy as np
import pytest
import torch

from mast3r_slam_tpu.models import io as jio
from mast3r_slam_tpu.models.retrieval import RetrievalModel as JaxRetrievalModel
from mast3r_slam_torch.models import MASt3RConfig, MASt3RModel, io
from mast3r_slam_torch.models.mast3r import load_mast3r
from mast3r_slam_torch.models.retrieval import RetrievalModel
from test_retrieval_import import D, _make_naver_state
from test_torch_helpers import tiny_pair
from test_torch_model import check_encode_decode


def _upstream_state(jm, seed: int = 0) -> dict:
    """The tiny model's upstream-named key surface with perturbed values, and
    the upstream key that real checkpoints carry and the forward ignores."""
    rng = np.random.default_rng(seed)
    state = {k: (v + 0.02 * rng.normal(size=v.shape)).astype(np.float32)
             for k, v in jio.export_torch_state_dict(jm.params).items()}
    state["mask_token"] = rng.normal(size=(1, 1, 64)).astype(np.float32)
    return state


def _write(state: dict, path) -> str:
    path = str(path)
    if path.endswith(".npz"):
        np.savez(path, **state)
    elif path.endswith(".pth"):
        torch.save({"model": {f"module.{k}": torch.from_numpy(v) for k, v in state.items()},
                    "args": argparse.Namespace(model="MASt3R(tiny)", seed=0)}, path)
    else:
        from safetensors.numpy import save_file

        save_file(state, path)
    return path


@pytest.fixture(scope="module")
def jm():
    """A JAX tiny model of its own: JAX reads `runtime.gelu_impl` when a jit
    traces, so a model shared with other files may carry another setting."""
    return tiny_pair("linear")[0]


def _jax_with(jm, params):
    out = copy.copy(jm)
    out.params = params
    return out


@pytest.mark.parametrize("suffix", [".safetensors", ".npz", ".pth"])
def test_upstream_file_loads_in_both(jm, tmp_path, suffix):
    state = _upstream_state(jm)
    path = _write(state, tmp_path / f"tiny{suffix}")
    loaded = _jax_with(jm, jio.load_checkpoint_into(jm.params, path, strict=True))
    tm = load_mast3r(model_type="tiny", resolution=64, checkpoint=path, device="cpu")
    own = tm.net.state_dict()
    for name, value in state.items():
        if name != "mask_token":
            np.testing.assert_array_equal(own[name].numpy(), value, err_msg=name)
    check_encode_decode(loaded, tm)


def test_save_checkpoint_crosses_packages(jm, tmp_path):
    """The port's `save_checkpoint` loads strictly in JAX with the port's
    weights, and JAX's loads strictly in the port with JAX's."""
    tm = MASt3RModel.create(cfg=MASt3RConfig.tiny(), resolution=64, device="cpu", seed=3)
    ours = tmp_path / "port.safetensors"
    io.save_checkpoint(tm.net, str(ours))
    params = jio.load_checkpoint_into(jm.params, str(ours), strict=True)
    exported = jio.export_torch_state_dict(params)
    for name, value in tm.net.state_dict().items():
        np.testing.assert_array_equal(exported[name], value.numpy(), err_msg=name)
    check_encode_decode(_jax_with(jm, params), tm)

    theirs = tmp_path / "jax.npz"
    jio.save_checkpoint(jm.params, str(theirs))
    tm2 = MASt3RModel.create(cfg=MASt3RConfig.tiny(), resolution=64, device="cpu", seed=4)
    io.load_checkpoint_into(tm2.net, str(theirs))
    exported = jio.export_torch_state_dict(jm.params)
    for name, value in tm2.net.state_dict().items():
        np.testing.assert_array_equal(value.numpy(), exported[name], err_msg=name)


def test_strict_load_rejects_missing_and_unexpected_keys(jm, tmp_path):
    state = _upstream_state(jm, seed=1)
    short = dict(state)
    del short["enc_blocks.0.attn.qkv.weight"]
    extra = dict(state, **{"dec_blocks.99.norm1.weight": np.ones(48, np.float32)})
    for tag, bad in (("missing", short), ("unexpected", extra)):
        path = _write(bad, tmp_path / f"{tag}.safetensors")
        with pytest.raises(KeyError, match="strict"):
            jio.load_checkpoint_into(jm.params, path, strict=True)
        with pytest.raises(KeyError, match="strict"):
            load_mast3r(model_type="tiny", resolution=64, checkpoint=path, device="cpu")


def test_naver_retrieval_file_folds_in_both(tmp_path):
    """A naver retrieval .pth (prewhiten, projector, attention, postwhiten in
    float64 / float32, a frozen backbone key, wrapped with "args"): the
    folded weights and the signatures agree (atol 1e-5: the fold's float32
    products in two orders)."""
    state = _make_naver_state(np.random.default_rng(5))
    path = tmp_path / "retrieval.pth"
    torch.save({"model": state, "args": argparse.Namespace(arch="retrieval")}, path)
    jr = JaxRetrievalModel.from_pretrained(backbone_dim=D, checkpoint=str(path))
    tr = RetrievalModel.from_pretrained(D, checkpoint=str(path), device="cpu")
    for layer, leaves in tr.params.items():
        for leaf, value in leaves.items():
            np.testing.assert_allclose(value.numpy(), np.asarray(jr.params["params"][layer][leaf]),
                                       atol=1e-5, rtol=0, err_msg=f"{layer}.{leaf}")
    feat = np.random.default_rng(6).standard_normal((40, D)).astype(np.float32)
    np.testing.assert_allclose(tr.forward_global(torch.from_numpy(feat)).numpy(),
                               np.asarray(jr.forward_global(jax.numpy.asarray(feat))),
                               atol=1e-5, rtol=0)
    state["projector.1.weight"] = torch.zeros(D, D)
    torch.save(state, tmp_path / "deep.pth")
    with pytest.raises(NotImplementedError, match="multi-layer projector"):
        RetrievalModel.from_pretrained(D, checkpoint=str(tmp_path / "deep.pth"), device="cpu")


def test_retrieval_head_in_own_names_loads_strictly(tmp_path):
    """JAX's `save_checkpoint` of its head (``whiten.weight`` etc.) is not a
    naver file: both packages take the name-mapped loader, strictly."""
    jr = JaxRetrievalModel(D, D, seed=2)
    path = tmp_path / "head.npz"
    jio.save_checkpoint(jr.params, str(path))
    assert not io.is_retrieval_state_dict(io.load_state_dict_file(str(path)))
    tr = RetrievalModel.from_pretrained(D, checkpoint=str(path), device="cpu")
    for layer, leaves in tr.params.items():
        for leaf, value in leaves.items():
            np.testing.assert_array_equal(value.numpy(),
                                          np.asarray(jr.params["params"][layer][leaf]))
    state = dict(np.load(path))
    state["whiten.extra"] = np.zeros(1, np.float32)
    np.savez(tmp_path / "bad.npz", **state)
    with pytest.raises(KeyError, match="unexpected"):
        RetrievalModel.from_pretrained(D, checkpoint=str(tmp_path / "bad.npz"), device="cpu")


def test_command_line_checkpoint_flag(jm, tmp_path, monkeypatch):
    """`python -m mast3r_slam_torch.slam --checkpoint PATH` loads the file
    into the model the loop runs (the tiny config patched in for
    mast3r_full's), and runs."""
    from PIL import Image

    from mast3r_slam_torch import config as torch_config
    from mast3r_slam_torch.models import mast3r as mast3r_mod
    from mast3r_slam_torch.workload import drift_frames

    made = []
    create = MASt3RModel.create.__func__

    def tiny_create(cls, **kw):
        kw.update(cfg=MASt3RConfig.tiny(), resolution=64)
        made.append(create(cls, **kw))
        return made[-1]

    monkeypatch.setattr(mast3r_mod.MASt3RModel, "create", classmethod(tiny_create))
    state = _upstream_state(jm, seed=7)
    path = _write(state, tmp_path / "ckpt.safetensors")
    rng = np.random.default_rng(2)
    frames = tmp_path / "frames"
    frames.mkdir()
    for i, img in enumerate(drift_frames(rng.uniform(0, 1, (48, 64, 3)).astype(np.float32), 3,
                                         rng)):
        Image.fromarray((img * 255).astype(np.uint8)).save(frames / f"{i:04d}.png")
    from mast3r_slam_torch import slam as slam_mod

    try:
        assert slam_mod.main([str(frames), "--checkpoint", path, "--resolution", "64",
                              "--device", "cpu", "--max-frames", "3"]) == 0
    finally:
        torch_config.reset_config()
    assert len(made) == 1
    np.testing.assert_array_equal(made[0].net.state_dict()["enc_norm.weight"].numpy(),
                                  state["enc_norm.weight"])
