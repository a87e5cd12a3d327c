"""The port's pipeline-parallel and sequence-parallel encoders
(`parallel.pipeline.pipelined_encode`, `parallel.sequence.
sequence_parallel_encode`) on gloo process groups on the CPU, against JAX's
on the conftest's virtual devices, with the same weights: a tiny model of
encoder depth 4 at 48x64 (12 tokens), B 4.

Cases: GPipe at (stages, M) in {(2, 2), (2, 4), (4, 4)} (2 and 4 ranks);
sequence parallel at dp 2 x sp 2 (batch on dp) and at sp 4 (replicated
batch, 3 tokens a rank). Band: 1e-4, JAX's dryrun band for both encoders
(__graft_entry__.py). JAX's error cases raise: a depth that the stages do
not divide, a batch that the microbatches do not divide; blocks are ordered
by their numeric suffix.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mast3r_slam_tpu.models import MASt3RConfig as JaxMASt3RConfig
from mast3r_slam_tpu.models import MASt3RModel as JaxMASt3RModel
from mast3r_slam_tpu.parallel import make_mesh as jax_make_mesh
from mast3r_slam_tpu.parallel.pipeline import make_pipeline_mesh as jax_pipeline_mesh
from mast3r_slam_tpu.parallel.pipeline import pipelined_encode as jax_pipelined_encode
from mast3r_slam_tpu.parallel.sequence import sequence_parallel_encode as jax_sp_encode
from mast3r_slam_torch.models import MASt3RConfig
from mast3r_slam_torch.models.io import params_from_flax
from mast3r_slam_torch.parallel.mesh import spawn
from mast3r_slam_torch.parallel.pipeline import encoder_stage_params
from test_torch_helpers import flax_tree
from test_torch_parallel_workers import encode_rank, tiny_model

ATOL = 1e-4
CFG = dict(enc_embed_dim=64, enc_depth=4, enc_num_heads=2, patch_size=16, dec_embed_dim=48,
           dec_depth=2, dec_num_heads=2, head_type="linear", dtype=torch.float32)
PP_CASES = {2: [("pp", 2, 2), ("pp", 2, 4)], 4: [("pp", 4, 4)]}
SP_CASES = [("sp", 2, 2, "dp"), ("sp", 1, 4, None)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jcfg = dataclasses.replace(JaxMASt3RConfig.tiny(), enc_depth=4)
    jm = JaxMASt3RModel.create(resolution=32, _test_cfg=jcfg)
    state = params_from_flax(flax_tree(jm.params))
    imgs = np.random.default_rng(0).uniform(-1, 1, (4, 48, 64, 3)).astype(np.float32)
    x = jnp.asarray(imgs)
    jax_out = {}
    for case in PP_CASES[2] + PP_CASES[4]:
        _, stages, m = case
        jax_out[case] = jax_pipelined_encode(jm.cfg, jm.params, x, jax_pipeline_mesh(stages), m)
    for case in SP_CASES:
        _, dp, sp, batch_axis = case
        mesh = jax_make_mesh(dp * sp, tp=sp, axis_names=("dp", "sp"))
        jax_out[case] = jax_sp_encode(jm.cfg, jm.params, x, mesh, batch_axis=batch_axis)
    unsharded = tiny_model(state, MASt3RConfig(**CFG), resolution=32).encode(torch.from_numpy(imgs))
    work = tmp_path_factory.mktemp("ranks")
    two = spawn(encode_rank, 2, (state, CFG, imgs, PP_CASES[2]), device="cpu",
                workdir=str(work / "two"))
    four = spawn(encode_rank, 4, (state, CFG, imgs, PP_CASES[4] + SP_CASES), device="cpu",
                 workdir=str(work / "four"))
    return dict(jax=jax_out, unsharded=unsharded, two=two, four=four, state=state)


def _check(runs, case, ranks):
    want_tok, want_pos = runs["jax"][case]
    for r in ranks:
        tok, pos = r[case]
        np.testing.assert_allclose(tok.numpy(), np.asarray(want_tok), atol=ATOL, rtol=0)
        np.testing.assert_array_equal(pos.numpy(), np.asarray(want_pos))
        np.testing.assert_allclose(tok.numpy(), runs["unsharded"][0].numpy(), atol=ATOL, rtol=0)


@pytest.mark.parametrize("stages,m", [(2, 2), (2, 4), (4, 4)])
def test_pipelined_encode_matches_jax(runs, stages, m):
    _check(runs, ("pp", stages, m), runs["two"] if stages == 2 else runs["four"])


@pytest.mark.parametrize("dp,sp", [(2, 2), (1, 4)])
def test_sequence_parallel_encode_matches_jax(runs, dp, sp):
    _check(runs, ("sp", dp, sp, "dp" if dp > 1 else None), runs["four"])


def test_error_cases_and_block_order(runs):
    """JAX's error cases (tests/test_pipeline_parallel.py): a batch of 3 in 2
    microbatches raises on every rank, a depth of 4 over 3 stages raises;
    the slabs follow the numeric suffix (blocks 10 and 11 after 9, not
    after 1)."""
    for r in runs["two"] + runs["four"]:
        assert all(v for k, v in r.items() if isinstance(k, tuple) and k[-1] == "odd")
    with pytest.raises(ValueError, match="not divisible"):
        encoder_stage_params(runs["state"], 3)
    slabs = encoder_stage_params(runs["state"], 2)
    assert [len(s) for s in slabs] == [2, 2]
    assert torch.equal(slabs[1][0]["attn.qkv.weight"], runs["state"]["enc_blocks.2.attn.qkv.weight"])
    deep = {f"enc_blocks.{i}.w": torch.tensor(float(i)) for i in (10, 2, 11, 0, 1, 3, 9, 8, 4,
                                                                   5, 7, 6)}
    order = [float(b["w"]) for s in encoder_stage_params(deep, 3) for b in s]
    assert order == [float(i) for i in range(12)]
