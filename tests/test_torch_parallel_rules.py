"""The port's mesh and tensor-parallel rules (`parallel.mesh.mesh_shape`,
`parallel.sharding`) against JAX's (`parallel.make_mesh`, `_spec_for`), and
the tp-split forward against the unsharded one.

* `mesh_shape` gives JAX's (dp, tp) for n in {1, 2, 3, 4, 6, 8}.
* Every parameter's role (column / row / replicated) equals JAX's spec on
  the tiny model's tree, mapped through the weight map, also for int8
  weights (JAX's ``__w8__`` / ``scale`` leaves, the port's ``weight_q`` /
  ``weight_scale``).
* The per-head qkv split gives each rank the rows of its heads of q, k and
  v, and undoes to the whole weight.
* The tiny model split over tp 2 on 2 gloo ranks: pts3d and desc within
  2e-4 of the unsharded port and of JAX's unsharded forward
  (tests/test_parallel.py's band), also with int8 weights.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from mast3r_slam_tpu.models import MASt3RConfig as JaxMASt3RConfig
from mast3r_slam_tpu.models import MASt3RModel as JaxMASt3RModel
from mast3r_slam_tpu.parallel import make_mesh as jax_make_mesh
from mast3r_slam_tpu.parallel.sharding import _spec_for
from mast3r_slam_torch.models.io import _flax_path_to_torch_name, params_from_flax
from mast3r_slam_torch.parallel.mesh import mesh_shape, spawn
from mast3r_slam_torch.parallel.sharding import (infer_param_shardings, param_role, qkv_view,
                                                 shard_slices, split_tensor)
from test_torch_helpers import flax_tree
from test_torch_parallel_workers import forward_rank, tiny_model

ATOL = 2e-4
ROLE = {P(None, "tp"): "column", P("tp", None): "row", P("tp"): "column", P(): "replicated"}


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8])
def test_mesh_shape_is_jax_rule(n):
    mesh = jax_make_mesh(n)
    assert mesh_shape(n) == (mesh.shape["dp"], mesh.shape["tp"])
    assert mesh_shape(n, tp=1) == (n, 1)
    with pytest.raises(ValueError):
        mesh_shape(n, tp=n + 1)


def _port_name(path: tuple) -> str:
    """A flax path of a (possibly int8) tree -> the port's parameter name."""
    if path[-2] == "kernel" and path[-1] in ("__w8__", "scale"):
        base = _flax_path_to_torch_name(path[:-1])
        return base + ("_q" if path[-1] == "__w8__" else "_scale")
    return _flax_path_to_torch_name(path)


@pytest.mark.parametrize("quant", [False, True])
def test_roles_equal_jax_specs(quant):
    jm = JaxMASt3RModel.create(resolution=64, _test_cfg=JaxMASt3RConfig.tiny())
    tm = tiny_model(params_from_flax(flax_tree(jm.params)))
    if quant:
        jm.quantize_weights("int8", min_elems=1024)
        tm.quantize_weights("int8", min_elems=1024)
    roles = infer_param_shardings(tm.net)
    seen = set()
    for path, leaf in jax.tree_util.tree_flatten_with_path(jm.params)[0]:
        keys = tuple(p.key for p in path)
        name = _port_name(keys)
        want = ROLE[_spec_for(keys, leaf.shape)]
        assert roles[name] == want, (keys, name)
        assert param_role(name, leaf.ndim) == want
        seen.add(name)
    assert seen == set(roles)
    counts = {r: sum(v == r for v in roles.values()) for r in ("column", "row")}
    assert counts["column"] > 0 and counts["row"] > 0
    if quant:
        assert roles["enc_blocks.0.attn.qkv.weight_q"] == "column"
        assert roles["enc_blocks.0.attn.qkv.weight_scale"] == "column"
        assert roles["enc_blocks.0.mlp.fc2.weight_q"] == "row"
        assert roles["enc_blocks.0.mlp.fc2.weight_scale"] == "replicated"


def test_per_head_qkv_split():
    """Rows of a fused qkv weight numbered (which, head, row): rank r of tp
    takes heads [r·H/tp, (r+1)·H/tp) of each of q, k and v."""
    heads, hd, d, tp = 4, 3, 5, 2
    w = torch.arange(3 * heads * hd, dtype=torch.float32)[:, None].repeat(1, d)
    parts = [split_tensor(w, "column", r, tp, heads) for r in range(tp)]
    for r, part in enumerate(parts):
        assert part.shape == (3 * heads // tp * hd, d)
        got = qkv_view(part, heads // tp)[..., 0]
        for which in range(3):
            for h in range(heads // tp):
                head = r * heads // tp + h
                want = torch.arange(hd) + (which * heads + head) * hd
                assert torch.equal(got[which, h], want.float())
    whole = torch.zeros(3, heads, hd, d)
    for r, part in enumerate(parts):
        whole[shard_slices((3, heads), "column", r, tp, heads)] = qkv_view(part, heads // tp)
    assert torch.equal(whole.reshape(-1, d), w)
    with pytest.raises(ValueError, match="heads"):
        split_tensor(w, "column", 0, 3, heads)
    assert torch.equal(split_tensor(w.T, "row", 1, 2), w.T[:, 18:])


@pytest.fixture(scope="module")
def forwards(tmp_path_factory):
    jm = JaxMASt3RModel.create(resolution=64, _test_cfg=JaxMASt3RConfig.tiny())
    state = params_from_flax(flax_tree(jm.params))
    imgs = np.random.default_rng(0).uniform(-1, 1, (2, 48, 64, 3)).astype(np.float32)
    out = {}
    for quant in (False, True):
        tm = tiny_model(state)
        if quant:
            tm.quantize_weights("int8", min_elems=1024)
        with torch.no_grad():
            o1, o2 = tm.net(torch.from_numpy(imgs), torch.from_numpy(imgs))
        ranks = spawn(forward_rank, 2, (state, imgs, quant), device="cpu",
                      workdir=str(tmp_path_factory.mktemp(f"ranks{int(quant)}")))
        out[quant] = (o1["pts3d"], o2["desc"], ranks)
    j1, j2 = jm.reconstruct(jnp.asarray(imgs), jnp.asarray(imgs))
    return out, (np.asarray(j1["pts3d"]), np.asarray(j2["desc"]))


@pytest.mark.parametrize("quant", [False, True])
def test_tp_split_forward_matches_unsharded(forwards, quant):
    out, (j_pts, j_desc) = forwards
    pts, desc, ranks = out[quant]
    for r_pts, r_desc, heads in ranks:
        assert heads == 1
        np.testing.assert_allclose(r_pts.numpy(), pts.numpy(), atol=ATOL, rtol=0)
        np.testing.assert_allclose(r_desc.numpy(), desc.numpy(), atol=ATOL, rtol=0)
        if not quant:
            np.testing.assert_allclose(r_pts.numpy(), j_pts, atol=ATOL, rtol=0)
            np.testing.assert_allclose(r_desc.numpy(), j_desc, atol=ATOL, rtol=0)
