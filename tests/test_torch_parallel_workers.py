"""Rank bodies of the port's multi-rank tests (tests/test_torch_parallel_*.py,
_multihost.py, _train.py): each runs in its own process, started by
`mast3r_slam_torch.parallel.mesh.spawn` in a gloo process group on the CPU,
and returns what its test compares. This module imports torch and the port
only, so that a rank starts without jax; it holds no tests."""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from mast3r_slam_torch import config as torch_config
from mast3r_slam_torch.models import MASt3RConfig, MASt3RModel
from mast3r_slam_torch.parallel import mesh as pmesh


def tiny_model(state: dict, cfg: MASt3RConfig | None = None, resolution: int = 64, **kw):
    """The port's tiny model on the CPU with the weights `state`."""
    m = MASt3RModel.create(cfg=cfg or MASt3RConfig.tiny(), head_type="linear",
                           resolution=resolution, device="cpu", **kw)
    m.load_state_dict(state)
    return m


def _raises(fn, exc=ValueError) -> bool:
    try:
        fn()
    except exc:
        return True
    return False


# -- serving and the sharded graph solve ----------------------------------------


def serving_run(model, mesh, inputs: dict, microbatch: int) -> dict:
    """The serving script of tests/test_torch_parallel_serving.py on one
    BatchTracker: two feature-fed steps, a promotion of streams 1 and 2, a
    closed and reopened slot 3, one image-fed step -> every result."""
    from mast3r_slam_torch.serving import BatchTracker

    f = lambda k: torch.from_numpy(inputs[k])  # noqa: E731
    bt = BatchTracker(model, mesh=mesh, microbatch=microbatch)
    bt.init_from_keyframes(f("kf_feat"), f("kf_pos"), f("kf_X"), f("kf_C"))
    out = {}
    for step in range(2):
        r = bt.resolve_stats(bt.step_async(f(f"feat{step}"), f(f"pos{step}")))
        out[f"stats{step}"] = r["match_frac"]
        out[f"tracked{step}"] = r["tracked"]
        out[f"poses{step}"] = r["poses"].clone()
    bt.update_keyframes([1, 2], f("kf_feat")[[2, 1]], f("kf_pos")[[2, 1]], f("kf_X")[[2, 1]],
                        f("kf_C")[[2, 1]])
    out["closed"] = torch.from_numpy(bt.close_slot(3))
    bt.open_slot(3, f("kf_feat")[0], f("kf_pos")[0], f("kf_X")[0], f("kf_C")[0])
    r = bt.resolve_stats(bt.step_images_async(f("imgs")))
    out["stats_img"], out["tracked_img"], out["poses_img"] = r["match_frac"], r["tracked"], r["poses"]
    s = bt.global_state()
    out.update({k: getattr(s, k).clone() for k in ("T_WC", "kf_X", "kf_C", "kf_N", "fr_X", "kf_T")})
    return out


def serving_rank(rank, state, settings, inputs, tp, microbatch, solve=None):
    """BatchTracker over make_mesh(tp=tp) (and, with `solve`, the sharded
    graph solves at dp = world) -> results and the error checks."""
    from mast3r_slam_torch.parallel.mesh import make_mesh

    torch_config.set_config(torch_config.Config.from_dict(settings))
    out = {}
    mesh = make_mesh(tp=tp)
    dp = pmesh.axis_size(mesh, "dp")
    if dp > 1:
        from mast3r_slam_torch.serving import BatchTracker

        model = tiny_model(state)
        out["odd_batch_raises"] = _raises(lambda: BatchTracker(model, mesh=mesh).init_from_keyframes(
            torch.zeros(dp + 1, 2, 2), None, None, None))
        out["microbatch_raises"] = _raises(lambda: BatchTracker(model, mesh=mesh,
                                                                microbatch=dp + 1))
    model = tiny_model(state)
    out["serving"] = serving_run(model, mesh, inputs, microbatch)
    out["heads"] = model.net.enc_blocks[0].attn.num_heads
    if solve is not None:
        out["solve"] = solve_checks(make_mesh(tp=1), solve)
    return out


def solve_checks(mesh, problems: dict) -> dict:
    """The rays and calib graph solves sharded over dp, FactorGraph's
    padding and its sharded solve against its unsharded one on this rank."""
    from mast3r_slam_torch.ops.gauss_newton import GNParams, gauss_newton_graph

    out = {}
    for mode, prob in problems.items():
        t = {k: torch.from_numpy(np.asarray(v)) for k, v in prob.items() if k != "img_size"}
        args = (t["Twc0"], t["Xs"], t["Cs"], t["ii"], t["jj"], t["idx"], t["valid"], t["Q"],
                t["edge_mask"], t["free"])
        kw = dict(mode=mode, K_intr=t.get("K"), img_size=tuple(prob["img_size"]),
                  params=GNParams(max_iter=10, pixel_border=1))
        out[mode] = gauss_newton_graph(*args, mesh=mesh, **kw)[0]
        out[f"{mode}+bf16"] = gauss_newton_graph(*args, mesh=mesh, variant="noconcat+bf16",
                                                 **kw)[0]
        cut = [a[:-1] if i in (3, 4, 5, 6, 7, 8) else a for i, a in enumerate(args)]
        out[f"{mode}_odd_edges_raise"] = _raises(lambda: gauss_newton_graph(*cut, mesh=mesh, **kw))
    out["factor_graph"] = factor_graph_check(mesh, problems["rays"])
    return out


def factor_graph_check(mesh, prob) -> dict:
    """A FactorGraph holding the problem's edges (one way; the solve adds the
    reverse): its padded solve arguments, and its sharded rays solve against
    the same graph unsharded."""
    from mast3r_slam_torch.frame import Keyframes
    from mast3r_slam_torch.global_opt import FactorGraph

    torch_config.set_config(torch_config.Config.from_dict({"local_opt": {"pin": 1,
                                                                         "max_edges": 16}}))
    h, w = prob["img_size"]
    k = prob["Xs"].shape[0]
    out = {}
    for name, m in (("sharded", mesh), ("unsharded", None)):
        kf = Keyframes(h, w, capacity=k, device="cpu")
        kf.X[:k] = torch.from_numpy(np.asarray(prob["Xs"]))
        kf.C[:k] = torch.from_numpy(np.asarray(prob["Cs"]))[..., None]
        kf.N[:k] = 1.0
        kf.T_WC[:k] = torch.from_numpy(np.asarray(prob["Twc0"]))
        kf.frame_ids = list(range(k))
        g = FactorGraph(None, kf, mesh=m)
        e = 3  # three edges, two ways: 6 -> padded to a multiple of dp
        g.ii[:e], g.jj[:e] = np.asarray(prob["ii"])[:e], np.asarray(prob["jj"])[:e]
        idx = torch.from_numpy(np.asarray(prob["idx"])[:e]).long()
        g.idx_ii2jj[:e] = idx
        g.idx_jj2ii[:e] = torch.argsort(idx, dim=1)
        g.valid_match_j[:e] = True
        g.valid_match_i[:e] = True
        g.Q_ii2jj[:e] = 4.0
        g.Q_jj2ii[:e] = 4.0
        g.n_edges = e
        prep = g._prepare_solve()
        out[f"{name}_edges"] = int(prep["ii"].shape[0])
        out[f"{name}_mask"] = prep["edge_mask"].clone()
        g.solve_GN_rays()
        out[f"{name}_T"] = kf.T_WC[:k].clone()
    return out


# -- encodes ---------------------------------------------------------------------


def encode_rank(rank, state, cfg_kw, imgs, cases):
    """The pipelined and sequence-parallel encodes of `cases` (each
    ("pp", stages, M) or ("sp", dp, sp, batch_axis)) -> tokens per case."""
    from mast3r_slam_torch.parallel.mesh import make_mesh
    from mast3r_slam_torch.parallel.pipeline import make_pipeline_mesh, pipelined_encode
    from mast3r_slam_torch.parallel.sequence import sequence_parallel_encode

    cfg = MASt3RConfig(**cfg_kw)
    model = tiny_model(state, cfg, resolution=32)
    x = torch.from_numpy(imgs)
    out = {}
    for case in cases:
        if case[0] == "pp":
            _, stages, m = case
            mesh = make_pipeline_mesh(stages)
            out[case] = pipelined_encode(cfg, model, x, mesh, m)
            out[(case, "odd")] = _raises(lambda: pipelined_encode(cfg, model, x[:3], mesh, 2))
        else:
            _, dp, sp, batch_axis = case
            mesh = make_mesh(dp * sp, tp=sp, axis_names=("dp", "sp"))
            out[case] = sequence_parallel_encode(cfg, model, x, mesh, batch_axis=batch_axis)
    return out


# -- several hosts ---------------------------------------------------------------


def multihost_rank(rank, world, hosts, init_method):
    """tests/multihost_worker.py's checks on `hosts` hosts of world/hosts
    ranks each, joined through `multihost.initialize`."""
    from mast3r_slam_torch.parallel import multihost

    multihost.initialize(init_method, world, rank, local_world_size=world // hosts,
                         backend="gloo", device="cpu")
    try:
        res = {"rank": rank}
        mesh = multihost.make_global_mesh()
        res["mesh_shape"] = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
        tp_ranks = dist.get_process_group_ranks(mesh.get_group("tp"))
        res["tp_ranks"] = tp_ranks
        local = world // hosts
        res["tp_in_one_host"] = len({r // local for r in tp_ranks}) == 1
        res["cross_host_tp_raises"] = _raises(lambda: multihost.make_global_mesh(tp=2 * local))
        # A sum over every rank, tp then dp: each rank adds rank + 1.
        x = torch.tensor([rank + 1.0])
        dist.all_reduce(x, group=mesh.get_group("tp"))
        dist.all_reduce(x, group=mesh.get_group("dp"))
        res["psum"] = float(x)
        # One shard per rank, through the mesh's own axes.
        g = multihost.host_local_batch_to_global(torch.tensor([rank + 1.0]), mesh, ("dp", "tp"))
        res["gathered"] = g.tolist()
        # The dp fan-out round trip (the serving pattern): dp index d owns 2
        # sequences of a [B, 4, 3] batch; the ranks of a tp group pass the same.
        d = pmesh.axis_rank(mesh, "dp")
        x_local = torch.arange(24, dtype=torch.float32).reshape(2, 4, 3) + 100.0 * d
        xg = multihost.host_local_batch_to_global(x_local, mesh)
        yg = (xg * 2.0).sum(dim=(1, 2))
        y_local = multihost.global_array_to_host_local(yg, mesh)
        res["global_shape"] = list(xg.shape)
        res["fanout_ok"] = bool(torch.allclose(y_local, (x_local * 2.0).sum(dim=(1, 2))))
        res["broadcast"] = float(multihost.broadcast_from_host0(np.float32(7.0 * rank + 3.0)))
        res["replicated"] = [type(p).__name__ for p in multihost.replicated_sharding(mesh)]
        multihost.sync("done")
        return res
    finally:
        dist.destroy_process_group()


# -- training --------------------------------------------------------------------


def train_rank(rank, state, batches, tp, steps):
    """`steps` train steps of the tiny model over make_mesh(tp=tp) -> the
    losses and every parameter gathered whole."""
    from mast3r_slam_torch.parallel.mesh import make_mesh
    from mast3r_slam_torch.parallel.sharding import shard_params, tp_layout, unsplit_tensor
    from mast3r_slam_torch.parallel.train import adamw, make_train_step

    mesh = make_mesh(tp=tp)
    model = tiny_model(state, master_weights=True)
    net = shard_params(model.net, mesh)
    opt = adamw(net.parameters())
    step = make_train_step(net, opt, mesh)
    layout = tp_layout(net)
    g = mesh.get_group("tp")

    def whole(get):
        return {name: unsplit_tensor(get(p).detach(), *layout[name][:1], tp, g,
                                     layout[name][1]) for name, p in net.named_parameters()}

    losses, grads = [], []
    for i in range(steps):
        loss, aux = step(batches[i])
        losses.append((float(loss), float(aux["regr"]), float(aux["match"])))
        grads.append(whole(lambda p: p.grad))
    return {"losses": losses, "grads": grads, "params": whole(lambda p: p)}


def forward_rank(rank, state, imgs, quant):
    """The tiny model's two-view forward split over tp = world (int8 weights
    with `quant`) -> (view 1's pts3d, view 2's desc, encoder heads per rank)."""
    from mast3r_slam_torch.parallel.mesh import make_mesh
    from mast3r_slam_torch.parallel.sharding import shard_params

    model = tiny_model(state)
    if quant:
        model.quantize_weights("int8", min_elems=1024)
    shard_params(model.net, make_mesh(tp=dist.get_world_size()))
    x = torch.from_numpy(imgs)
    with torch.no_grad():
        out1, out2 = model.net(x, x)
    return out1["pts3d"], out2["desc"], model.net.enc_blocks[0].attn.num_heads
