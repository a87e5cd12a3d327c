"""Training driver: synthetic data, checkpoints in JAX's layout, the loop and
its command line (the port of ``mast3r_slam_tpu/parallel/trainer.py``).

* `synthetic_pair_batch` draws JAX's numbers from the same numpy generator
  (a smooth random surface rendered as its normal map, a lightly perturbed
  second view, identity correspondences), so both packages train on the
  same batch from one seed.
* `save_train_ckpt` / `load_train_ckpt` write and read JAX's file: an .npz
  with the parameters as ``p{i}`` in flax's flatten order and layout, the
  optimizer state as ``o{i}`` (optax's Adam count, then every mu, then every
  nu, each in the parameters' order) and ``step``. The weight map of
  `models.io` (`flax_order`, `to_flax_layout`) carries names and layouts;
  torch's AdamW ``exp_avg`` / ``exp_avg_sq`` / ``step`` are optax's mu / nu /
  count. Tensor-parallel parts are gathered to whole tensors on save and
  split again on load, so a file is the same whatever the mesh.
* `train_loop` steps the optimizer from a copy of the model's network,
  resuming from a checkpoint that exists.
* The command line, ``python -m mast3r_slam_torch.parallel.trainer --steps 3
  [--devices N] [--tp T] [--resolution 512 --weights PATH]``: with
  ``--devices N`` it starts N gloo ranks on the CPU (JAX's virtual mesh);
  without it every process is one rank on its card, as ``torchrun
  --nproc-per-node N`` starts them (one rank when run alone).
  ``--resolution 0`` trains JAX's tiny trainer model (128 wide, 2 + 2
  blocks, 4 heads, f32); ``--resolution 512`` mast3r_full in bf16 with f32
  master weights.
"""

from __future__ import annotations

import copy
import os
import sys
from pathlib import Path
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from mast3r_slam_torch.models.io import _to_torch_layout, flax_order, to_flax_layout
from mast3r_slam_torch.parallel.mesh import axis_rank, axis_size
from mast3r_slam_torch.parallel.sharding import shard_params, split_tensor, tp_layout, unsplit_tensor
from mast3r_slam_torch.parallel.train import adamw, make_train_step


def synthetic_pair_batch(rng: np.random.Generator, b: int, h: int, w: int, m: int) -> dict:
    """Geometric two-view pairs (JAX's draws, as CPU tensors): a smooth
    random surface rendered as its normal map, the second view perturbed by
    noise, both ground-truth pointmaps in view 1's frame, m correspondences
    per pair sampled without replacement (identity pairing)."""
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    xs = (xs - w / 2) / max(w, 1)
    ys = (ys - h / 2) / max(h, 1)
    imgs1, imgs2, pts = [], [], []
    for _ in range(b):
        a1, a2 = rng.uniform(2, 6, 2)
        p1, p2 = rng.uniform(0, 2 * np.pi, 2)
        z = 2.0 + 0.4 * np.sin(a1 * xs + p1) * np.cos(a2 * ys + p2)
        X = np.stack([xs * z, ys * z, z], -1)
        gx = np.gradient(z, axis=1)
        gy = np.gradient(z, axis=0)
        nrm = np.stack([-gx, -gy, np.ones_like(z)], -1)
        nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
        img = nrm.astype(np.float32)
        imgs1.append(img + rng.normal(0, 0.02, img.shape).astype(np.float32))
        imgs2.append(img + rng.normal(0, 0.02, img.shape).astype(np.float32))
        pts.append(X.astype(np.float32))
    idx = np.stack([rng.choice(h * w, size=m, replace=False) for _ in range(b)])
    pts = torch.from_numpy(np.stack(pts))
    return dict(
        img1=torch.from_numpy(np.stack(imgs1)), img2=torch.from_numpy(np.stack(imgs2)),
        gt_pts1=pts, gt_pts2=pts.clone(),
        valid1=torch.ones((b, h, w), dtype=torch.bool), valid2=torch.ones((b, h, w), dtype=torch.bool),
        corr_idx1=torch.from_numpy(idx.astype(np.int32)),
        corr_idx2=torch.from_numpy(idx.astype(np.int32)),
        corr_valid=torch.ones((b, m), dtype=torch.bool),
    )


def _tp(net, mesh):
    tp = axis_size(mesh, "tp") if getattr(net, "_tp_split", None) is not None else 1
    return tp, axis_rank(mesh, "tp"), (mesh.get_group("tp") if tp > 1 else None)


def save_train_ckpt(path, net, optimizer, step: int, mesh=None) -> None:
    """Write `net`'s parameters and the AdamW state in JAX's layout (see the
    module docstring), uncompressed (f32 weights barely compress; JAX's
    loader reads either form). Collective where `net` is split over tp; rank
    0 writes (the others wait for the file)."""
    tp, _, group = _tp(net, mesh)
    layout = tp_layout(net)
    params = dict(net.named_parameters())
    order = flax_order(net)
    n = len(order)
    arrays, count = {}, 0

    def whole(name, t):
        role, heads = layout[name]
        if tp > 1 and role != "replicated":
            t = unsplit_tensor(t, role, tp, group, heads)
        return to_flax_layout(name, t.detach().float().cpu().numpy())

    for i, (name, _) in enumerate(order):
        p = params[name]
        state = optimizer.state.get(p, {})
        arrays[f"p{i}"] = whole(name, p)
        arrays[f"o{1 + i}"] = whole(name, state.get("exp_avg", torch.zeros_like(p)))
        arrays[f"o{1 + n + i}"] = whole(name, state.get("exp_avg_sq", torch.zeros_like(p)))
        count = int(state["step"]) if "step" in state else count
    arrays["o0"] = np.asarray(count, np.int32)
    arrays["step"] = np.asarray(step)
    distributed = dist.is_available() and dist.is_initialized()
    if not distributed or dist.get_rank() == 0:
        tmp = str(path) + ".tmp.npz"
        np.savez(tmp, **arrays)
        Path(tmp).rename(path)
    if distributed:
        dist.barrier()


@torch.no_grad()
def load_train_ckpt(path, net, optimizer, mesh=None) -> int:
    """Load a checkpoint of `save_train_ckpt` or of JAX's `save_train_ckpt`
    into `net` and `optimizer` (this rank's parts where `net` is split over
    tp) -> the step it was saved at."""
    tp, rank, _ = _tp(net, mesh)
    layout = tp_layout(net)
    params = dict(net.named_parameters())
    order = flax_order(net)
    n = len(order)
    z = np.load(path)
    count = float(z["o0"])

    def local(key, name, like):
        arr = _to_torch_layout(name, np.asarray(z[key], np.float32))
        t = torch.from_numpy(np.ascontiguousarray(arr))
        role, heads = layout[name]
        if tp > 1 and role != "replicated":
            t = split_tensor(t, role, rank, tp, heads)
        if tuple(t.shape) != tuple(like.shape):
            raise ValueError(f"checkpoint leaf {key} ({name}): shape {tuple(t.shape)} != "
                             f"{tuple(like.shape)}")
        return t.to(device=like.device, dtype=like.dtype)

    for i, (name, _) in enumerate(order):
        p = params[name]
        p.copy_(local(f"p{i}", name, p))
        optimizer.state[p] = {"step": torch.tensor(count, dtype=torch.float32),
                              "exp_avg": local(f"o{1 + i}", name, p),
                              "exp_avg_sq": local(f"o{1 + n + i}", name, p)}
    return int(z["step"])


def train_loop(model, mesh, steps: int, batch_fn: Callable[[int], dict],
               learning_rate: float = 1e-4, ckpt_path: str | None = None, save_every: int = 0,
               log: Callable[[str], None] = lambda s: print(s, file=sys.stderr)):
    """Run steps [start, steps) of AdamW on a copy of `model`'s network (the
    model itself is left as it is), split over the mesh's tp axis, each
    batch ``batch_fn(i)`` (the global batch) sharded over dp; resume from
    `ckpt_path` where it exists, save there every `save_every` steps and at
    the end -> (the trained network,
    the losses of the steps run)."""
    net = copy.deepcopy(getattr(model, "net", model))
    shard_params(net, mesh)
    opt = adamw(net.parameters(), learning_rate)
    start = 0
    if ckpt_path and Path(ckpt_path).exists():
        start = load_train_ckpt(ckpt_path, net, opt, mesh)
        log(f"[train] resumed from {ckpt_path} at step {start}")
    step_fn = make_train_step(net, opt, mesh)
    losses = []
    for i in range(start, steps):
        loss, aux = step_fn(batch_fn(i))
        loss = float(loss)
        if not np.isfinite(loss):
            raise FloatingPointError(f"non-finite loss at step {i}")
        losses.append(loss)
        log(f"[train] step {i} loss={loss:.4f} regr={float(aux['regr']):.4f} "
            f"match={float(aux['match']):.4f}")
        if ckpt_path and save_every and (i + 1) % save_every == 0:
            save_train_ckpt(ckpt_path, net, opt, i + 1, mesh)
    if ckpt_path:
        save_train_ckpt(ckpt_path, net, opt, steps, mesh)
    return net, losses


def trainer_model(resolution: int, weights: str = "", device=None):
    """The CLI's model: JAX's tiny trainer model at resolution 0 (f32), else
    mast3r_full at `resolution` in bf16 with f32 master weights, from
    `weights` where given."""
    from mast3r_slam_torch.models import MASt3RConfig, MASt3RModel

    if resolution:
        return MASt3RModel.create(resolution=resolution, checkpoint=weights or None,
                                  device=device, master_weights=True)
    cfg = MASt3RConfig(enc_embed_dim=128, enc_depth=2, enc_num_heads=4, patch_size=16,
                       dec_embed_dim=96, dec_depth=2, dec_num_heads=4, head_type="linear",
                       dtype=torch.float32)
    return MASt3RModel.create(cfg=cfg, resolution=64, device=device, master_weights=True)


def _run(rank, args) -> list:
    from mast3r_slam_torch.parallel.mesh import make_mesh, rank_device

    model = trainer_model(args.resolution, args.weights, rank_device())
    mesh = make_mesh(tp=args.tp or None)
    h, w = model.out_hw
    b = args.batch or 2 * axis_size(mesh, "dp")
    rng = np.random.default_rng(0)
    log = (lambda s: print(s, file=sys.stderr)) if dist.get_rank() == 0 else (lambda s: None)
    _, losses = train_loop(model, mesh, args.steps,
                           lambda i: synthetic_pair_batch(rng, b, h, w, m=16),
                           learning_rate=args.lr, ckpt_path=args.ckpt or None,
                           save_every=args.save_every, log=log)
    return losses


def main(argv=None) -> int:
    import argparse
    import tempfile

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--batch", type=int, default=0, help="0 = 2 per dp shard")
    ap.add_argument("--devices", type=int, default=0,
                    help="start N gloo ranks on the CPU (0 = this process is one rank on its card)")
    ap.add_argument("--tp", type=int, default=0, help="tensor-parallel axis (0 = auto)")
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--ckpt", default="", help="checkpoint path (resume if exists)")
    ap.add_argument("--save-every", type=int, default=0)
    ap.add_argument("--resolution", type=int, default=0,
                    help="full model resolution (0 = tiny test model)")
    ap.add_argument("--weights", default="", help="initial checkpoint (safetensors/npz)")
    args = ap.parse_args(argv)

    if args.devices:
        from mast3r_slam_torch.parallel.mesh import spawn

        losses = spawn(_run, args.devices, (args,), backend="gloo", device="cpu")[0]
    else:
        from mast3r_slam_torch.parallel.mesh import init_distributed

        if "RANK" in os.environ:
            init_distributed()
        else:  # run alone: a process group of one rank
            init_distributed(0, 1, "file://" + os.path.join(tempfile.mkdtemp(), "init"))
        rank = dist.get_rank()
        try:
            losses = _run(rank, args)
        finally:
            dist.destroy_process_group()
        if rank:
            return 0
    print(f"final loss {losses[-1]:.4f} over {len(losses)} steps")
    return 0


if __name__ == "__main__":
    sys.exit(main())
