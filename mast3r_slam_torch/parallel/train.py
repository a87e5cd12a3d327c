"""MASt3R fine-tuning: the losses and the sharded (dp, tp) train step (the
port of ``mast3r_slam_tpu/parallel/train.py``).

Losses are JAX's, the DUSt3R / MASt3R objectives:

* pointmaps: confidence-weighted regression, sum conf·||pn - gn|| -
  alpha·log(conf) over valid pixels, both pointmaps scale-normalised by their
  mean valid distance (`_normalized`, per sample);
* descriptors: InfoNCE over the ground-truth correspondences with
  temperature tau, both directions.

The train step. Each dp rank takes its rows of the global batch (every rank
is passed the whole batch, as JAX's step takes a global array). JAX's loss is
one function of the global batch, so its two normalizers (the valid-pixel
count and the valid-correspondence count) sum over every dp shard: the port
all-reduces them (`torch.distributed.nn.functional.all_reduce`, which has a
gradient), each rank's loss is its share of the global loss, and the
gradients summed over dp are the gradient of JAX's loss, also where the
ranks' valid masks differ. Tensor parallelism (`sharding.shard_params`) puts
Megatron's pair of functions around the split layers; the replicated
parameters then get the same gradient on every tp rank, so every gradient is
all-reduced over dp only.

Parameters are f32 master weights computed in the model dtype
(``MASt3RModel.create(master_weights=True)``), as flax computes in
``dtype`` from f32 parameters; there is no autocast. The optimizer is
`torch.optim.AdamW` with optax.adamw's defaults (`adamw`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
import torch.distributed as dist
import torch.nn as nn

from mast3r_slam_torch.parallel.mesh import axis_rank, axis_size


@dataclasses.dataclass
class TrainState:
    """The port's counterpart of JAX's (params, opt_state, step): the
    network holds the parameters, the optimizer its state."""

    net: nn.Module
    optimizer: Any
    step: int = 0


def adamw(params, learning_rate: float = 1e-4) -> torch.optim.AdamW:
    """``optax.adamw(learning_rate)``: betas (0.9, 0.999), eps 1e-8, no
    eps_root, weight decay 1e-4 (torch's default is 1e-2) on every parameter,
    decoupled as in optax (the update adds wd·param before the learning-rate
    scale)."""
    return torch.optim.AdamW(params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=1e-4)


def _sum_over(x: torch.Tensor, group) -> torch.Tensor:
    """x summed over `group` (differentiable); x itself without a group."""
    if group is None:
        return x
    from torch.distributed.nn.functional import all_reduce

    return all_reduce(x, group=group)


def _normalized(pts: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Scale-normalise pointmaps [B, H, W, 3] by their mean valid-point distance."""
    d = torch.linalg.vector_norm(pts, dim=-1, keepdim=True)
    denom = (d * valid).sum(dim=(1, 2, 3), keepdim=True) / torch.clamp(
        valid.sum(dim=(1, 2, 3), keepdim=True), min=1.0)
    return pts / torch.clamp(denom, min=1e-8)


def confidence_regression_loss(pred_pts, conf, gt_pts, valid, alpha: float = 0.2, group=None):
    """Confidence-weighted pointmap loss of one view; `group` sums the
    valid-pixel normalizer over the dp ranks."""
    v = valid.to(pred_pts.dtype)[..., None]
    err = torch.linalg.vector_norm(_normalized(pred_pts, v) - _normalized(gt_pts, v), dim=-1)
    w = v[..., 0]
    per_px = conf * err - alpha * torch.log(conf)
    return (per_px * w).sum() / torch.clamp(_sum_over(w.sum(), group), min=1.0)


def matching_infonce_loss(desc1, desc2, corr_idx1, corr_idx2, corr_valid, tau: float = 0.07,
                          group=None):
    """InfoNCE over sampled ground-truth correspondences: desc1/2 [B, H, W,
    D], corr_idx1/2 [B, M] flat pixel indices, corr_valid [B, M]; `group`
    sums the valid-correspondence normalizer over the dp ranks."""
    b, h, w, d = desc1.shape

    def take(desc, idx):
        return torch.gather(desc.reshape(b, h * w, d), 1, idx.long()[..., None].expand(-1, -1, d))

    sim = torch.einsum("bmd,bnd->bmn", take(desc1, corr_idx1), take(desc2, corr_idx2)) / tau
    diag = sim.diagonal(dim1=1, dim2=2)
    ce_12 = torch.logsumexp(sim, dim=2) - diag
    ce_21 = torch.logsumexp(sim, dim=1) - diag
    v = corr_valid.to(sim.dtype)
    return ((ce_12 + ce_21) * v).sum() / torch.clamp(_sum_over(v.sum(), group), min=1.0) * 0.5


def mast3r_loss(net: nn.Module, batch: dict, alpha: float = 0.2, beta: float = 1.0, group=None):
    """Total loss of a batch of view pairs -> (loss, {"regr", "match"}).

    batch keys: img1, img2 [B, H, W, 3] in [-1, 1]; gt_pts1, gt_pts2 [B, H,
    W, 3] (both in view 1's frame); valid1, valid2 [B, H, W]; corr_idx1,
    corr_idx2 [B, M]; corr_valid [B, M]. With `group` the batch is this
    rank's shard and the loss its share of the loss of the global batch."""
    out1, out2 = net(batch["img1"], batch["img2"])
    l_regr = (confidence_regression_loss(out1["pts3d"], out1["conf"], batch["gt_pts1"],
                                         batch["valid1"], alpha, group)
              + confidence_regression_loss(out2["pts3d"], out2["conf"], batch["gt_pts2"],
                                           batch["valid2"], alpha, group))
    l_match = matching_infonce_loss(out1["desc"], out2["desc"], batch["corr_idx1"],
                                    batch["corr_idx2"], batch["corr_valid"], group=group)
    return l_regr + beta * l_match, {"regr": l_regr, "match": l_match}


def shard_batch(batch: dict, mesh, device) -> dict:
    """This dp rank's rows of a global batch, on `device`."""
    dp = axis_size(mesh, "dp")
    out = {}
    for key, x in batch.items():
        x = torch.as_tensor(x)
        if x.shape[0] % dp:
            raise ValueError(f"batch {x.shape[0]} not divisible by dp axis {dp}")
        n = x.shape[0] // dp
        r = axis_rank(mesh, "dp")
        out[key] = x[r * n:(r + 1) * n].to(device)
    return out


def make_train_step(net: nn.Module, optimizer, mesh=None) -> Callable:
    """The train step over `mesh` (None: one rank): ``step(batch) -> (loss,
    aux)`` with the loss and its two terms of the global batch (detached),
    after one optimizer step. `net` is split over tp already
    (`sharding.shard_params`, as `trainer.train_loop` does)."""
    dp = axis_size(mesh, "dp")
    group = mesh.get_group("dp") if dp > 1 else None
    params = [p for p in net.parameters() if p.requires_grad]
    device = params[0].device

    def step(batch: dict):
        local = shard_batch(batch, mesh, device)
        optimizer.zero_grad(set_to_none=True)
        loss, aux = mast3r_loss(net, local, group=group)
        loss.backward()
        if group is not None:
            grads = [p.grad if p.grad is not None else p.grad.new_zeros(p.shape)
                     for p in params]
            flat = torch.cat([g.reshape(-1) for g in grads])
            dist.all_reduce(flat, group=group)
            for g, part in zip(grads, flat.split([g.numel() for g in grads])):
                g.copy_(part.view_as(g))
        optimizer.step()
        terms = torch.stack([loss.detach(), aux["regr"].detach(), aux["match"].detach()])
        if group is not None:
            dist.all_reduce(terms, group=group)
        return terms[0], {"regr": terms[1], "match": terms[2]}

    return step
