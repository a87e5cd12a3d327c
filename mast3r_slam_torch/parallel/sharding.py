"""Tensor parallelism for the ViT: Megatron's rules (the port of
``mast3r_slam_tpu/parallel/sharding.py``).

Roles, JAX's ``_spec_for`` under the port's names (`param_role`):

* column-parallel, the output axis split: ``qkv``, ``projq``, ``projk``,
  ``projv`` and ``fc1`` weights and their biases;
* row-parallel, the input axis split: ``proj`` and ``fc2`` weights, with one
  all-reduce over "tp" after each; their biases are replicated;
* replicated: everything else (norms, the patch embed, ``decoder_embed``) and
  every layer under a ``head``.

The port keeps weights as torch's [out, in], so JAX's "output axis last"
(``P(None, "tp")``) is torch's axis 0, and JAX's ``P("tp", None)`` its axis 1.
An int8 layer (`models.quant`) splits its int8 values as the weight they
replace; its per-output-row scales are split with a column-parallel weight and
replicated with a row-parallel one (JAX's ``__w8__`` / ``scale`` rule).

The fused ``qkv`` weight is split per head: GSPMD splits JAX's 3·D output axis
into tp contiguous pieces, which do not line up with heads, and makes that
right by resharding. Explicit collectives cannot, so rank r takes heads
[r·H/tp, (r+1)·H/tp) of each of q, k and v: the same function in another
layout. A head count that tp does not divide raises.

`shard_params` splits a built model in place and turns its tensor-parallel
layers into `ColumnParallelLinear` / `RowParallelLinear`, which carry
Megatron's pair of functions: before a column-parallel layer the identity
forward with an all-reduce backward (`copy_to_group`), after a row-parallel
layer the all-reduce forward with the identity backward (`reduce_from_group`).
Both all-reduce in f32.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from mast3r_slam_torch.device import Linear
from mast3r_slam_torch.models.vit import Attention, CrossAttention
from mast3r_slam_torch.parallel.mesh import all_gather, axis_rank, axis_size

COL_PARALLEL = ("qkv", "projq", "projk", "projv", "fc1")  # output axis split
ROW_PARALLEL = ("proj", "fc2")  # input axis split


def param_role(name: str, ndim: int) -> str:
    """"column", "row" or "replicated" for the parameter or buffer `name`
    (of `ndim` dimensions) of the port's network: JAX's `_spec_for`."""
    parts = name.split(".")
    if any("head" in p for p in parts):
        return "replicated"
    leaf, module = parts[-1], parts[-2] if len(parts) >= 2 else ""
    if leaf in ("weight", "weight_q") and ndim == 2:
        if module in COL_PARALLEL:
            return "column"
        if module in ROW_PARALLEL:
            return "row"
    if leaf == "bias" and module in COL_PARALLEL:
        return "column"
    if leaf == "weight_scale" and module in COL_PARALLEL and ndim == 2:
        return "column"
    return "replicated"


def infer_param_shardings(net: nn.Module, mesh=None) -> dict[str, str]:
    """Role of every parameter and buffer of `net` (not yet split), by name:
    JAX's `infer_param_shardings` as roles rather than shardings (the mesh
    does not change them)."""
    tensors = list(net.named_parameters()) + list(net.named_buffers())
    return {name: param_role(name, t.dim()) for name, t in tensors}


def shard_slices(shape, role: str, rank: int, tp: int, heads: int | None = None) -> tuple:
    """The index of rank `rank`'s part of a tensor of `shape` with `role`:
    rows (column), columns (row), all of it (replicated). With `heads`, the
    rows are a fused qkv projection's [3, heads, head_dim] and the part is
    the rank's heads of each of q, k and v (index into the [3, heads, ...]
    view, see `qkv_view`)."""
    if role == "replicated":
        return (slice(None),)
    axis = 0 if role == "column" else 1
    if heads is not None:
        if heads % tp:
            raise ValueError(f"{heads} heads do not split over tp={tp}")
        h = heads // tp
        return (slice(None), slice(rank * h, (rank + 1) * h))
    n = shape[axis]
    if n % tp:
        raise ValueError(f"axis of {n} does not split over tp={tp}")
    part = slice(rank * (n // tp), (rank + 1) * (n // tp))
    return (part,) if axis == 0 else (slice(None), part)


def qkv_view(t: torch.Tensor, heads: int) -> torch.Tensor:
    """A fused qkv weight / bias / scale [3·D, ...] as [3, heads, D/heads, ...]."""
    return t.reshape((3, heads, t.shape[0] // (3 * heads)) + tuple(t.shape[1:]))


def split_tensor(t: torch.Tensor, role: str, rank: int, tp: int,
                 heads: int | None = None) -> torch.Tensor:
    """Rank `rank`'s part of the whole tensor `t` (a contiguous copy)."""
    if heads is None:
        return t[shard_slices(t.shape, role, rank, tp)].contiguous()
    part = qkv_view(t, heads)[shard_slices(t.shape, role, rank, tp, heads)]
    return part.reshape((-1,) + tuple(t.shape[1:])).contiguous()


def unsplit_tensor(local: torch.Tensor, role: str, tp: int, group,
                   heads: int | None = None) -> torch.Tensor:
    """The whole tensor from every rank's part (`split_tensor` undone),
    collectively over `group`."""
    if role == "replicated":
        return local
    if heads is None:
        return all_gather(local, group, 0 if role == "column" else 1)
    whole = all_gather(qkv_view(local, heads // tp), group, 1)
    return whole.reshape((-1,) + tuple(local.shape[1:]))


class _CopyToGroup(torch.autograd.Function):
    """Identity forward, all-reduce (sum) backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromGroup(torch.autograd.Function):
    """All-reduce (sum) forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    return _ReduceFromGroup.apply(x, group)


class ColumnParallelLinear(Linear):
    """This rank's rows of a column-parallel Linear; the input's gradient is
    summed over the tp group."""

    tp_group = None

    def forward(self, x):
        return super().forward(copy_to_group(x, self.tp_group))


class RowParallelLinear(Linear):
    """This rank's columns of a row-parallel Linear: the partial products
    summed over the tp group in f32, the replicated bias added once, then
    rounded to the layer's dtype."""

    tp_group = None

    def forward(self, x):
        w = self.layer_weight()
        y = reduce_from_group(F.linear(x.to(w.dtype), w).float(), self.tp_group)
        b = self.layer_bias()
        return (y if b is None else y + b.float()).to(w.dtype)


def _qkv_heads(net: nn.Module, name: str) -> int | None:
    """The head count of the attention that owns a fused qkv layer `name`."""
    owner, _, leaf = name.rpartition(".")
    mod = net.get_submodule(owner) if owner else net
    return mod.num_heads if leaf == "qkv" and isinstance(mod, Attention) else None


@torch.no_grad()
def shard_params(net: nn.Module, mesh, axis: str = "tp") -> nn.Module:
    """Split `net`'s tensor-parallel layers over the mesh's `axis` in place:
    each rank keeps its part of every column- and row-parallel weight (and
    int8 values and scales), the attention modules their share of the
    heads. A no-op at tp 1 and on a net split before over the same group."""
    tp = axis_size(mesh, axis)
    if tp == 1:
        return net
    rank, group = axis_rank(mesh, axis), mesh.get_group(axis)
    done = getattr(net, "_tp_split", None)
    if done is not None:
        if done != (tp, rank, group):
            raise ValueError(f"{type(net).__name__} is already split over another tp group")
        return net
    for name, mod in net.named_modules():
        if isinstance(mod, (Attention, CrossAttention)) and "head" not in name:
            if mod.num_heads % tp:
                raise ValueError(f"{name}: {mod.num_heads} heads do not split over tp={tp}")
    for name, mod in list(net.named_modules()):
        if not isinstance(mod, Linear):
            continue
        quant = mod.quant_dtype is not None
        role = param_role(f"{name}.{'weight_q' if quant else 'weight'}", 2)
        if role == "replicated":
            continue
        heads = _qkv_heads(net, name)
        if quant:
            mod.weight_q = split_tensor(mod.weight_q, role, rank, tp, heads)
            mod.weight_scale = split_tensor(mod.weight_scale, param_role(
                f"{name}.weight_scale", 2), rank, tp, heads)
            n_out, n_in = mod.weight_q.shape
        else:
            mod.weight = nn.Parameter(split_tensor(mod.weight, role, rank, tp, heads))
            n_out, n_in = mod.weight.shape
        if mod.bias is not None:
            mod.bias = nn.Parameter(split_tensor(mod.bias, param_role(f"{name}.bias", 1),
                                                 rank, tp, heads))
        mod.out_features, mod.in_features = n_out, n_in
        mod.__class__ = ColumnParallelLinear if role == "column" else RowParallelLinear
        mod.tp_group = group
    for name, mod in net.named_modules():
        if isinstance(mod, (Attention, CrossAttention)) and "head" not in name:
            mod.num_heads //= tp
    net._tp_split = (tp, rank, group)
    return net


def tp_layout(net: nn.Module) -> dict[str, tuple[str, int | None]]:
    """(role, qkv head count of the whole layer or None) of every parameter
    and buffer of a net split by `shard_params` (every role "replicated"
    on a net that is not split)."""
    split = getattr(net, "_tp_split", None)
    tp = 1 if split is None else split[0]
    out = {}
    for name, t in list(net.named_parameters()) + list(net.named_buffers()):
        role = param_role(name, t.dim()) if split is not None else "replicated"
        owner = name.rpartition(".")[0]
        heads = _qkv_heads(net, owner) if role != "replicated" else None
        out[name] = (role, None if heads is None else heads * tp)
    return out
