"""Several hosts: the process group, a global mesh, and the batch fan-out
(the port of ``mast3r_slam_tpu/parallel/multihost.py``).

In JAX one process per host drives all of its chips. In the port one process
drives one card, so a host runs several ranks, and ranks are numbered host by
host (as ``torchrun --nnodes H --nproc-per-node L`` numbers them): rank r
lives on host r // L, where L is the ranks per host.

* `initialize` joins the process group over ``tcp://`` (every process calls
  it with its own rank).
* `make_global_mesh` is a (dp, tp) mesh over every rank in which tp never
  crosses a host: tensor-parallel all-reduces are latency-bound and stay on a
  host's NVLink, and hosts stack along dp, so only dp reductions cross hosts.
* `host_local_batch_to_global` / `global_array_to_host_local` convert
  between a rank's own shard of a batch and the global batch. The global
  batch is a plain tensor, whole on every rank, rather than a `DTensor` with
  a ``Shard(0)`` placement: every consumer in the port (`BatchTracker`, the
  train step, the sharded graph solve) takes the global batch on every rank
  and slices its own rows, as JAX's sharded programs take a global array, so
  a DTensor would be materialised at once anyway. The gather is one
  all-gather (`mesh.all_gather`).
* `broadcast_from_host0`, `sync` (a barrier) and `replicated_sharding`.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from mast3r_slam_torch.device import resolve_device
from mast3r_slam_torch.parallel.mesh import (_device_mesh, all_gather, axis_rank, axis_size,
                                             init_distributed, mesh_shape)

_LOCAL_WORLD: int | None = None  # ranks per host, set by initialize


def initialize(coordinator_address: str, num_processes: int, process_id: int,
               local_device_ids: Optional[Sequence[int]] = None,
               local_world_size: Optional[int] = None, backend: str | None = None,
               device: str | torch.device | None = None) -> torch.device:
    """Join the process group of `num_processes` ranks at
    ``tcp://coordinator_address`` ("host:port" of rank 0; an address with a
    scheme, such as ``file://``, is taken as it is) as rank
    `process_id` -> this rank's device. `device` defaults to the card and
    raises without CUDA (pass ``device="cpu"`` for the CPU).
    `local_device_ids` names the card of this rank
    (``cuda:local_device_ids[0]``; default: its local rank);
    `local_world_size` is the ranks per host (default ``LOCAL_WORLD_SIZE`` as
    torchrun sets it, else every rank on one host). Call once per process."""
    global _LOCAL_WORLD
    if local_world_size is None:
        local_world_size = int(os.environ.get("LOCAL_WORLD_SIZE", num_processes))
    if num_processes % local_world_size:
        raise ValueError(f"{num_processes} ranks do not fill hosts of {local_world_size}")
    local_rank = process_id % local_world_size
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        card = local_device_ids[0] if local_device_ids else local_rank
        device = torch.device("cuda", card % torch.cuda.device_count())
    address = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    dev = init_distributed(process_id, num_processes, address,
                           backend=backend, device=device, local_rank=local_rank)
    _LOCAL_WORLD = local_world_size
    return dev


def local_world_size() -> int:
    """Ranks per host (every rank on one host before `initialize`)."""
    return _LOCAL_WORLD if _LOCAL_WORLD is not None else dist.get_world_size()


def make_global_mesh(tp: Optional[int] = None, axis_names: tuple[str, str] = ("dp", "tp")):
    """(dp, tp) `DeviceMesh` over every rank, tp inside one host: tp
    defaults to the largest of 4 and 2 that divides both the ranks per host
    and the world, and raises where it does not divide the ranks per host."""
    world, local = dist.get_world_size(), local_world_size()
    if tp is None:
        tp = next((c for c in (4, 2) if local % c == 0 and world % c == 0), 1)
    if local % tp:
        raise ValueError(f"tp={tp} must divide the ranks per host {local} so that "
                         "tensor-parallel collectives never cross hosts")
    return _device_mesh(mesh_shape(world, tp), tuple(axis_names))


def _shard_axes(mesh, spec) -> tuple[int, int, object]:
    """(index of this rank's shard, shard count, group) for the mesh axes
    `spec` ("dp", or ("dp", "tp") for one shard per rank)."""
    axes = (spec,) if isinstance(spec, str) else tuple(spec)
    if axes == ("dp",):
        return axis_rank(mesh, "dp"), axis_size(mesh, "dp"), mesh.get_group("dp")
    if axes == tuple(mesh.mesh_dim_names):
        index = 0
        for name in axes:
            index = index * axis_size(mesh, name) + axis_rank(mesh, name)
        return index, dist.get_world_size(), dist.group.WORLD
    raise ValueError(f"unsupported batch spec {spec!r} on a mesh {mesh.mesh_dim_names}")


def host_local_batch_to_global(x: torch.Tensor, mesh, spec="dp") -> torch.Tensor:
    """This rank's shard of a batch -> the global batch, the shards stacked
    along dim 0 in mesh order, on every rank. With spec "dp" the ranks of one
    tp group pass the same shard; with the mesh's own axes every rank passes
    its own."""
    return all_gather(x, _shard_axes(mesh, spec)[2])


def global_array_to_host_local(x: torch.Tensor, mesh, spec="dp") -> torch.Tensor:
    """The inverse: this rank's rows of the global batch `x`."""
    index, count, _ = _shard_axes(mesh, spec)
    if x.shape[0] % count:
        raise ValueError(f"batch {x.shape[0]} not divisible into {count} shards")
    n = x.shape[0] // count
    return x[index * n:(index + 1) * n]


def broadcast_from_host0(tree):
    """Rank 0's value of `tree` (tensors, arrays, scalars and containers of
    them) on every rank."""
    obj = [tree if dist.get_rank() == 0 else None]
    dist.broadcast_object_list(obj, src=0)
    return obj[0]


def sync(tag: str = "barrier") -> None:
    """A barrier over every rank (`tag` names it in errors only)."""
    dist.barrier()


def replicated_sharding(mesh):
    """DTensor placements that replicate over every axis of `mesh` (JAX's
    ``NamedSharding(mesh, P())``)."""
    from torch.distributed.tensor import Replicate

    return [Replicate()] * mesh.ndim
