"""Process groups and device meshes (the port of
``mast3r_slam_tpu/parallel/mesh.py``).

JAX's mesh is a grid of devices driven by one program. The port's is a grid of
ranks, one process per card, joined in a `torch.distributed` process group,
and described by a `DeviceMesh` whose dimension names are JAX's axis names
(("dp", "tp"), ("pp",) or ("dp", "sp")). Each parallel path takes the group of
its axis from the mesh and calls its collectives itself.

* `mesh_shape` is JAX's shape rule, a pure function: tp is the largest of 4
  and 2 that divides n, and dp is the rest.
* `init_distributed` joins the process group and picks the rank's device and
  backend: NCCL for CUDA, gloo for the CPU, or gloo where the caller asks for
  it (two ranks on one card: NCCL refuses two ranks on one device). The
  device is the card unless the caller passes ``device="cpu"``; without
  CUDA it raises, as `device.resolve_device` does.
* `make_mesh` builds the ("dp", "tp") mesh over every rank of the group.
* `spawn` starts ranks on this host, each in its own process (the tests, the
  trainer's ``--devices N`` and chip_smoke.py use it; ``torchrun`` starts
  them otherwise).
* `all_gather` is the one gather the paths share (serving, multihost, the
  tp unsplit and sequence parallelism): every rank's shard along a dimension,
  concatenated in group-rank order. NCCL and gloo both carry it for CUDA
  tensors.
"""

from __future__ import annotations

import os
import tempfile

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from mast3r_slam_torch.device import resolve_device

_DEVICE: torch.device | None = None  # this rank's device, set by init_distributed


def mesh_shape(n_devices: int, tp: int | None = None) -> tuple[int, int]:
    """(dp, tp) of JAX's `make_mesh`: tp defaults to the largest of 4 and 2
    that divides `n_devices` (else 1); dp takes the rest."""
    if tp is None:
        tp = next((c for c in (4, 2) if n_devices % c == 0), 1)
    if tp < 1 or n_devices % tp:
        raise ValueError(f"tp={tp} does not divide {n_devices} devices")
    return n_devices // tp, tp


def init_distributed(rank: int | None = None, world_size: int | None = None,
                     init_method: str | None = None, backend: str | None = None,
                     device: str | torch.device | None = None,
                     local_rank: int | None = None) -> torch.device:
    """Join the default process group -> this rank's device.

    Missing arguments come from ``torchrun``'s environment (RANK, WORLD_SIZE,
    LOCAL_RANK, MASTER_ADDR/MASTER_PORT through ``env://``). `device`
    defaults to the card, and raises without CUDA (pass ``device="cpu"`` for
    the CPU): ``cuda:{local_rank}``, or ``cuda:0`` when ranks share one card
    (local_rank modulo the card count). `backend` defaults to NCCL on the card
    and gloo on the CPU."""
    global _DEVICE
    env = os.environ
    rank = int(env.get("RANK", 0)) if rank is None else rank
    world_size = int(env.get("WORLD_SIZE", 1)) if world_size is None else world_size
    local_rank = int(env.get("LOCAL_RANK", rank)) if local_rank is None else local_rank
    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=init_method or "env://", rank=rank,
                            world_size=world_size)
    _DEVICE = dev
    return dev


def rank_device() -> torch.device:
    """The device `init_distributed` picked for this rank (the CPU before it)."""
    return _DEVICE if _DEVICE is not None else torch.device("cpu")


def _device_mesh(shape: tuple[int, ...], names: tuple[str, ...]) -> DeviceMesh:
    world = dist.get_world_size()
    if int(torch.tensor(shape).prod()) != world:
        raise ValueError(f"a mesh {dict(zip(names, shape))} must span the {world} ranks of the "
                         "process group")
    return init_device_mesh(rank_device().type, shape, mesh_dim_names=names)


def make_mesh(n_devices: int | None = None, tp: int | None = None,
              axis_names: tuple[str, str] = ("dp", "tp")) -> DeviceMesh:
    """A (dp, tp) `DeviceMesh` over the ranks of the process group, shaped
    by `mesh_shape` (rank r sits at dp r // tp, tp r % tp). `n_devices`
    defaults to the world size and must equal it."""
    n = dist.get_world_size() if n_devices is None else n_devices
    return _device_mesh(mesh_shape(n, tp), tuple(axis_names))


def axis_size(mesh: DeviceMesh | None, name: str) -> int:
    """Ranks along `name` (1 without a mesh or without that axis)."""
    if mesh is None or name not in (mesh.mesh_dim_names or ()):
        return 1
    return mesh.size(mesh.mesh_dim_names.index(name))


def axis_rank(mesh: DeviceMesh | None, name: str) -> int:
    """This rank's index along `name` (0 without a mesh or that axis)."""
    if mesh is None or name not in (mesh.mesh_dim_names or ()):
        return 0
    return mesh.get_local_rank(name)


def all_gather(local: torch.Tensor, group, dim: int = 0,
               sizes: list[int] | None = None) -> torch.Tensor:
    """Every rank's `local` concatenated along `dim` in group-rank order, on
    every rank of `group`. Shards may differ in size along `dim` only, as
    `sizes` (one entry per rank) gives them; without `sizes` they are equal."""
    n = dist.get_world_size(group)
    if n == 1:
        return local
    sizes = sizes or [local.shape[dim]] * n
    pad = max(sizes) - local.shape[dim]
    if pad:
        shape = list(local.shape)
        shape[dim] = pad
        local = torch.cat([local, local.new_zeros(shape)], dim=dim)
    parts = [torch.empty_like(local) for _ in range(n)]
    dist.all_gather(parts, local.contiguous(), group=group)
    return torch.cat([p.narrow(dim, 0, m) for p, m in zip(parts, sizes)], dim=dim)


# -- ranks on this host ---------------------------------------------------------


def _rank_main(rank, fn, world_size, args, backend, device, init_file, out_dir, threads, join):
    if threads:
        torch.set_num_threads(threads)
    init_method = f"file://{init_file}"
    if join:
        init_distributed(rank, world_size, init_method, backend, device, local_rank=rank)
    else:
        args = args + (init_method,)
    try:
        result = fn(rank, *args)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn, world_size: int, args: tuple = (), backend: str | None = None,
          device: str | None = None, workdir: str | None = None, threads: int = 1,
          join: bool = True) -> list:
    """Run ``fn(rank, *args)`` on `world_size` ranks of a new process group,
    each in its own process on this host, joined through a file under
    `workdir` (a new temporary directory by default) -> the ranks' return
    values, in rank order (saved with torch.save; tensors come back on the
    CPU). `fn` must be importable by name. `device` defaults to the card and
    puts every rank on ``cuda:{rank % cards}`` (pass ``device="cpu"`` for the
    CPU); `device` and `backend` as in `init_distributed`. Each rank
    runs `threads` intra-op threads (0 leaves torch's default). A rank that
    raises makes the call raise. With ``join=False`` the ranks join the
    group themselves: `fn` gets the init method ("file://...") as its last
    argument."""
    import torch.multiprocessing as mp

    device = resolve_device(device) if join else device
    own = workdir is None
    workdir = tempfile.mkdtemp(prefix="ranks-") if own else workdir
    os.makedirs(workdir, exist_ok=True)
    init_file = os.path.join(workdir, "init")
    if os.path.exists(init_file):
        os.remove(init_file)
    mp.spawn(_rank_main, args=(fn, world_size, tuple(args), backend, device, init_file, workdir,
                               threads, join), nprocs=world_size, join=True)
    results = [torch.load(os.path.join(workdir, f"rank{r}.pt"), map_location="cpu",
                          weights_only=False) for r in range(world_size)]
    if own:
        import shutil

        shutil.rmtree(workdir, ignore_errors=True)
    return results
