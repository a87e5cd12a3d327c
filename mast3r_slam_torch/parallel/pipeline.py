"""GPipe pipeline parallelism for the ViT encoder over mesh axis "pp" (the
port of ``mast3r_slam_tpu/parallel/pipeline.py``).

Each rank of a ("pp",) mesh is one stage and applies its slab of encoder
blocks (`encoder_stage_params` orders them by their numeric suffix). M
microbatches flow through P stages in M + P - 1 steps: at step t stage s
works on microbatch t - s, receiving it from stage s - 1 and handing its
output to stage s + 1 with point-to-point sends (JAX: a ``ppermute`` around
the ring). The pipeline bubble is GPipe's (P - 1) / (M + P - 1). The patch
embed, the RoPE tables and the final LayerNorm run on every rank; the last
stage's outputs reach every rank by a broadcast (JAX zeroes the other
stages' and sums). The result equals the unsharded encode up to the order of
float sums.
"""

from __future__ import annotations

import functools
import re

import torch
import torch.distributed as dist

from mast3r_slam_torch.models.vit import rope_2d_angles
from mast3r_slam_torch.parallel.mesh import _device_mesh, axis_rank, axis_size


def make_pipeline_mesh(n_stages: int):
    """A ("pp",) `DeviceMesh` of `n_stages` ranks, which must be the world."""
    world = dist.get_world_size()
    if world < n_stages:
        raise ValueError(f"need {n_stages} ranks for {n_stages} stages, have {world}")
    return _device_mesh((n_stages,), ("pp",))


def _stage_blocks(block_ids, n_stages: int) -> list[list[int]]:
    order = sorted(block_ids)
    if len(order) % n_stages:
        raise ValueError(f"encoder depth {len(order)} not divisible by {n_stages} stages")
    per = len(order) // n_stages
    return [order[s * per:(s + 1) * per] for s in range(n_stages)]


def encoder_stage_params(state: dict, n_stages: int) -> list[list[dict]]:
    """The encoder blocks of a state dict (``enc_blocks.<i>.*``), in order of
    their numeric suffix, as `n_stages` slabs of depth / n_stages blocks, each
    block a dict of its own parameter names -> tensors. Raises when
    n_stages does not divide the depth."""
    blocks: dict[int, dict] = {}
    for name, value in state.items():
        m = re.match(r"^enc_blocks\.(\d+)\.(.+)$", name)
        if m:
            blocks.setdefault(int(m.group(1)), {})[m.group(2)] = value
    return [[blocks[i] for i in ids] for ids in _stage_blocks(blocks, n_stages)]


@torch.no_grad()
def pipelined_encode(cfg, model, imgs: torch.Tensor, mesh, n_microbatches: int):
    """ViT-encode `imgs` [B, H, W, 3] with the encoder blocks pipelined over
    the mesh's "pp" axis -> (tokens [B, S, D], pos [B, S, 2]), as
    `MASt3RModel.encode`, on every rank. `model` is the `MASt3RModel` (or its
    net) whose blocks the stages run; `n_microbatches` must divide B (M >= P
    keeps the bubble under half)."""
    net = getattr(model, "net", model)
    n_stages, stage = axis_size(mesh, "pp"), axis_rank(mesh, "pp")
    group = mesh.get_group("pp")
    ranks = dist.get_process_group_ranks(group)
    x, pos = net.patch_embed(imgs)
    cos, sin = rope_2d_angles(pos, cfg.enc_embed_dim // cfg.enc_num_heads, cfg.rope_base)
    b, s, d = x.shape
    m = n_microbatches
    if b % m:
        raise ValueError(f"batch {b} not divisible into {m} microbatches")
    mb = b // m
    # The RoPE tables are the same for every image (one grid), so one
    # microbatch's slice serves them all.
    rope = (cos[:mb], sin[:mb])
    blocks = [net.enc_blocks[i] for i in _stage_blocks(range(len(net.enc_blocks)), n_stages)[stage]]

    outs = x.new_zeros((m, mb, s, d))
    pending = []
    for t in range(m + n_stages - 1):
        i = t - stage  # the microbatch this stage works on at step t
        if not 0 <= i < m:
            continue
        if stage == 0:
            h = x[i * mb:(i + 1) * mb]
        else:
            h = x.new_empty((mb, s, d))
            dist.recv(h, src=ranks[stage - 1], group=group)
        for blk in blocks:
            h = blk(h, rope)
        if stage == n_stages - 1:
            outs[i] = h
        else:
            h = h.contiguous()
            pending.append((dist.isend(h, dst=ranks[stage + 1], group=group), h))
    for work, _ in pending:
        work.wait()
    dist.broadcast(outs, src=ranks[-1], group=group)
    return net.enc_norm(outs.reshape(b, s, d)), pos


def jit_pipelined_encode(cfg, mesh, n_microbatches: int):
    """`pipelined_encode` with its settings bound -> ``fn(model, imgs)``
    (JAX's jitted form; eager PyTorch has nothing to trace)."""
    return functools.partial(pipelined_encode, cfg, mesh=mesh, n_microbatches=n_microbatches)
