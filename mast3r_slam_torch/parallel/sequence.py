"""Sequence parallelism for the ViT encoder over mesh axis "sp" (the port of
``mast3r_slam_tpu/parallel/sequence.py``).

The token axis of the encoder's residual stream is split over the "sp" ranks
(contiguous shards, as even as `torch.tensor_split` makes them), the batch
over "dp" or replicated. Norms, MLPs and the qkv projection run on the rank's
own tokens. Attention rotates q and k by the RoPE angles of the rank's own
positions, all-gathers K and V over sp, and runs the attention kernel with
the rank's Sq = S/sp queries against all Skv = S keys; the output projection
is again per token. JAX writes the same layout as sharding constraints and
lets GSPMD insert the gathers. The result, gathered over sp and dp, equals the
unsharded encode up to the order of float sums; it saves activation memory
(the [B, S, 4·D] MLP transients scale with S/sp), not time.
"""

from __future__ import annotations

import functools

import torch

from mast3r_slam_torch.models.vit import _merge_heads, rope_2d_angles
from mast3r_slam_torch.ops.attention import flash_attention
from mast3r_slam_torch.ops.rope import rotate_qk
from mast3r_slam_torch.parallel.mesh import all_gather, axis_rank, axis_size


def _sp_block(blk, x, rope, sizes, group):
    """One encoder block on this rank's tokens `x` [B, S/sp, D]."""
    a = blk.attn
    h = blk.norm1(x)
    b, s, _ = h.shape
    qkv = a.qkv(h).view(b, s, 3, a.num_heads, -1)
    q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
    q, k = rotate_qk(q, k, rope, rope)
    if group is not None:
        k, v = all_gather(k, group, 2, sizes), all_gather(v, group, 2, sizes)
    x = x + a.proj(_merge_heads(flash_attention(q, k, v)))
    return x + blk.mlp(blk.norm2(x))


@torch.no_grad()
def sequence_parallel_encode(cfg, model, imgs: torch.Tensor, mesh, batch_axis: str | None = "dp",
                             token_axis: str = "sp"):
    """ViT-encode `imgs` [B, H, W, 3] with the token axis split over the
    mesh's `token_axis` and the batch over `batch_axis` (None: every rank
    encodes the whole batch) -> (tokens [B, S, D], pos [B, S, 2]), as
    `MASt3RModel.encode`, on every rank. B must be a multiple of the batch
    axis. `model` is the `MASt3RModel` (or its net)."""
    net = getattr(model, "net", model)
    sp, sr, group = axis_size(mesh, token_axis), axis_rank(mesh, token_axis), None
    if sp > 1:
        group = mesh.get_group(token_axis)
    B = imgs.shape[0]
    dp = axis_size(mesh, batch_axis) if batch_axis else 1
    if B % dp:
        raise ValueError(f"batch {B} not divisible by {batch_axis} axis {dp}")
    if dp > 1:
        r = axis_rank(mesh, batch_axis)
        imgs = imgs[r * (B // dp):(r + 1) * (B // dp)]
    x, pos = net.patch_embed(imgs)
    cos, sin = rope_2d_angles(pos, cfg.enc_embed_dim // cfg.enc_num_heads, cfg.rope_base)
    sizes = [len(c) for c in torch.arange(x.shape[1]).tensor_split(sp)]
    lo = sum(sizes[:sr])
    mine = slice(lo, lo + sizes[sr])
    # this rank's tokens, contiguous: the norms' kernel reads contiguous rows
    x, rope = x[:, mine].contiguous(), (cos[:, mine], sin[:, mine])
    for blk in net.enc_blocks:
        x = _sp_block(blk, x, rope, sizes, group)
    tokens = net.enc_norm(x)
    if group is not None:
        tokens = all_gather(tokens, group, 1, sizes)
    if dp > 1:
        tokens = all_gather(tokens, mesh.get_group(batch_axis))
    return tokens, pos[:1].expand(B, -1, -1)


def jit_sequence_parallel_encode(cfg, mesh, batch_axis: str | None = "dp", token_axis: str = "sp"):
    """`sequence_parallel_encode` with its settings bound -> ``fn(model,
    imgs)`` (JAX's jitted form; eager PyTorch has nothing to trace)."""
    return functools.partial(sequence_parallel_encode, cfg, mesh=mesh, batch_axis=batch_axis,
                             token_axis=token_axis)
