"""Vision-transformer blocks for the MASt3R family (the port of
``mast3r_slam_tpu/models/vit.py``).

Modules carry the upstream (naver CroCo-v2 / DUSt3R / MASt3R) parameter
names, so the state dict of the port is the upstream checkpoint layout.
Tokens are [B, S, C]; attention runs on [B, H, S, D] through
`ops.attention.flash_attention`, the hand-written kernel on the card, whatever
`runtime.attention_impl` says (see `config.RuntimeConfig`).

Dtype policy (see `device.py`): Linear/Conv layers compute in the model
dtype, LayerNorms in f32, residual streams stay in the compute dtype. The
norms inside the blocks feed only the blocks' projections and MLPs, so they
write the model dtype (`device.feeds_compute`), the cast those layers make;
`enc_norm` and `dec_norm` write f32, as in flax. Every norm runs through
`ops.layer_norm.layer_norm`: on the card one launch of ``csrc/layer_norm.cu``.
One deliberate difference from the JAX package: there, RoPE multiplies bf16
q/k by f32 tables and so promotes q/k to f32 before attention; here the
rotation is computed in f32 and rounded back to the compute dtype so that
the kernel takes bf16 q/k/v. In an f32 model the two are the same
computation. Every attention call rotates q and k through
`ops.rope.rotate_qk`: on the card one launch of the hand-written kernel
``csrc/rope.cu``, which keeps that one rounding, elsewhere `apply_rope`.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from mast3r_slam_torch.config import get_config
from mast3r_slam_torch.device import Conv2d, LayerNorm, Linear, feeds_compute
from mast3r_slam_torch.ops.attention import flash_attention
from mast3r_slam_torch.ops.rope import apply_rope, rotate_qk  # noqa: F401 (JAX's vit name)


def rope_2d_angles(positions: torch.Tensor, head_dim: int, base: float = 100.0):
    """cos/sin tables [B, S, D] for CroCo-v2 2D RoPE, quarters [fy, fy, fx, fx].

    positions: [B, S, 2] integer (x, y) patch coordinates.
    """
    if head_dim % 4:
        raise ValueError(f"RoPE-2D needs head_dim % 4 == 0, got {head_dim}")
    quarter = head_dim // 4
    freqs = 1.0 / (
        base ** (torch.arange(quarter, dtype=torch.float32, device=positions.device) / quarter)
    )
    ang_y = positions[..., 1].float()[..., None] * freqs
    ang_x = positions[..., 0].float()[..., None] * freqs
    ang = torch.cat([ang_y, ang_y, ang_x, ang_x], dim=-1)
    return torch.cos(ang), torch.sin(ang)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact-erf or tanh-approximate GELU per ``runtime.gelu_impl``."""
    approximate = "tanh" if get_config().runtime.gelu_impl == "tanh" else "none"
    return F.gelu(x, approximate=approximate)


class Mlp(nn.Module):
    """fc2(gelu(fc1(x))). `runtime.gelu_barrier` (JAX: an optimization barrier
    that makes XLA write the GELU output out instead of fusing it into fc2's
    operand load) is accepted and has nothing to change here: in eager
    PyTorch the GELU output is always a tensor of its own between the two
    GEMMs, so the knob's semantics, the same math with the GELU
    materialised, hold with it on and off."""

    def __init__(self, in_dim: int, hidden: int, out_dim: int):
        super().__init__()
        self.fc1 = Linear(in_dim, hidden)
        self.fc2 = Linear(hidden, out_dim)

    def forward(self, x):
        return self.fc2(gelu(self.fc1(x)))


def _split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, s, c = x.shape
    return x.view(b, s, num_heads, c // num_heads).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, h * d)


class Attention(nn.Module):
    """Self-attention with 2D RoPE."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = Linear(dim, dim * 3)
        self.proj = Linear(dim, dim)

    def forward(self, x, rope=None):
        b, s, _ = x.shape
        # The head dim follows from the projection's width, which is this
        # rank's share of the heads under tensor parallelism (parallel/sharding.py).
        qkv = self.qkv(x).view(b, s, 3, self.num_heads, -1)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)  # each [B, H, S, hd], no copy
        q, k = rotate_qk(q, k, rope, rope)
        return self.proj(_merge_heads(flash_attention(q, k, v)))


class CrossAttention(nn.Module):
    """Queries from x, keys/values from the other view's tokens y."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.projq = Linear(dim, dim)
        self.projk = Linear(dim, dim)
        self.projv = Linear(dim, dim)
        self.proj = Linear(dim, dim)

    def forward(self, x, y, rope_q=None, rope_k=None):
        q = _split_heads(self.projq(x), self.num_heads)
        k = _split_heads(self.projk(y), self.num_heads)
        v = _split_heads(self.projv(y), self.num_heads)
        q, k = rotate_qk(q, k, rope_q, rope_k)
        return self.proj(_merge_heads(flash_attention(q, k, v)))


class EncoderBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0):
        super().__init__()
        self.norm1 = feeds_compute(LayerNorm(dim))
        self.attn = Attention(dim, num_heads)
        self.norm2 = feeds_compute(LayerNorm(dim))
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim)

    def forward(self, x, rope=None):
        x = x + self.attn(self.norm1(x), rope)
        return x + self.mlp(self.norm2(x))


class DecoderBlock(nn.Module):
    """DUSt3R decoder block: self-attention, cross-attention to the other
    view, MLP."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0):
        super().__init__()
        self.norm1 = feeds_compute(LayerNorm(dim))
        self.attn = Attention(dim, num_heads)
        self.norm2 = feeds_compute(LayerNorm(dim))
        self.norm_y = feeds_compute(LayerNorm(dim))
        self.cross_attn = CrossAttention(dim, num_heads)
        self.norm3 = feeds_compute(LayerNorm(dim))
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim)

    def forward(self, x, y, rope_x=None, rope_y=None):
        x = x + self.attn(self.norm1(x), rope_x)
        x = x + self.cross_attn(self.norm2(x), self.norm_y(y), rope_q=rope_x, rope_k=rope_y)
        return x + self.mlp(self.norm3(x))


class PatchEmbed(nn.Module):
    """Conv patchifier: NHWC image -> tokens [B, S, C] + (x, y) positions."""

    def __init__(self, patch_size: int, embed_dim: int):
        super().__init__()
        self.patch_size = patch_size
        self.proj = Conv2d(3, embed_dim, patch_size, patch_size)

    def forward(self, img):  # [B, H, W, 3], normalized to [-1, 1]
        b, h, w, _ = img.shape
        p = self.patch_size
        x = self.proj(img.permute(0, 3, 1, 2)).flatten(2).transpose(1, 2)
        hp, wp = h // p, w // p
        yy, xx = torch.meshgrid(
            torch.arange(hp, device=img.device), torch.arange(wp, device=img.device),
            indexing="ij",
        )
        pos = torch.stack([xx.reshape(-1), yy.reshape(-1)], dim=-1).to(torch.int32)
        return x, pos[None].expand(b, -1, -1)


class ViTEncoder(nn.Module):
    """CroCo-v2 RoPE ViT encoder (no cls token, no learned position
    embedding). Parameters: ``patch_embed``, ``enc_blocks``, ``enc_norm``."""

    def __init__(self, embed_dim: int = 1024, depth: int = 24, num_heads: int = 16,
                 patch_size: int = 16, mlp_ratio: float = 4.0, rope_base: float = 100.0):
        super().__init__()
        self.enc_num_heads = num_heads
        self.rope_base = rope_base
        self.patch_embed = PatchEmbed(patch_size, embed_dim)
        self.enc_blocks = nn.ModuleList(
            [EncoderBlock(embed_dim, num_heads, mlp_ratio) for _ in range(depth)]
        )
        self.enc_norm = LayerNorm(embed_dim)

    def forward(self, img):
        """The encode (JAX ``ViTEncoder.__call__``)."""
        return self.encode(img)

    def encode(self, img):
        """img [B, H, W, 3] in [-1, 1] -> (feat [B, S, C] f32, pos [B, S, 2])."""
        x, pos = self.patch_embed(img)
        rope = rope_2d_angles(pos, x.shape[-1] // self.enc_num_heads, self.rope_base)
        for blk in self.enc_blocks:
            x = blk(x, rope)
        return self.enc_norm(x), pos
