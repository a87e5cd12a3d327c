"""Regression heads (the port of ``mast3r_slam_tpu/models/heads.py``):
the DPT pts3d/conf head, the linear pts3d head and the catmlp local-feature
(desc/desc_conf) head, under the upstream parameter names.

Public functions keep the JAX layouts (NHWC images, [B, S, C] tokens); the
convolutions inside run NCHW. Output parameterizations are DUSt3R's:
pts3d = unit(raw) * expm1(|raw|), conf = 1 + exp(x), desc_conf = exp(x),
desc L2-normalized.

`resize_bilinear_ac` is ``F.interpolate(align_corners=True)``. The JAX
package contracts with interpolation matrices built in the activation dtype
(bf16 for the deployment model); PyTorch weights in f32 and rounds the
result, so on the card the two differ by bf16 rounding of the weights. In
f32 (the CPU tests) they agree.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from mast3r_slam_torch.device import Conv2d, ConvTranspose2d, Linear, keep_f32
from mast3r_slam_torch.models.vit import gelu


def postprocess_pts3d(raw: torch.Tensor) -> torch.Tensor:
    """[..., 3] raw -> unit(raw) * expm1(|raw|)."""
    d = torch.linalg.vector_norm(raw, dim=-1, keepdim=True)
    return raw / torch.clamp(d, min=1e-8) * torch.expm1(d)


def postprocess_conf(raw: torch.Tensor) -> torch.Tensor:
    """1 + exp(x); the clip only guards exp overflow."""
    return 1.0 + torch.exp(torch.clamp(raw, -50.0, 50.0))


def postprocess_desc_conf(raw: torch.Tensor) -> torch.Tensor:
    """exp(x) (the released checkpoints' desc_conf mode, vmin 0)."""
    return torch.exp(torch.clamp(raw, -50.0, 50.0))


def pixel_shuffle(x: torch.Tensor, p: int) -> torch.Tensor:
    """[B, hp, wp, C*p*p] -> [B, hp*p, wp*p, C], channel index c*p*p + ry*p + rx
    (torch F.pixel_shuffle order)."""
    b, hp, wp, c = x.shape
    cc = c // (p * p)
    x = x.reshape(b, hp, wp, cc, p, p).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(b, hp * p, wp * p, cc)


def _resize(x: torch.Tensor, oh: int, ow: int) -> torch.Tensor:
    """NCHW bilinear resize, align_corners=True."""
    if tuple(x.shape[-2:]) == (oh, ow):
        return x
    return F.interpolate(x, size=(oh, ow), mode="bilinear", align_corners=True)


def resize_bilinear_ac(x: torch.Tensor, oh: int, ow: int) -> torch.Tensor:
    """NHWC bilinear resize with align_corners=True."""
    return _resize(x.permute(0, 3, 1, 2), oh, ow).permute(0, 2, 3, 1)


def tokens_to_grid(tokens: torch.Tensor, hp: int, wp: int) -> torch.Tensor:
    """[B, S, C] -> [B, hp, wp, C]."""
    b, s, c = tokens.shape
    return tokens.reshape(b, hp, wp, c)


def _tokens_to_nchw(tokens: torch.Tensor, hp: int, wp: int) -> torch.Tensor:
    b, s, c = tokens.shape
    return tokens.transpose(1, 2).reshape(b, c, hp, wp)


class ResidualConvUnit(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.conv1 = Conv2d(features, features, 3, 1, 1)
        self.conv2 = Conv2d(features, features, 3, 1, 1)

    def forward(self, x):
        return x + self.conv2(F.relu(self.conv1(F.relu(x))))


class FeatureFusionBlock(nn.Module):
    """DPT fusion: (+ skip RCU), RCU, 1x1 out_conv, x2 align-corners resize.

    The 1x1 conv runs before the resize (as in the JAX package): a 1x1 conv
    commutes with a resize whose rows sum to 1, and costs a quarter of the
    pixels there. ``resConfUnit1`` exists only where the block has a skip
    input (upstream's refinenet4 copy is dead and is not loaded)."""

    def __init__(self, features: int, has_skip: bool = True):
        super().__init__()
        self.out_conv = Conv2d(features, features, 1)
        if has_skip:
            self.resConfUnit1 = ResidualConvUnit(features)
        self.resConfUnit2 = ResidualConvUnit(features)

    def forward(self, prev, skip=None):
        x = prev
        if skip is not None:
            x = x[:, :, : skip.shape[2], : skip.shape[3]]  # crop odd grids, as upstream
            x = x + self.resConfUnit1(skip)
        x = self.out_conv(self.resConfUnit2(x))
        return _resize(x, x.shape[2] * 2, x.shape[3] * 2)


class _Scratch(nn.Module):
    def __init__(self, layer_dims, features: int):
        super().__init__()
        for i, d in enumerate(layer_dims):
            setattr(self, f"layer{i + 1}_rn", Conv2d(d, features, 3, 1, 1, bias=False))
        for i in range(1, 5):
            setattr(self, f"refinenet{i}", FeatureFusionBlock(features, has_skip=i < 4))


class DPTHead(nn.Module):
    """Dense prediction head over 4 hook layers: reassemble to a 1/4..1/32
    pyramid, fuse top-down, regress `out_channels` per pixel at full size."""

    def __init__(self, dim_tokens, out_channels: int = 4, features: int = 256,
                 layer_dims=(96, 192, 384, 768)):
        super().__init__()
        d = layer_dims
        self.act_postprocess = nn.ModuleList(
            [
                nn.Sequential(Conv2d(dim_tokens[0], d[0], 1), ConvTranspose2d(d[0], d[0], 4, 4)),
                nn.Sequential(Conv2d(dim_tokens[1], d[1], 1), ConvTranspose2d(d[1], d[1], 2, 2)),
                nn.Sequential(Conv2d(dim_tokens[2], d[2], 1)),
                nn.Sequential(Conv2d(dim_tokens[3], d[3], 1), Conv2d(d[3], d[3], 3, 2, 1)),
            ]
        )
        self.scratch = _Scratch(layer_dims, features)
        self.head = nn.ModuleList(
            [
                Conv2d(features, features // 2, 3, 1, 1),
                nn.Identity(),  # the resize to the image size (no parameters)
                Conv2d(features // 2, 32, 3, 1, 1),
                nn.ReLU(),
                keep_f32(Conv2d(32, out_channels, 1)),
            ]
        )

    def forward(self, hooks, hp: int, wp: int, out_hw) -> torch.Tensor:
        """hooks: 4 token tensors [B, S, C_i] -> raw [B, H, W, out_channels] f32."""
        sc = self.scratch
        l1, l2, l3, l4 = (
            rn(post(_tokens_to_nchw(tok, hp, wp)))
            for tok, post, rn in zip(
                hooks, self.act_postprocess,
                (sc.layer1_rn, sc.layer2_rn, sc.layer3_rn, sc.layer4_rn),
            )
        )
        path = sc.refinenet4(l4)
        path = sc.refinenet3(path, l3)
        path = sc.refinenet2(path, l2)
        path = sc.refinenet1(path, l1)
        x = _resize(self.head[0](path), *out_hw)
        x = self.head[4](F.relu(self.head[2](x)))
        return x.permute(0, 2, 3, 1)


class LocalFeaturesHead(nn.Module):
    """MASt3R catmlp head: MLP over [enc_tokens ; dec_tokens], pixel-shuffled
    to desc (local_feat_dim) + desc_conf (1)."""

    def __init__(self, idim: int, local_feat_dim: int = 24, patch_size: int = 16,
                 hidden_factor: float = 4.0):
        super().__init__()
        self.local_feat_dim = local_feat_dim
        self.patch_size = patch_size
        self.fc1 = Linear(idim, int(hidden_factor * idim))
        self.fc2 = Linear(int(hidden_factor * idim), (local_feat_dim + 1) * patch_size**2)

    def forward(self, dec_tokens, enc_tokens, hp: int, wp: int):
        x = torch.cat([enc_tokens.to(dec_tokens.dtype), dec_tokens], dim=-1)
        h = self.fc2(gelu(self.fc1(x)))
        pix = pixel_shuffle(h.reshape(h.shape[0], hp, wp, -1), self.patch_size)
        raw_desc = pix[..., : self.local_feat_dim].float()
        desc = raw_desc / torch.clamp(
            torch.linalg.vector_norm(raw_desc, dim=-1, keepdim=True), min=1e-8
        )
        return desc, postprocess_desc_conf(pix[..., self.local_feat_dim].float())


def _outputs(raw: torch.Tensor, desc, desc_conf) -> dict:
    return {
        "pts3d": postprocess_pts3d(raw[..., :3]),
        "conf": postprocess_conf(raw[..., 3]),
        "desc": desc,
        "desc_conf": desc_conf,
    }


class CatMLPDPTHead(nn.Module):
    """Upstream Cat_MLP_LocalFeatures_DPT_Pts3d: DPT pts3d/conf + catmlp desc."""

    def __init__(self, enc_dim: int, dec_dim: int, patch_size: int, local_feat_dim: int = 24):
        super().__init__()
        self.patch_size = patch_size
        self.dpt = DPTHead([enc_dim, dec_dim, dec_dim, dec_dim])
        self.head_local_features = LocalFeaturesHead(enc_dim + dec_dim, local_feat_dim, patch_size)

    def forward(self, hooks, hp: int, wp: int, out_hw) -> dict:
        """hooks: [encoder tokens, 2 middle decoder layers, final decoder tokens]."""
        raw = self.dpt(hooks, hp, wp, out_hw)
        return _outputs(raw, *self.head_local_features(hooks[-1], hooks[0], hp, wp))


class LinearPts3dHead(nn.Module):
    """DUSt3R LinearPts3d (``proj``, f32) plus the catmlp local-features head."""

    def __init__(self, enc_dim: int, dec_dim: int, patch_size: int, local_feat_dim: int = 24):
        super().__init__()
        self.patch_size = patch_size
        self.proj = keep_f32(Linear(dec_dim, 4 * patch_size**2))
        self.head_local_features = LocalFeaturesHead(enc_dim + dec_dim, local_feat_dim, patch_size)

    def forward(self, hooks, hp: int, wp: int, out_hw) -> dict:
        x = self.proj(hooks[-1])
        raw = pixel_shuffle(x.reshape(x.shape[0], hp, wp, -1), self.patch_size)
        return _outputs(raw, *self.head_local_features(hooks[-1], hooks[0], hp, wp))
