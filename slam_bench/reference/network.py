"""Plain MASt3R network: the benchmark's reference for the port's encoder,
two-view decoder and heads.

A frozen rewrite of the upstream architecture (naver CroCo-v2 / DUSt3R /
MASt3R: ``MASt3R_ViTLarge_BaseDecoder_512_catmlpdpt_metric``) as the port's
``models/vit.py``, ``models/heads.py`` and ``models/mast3r.py`` lay it out,
with the same parameter names, so that one state dict serves both, on plain
torch operations: attention is softmax(q k^T / sqrt(d)) v written out, the
1x1 output conv of a DPT fusion block runs before its resize (it commutes
with a resize whose rows sum to one), and the GELU is the configuration's
(``tanh`` or exact ``erf``). It imports nothing of the port.

It computes in the precision the configuration states, as that precision is
defined for this network (the JAX package's dtype policy): the weights of
linear and convolution layers in that dtype, each layer casting its input to
its weight's; LayerNorms and the DPT heads' last convolution in float32; the
residual streams in the layer dtype; RoPE in float32, rounded back; attention
scores and softmax in float32 with the probabilities rounded to the value
dtype for the product with v; head outputs post-processed in float32. With a
float32 configuration every step is float32. Callers switch TF32 off
(`set_float32_exact`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn as nn
import torch.nn.functional as F


def set_float32_exact() -> None:
    """Keep float32 matrix products and convolutions out of TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@dataclass(frozen=True)
class NetSizes:
    """The widths of one configuration file's ``network`` group."""

    enc_embed_dim: int
    enc_depth: int
    enc_num_heads: int
    patch_size: int
    dec_embed_dim: int
    dec_depth: int
    dec_num_heads: int
    local_feat_dim: int = 24
    rope_base: float = 100.0
    gelu: str = "tanh"

    @classmethod
    def from_config(cls, net: dict) -> "NetSizes":
        keys = cls.__dataclass_fields__
        return cls(**{k: v for k, v in net.items() if k in keys})


def rope_angles(pos: torch.Tensor, head_dim: int, base: float):
    """cos, sin [B, S, head_dim] of 2D RoPE, quarters (y, y, x, x)."""
    quarter = head_dim // 4
    freqs = 1.0 / base ** (torch.arange(quarter, dtype=torch.float32, device=pos.device) / quarter)
    ay = pos[..., 1].float()[..., None] * freqs
    ax = pos[..., 0].float()[..., None] * freqs
    ang = torch.cat([ay, ay, ax, ax], dim=-1)
    return torch.cos(ang), torch.sin(ang)


def rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotated in float32, rounded back to x's dtype."""
    q = x.shape[-1] // 4
    xf = x.float()
    y1, y2, x1, x2 = xf.split(q, dim=-1)
    return (xf * cos[:, None] + torch.cat([-y2, y1, -x2, x1], dim=-1) * sin[:, None]).to(x.dtype)


def attention(q, k, v):
    """[B, H, S, D] -> [B, H, Sq, D] in v's dtype: scores and softmax in
    float32, the unnormalised probabilities rounded to v's dtype for p v."""
    s = (q.float() @ k.float().transpose(-1, -2)) / math.sqrt(q.shape[-1])
    p = torch.exp(s - s.amax(-1, keepdim=True))
    o = (p.to(v.dtype).float() @ v.float()) / p.sum(-1, keepdim=True)
    return o.to(v.dtype)


class Linear(nn.Linear):
    def forward(self, x):
        return super().forward(x.to(self.weight.dtype))


class Conv2d(nn.Conv2d):
    def forward(self, x):
        return super().forward(x.to(self.weight.dtype))


class ConvTranspose2d(nn.ConvTranspose2d):
    def forward(self, x):
        return super().forward(x.to(self.weight.dtype))


class LayerNorm(nn.LayerNorm):
    """float32 in and out, eps 1e-6."""

    def __init__(self, dim: int):
        super().__init__(dim, eps=1e-6)

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias, self.eps)


def heads_of(x: torch.Tensor, h: int) -> torch.Tensor:
    b, s, c = x.shape
    return x.view(b, s, h, c // h).transpose(1, 2)


def merge(x: torch.Tensor) -> torch.Tensor:
    b, h, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, h * d)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, gelu: str):
        super().__init__()
        self.fc1 = Linear(dim, hidden)
        self.fc2 = Linear(hidden, dim)
        self.approximate = "tanh" if gelu == "tanh" else "none"

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate=self.approximate))


class SelfAttention(nn.Module):
    def __init__(self, dim: int, h: int):
        super().__init__()
        self.h = h
        self.qkv = Linear(dim, 3 * dim)
        self.proj = Linear(dim, dim)

    def forward(self, x, rp):
        b, s, _ = x.shape
        q, k, v = self.qkv(x).view(b, s, 3, self.h, -1).permute(2, 0, 3, 1, 4).unbind(0)
        return self.proj(merge(attention(rope(q, *rp), rope(k, *rp), v)))


class CrossAttention(nn.Module):
    def __init__(self, dim: int, h: int):
        super().__init__()
        self.h = h
        self.projq = Linear(dim, dim)
        self.projk = Linear(dim, dim)
        self.projv = Linear(dim, dim)
        self.proj = Linear(dim, dim)

    def forward(self, x, y, rq, rk):
        q = rope(heads_of(self.projq(x), self.h), *rq)
        k = rope(heads_of(self.projk(y), self.h), *rk)
        return self.proj(merge(attention(q, k, heads_of(self.projv(y), self.h))))


def _ln(dim: int) -> LayerNorm:
    return LayerNorm(dim)


class EncoderBlock(nn.Module):
    def __init__(self, dim: int, h: int, gelu: str):
        super().__init__()
        self.norm1, self.attn = _ln(dim), SelfAttention(dim, h)
        self.norm2, self.mlp = _ln(dim), Mlp(dim, 4 * dim, gelu)

    def forward(self, x, rp):
        x = x + self.attn(self.norm1(x), rp)
        return x + self.mlp(self.norm2(x))


class DecoderBlock(nn.Module):
    def __init__(self, dim: int, h: int, gelu: str):
        super().__init__()
        self.norm1, self.attn = _ln(dim), SelfAttention(dim, h)
        self.norm2, self.norm_y, self.cross_attn = _ln(dim), _ln(dim), CrossAttention(dim, h)
        self.norm3, self.mlp = _ln(dim), Mlp(dim, 4 * dim, gelu)

    def forward(self, x, y, rx, ry):
        x = x + self.attn(self.norm1(x), rx)
        x = x + self.cross_attn(self.norm2(x), self.norm_y(y), rx, ry)
        return x + self.mlp(self.norm3(x))


class PatchEmbed(nn.Module):
    def __init__(self, p: int, dim: int):
        super().__init__()
        self.p = p
        self.proj = Conv2d(3, dim, p, p)

    def forward(self, img):  # [B, H, W, 3] in [-1, 1]
        b, h, w, _ = img.shape
        x = self.proj(img.permute(0, 3, 1, 2)).flatten(2).transpose(1, 2)
        yy, xx = torch.meshgrid(torch.arange(h // self.p, device=img.device),
                                torch.arange(w // self.p, device=img.device), indexing="ij")
        pos = torch.stack([xx.reshape(-1), yy.reshape(-1)], dim=-1)
        return x, pos[None].expand(b, -1, -1)


def _resize(x: torch.Tensor, oh: int, ow: int) -> torch.Tensor:
    if tuple(x.shape[-2:]) == (oh, ow):
        return x
    return F.interpolate(x, size=(oh, ow), mode="bilinear", align_corners=True)


class ResidualConvUnit(nn.Module):
    def __init__(self, f: int):
        super().__init__()
        self.conv1 = Conv2d(f, f, 3, 1, 1)
        self.conv2 = Conv2d(f, f, 3, 1, 1)

    def forward(self, x):
        return x + self.conv2(F.relu(self.conv1(F.relu(x))))


class FeatureFusionBlock(nn.Module):
    def __init__(self, f: int, has_skip: bool):
        super().__init__()
        self.out_conv = Conv2d(f, f, 1)
        if has_skip:
            self.resConfUnit1 = ResidualConvUnit(f)
        self.resConfUnit2 = ResidualConvUnit(f)

    def forward(self, x, skip=None):
        if skip is not None:
            x = x[:, :, : skip.shape[2], : skip.shape[3]] + self.resConfUnit1(skip)
        x = self.out_conv(self.resConfUnit2(x))
        return _resize(x, 2 * x.shape[2], 2 * x.shape[3])


class Scratch(nn.Module):
    def __init__(self, dims, f: int):
        super().__init__()
        for i, d in enumerate(dims):
            setattr(self, f"layer{i + 1}_rn", Conv2d(d, f, 3, 1, 1, bias=False))
        for i in range(1, 5):
            setattr(self, f"refinenet{i}", FeatureFusionBlock(f, i < 4))


class DPTHead(nn.Module):
    def __init__(self, tokens, f: int = 256, d=(96, 192, 384, 768)):
        super().__init__()
        self.act_postprocess = nn.ModuleList([
            nn.Sequential(Conv2d(tokens[0], d[0], 1), ConvTranspose2d(d[0], d[0], 4, 4)),
            nn.Sequential(Conv2d(tokens[1], d[1], 1), ConvTranspose2d(d[1], d[1], 2, 2)),
            nn.Sequential(Conv2d(tokens[2], d[2], 1)),
            nn.Sequential(Conv2d(tokens[3], d[3], 1), Conv2d(d[3], d[3], 3, 2, 1)),
        ])
        self.scratch = Scratch(d, f)
        self.head = nn.ModuleList([Conv2d(f, f // 2, 3, 1, 1), nn.Identity(),
                                   Conv2d(f // 2, 32, 3, 1, 1), nn.ReLU(),
                                   Conv2d(32, 4, 1)])

    def forward(self, hooks, hp: int, wp: int, out_hw):
        sc = self.scratch
        rns = (sc.layer1_rn, sc.layer2_rn, sc.layer3_rn, sc.layer4_rn)
        l1, l2, l3, l4 = (
            rn(post(t.transpose(1, 2).reshape(t.shape[0], t.shape[2], hp, wp)))
            for t, post, rn in zip(hooks, self.act_postprocess, rns))
        path = sc.refinenet1(sc.refinenet2(sc.refinenet3(sc.refinenet4(l4), l3), l2), l1)
        x = _resize(self.head[0](path), *out_hw)
        return self.head[4](F.relu(self.head[2](x))).permute(0, 2, 3, 1)


class LocalFeaturesHead(nn.Module):
    def __init__(self, idim: int, feat: int, p: int, gelu: str):
        super().__init__()
        self.feat, self.p = feat, p
        self.fc1 = Linear(idim, 4 * idim)
        self.fc2 = Linear(4 * idim, (feat + 1) * p * p)
        self.approximate = "tanh" if gelu == "tanh" else "none"

    def forward(self, dec, enc, hp: int, wp: int):
        x = torch.cat([enc.to(dec.dtype), dec], dim=-1)
        h = self.fc2(F.gelu(self.fc1(x), approximate=self.approximate))
        b, p = h.shape[0], self.p
        pix = h.reshape(b, hp, wp, -1, p, p).permute(0, 1, 4, 2, 5, 3).reshape(b, hp * p, wp * p, -1)
        desc = pix[..., : self.feat].float()
        desc = desc / torch.clamp(torch.linalg.vector_norm(desc, dim=-1, keepdim=True), min=1e-8)
        return desc, torch.exp(torch.clamp(pix[..., self.feat].float(), -50.0, 50.0))


class CatMLPDPTHead(nn.Module):
    def __init__(self, s: NetSizes):
        super().__init__()
        e, d = s.enc_embed_dim, s.dec_embed_dim
        self.dpt = DPTHead([e, d, d, d])
        self.head_local_features = LocalFeaturesHead(e + d, s.local_feat_dim, s.patch_size, s.gelu)

    def forward(self, hooks, hp, wp, out_hw) -> dict:
        raw = self.dpt(hooks, hp, wp, out_hw).float()
        xyz = raw[..., :3]
        n = torch.linalg.vector_norm(xyz, dim=-1, keepdim=True)
        desc, desc_conf = self.head_local_features(hooks[-1], hooks[0], hp, wp)
        return {"pts3d": xyz / torch.clamp(n, min=1e-8) * torch.expm1(n),
                "conf": 1.0 + torch.exp(torch.clamp(raw[..., 3], -50.0, 50.0)),
                "desc": desc, "desc_conf": desc_conf}


class Net(nn.Module):
    """Encoder, twin decoders with a shared ``dec_norm``, one head per view."""

    def __init__(self, s: NetSizes):
        super().__init__()
        self.s = s
        self.patch_embed = PatchEmbed(s.patch_size, s.enc_embed_dim)
        self.enc_blocks = nn.ModuleList(
            [EncoderBlock(s.enc_embed_dim, s.enc_num_heads, s.gelu) for _ in range(s.enc_depth)])
        self.enc_norm = _ln(s.enc_embed_dim)
        self.decoder_embed = Linear(s.enc_embed_dim, s.dec_embed_dim)
        for name in ("dec_blocks", "dec_blocks2"):
            setattr(self, name, nn.ModuleList(
                [DecoderBlock(s.dec_embed_dim, s.dec_num_heads, s.gelu)
                 for _ in range(s.dec_depth)]))
        self.dec_norm = _ln(s.dec_embed_dim)
        self.downstream_head1 = CatMLPDPTHead(s)
        self.downstream_head2 = CatMLPDPTHead(s)

    def encode(self, img: torch.Tensor):
        """img [B, H, W, 3] in [-1, 1] -> (feat [B, S, C], pos [B, S, 2])."""
        x, pos = self.patch_embed(img)
        rp = rope_angles(pos, x.shape[-1] // self.s.enc_num_heads, self.s.rope_base)
        for blk in self.enc_blocks:
            x = blk(x, rp)
        return self.enc_norm(x), pos

    def decode(self, f1, pos1, f2, pos2, out_hw, views=(1, 2)) -> tuple:
        """Two-view decode -> one dict per view (pts3d, conf, desc, desc_conf)."""
        s = self.s
        hd = s.dec_embed_dim // s.dec_num_heads
        r1, r2 = rope_angles(pos1, hd, s.rope_base), rope_angles(pos2, hd, s.rope_base)
        x1, x2 = self.decoder_embed(f1), self.decoder_embed(f2)
        hooks1, hooks2 = [f1], [f2]
        for b1, b2 in zip(self.dec_blocks, self.dec_blocks2):
            x1, x2 = b1(x1, x2, r1, r2), b2(x2, x1, r2, r1)
            hooks1.append(x1)
            hooks2.append(x2)
        hooks1[-1], hooks2[-1] = self.dec_norm(x1), self.dec_norm(x2)
        d = s.dec_depth
        pick = (0, d * 2 // 4, d * 3 // 4, d)
        hp, wp = out_hw[0] // s.patch_size, out_hw[1] // s.patch_size
        heads = {1: (self.downstream_head1, hooks1), 2: (self.downstream_head2, hooks2)}
        return tuple(heads[v][0]([heads[v][1][i] for i in pick], hp, wp, out_hw) for v in views)
