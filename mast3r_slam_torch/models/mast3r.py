"""MASt3R two-view pointmap network (the port of
``mast3r_slam_tpu/models/mast3r.py``): RoPE ViT encoder, twin cross-attention
decoders with one shared ``dec_norm``, and per-view heads.

* ``MASt3RBackbone`` = encoder + twin decoders (``_run_decoder``);
* ``MASt3RNet`` adds ``downstream_head1/2`` and the two-view ``decode``;
* ``MASt3RModel`` holds a net on a device and exposes encode / decode /
  mono, the entry points the tracker calls.

The state dict uses the upstream names (patch_embed, enc_blocks, enc_norm,
decoder_embed, dec_blocks, dec_blocks2, dec_norm, downstream_head{1,2}).
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn as nn

from mast3r_slam_torch.device import (
    LayerNorm,
    Linear,
    apply_dtype_policy,
    precision_dtype,
    resolve_device,
)
from mast3r_slam_torch.models.heads import CatMLPDPTHead, LinearPts3dHead
from mast3r_slam_torch.models.vit import DecoderBlock, ViTEncoder, rope_2d_angles


@dataclasses.dataclass(frozen=True)
class MASt3RConfig:
    enc_embed_dim: int = 1024
    enc_depth: int = 24
    enc_num_heads: int = 16
    patch_size: int = 16
    dec_embed_dim: int = 768
    dec_depth: int = 12
    dec_num_heads: int = 12
    head_type: str = "dpt"  # "dpt" | "linear"
    local_feat_dim: int = 24
    dtype: torch.dtype = torch.bfloat16
    rope_base: float = 100.0

    @staticmethod
    def mast3r_full(precision: str = "bf16") -> "MASt3RConfig":
        """ViT-L/16 encoder (1024, depth 24, 16 heads), ViT-B decoders (768,
        depth 12, 12 heads), DPT + catmlp heads."""
        return MASt3RConfig(dtype=precision_dtype(precision))

    @staticmethod
    def dunemast3r(variant: str = "base", precision: str = "bf16") -> "MASt3RConfig":
        """The compact DUNE-style encoder at patch 14, "small" (384 wide, 12
        deep, 6 heads) or "base" (768, 12, 12), with mast3r_full's decoders
        and heads (336-pixel class)."""
        dims = {"small": (384, 12, 6), "base": (768, 12, 12)}
        if variant not in dims:
            raise ValueError(f"unknown dunemast3r variant {variant!r}")
        d, depth, heads = dims[variant]
        return MASt3RConfig(enc_embed_dim=d, enc_depth=depth, enc_num_heads=heads, patch_size=14,
                            dtype=precision_dtype(precision))

    @staticmethod
    def tiny(patch_size: int = 16) -> "MASt3RConfig":
        """Test-scale config, structure-identical to the full model."""
        return MASt3RConfig(
            enc_embed_dim=64, enc_depth=2, enc_num_heads=2, patch_size=patch_size,
            dec_embed_dim=48, dec_depth=2, dec_num_heads=2, head_type="linear",
            dtype=torch.float32,
        )


class MASt3RBackbone(ViTEncoder):
    """Encoder + twin decoders (no heads)."""

    def __init__(self, cfg: MASt3RConfig):
        super().__init__(cfg.enc_embed_dim, cfg.enc_depth, cfg.enc_num_heads,
                         cfg.patch_size, rope_base=cfg.rope_base)
        self.cfg = cfg
        self.decoder_embed = Linear(cfg.enc_embed_dim, cfg.dec_embed_dim)
        self.dec_blocks = nn.ModuleList(
            [DecoderBlock(cfg.dec_embed_dim, cfg.dec_num_heads) for _ in range(cfg.dec_depth)]
        )
        self.dec_blocks2 = nn.ModuleList(
            [DecoderBlock(cfg.dec_embed_dim, cfg.dec_num_heads) for _ in range(cfg.dec_depth)]
        )
        self.dec_norm = LayerNorm(cfg.dec_embed_dim)

    def _run_decoder(self, f1, pos1, f2, pos2):
        """-> (x1, x2, hooks1, hooks2); hook 0 is the encoder tokens and the
        last hook the dec_norm'd final tokens."""
        c = self.cfg
        head_dim = c.dec_embed_dim // c.dec_num_heads
        rope1 = rope_2d_angles(pos1, head_dim, c.rope_base)
        rope2 = rope_2d_angles(pos2, head_dim, c.rope_base)
        x1, x2 = self.decoder_embed(f1), self.decoder_embed(f2)
        hooks1, hooks2 = [f1], [f2]
        for blk1, blk2 in zip(self.dec_blocks, self.dec_blocks2):
            x1, x2 = blk1(x1, x2, rope1, rope2), blk2(x2, x1, rope2, rope1)
            hooks1.append(x1)
            hooks2.append(x2)
        x1, x2 = self.dec_norm(x1), self.dec_norm(x2)
        hooks1[-1], hooks2[-1] = x1, x2
        return x1, x2, hooks1, hooks2


class MASt3RNet(MASt3RBackbone):
    def __init__(self, cfg: MASt3RConfig):
        super().__init__(cfg)
        if cfg.head_type not in ("dpt", "linear"):
            raise ValueError(f"unknown head_type {cfg.head_type!r}")
        head_cls = CatMLPDPTHead if cfg.head_type == "dpt" else LinearPts3dHead
        self.downstream_head1 = head_cls(cfg.enc_embed_dim, cfg.dec_embed_dim, cfg.patch_size,
                                         cfg.local_feat_dim)
        self.downstream_head2 = head_cls(cfg.enc_embed_dim, cfg.dec_embed_dim, cfg.patch_size,
                                         cfg.local_feat_dim)

    def _hooks(self, hooks):
        d = self.cfg.dec_depth
        return [hooks[i] for i in (0, d * 2 // 4, d * 3 // 4, d)]

    def decode(self, f1, pos1, f2, pos2, out_hw, views=(1, 2)):
        """Cached-feature two-view decode -> one output dict per requested
        view (pts3d [B,H,W,3], conf [B,H,W], desc [B,H,W,24], desc_conf).
        ``views=(1,)`` skips head 2, which a self-pair (mono) decode discards."""
        p = self.cfg.patch_size
        hp, wp = out_hw[0] // p, out_hw[1] // p
        _, _, hooks1, hooks2 = self._run_decoder(f1, pos1, f2, pos2)
        heads = {1: (self.downstream_head1, hooks1), 2: (self.downstream_head2, hooks2)}
        return tuple(
            heads[i][0](self._hooks(heads[i][1]), hp, wp, out_hw) for i in views
        )


def _canonical_hw(resolution: int, patch: int) -> tuple[int, int]:
    """4:3 landscape, multiples of the patch (512 -> 384x512 at patch 16,
    336 -> 252x336 at patch 14)."""
    h = (int(round(resolution * 3 / 4)) // patch) * patch
    return h, (resolution // patch) * patch


@torch.no_grad()
def init_weights(net: nn.Module, generator: torch.Generator) -> None:
    """Seeded random init: weights ~ N(0, 1/fan_in) (flax's lecun scale),
    biases 0, LayerNorms (1, 0). Values differ from flax's: JAX and torch
    draw different numbers from the same seed."""
    for m in net.modules():
        if isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
            w = m.weight
            if isinstance(m, nn.ConvTranspose2d):
                fan_in = w.shape[0] * w[0, 0].numel()
            else:
                fan_in = w[0].numel()
            w.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=generator)
            if m.bias is not None:
                m.bias.zero_()


class MASt3RModel:
    """A `MASt3RNet` on a device, with the inference entry points."""

    def __init__(self, cfg: MASt3RConfig, net: MASt3RNet, out_hw: tuple[int, int],
                 device: torch.device):
        self.cfg = cfg
        self.net = net
        self.out_hw = out_hw
        self.device = device

    @classmethod
    def create(cls, model_type: str = "mast3r_full", resolution: int = 512,
               precision: str = "bf16", seed: int = 0, head_type: str | None = None,
               device: str | torch.device | None = None,
               cfg: MASt3RConfig | None = None, variant: str = "base") -> "MASt3RModel":
        """Build a randomly initialized model (seeded torch.Generator) on
        `device` (default: the card; raises without CUDA). ``model_type`` is
        "mast3r_full", "dunemast3r" (of `variant` "small" or "base") or
        "tiny"; `cfg` overrides them."""
        dev = resolve_device(device)
        if cfg is None:
            if model_type == "mast3r_full":
                cfg = MASt3RConfig.mast3r_full(precision)
            elif model_type == "dunemast3r":
                cfg = MASt3RConfig.dunemast3r(variant, precision)
            elif model_type == "tiny":
                cfg = MASt3RConfig.tiny()
            else:
                raise ValueError(f"unknown model_type {model_type!r}")
        if head_type is not None:
            cfg = dataclasses.replace(cfg, head_type=head_type)
        with torch.device("meta"):
            net = MASt3RNet(cfg)
        net = net.to_empty(device=dev)
        init_weights(net, torch.Generator(device=dev).manual_seed(seed))
        apply_dtype_policy(net, cfg.dtype)
        return cls(cfg, net.eval(), _canonical_hw(resolution, cfg.patch_size), dev)

    @property
    def embed_dim(self) -> int:
        return self.cfg.enc_embed_dim

    @property
    def patch_size(self) -> int:
        return self.cfg.patch_size

    def set_out_hw(self, h: int, w: int) -> None:
        """Pin the decode output resolution to the processed frame shape
        (preprocessing crops to the input's own aspect ratio, which need not
        be the canonical 4:3 of `create`)."""
        p = self.cfg.patch_size
        if h % p or w % p:
            raise ValueError(f"out_hw {(h, w)} is not a multiple of the patch {p}")
        self.out_hw = (h, w)

    def load_state_dict(self, state: dict, strict: bool = True) -> None:
        """Load an upstream-named state dict (see `models.io`); the dtype
        policy is re-applied by copying into the existing parameters."""
        from mast3r_slam_torch.models.io import load_state_dict

        load_state_dict(self.net, state, strict=strict)

    @torch.no_grad()
    def encode(self, img: torch.Tensor):
        """img [B, H, W, 3] in [-1, 1] -> (feat [B, S, C], pos [B, S, 2])."""
        return self.net.encode(img)

    @torch.no_grad()
    def decode(self, f1, pos1, f2, pos2):
        """Two-view decode from cached features -> (out1, out2)."""
        return self.net.decode(f1, pos1, f2, pos2, self.out_hw)

    @torch.no_grad()
    def mono(self, feat: torch.Tensor, pos: torch.Tensor):
        """Self-pair pointmap from one frame's features [S, C], [S, 2]
        -> (X [H*W, 3], C [H*W, 1]); head 2's output would be discarded, so
        it is not computed (counterpart of inference.mast3r_inference_mono)."""
        (out,) = self.net.decode(feat[None], pos[None], feat[None], pos[None], self.out_hw,
                                 views=(1,))
        return out["pts3d"][0].reshape(-1, 3), out["conf"][0].reshape(-1, 1)

    def num_params(self) -> int:
        return sum(p.numel() for p in self.net.parameters())


def load_mast3r(model_type: str = "mast3r_full", variant: str = "base", resolution: int = 512,
                precision: str = "bf16", checkpoint: str | None = None,
                head_type: str | None = None, seed: int = 0, device=None) -> MASt3RModel:
    """The SLAM loop's model factory: "mast3r_full" or "dunemast3r" (`variant`
    "small" or "base") on `device` (default: the card), initialised from
    `seed`, then, with `checkpoint`, loaded strictly from that local
    upstream-named safetensors / .npz / .pth file (`models.io`)."""
    model = MASt3RModel.create(model_type=model_type, variant=variant, resolution=resolution,
                               precision=precision, seed=seed, head_type=head_type,
                               device=device)
    if checkpoint is not None:
        from mast3r_slam_torch.models.io import load_checkpoint_into

        load_checkpoint_into(model.net, checkpoint)
    return model
