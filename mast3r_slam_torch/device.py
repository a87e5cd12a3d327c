"""Device resolution and the dtype policy of the port.

Entry points run on the card: ``resolve_device(None)`` is ``cuda`` and raises
on a host without CUDA rather than falling back to the CPU. The CPU is taken
only when the caller asks for it (``device="cpu"``), as the tests do.

The dtype policy is the JAX package's (``mast3r_slam_tpu/models``): matmuls
and convolutions run in the model's compute dtype (bf16 for the deployment
model), LayerNorms in f32, the pts3d regression conv of the DPT head and the
linear pts3d head in f32, and everything downstream of the network (matcher
costs, Gauss-Newton, Lie groups, fusion) in f32. `apply_dtype_policy` casts
the parameters once; each layer casts its input to its weight's dtype, which
is what flax's ``dtype=`` does on every call.
"""

from __future__ import annotations

import torch
import torch.nn as nn

_PRECISIONS = {"fp32": torch.float32, "bf16": torch.bfloat16, "fp16": torch.bfloat16}


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` -> the card (raises without CUDA); ``"cpu"`` on request."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "mast3r_slam_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run the plain PyTorch versions"
            )
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def precision_dtype(precision: str) -> torch.dtype:
    """Model precision name -> compute dtype (fp16 maps to bf16, as in JAX)."""
    try:
        return _PRECISIONS[precision]
    except KeyError:
        raise ValueError(f"unknown precision {precision!r}") from None


class Linear(nn.Linear):
    """nn.Linear that computes in its weight's dtype (flax ``Dense(dtype=)``)."""

    keep_f32 = False

    def forward(self, x):
        w = self.weight
        return nn.functional.linear(x.to(w.dtype), w, self.bias)


class Conv2d(nn.Conv2d):
    keep_f32 = False

    def forward(self, x):
        return super().forward(x.to(self.weight.dtype))


class ConvTranspose2d(nn.ConvTranspose2d):
    keep_f32 = False

    def forward(self, x):
        return super().forward(x.to(self.weight.dtype))


class LayerNorm(nn.LayerNorm):
    """f32 LayerNorm (eps 1e-6, flax and upstream): output is f32."""

    def __init__(self, dim: int):
        super().__init__(dim, eps=1e-6)

    def forward(self, x):
        return nn.functional.layer_norm(
            x.float(), self.normalized_shape, self.weight, self.bias, self.eps
        )


def keep_f32(layer: nn.Module) -> nn.Module:
    """Mark a Linear/Conv layer to stay in f32 under `apply_dtype_policy`."""
    layer.keep_f32 = True
    return layer


def apply_dtype_policy(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast every compute layer's parameters to `dtype`; LayerNorms and the
    layers marked by `keep_f32` stay f32."""
    for m in model.modules():
        if isinstance(m, (Linear, Conv2d, ConvTranspose2d)):
            m.to(torch.float32 if m.keep_f32 else dtype)
    return model
