"""The network's weights, made by the benchmark from the seed on the device.

The leaves and shapes are those of the plain reference network
(`reference.network.Net`), whose parameter names are the port's. The rule is
a frozen copy of the port's ``models/mast3r.init_weights``: weights of
linear and convolution layers ~ N(0, 1/fan_in), biases 0, LayerNorms (1, 0).
The normal draws come from one ``torch.Generator`` on the device, in a few
flat buffers of at most `CHUNK` elements, and each leaf is then cut to the
dtype the configuration serves it in: float32 for the LayerNorms and each
DPT head's last (pts3d) convolution, the configuration's precision for the
rest, as the port's dtype policy (``device.apply_dtype_policy``) holds
them. Both the port and the reference are given these values.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

CHUNK = 1 << 26  # elements per draw (256 MB of float32)
F32_LEAVES = (".dpt.head.4.",)  # kept float32 by the port's policy
DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}


def _leaves(net: nn.Module):
    """(name, tensor shape, kind, fan_in) per parameter, in module order."""
    out = []
    for mname, m in net.named_modules():
        for pname, p in m.named_parameters(recurse=False):
            name = f"{mname}.{pname}" if mname else pname
            if isinstance(m, nn.LayerNorm):
                kind = "one" if pname == "weight" else "zero"
            elif pname == "bias":
                kind = "zero"
            elif isinstance(m, nn.ConvTranspose2d):
                kind = ("normal", p.shape[0] * p[0, 0].numel())
            else:
                kind = ("normal", p[0].numel())
            out.append((name, tuple(p.shape), kind, m))
    return out


@torch.no_grad()
def make(net_meta: nn.Module, seed: int, device, precision: str) -> dict[str, torch.Tensor]:
    """{name: tensor on `device` in its served dtype} for the leaves of
    `net_meta` (a reference network on the meta device)."""
    served = DTYPES[precision]
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 64))
    leaves = _leaves(net_meta)
    out: dict[str, torch.Tensor] = {}

    def dtype_of(name: str, m) -> torch.dtype:
        if isinstance(m, nn.LayerNorm) or any(k in f".{name}" for k in F32_LEAVES):
            return torch.float32
        return served

    chunk: list = []

    def flush() -> None:
        n = sum(math.prod(s) for _, s, _, _, _ in chunk)
        buf = torch.empty(n, dtype=torch.float32, device=device).normal_(generator=gen)
        at = 0
        for name, shape, fan_in, m, dt in chunk:
            k = math.prod(shape)
            out[name] = (buf[at:at + k].view(shape) / math.sqrt(fan_in)).to(dt)
            at += k
        chunk.clear()

    pending = 0
    for name, shape, kind, m in leaves:
        dt = dtype_of(name, m)
        if kind == "one":
            out[name] = torch.ones(shape, dtype=dt, device=device)
        elif kind == "zero":
            out[name] = torch.zeros(shape, dtype=dt, device=device)
        else:
            k = math.prod(shape)
            if chunk and pending + k > CHUNK:
                flush()
                pending = 0
            chunk.append((name, shape, kind[1], m, dt))
            pending += k
    if chunk:
        flush()
    return {name: out[name] for name, *_ in leaves}
