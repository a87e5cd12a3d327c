"""Weights across the two packages: flax params -> the port's state dict.

`params_from_flax` takes the JAX package's flax parameter tree as a nested
dict of numpy arrays (``{"params": {...}}`` or its inner dict) and returns
the upstream-named state dict the port's modules use. The name rules and
layout rules are this package's own copy of ``mast3r_slam_tpu/models/io.py``
(``_RULES``, ``_to_torch_layout``); the port imports nothing from there.

Layouts (flax -> torch): Linear kernel [in, out] -> weight [out, in]; Conv
kernel [kh, kw, in, out] -> [out, in, kh, kw]; ConvTranspose (flax
transpose_kernel) [kh, kw, out, in] -> [in, out, kh, kw]; the DPT
act_postprocess Dense [in, out] -> 1x1 conv [out, in, 1, 1]; LayerNorm
scale -> weight.

`load_state_dict` loads strictly: a missing or an unexpected key raises,
except the two upstream parameter groups that real checkpoints carry and the
forward never reads (``mask_token`` and refinenet4's ``resConfUnit1``).
"""

from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch
import torch.nn as nn

_RULES: list[tuple[str, str]] = [
    (r"^encoder/patch_embed/proj/(.*)$", r"patch_embed.proj.\1"),
    (r"^encoder/blocks_(\d+)/(.*)$", r"enc_blocks.\1.\2"),
    (r"^encoder/norm/(.*)$", r"enc_norm.\1"),
    (r"^decoder_embed/(.*)$", r"decoder_embed.\1"),
    (r"^dec_blocks_(\d+)/(.*)$", r"dec_blocks.\1.\2"),
    (r"^dec_blocks2_(\d+)/(.*)$", r"dec_blocks2.\1.\2"),
    (r"^dec_norm/(.*)$", r"dec_norm.\1"),
    (r"^head([12])/act_postprocess_(\d+)/(.*)$",
     r"downstream_head\1.dpt.act_postprocess.\2.0.\3"),
    (r"^head([12])/resample_(\d+)/(.*)$", r"downstream_head\1.dpt.act_postprocess.\2.1.\3"),
    (r"^head([12])/layer_rn_0/(.*)$", r"downstream_head\1.dpt.scratch.layer1_rn.\2"),
    (r"^head([12])/layer_rn_1/(.*)$", r"downstream_head\1.dpt.scratch.layer2_rn.\2"),
    (r"^head([12])/layer_rn_2/(.*)$", r"downstream_head\1.dpt.scratch.layer3_rn.\2"),
    (r"^head([12])/layer_rn_3/(.*)$", r"downstream_head\1.dpt.scratch.layer4_rn.\2"),
    (r"^head([12])/refine(\d)/rcu_skip/(.*)$",
     r"downstream_head\1.dpt.scratch.refinenet\2.resConfUnit1.\3"),
    (r"^head([12])/refine(\d)/rcu_out/(.*)$",
     r"downstream_head\1.dpt.scratch.refinenet\2.resConfUnit2.\3"),
    (r"^head([12])/refine(\d)/out_conv/(.*)$",
     r"downstream_head\1.dpt.scratch.refinenet\2.out_conv.\3"),
    (r"^head([12])/head_conv1/(.*)$", r"downstream_head\1.dpt.head.0.\2"),
    (r"^head([12])/head_conv2/(.*)$", r"downstream_head\1.dpt.head.2.\2"),
    (r"^head([12])/head_conv3/(.*)$", r"downstream_head\1.dpt.head.4.\2"),
    (r"^head([12])/proj/(.*)$", r"downstream_head\1.proj.\2"),
    (r"^local_head([12])/(.*)$", r"downstream_head\1.head_local_features.\2"),
]
_LEAF_RENAME = {"kernel": "weight", "scale": "weight", "bias": "bias"}
_DENSE_AS_CONV1X1 = re.compile(r"\.dpt\.act_postprocess\.\d+\.0\.weight$")
_IGNORED_UPSTREAM = (
    re.compile(r"^mask_token$"),
    re.compile(r"^downstream_head[12]\.dpt\.scratch\.refinenet4\.resConfUnit1\."),
)


def _flax_path_to_torch_name(path: tuple[str, ...]) -> str:
    parts = [p for p in path if p != "params"]
    name = "/".join(parts[:-1]) + "/" + _LEAF_RENAME.get(parts[-1], parts[-1])
    for pat, repl in _RULES:
        new, n = re.subn(pat, repl, name)
        if n:
            name = new
            break
    return name.replace("/", ".")


def _to_torch_layout(torch_name: str, value: np.ndarray) -> np.ndarray:
    if not torch_name.endswith("weight"):
        return value
    if _DENSE_AS_CONV1X1.search(torch_name):
        return value.T[..., None, None]
    if value.ndim == 2:
        return value.T
    if value.ndim == 4:
        return value.transpose(3, 2, 0, 1)
    return value


def _flatten(tree: Mapping, prefix: tuple[str, ...] = ()):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _flatten(value, prefix + (str(key),))
        else:
            yield prefix + (str(key),), value


def params_from_flax(tree: Mapping) -> dict[str, torch.Tensor]:
    """Flax params (nested dict of numpy arrays) -> upstream-named f32 state dict."""
    out = {}
    for path, value in _flatten(tree):
        name = _flax_path_to_torch_name(path)
        arr = _to_torch_layout(name, np.asarray(value, dtype=np.float32))
        out[name] = torch.from_numpy(np.array(arr, dtype=np.float32, order="C"))
    return out


def load_state_dict(net: nn.Module, state: Mapping[str, torch.Tensor], strict: bool = True):
    """Copy `state` into `net`'s parameters (each keeps its device and dtype).

    strict=True raises KeyError on any missing parameter or unexpected key
    (the documented-dead upstream keys excepted) and ValueError on a shape
    mismatch."""
    state = {k: v for k, v in state.items() if not any(p.search(k) for p in _IGNORED_UPSTREAM)}
    own = net.state_dict()
    missing = sorted(set(own) - set(state))
    unexpected = sorted(set(state) - set(own))
    if strict and (missing or unexpected):
        raise KeyError(
            f"strict load failed: {len(missing)} missing (e.g. {missing[:8]}), "
            f"{len(unexpected)} unexpected (e.g. {unexpected[:8]})"
        )
    with torch.no_grad():
        for name, value in state.items():
            if name not in own:
                continue
            target = own[name]
            value = torch.as_tensor(value)
            if tuple(value.shape) != tuple(target.shape):
                raise ValueError(
                    f"{name}: checkpoint shape {tuple(value.shape)} != model {tuple(target.shape)}"
                )
            target.copy_(value)
