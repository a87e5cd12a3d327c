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

Checkpoint files (the port of ``load_state_dict_file``,
``load_checkpoint_into``, ``save_checkpoint``, ``is_retrieval_state_dict``
and ``import_retrieval_state_dict`` of ``mast3r_slam_tpu/models/io.py``):
safetensors, ``.npz`` and torch ``.pth/.pt/.bin`` files of upstream-named
state dicts, read as numpy arrays, so a file that either package writes loads
in the other. The naver retrieval head's checkpoint is folded into the
port's `RetrievalModel.params` as JAX folds it into its flax params.
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


# The weight map backwards (torch -> flax), for files in JAX's own layout
# (`parallel.trainer`'s checkpoints): each rule undoes one of `_RULES`.
_INVERSE_RULES: list[tuple[str, object]] = [
    (r"^patch_embed\.proj\.(.*)$", r"encoder/patch_embed/proj/\1"),
    (r"^enc_blocks\.(\d+)\.(.*)$", r"encoder/blocks_\1/\2"),
    (r"^enc_norm\.(.*)$", r"encoder/norm/\1"),
    (r"^decoder_embed\.(.*)$", r"decoder_embed/\1"),
    (r"^dec_blocks\.(\d+)\.(.*)$", r"dec_blocks_\1/\2"),
    (r"^dec_blocks2\.(\d+)\.(.*)$", r"dec_blocks2_\1/\2"),
    (r"^dec_norm\.(.*)$", r"dec_norm/\1"),
    (r"^downstream_head([12])\.dpt\.act_postprocess\.(\d+)\.0\.(.*)$",
     r"head\1/act_postprocess_\2/\3"),
    (r"^downstream_head([12])\.dpt\.act_postprocess\.(\d+)\.1\.(.*)$", r"head\1/resample_\2/\3"),
    (r"^downstream_head([12])\.dpt\.scratch\.layer(\d)_rn\.(.*)$",
     lambda m: f"head{m.group(1)}/layer_rn_{int(m.group(2)) - 1}/{m.group(3)}"),
    (r"^downstream_head([12])\.dpt\.scratch\.refinenet(\d)\.resConfUnit1\.(.*)$",
     r"head\1/refine\2/rcu_skip/\3"),
    (r"^downstream_head([12])\.dpt\.scratch\.refinenet(\d)\.resConfUnit2\.(.*)$",
     r"head\1/refine\2/rcu_out/\3"),
    (r"^downstream_head([12])\.dpt\.scratch\.refinenet(\d)\.out_conv\.(.*)$",
     r"head\1/refine\2/out_conv/\3"),
    (r"^downstream_head([12])\.dpt\.head\.0\.(.*)$", r"head\1/head_conv1/\2"),
    (r"^downstream_head([12])\.dpt\.head\.2\.(.*)$", r"head\1/head_conv2/\2"),
    (r"^downstream_head([12])\.dpt\.head\.4\.(.*)$", r"head\1/head_conv3/\2"),
    (r"^downstream_head([12])\.proj\.(.*)$", r"head\1/proj/\2"),
    (r"^downstream_head([12])\.head_local_features\.(.*)$", r"local_head\1/\2"),
]


def flax_path_of(torch_name: str, layer_norm: bool) -> tuple[str, ...]:
    """The flax parameter path (without "params") of a port parameter:
    `params_from_flax`'s name map undone. `layer_norm` says whether the
    owner is a LayerNorm (its weight is flax's ``scale``, else ``kernel``)."""
    owner, _, leaf = torch_name.rpartition(".")
    leaf = {"weight": "scale" if layer_norm else "kernel"}.get(leaf, leaf)
    for pat, repl in _INVERSE_RULES:
        new, n = re.subn(pat, repl, f"{owner}.{leaf}")
        if n:
            head, _, rest = new.rpartition("/")
            return tuple(head.split("/")) + tuple(rest.split("."))
    raise KeyError(f"no flax path for {torch_name!r}")


def to_flax_layout(torch_name: str, value: np.ndarray) -> np.ndarray:
    """`_to_torch_layout` undone: a port weight in its flax kernel's layout."""
    if not torch_name.endswith("weight"):
        return value
    if _DENSE_AS_CONV1X1.search(torch_name):
        return value[..., 0, 0].T
    if value.ndim == 2:
        return value.T
    if value.ndim == 4:
        return value.transpose(2, 3, 1, 0)
    return value


def flax_order(net: nn.Module) -> list[tuple[str, tuple[str, ...]]]:
    """(parameter name, flax path) of every parameter of `net`, in the order
    in which JAX flattens its flax parameter tree (keys sorted at every
    level), so position i is the leaf JAX calls number i."""
    norms = {name for name, m in net.named_modules() if isinstance(m, nn.LayerNorm)}
    pairs = [(name, ("params",) + flax_path_of(name, name.rpartition(".")[0] in norms))
             for name, _ in net.named_parameters()]
    return sorted(pairs, key=lambda pair: pair[1])


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


# -- checkpoint files ---------------------------------------------------------


def load_state_dict_file(path: str) -> dict[str, np.ndarray]:
    """Read a safetensors / .npz / torch .pth (.pt, .bin) state dict as numpy
    arrays. A torch checkpoint wrapped as ``{"model": ..., "args": ...}``
    (the naver releases) is unwrapped and its other entries dropped, a
    ``module.`` prefix is stripped, and torch tensors come back as float32,
    as in JAX.

    The torch file is read with ``weights_only=False``, as JAX reads it:
    PyTorch's default (True) refuses the ``argparse.Namespace`` under
    "args" of the naver files, and the port must load every file that JAX
    loads. That unpickles the file, which can run code: load only local
    files you trust."""
    path = str(path)
    if path.endswith(".npz"):
        with np.load(path) as data:
            return dict(data)
    if path.endswith((".pth", ".pt", ".bin")):
        raw = torch.load(path, map_location="cpu", weights_only=False)
        if isinstance(raw, dict) and "model" in raw:
            raw = raw["model"]
        return {k.removeprefix("module."): v.detach().to(torch.float32).numpy()
                if torch.is_tensor(v) else np.asarray(v) for k, v in raw.items()}
    from safetensors.numpy import load_file

    return load_file(path)


def load_checkpoint_into(net: nn.Module, path: str, strict: bool = True) -> nn.Module:
    """Load a local safetensors / .npz / .pth checkpoint into `net` in place
    (strictly by default, see `load_state_dict`); returns `net`."""
    state = {k: torch.from_numpy(np.ascontiguousarray(v))
             for k, v in load_state_dict_file(path).items()}
    load_state_dict(net, state, strict=strict)
    return net


def save_checkpoint(net: nn.Module, path: str) -> None:
    """Write `net`'s upstream-named state dict as float32 safetensors (or
    .npz by the suffix), the layout `load_checkpoint_into` and JAX's loader
    read."""
    state = {k: v.detach().to(torch.float32).cpu().contiguous().numpy()
             for k, v in net.state_dict().items()}
    if str(path).endswith(".npz"):
        np.savez(path, **state)
    else:
        from safetensors.numpy import save_file

        save_file(state, str(path))


# -- the retrieval head --------------------------------------------------------


def is_retrieval_state_dict(state: Mapping[str, np.ndarray]) -> bool:
    """A naver retrieval checkpoint: attention plus at least one naver
    whitener or projector tensor (``prewhiten.m/.p``, ``postwhiten.m/.p``,
    ``projector.N.weight``) and no decoder head keys. A state dict in the
    head's own names (``postwhiten.weight``) is not one, and takes the
    name-mapped loader (`import_retrieval_params`)."""
    keys = set(state)
    naver = any(k in keys for k in ("prewhiten.m", "prewhiten.p", "postwhiten.m",
                                    "postwhiten.p"))
    naver = naver or any(re.match(r"^projector\.\d+\.weight$", k) for k in keys)
    heads = any(k.startswith("downstream_head") for k in keys)
    return "attention.weight" in keys and naver and not heads


def _params_like(params: dict, tree: dict) -> dict:
    """`tree` (layer -> leaf -> numpy) as float32 tensors on the device of
    `params`."""
    dev = params["whiten"]["kernel"].device
    return {layer: {leaf: torch.as_tensor(np.asarray(v, np.float32), device=dev)
                    for leaf, v in leaves.items()} for layer, leaves in tree.items()}


def import_retrieval_state_dict(params: dict, state: Mapping[str, np.ndarray]) -> dict:
    """Fold a naver retrieval checkpoint into `RetrievalModel.params` (a new
    dict). Upstream computes, in its released config,

        y   = (x - prewhiten.m) @ prewhiten.p
        y   = y @ projector.0.weight.T + projector.0.bias
        a   = attention(y)
        sig = l2norm((weighted mean of y by a - postwhiten.m) @ postwhiten.p)

    The two affine stages before attention fold into ``whiten`` (kernel =
    P_pre @ W_proj.T, bias = b_proj - m_pre @ kernel); postwhiten commutes
    with the weighted mean and loads into ``postwhiten``. The whiteners are
    float64 upstream and are cast to float32. Raises on a multi-layer
    projector, on half of a (mean, projection) pair and on any key that is
    neither the head's nor the backbone's."""
    state = {k.removeprefix("module."): np.asarray(v) for k, v in state.items()}
    known: set[str] = set()

    def take(name):
        if name in state:
            known.add(name)
            return np.asarray(state[name], np.float32)
        return None

    linear = sorted({int(m.group(1)) for k in state
                     if (m := re.match(r"^projector\.(\d+)\.weight$", k))})
    if linear not in ([], [0]):
        raise NotImplementedError(
            f"retrieval checkpoint has a multi-layer projector (linear indices {linear}); only "
            "the released single-Linear config folds into the whiten layer")
    d_in, d_out = params["whiten"]["kernel"].shape
    m_pre, P_pre = take("prewhiten.m"), take("prewhiten.p")
    W_proj, b_proj = take("projector.0.weight"), take("projector.0.bias")
    att_w, att_b = take("attention.weight"), take("attention.bias")
    m_post, P_post = take("postwhiten.m"), take("postwhiten.p")
    for pair, a, b in ((("prewhiten.m", "prewhiten.p"), m_pre, P_pre),
                       (("postwhiten.m", "postwhiten.p"), m_post, P_post),
                       (("projector.0.bias", "projector.0.weight"), b_proj, W_proj)):
        if a is not None and b is None:
            raise KeyError(f"retrieval checkpoint has {pair[0]} without {pair[1]}: refusing to "
                           "drop it silently")
    kernel = np.eye(d_in, dtype=np.float32)
    bias = np.zeros(d_in, dtype=np.float32)
    if P_pre is not None:
        m = np.zeros(d_in, np.float32) if m_pre is None else m_pre.reshape(-1)
        kernel, bias = P_pre, -(m @ P_pre)
    if W_proj is not None:
        kernel = kernel @ W_proj.T
        bias = bias @ W_proj.T + (0.0 if b_proj is None else b_proj)
    if kernel.shape != (d_in, d_out):
        raise ValueError(f"retrieval fold produced kernel {kernel.shape}, the head's whiten "
                         f"expects {(d_in, d_out)}: backbone_dim mismatch")
    if att_w is None or att_b is None:
        raise KeyError("retrieval checkpoint missing attention.{weight,bias}")
    tree = {layer: {leaf: v.detach().cpu().numpy() for leaf, v in leaves.items()}
            for layer, leaves in params.items()}
    tree["whiten"] = {"kernel": kernel, "bias": bias.reshape(d_out)}
    tree["attention"] = {"kernel": att_w.T, "bias": att_b}
    if P_post is not None:
        m = np.zeros(d_out, np.float32) if m_post is None else m_post.reshape(-1)
        tree["postwhiten"] = {"kernel": P_post, "bias": -(m @ P_post)}
    unexpected = sorted(k for k in set(state) - known if not k.startswith("backbone."))
    if unexpected:
        raise KeyError(f"retrieval checkpoint has {len(unexpected)} unrecognized non-backbone "
                       f"keys, e.g. {unexpected[:8]}")
    return _params_like(params, tree)


def import_retrieval_params(params: dict, state: Mapping[str, np.ndarray],
                            strict: bool = True) -> dict:
    """A state dict in the head's own upstream-style names (``whiten.weight``
    [out, in], ``whiten.bias``, likewise ``attention`` and ``postwhiten``)
    -> `RetrievalModel.params` (a new dict), as JAX's generic loader maps
    them. strict=True raises KeyError on a missing or an unexpected key."""
    state = {k.removeprefix("module."): np.asarray(v) for k, v in state.items()}
    tree, missing = {}, []
    for layer, leaves in params.items():
        tree[layer] = {}
        for leaf, value in leaves.items():
            name = f"{layer}.{_LEAF_RENAME[leaf]}"
            if name in state:
                v = state[name]
                tree[layer][leaf] = v.T if leaf == "kernel" else v
                if tuple(tree[layer][leaf].shape) != tuple(value.shape):
                    raise ValueError(f"{name}: checkpoint shape {state[name].shape} does not "
                                     f"map onto {tuple(value.shape)}")
            else:
                missing.append(name)
                tree[layer][leaf] = value.detach().cpu().numpy()
    used = {f"{layer}.{_LEAF_RENAME[leaf]}" for layer, leaves in params.items()
            for leaf in leaves}
    unexpected = sorted(set(state) - used)
    if strict and (missing or unexpected):
        raise KeyError(f"strict load failed: {len(missing)} missing (e.g. {missing[:8]}), "
                       f"{len(unexpected)} unexpected (e.g. {unexpected[:8]})")
    return _params_like(params, tree)
