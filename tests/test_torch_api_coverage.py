"""The port's public surface against the JAX package's, function by function.

Both packages are read with `ast` and imported by neither this test nor its
helpers. For every module of ``mast3r_slam_tpu/``, each public top-level
function and class, each public method of a class (and ``__init__`` and
``__call__``), each parameter name of those, and each name of a module's
``__all__`` must have its counterpart at the same path in
``mast3r_slam_torch/``:

* a function or class of the same name in the same module, or a name the
  module imports (a re-export, as the ``__init__`` files do);
* a method of the class or of a base class the port defines (bases are
  resolved by name across the port), where a flax ``__call__`` is the torch
  module's ``forward``;
* every parameter name but ``self``, ``cls`` and private ``_`` ones.

What the port does in another form is listed in `EXCEPTIONS`, one line per
entry, with what stands in its place. An entry that is no longer needed (the
JAX name is gone, or the port now has the name) fails the test, so the table
stays the list of what differs.
"""

from __future__ import annotations

import ast
import pathlib

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
JAX_ROOT, PORT_ROOT = REPO / "mast3r_slam_tpu", REPO / "mast3r_slam_torch"

# "module:name" (a function, class or method) or "module:name(param)" -> what
# the port has in its place.
EXCEPTIONS = {
    # -- JAX and flax idiom
    "lie/groups.py:SO3.tree_flatten": "pytree registration; the classes wrap a torch.Tensor",
    "lie/groups.py:SO3.tree_unflatten": "pytree registration",
    "lie/groups.py:SE3.tree_flatten": "pytree registration",
    "lie/groups.py:SE3.tree_unflatten": "pytree registration",
    "lie/groups.py:Sim3.tree_flatten": "pytree registration",
    "lie/groups.py:Sim3.tree_unflatten": "pytree registration",
    "models/mast3r.py:MASt3RNet.setup": "flax's setup; the submodules are built in __init__",
    "models/mast3r.py:MASt3RModel.__init__(params)": "the weights live in `net`, an nn.Module",
    "models/mast3r.py:MASt3RModel.__init__(resolution)":
        "`out_hw`, the decode's (h, w), which `create` derives from the resolution",
    "models/retrieval.py:RetrievalNet": "`RetrievalModel` holds the head's weights and applies it",
    "models/retrieval.py:RetrievalNet.__call__": "`RetrievalModel._apply`",
    "models/quant.py:QuantApplyNet": "`quantize_module` turns each layer's weight into int8 "
                                     "buffers that the layer dequantizes at every call",
    "models/quant.py:QuantApplyNet.__init__": "`quantize_module(net, dtype)`",
    "models/quant.py:QuantApplyNet.apply": "each quantized layer's forward (`device._LayerWeight`)",
    "models/quant.py:quantize_params": "`quantize_module`",
    "models/quant.py:dequantize_params": "`dequantize_module`",
    "models/quant.py:is_quantized_leaf": "`is_quantized_param`",
    "models/quant.py:quantized_fraction(qparams)": "`net`, the quantized module",
    "models/io.py:export_torch_state_dict": "the port's weights are a state dict already "
                                            "(`net.state_dict()`); `params_from_flax` maps JAX's",
    "models/io.py:import_torch_state_dict": "`load_state_dict(net, state, strict)`",
    "models/io.py:load_checkpoint_into(params)": "`net`, loaded in place",
    "models/io.py:save_checkpoint(params)": "`net`",
    "ops/attention.py:flash_attention(block_q)": "`attention_schedule` picks the tiles",
    "ops/attention.py:flash_attention(block_k)": "`attention_schedule` picks the tiles",
    "ops/attention.py:flash_attention(interpret)": "CPU tensors take `attention_reference`",
    "ops/attention.py:attention_xla": "`attention_reference`, the plain PyTorch version",
    "ops/attention.py:attention": "`models.vit` calls `flash_attention` on the card and "
                                  "`attention_reference` elsewhere (`runtime.attention_impl`)",
    "ops/iter_proj.py:iter_proj_reference": "`iter_proj` is itself the plain PyTorch version",
    "ops/refine.py:refine_matches_reference": "`refine_matches` is itself the plain version",
    "models/heads.py:LinearPts3dHead.__call__(tokens)":
        "`hooks`: the linear head takes the decoder's hooks, as the DPT head, and projects the "
        "last",
    # -- parallel/: parameters are the module's own
    "parallel/pipeline.py:encoder_stage_params(params)": "`net`",
    "parallel/pipeline.py:pipelined_encode(params)": "the stage's blocks, held by the rank",
    "parallel/pipeline.py:make_pipeline_mesh(devices)":
        "the world's ranks (`torch.distributed`), one card each",
    "parallel/sequence.py:sequence_parallel_encode(params)": "`net`",
    "parallel/sharding.py:infer_param_shardings(params)": "`net`",
    "parallel/sharding.py:shard_params(params)": "`net`, sharded in place",
    "parallel/train.py:make_train_step(params_example)": "`net`",
    "parallel/train.py:mast3r_loss(params)": "`net`",
    "parallel/trainer.py:load_train_ckpt(params_like)": "`net`, loaded in place",
    "parallel/trainer.py:load_train_ckpt(opt_state_like)": "`optimizer`, loaded in place",
    "parallel/trainer.py:save_train_ckpt(params)": "`net`",
    "parallel/trainer.py:save_train_ckpt(opt_state)": "`optimizer`",
    "parallel/trainer.py:train_loop(net)": "`model`, whose network a copy of is trained",
    "parallel/trainer.py:train_loop(params)": "the parameters of `model.net`",
    # -- arena and window program
    "frame.py:Keyframes.__init__(feat_dim)": "unread in JAX too: the feature slab is sized at "
                                             "the first append",
    "frame.py:Keyframes.__init__(num_patches)": "unread in JAX too",
    "tracker.py:WindowRow": "a window handle keeps each frame's outputs as its own dict "
                            "(`out['rows']`), so no lazy view into stacked outputs is needed",
    "tracker.py:WindowRow.__init__": "see WindowRow",
}


def _params(fn: ast.FunctionDef) -> list[str]:
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    names += [x.arg for x in (a.vararg, a.kwarg) if x is not None]
    return [n for n in names if n not in ("self", "cls") and not n.startswith("_")]


def _public_method(name: str) -> bool:
    return not name.startswith("_") or name in ("__init__", "__call__")


def _module_api(path: pathlib.Path):
    """-> (defs {qualname: params or None for a class}, classes {name: (bases,
    {method: params})}, imported names, __all__ or None)."""
    tree = ast.parse(path.read_text())
    defs, classes, imported, exported = {}, {}, set(), None
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if not node.name.startswith("_"):
                defs[node.name] = _params(node)
        elif isinstance(node, ast.ClassDef):
            methods = {m.name: _params(m) for m in node.body
                       if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))}
            bases = [b.id if isinstance(b, ast.Name) else getattr(b, "attr", "")
                     for b in node.bases]
            classes[node.name] = (bases, methods)
            if not node.name.startswith("_"):
                defs[node.name] = None
                defs.update({f"{node.name}.{m}": p for m, p in methods.items()
                             if _public_method(m)})
        elif isinstance(node, ast.ImportFrom):
            imported.update(a.asname or a.name for a in node.names)
        elif isinstance(node, ast.Import):
            imported.update((a.asname or a.name).split(".")[0] for a in node.names)
        elif isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "__all__" for t in node.targets):
            exported = [ast.literal_eval(e) for e in node.value.elts]
    return defs, classes, imported, exported


def _package(root: pathlib.Path) -> dict:
    return {str(p.relative_to(root)): _module_api(p) for p in sorted(root.rglob("*.py"))}


JAX_API, PORT_API = _package(JAX_ROOT), _package(PORT_ROOT)
PORT_CLASSES = {name: cls for _, classes, _, _ in PORT_API.values()
                for name, cls in classes.items()}


def _port_method(cls_name: str, method: str):
    """The method's parameters in the port's class or its bases (by name),
    a flax `__call__` as `forward`; None if absent."""
    seen, todo = set(), [cls_name]
    while todo:
        name = todo.pop(0)
        if name in seen or name not in PORT_CLASSES:
            continue
        seen.add(name)
        bases, methods = PORT_CLASSES[name]
        for m in (method, "forward") if method == "__call__" else (method,):
            if m in methods:
                return methods[m]
        todo.extend(bases)
    return None


def _counterpart(module: str, qualname: str):
    """-> (found, the port's parameters or None)."""
    if module not in PORT_API:
        return False, None
    defs, classes, imported, _ = PORT_API[module]
    if "." in qualname:
        cls, method = qualname.split(".", 1)
        if cls not in classes:
            return False, None
        params = _port_method(cls, method)
        return params is not None, params
    if qualname in defs:
        return True, defs[qualname]
    return qualname in imported, None


def _gaps() -> list[str]:
    """Every JAX name or parameter without a counterpart in the port."""
    gaps = []
    for module, (defs, _, _, exported) in JAX_API.items():
        for qualname, params in defs.items():
            found, port_params = _counterpart(module, qualname)
            if not found:
                gaps.append(f"{module}:{qualname}")
                continue
            if params is None or port_params is None:
                continue
            gaps += [f"{module}:{qualname}({p})" for p in params if p not in port_params]
        for name in exported or ():
            if name not in _port_exports(module):
                gaps.append(f"{module}:__all__[{name}]")
    return gaps


def _port_exports(module: str) -> set:
    """The names the port's module exports: its `__all__`, or without one
    its public definitions and imports."""
    if module not in PORT_API:
        return set()
    defs, _, imported, exported = PORT_API[module]
    return set(exported) if exported is not None else set(defs) | imported


def test_every_module_has_its_twin():
    assert sorted(set(JAX_API) - set(PORT_API)) == []


def test_every_public_name_and_parameter_has_a_counterpart():
    missing = [g for g in _gaps() if g not in EXCEPTIONS]
    assert missing == [], "JAX names without a counterpart in mast3r_slam_torch:\n" + "\n".join(
        missing)


def test_no_exception_is_stale():
    gaps = set(_gaps())
    stale = [key for key in EXCEPTIONS if key not in gaps]
    assert stale == [], f"entries the port now has, or JAX no longer has: {stale}"


@pytest.mark.parametrize("module", sorted(m for m, api in JAX_API.items() if api[3]))
def test_all_names_are_exported(module):
    """Each name of a JAX module's `__all__` is exported by the port's."""
    missing = [n for n in JAX_API[module][3] if n not in _port_exports(module)]
    assert [n for n in missing if f"{module}:__all__[{n}]" not in EXCEPTIONS] == []


def test_the_walk_sees_the_surface():
    """The walk reads what it should: known names, methods, a flax
    `__call__` as `forward` through a base class, a re-export."""
    assert JAX_API["ops/linalg.py"][0]["solve_2x2"] == ["A", "b", "damping"]
    assert _counterpart("frame.py", "Keyframes.get_confidences") == (True, [])
    assert _counterpart("models/vit.py", "EncoderBlock.__call__") == (True, ["x", "rope"])
    assert _counterpart("models/mast3r.py", "MASt3RNet.encode") == (True, ["img"])
    assert _counterpart("ops/__init__.py", "solve_3x3") == (True, None)
    assert _counterpart("tracker.py", "WindowRow") == (False, None)
    assert len(EXCEPTIONS) < len(JAX_API) * 2
