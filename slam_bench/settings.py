"""The port's configuration for a cell: the traffic mix's settings, the
cell's overrides, and the configuration file's GELU."""

from __future__ import annotations

import copy


def merge(base: dict, over: dict) -> dict:
    out = copy.deepcopy(base)
    for k, v in over.items():
        out[k] = merge(out.get(k, {}), v) if isinstance(v, dict) else v
    return out


def settings_of(cell) -> dict:
    s = merge(cell.traffic["settings"], cell.spec.get("overrides", {}))
    return merge(s, {"runtime": {"gelu_impl": cell.config["gelu"]}})
