"""Typed configuration: the port's own copy of ``mast3r_slam_tpu/config.py``.

Same schema, same defaults, same YAML ``inherit`` / ``_base_`` loader, so the
files under ``configs/`` load unchanged into either package. Unknown keys
raise. Every field is read by the port; two runtime knobs are exact by
construction in eager PyTorch and so change nothing (`gelu_barrier`,
`serving_scan_unroll`; see their readers, `models.vit.Mlp` and `serving`).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, fields
from pathlib import Path
from typing import Any

import yaml


@dataclass
class DatasetConfig:
    img_size: int = 512
    img_downsample: int = 1
    subsample: int = 1
    reverse: bool = False
    calib: list[float] | None = None  # [fx, fy, cx, cy], processed pixels


@dataclass
class MatchingConfig:
    # "auto" -> "simple" if use_simple else "iterative"; or "simple" |
    # "iterative" | "dense" (the shifted-tap matcher, ops/dense_match.py)
    method: str = "auto"
    dense_radius: int = 6
    dense_dilations: tuple = (1,)
    dense_desc_weight: float = 1.0
    dense_kernel: str = "xla"  # accepted for config compatibility only
    use_simple: bool = True
    max_iter: int = 10
    lambda_init: float = 1e-8
    convergence_thresh: float = 1e-6
    dist_thresh: float = 0.1
    use_refine: bool = True
    refine_radius: int = 3
    refine_dilation: int = 2

    def __post_init__(self):
        if self.dense_kernel not in ("xla", "auto"):
            raise ValueError(
                f"matching.dense_kernel={self.dense_kernel!r}: only 'xla' "
                "(and 'auto' == 'xla') exist"
            )


@dataclass
class TrackingConfig:
    min_match_frac: float = 0.05
    C_conf: float = 0.0
    Q_conf: float = 1.5
    rel_error: float = 1e-3
    delta_norm: float = 1e-3
    max_iters: int = 10
    huber: float = 1.345
    robust: str = "huber"  # huber | tukey
    tukey_t: float = 4.6851
    sigma_ray: float = 0.003
    sigma_dist: float = 10.0
    sigma_pixel: float = 1.0
    sigma_depth: float = 10.0
    pixel_border: int = 0
    depth_eps: float = 0.0
    match_frac_thresh: float = 0.333
    filtering_mode: str = "weighted_pointmap"
    filtering_score: str = "median"


@dataclass
class LocalOptConfig:
    window_size: int = 1_000_000
    pin: int = 1
    max_iters: int = 10
    min_match_frac: float = 0.1
    C_conf: float = 0.0
    Q_conf: float = 1.5
    sigma_ray: float = 0.003
    sigma_dist: float = 10.0
    sigma_pixel: float = 1.0
    sigma_depth: float = 10.0
    pixel_border: int = 0
    depth_eps: float = 0.0
    delta_norm: float = 1e-3
    huber: float = 1.345
    robust: str = "huber"
    tukey_t: float = 4.6851
    max_edges: int = 256
    backend_tasks_per_frame: int = 1
    solve_variant: str = "noconcat"
    point_stride: int = 1


@dataclass
class RetrievalConfig:
    k: int = 3
    min_thresh: float = 0.005
    whitening_kf: int = 0
    method: str = "signature"
    asmk_n_words: int = 256
    asmk_proj_dim: int = 64
    asmk_codebook_kf: int = 8


@dataclass
class RelocConfig:
    min_match_frac: float = 0.3
    strict: bool = True


@dataclass
class ModelConfig:
    model_type: str = "mast3r_full"
    variant: str = "base"
    resolution: int = 512
    precision: str = "bf16"
    checkpoint: str | None = None
    head_type: str | None = None


@dataclass
class RuntimeConfig:
    keyframe_capacity: int = 512
    prefetch_depth: int = 2
    donate_buffers: bool = True
    pipeline: bool = True
    sync_every: int = 8  # frames per tracking window (FrameTracker.track_window)
    snapshot_every: int = 0
    snapshot_path: str = "slam_state.npz"
    serving_microbatch: int = 4
    serving_scan_unroll: int = 1
    # the window program (tracker.FrameTracker._window_steps): decode a
    # window's frames against its first keyframe in chunks of
    # window_decode_microbatch before the chain; encode them in one batch
    window_spec_decode: bool = False
    window_decode_microbatch: int = 4
    window_batched_encode: bool = False
    # JAX's "auto" | "xla" | "flash" (an unknown value takes "xla") compute
    # one function, f32 scores and sums with P rounded to bf16, and differ in
    # who fuses it; the port has no XLA fuser to defer to, so every value,
    # an unknown one included, runs ops.attention.flash_attention
    attention_impl: str = "auto"
    gelu_barrier: bool = False  # exact by construction here (models.vit.Mlp)
    weight_quant: str = "none"
    gelu_impl: str = "erf"  # "erf" (exact) | "tanh" (approximation)
    eviction: str = "covisibility"
    eviction_protect: int = 4
    metrics_path: str = ""
    viewer_port: int = 0
    viewer_refresh: int = 10
    # the port's tracer over each SLAM.run (utils/profiling.py): host spans,
    # per-frame timestamps, counters and device stamps captured into the
    # window graphs; with trace_path, a Chrome trace written at the run's end
    trace: bool = False
    trace_path: str = ""


@dataclass
class Config:
    use_calib: bool = False
    single_thread: bool = True
    dataset: DatasetConfig = field(default_factory=DatasetConfig)
    matching: MatchingConfig = field(default_factory=MatchingConfig)
    tracking: TrackingConfig = field(default_factory=TrackingConfig)
    local_opt: LocalOptConfig = field(default_factory=LocalOptConfig)
    retrieval: RetrievalConfig = field(default_factory=RetrievalConfig)
    reloc: RelocConfig = field(default_factory=RelocConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    runtime: RuntimeConfig = field(default_factory=RuntimeConfig)

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "Config":
        return _merge_into(cls(), d)


def _merge_into(cfg: Any, updates: dict[str, Any]) -> Any:
    """Apply a (possibly partial, possibly nested) dict onto a dataclass."""
    known = {f.name for f in fields(cfg)}
    kwargs: dict[str, Any] = {}
    for key, value in updates.items():
        if key in ("inherit", "_base_"):
            continue
        if key not in known:
            raise KeyError(
                f"Unknown config key {key!r} for {type(cfg).__name__}; "
                f"known keys: {sorted(known)}"
            )
        current = getattr(cfg, key)
        if dataclasses.is_dataclass(current) and isinstance(value, dict):
            kwargs[key] = _merge_into(current, value)
        else:
            kwargs[key] = value
    return dataclasses.replace(cfg, **kwargs)


def _load_yaml_with_inherit(config_path: Path) -> dict[str, Any]:
    with open(config_path) as f:
        raw = yaml.safe_load(f) or {}
    base_key = "inherit" if "inherit" in raw else ("_base_" if "_base_" in raw else None)
    if base_key is None:
        return raw
    base_path = Path(raw[base_key])
    if not base_path.is_absolute():
        # project root first, then the config's own directory
        candidate = config_path.parent.parent / raw[base_key]
        base_path = candidate if candidate.exists() else config_path.parent / raw[base_key]
    base = _load_yaml_with_inherit(base_path)
    _deep_update(base, raw)
    base.pop(base_key, None)
    return base


def _deep_update(base: dict, update: dict) -> None:
    for key, value in update.items():
        if key in base and isinstance(base[key], dict) and isinstance(value, dict):
            _deep_update(base[key], value)
        else:
            base[key] = value


_config: Config | None = None


def default_config() -> Config:
    """The in-code defaults, installed nowhere."""
    return Config()


def load_config(config_path: str | Path) -> Config:
    """Load a YAML config (with inheritance) and install it globally."""
    global _config
    _config = Config.from_dict(_load_yaml_with_inherit(Path(config_path)))
    return _config


def set_config(cfg: Config) -> Config:
    global _config
    _config = cfg
    return cfg


def reset_config() -> None:
    global _config
    _config = None


def get_config() -> Config:
    """Current config, or a fresh default if none was installed."""
    return _config if _config is not None else Config()
