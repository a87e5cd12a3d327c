"""MASt3R-SLAM in PyTorch and CUDA for an NVIDIA H100: the port of
``mast3r_slam_tpu`` (JAX on a TPU), which stays the reference.

This package imports torch and never jax, and nothing of ``mast3r_slam_tpu``.
Its entry points (`SLAM`, `load_mast3r`, `models.MASt3RModel.create`,
`tracker.FrameTracker`, `BatchTracker`, `OfflineReconstructor`) run on the
card unless the caller passes ``device="cpu"``. The kernels written by hand
for Hopper live in ``csrc/`` and are built with nvcc on first use
(`ops.build`); every one has a plain PyTorch version beside it, which CPU
tensors take.

The port does what the JAX package does, function for function: the SLAM
loop under every file of ``configs/``, serving, offline reconstruction, int8
weights, the live viewer, checkpoints and snapshots, the run services in
``utils/`` and ``parallel/`` (sharded serving and solves, the pipeline and
sequence parallel encoders, multihost, training).
tests/test_torch_api_coverage.py holds its public names and parameters to
the JAX package's, with a table of the JAX idioms that have another form
here.

The top level exports what JAX's does: the config accessors and
``__version__`` at import, and `SLAM`, `load_mast3r`, `OfflineReconstructor`,
`BatchTracker` and `LiveViewer` on first access, so that importing the
package stays light::

    from mast3r_slam_torch import SLAM, default_config
"""

__version__ = "0.1.0"

from mast3r_slam_torch.config import default_config, get_config, load_config, set_config

__all__ = [
    "get_config",
    "load_config",
    "set_config",
    "default_config",
    "SLAM",
    "load_mast3r",
    "__version__",
]

_LAZY = {
    "SLAM": ("mast3r_slam_torch.slam", "SLAM"),
    "load_mast3r": ("mast3r_slam_torch.models.mast3r", "load_mast3r"),
    "OfflineReconstructor": ("mast3r_slam_torch.offline", "OfflineReconstructor"),
    "BatchTracker": ("mast3r_slam_torch.serving", "BatchTracker"),
    "LiveViewer": ("mast3r_slam_torch.viewer", "LiveViewer"),
}


def __getattr__(name):
    """The lazy top-level exports."""
    if name in _LAZY:
        import importlib

        module, attr = _LAZY[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
