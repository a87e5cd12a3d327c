"""MASt3R-SLAM in PyTorch and CUDA for an NVIDIA H100: the port of
``mast3r_slam_tpu`` (JAX on a TPU), which stays the reference.

This package imports torch and never jax, and nothing of ``mast3r_slam_tpu``.
Its entry points (`models.MASt3RModel.create`, `tracker.FrameTracker`) run on
the card unless the caller passes ``device="cpu"``. The kernels written by
hand for Hopper live in ``csrc/`` and are built with nvcc on first use
(`ops.build`); every one has a plain PyTorch version beside it, which CPU
tensors take.

Ported so far: the per-frame chained tracking step and `slam.SLAM.run`
under every file of ``configs/`` (rays and calibrated modes; the dense,
simple and iterative matchers; signature and ASMK retrieval; the
`mast3r_full` and `dunemast3r` models; the window program's knobs), serving
(`serving.BatchTracker`), offline reconstruction (`offline`), int8 weights
(`models.quant`), the live viewer (`viewer`), checkpoint files
(`models.io`), the Lie group classes (`lie`) and the run services in
``utils/`` (snapshots, metrics, profiling, evaluation, plots): everything
of the JAX package but ``parallel/`` (ROADMAP.md).
"""
