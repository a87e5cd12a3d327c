"""Several cards: device meshes, tensor parallelism, sharded serving and
graph solves, pipeline and sequence parallel encodes, several hosts, and
MASt3R training (the port of ``mast3r_slam_tpu/parallel/``).

JAX writes each of these as one program over a `jax.sharding.Mesh`, with
XLA inserting the collectives. The port runs one process per card in a
`torch.distributed` process group, describes the layout with a
`DeviceMesh` of JAX's axis names, and calls the collectives itself:

* `mesh` - `make_mesh` (JAX's shape rule), `init_distributed`, `spawn`;
* `sharding` - Megatron's column / row rules, `shard_params` splits a model
  in place (``serving.BatchTracker(mesh=)`` and the trainer use it);
* `pipeline` - GPipe over encoder depth ("pp"), point-to-point sends;
* `sequence` - the token axis over "sp", K/V all-gathered for attention;
* `multihost` - process groups across hosts, tp kept inside a host;
* `train` / `trainer` - the losses, the (dp, tp) train step with a gradient
  through the attention kernel, AdamW, checkpoints in JAX's layout.

The graph solve's edge sharding lives with the solve
(``ops.gauss_newton.gauss_newton_graph(mesh=)``, ``global_opt.FactorGraph``).
"""

from mast3r_slam_torch.parallel import multihost
from mast3r_slam_torch.parallel.mesh import init_distributed, make_mesh, spawn
from mast3r_slam_torch.parallel.pipeline import (encoder_stage_params, jit_pipelined_encode,
                                                 make_pipeline_mesh, pipelined_encode)
from mast3r_slam_torch.parallel.sequence import (jit_sequence_parallel_encode,
                                                 sequence_parallel_encode)
from mast3r_slam_torch.parallel.sharding import infer_param_shardings, shard_params
from mast3r_slam_torch.parallel.train import TrainState, make_train_step, mast3r_loss

__all__ = [
    "make_mesh",
    "multihost",
    "make_pipeline_mesh",
    "encoder_stage_params",
    "pipelined_encode",
    "jit_pipelined_encode",
    "sequence_parallel_encode",
    "jit_sequence_parallel_encode",
    "infer_param_shardings",
    "shard_params",
    "TrainState",
    "make_train_step",
    "mast3r_loss",
    "init_distributed",
    "spawn",
]
