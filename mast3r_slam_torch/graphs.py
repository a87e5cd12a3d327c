"""CUDA graphs of the tracking window: the port's counterpart of the JAX
package's one compiled program per window (``mast3r_slam_tpu/tracker.py``
``_make_fused_track_chain_scan``) and of its ``lax.cond`` promotion (:469).

* `branch(pred, fn, args, keep)`: ``fn(*args)`` where the one-element bool
  tensor `pred` is set, `keep` elsewhere, with nothing read back to the
  host. This module's `branch` is the select form: it computes ``fn`` and
  picks with ``torch.where``, bit for bit the function of a Python branch,
  since both sides are pure. It is the form of the CPU and of an eager
  window on the card, and it refuses to run under stream capture.
* Under capture a `WindowGraph` hands the step its own branch, which records
  a conditional IF node instead (`if_node`, ``csrc/graph_cond.cu``): the body
  ``fn`` is captured once as a graph of its own (static inputs and outputs,
  its own memory pool), and each IF node runs a copy of it only when the
  device-side `pred` is set. The step copies `args` into the body's inputs
  and then selects between the body's outputs and `keep`. The body also adds
  one to `GraphCache.body_runs`, a device counter.
* `WindowGraph`: one window program captured. Static inputs (copied in before
  each replay), one ``CUDAGraph`` replay, then the outputs cloned so that
  the next replay cannot overwrite rows the caller still holds. The capture
  is warmed up on throwaway copies of the inputs (cuBLAS workspaces, the
  kernel libraries' first calls, and the capture of every branch body), so
  a window's results do not depend on whether it was captured.
* `GraphCache`: a tracker's window graphs by key, sharing one memory pool
  (they never run at once), and dropped together when the model's
  parameters change (a graph holds their addresses).

Launch counts. The kernel wrappers count in Python when they launch, which
under capture happens once, at the capture. A `WindowGraph` records each
counter's change during its capture (`launches`) and during its branch
body's (`body_launches`), takes back what the warm-up and the captures
counted, adds `launches` at each replay, and leaves `body_launches` to the
drain, which adds it once per promotion the stats report
(`FrameTracker.sync_chain`).
"""

from __future__ import annotations

import ctypes
from itertools import chain
from typing import Callable, Optional

import torch

from mast3r_slam_torch.config import get_config
from mast3r_slam_torch.ops import attention, lane_shift, layer_norm, match_taps, pose_gn, rope
from mast3r_slam_torch.utils import profiling
from mast3r_slam_torch.utils.profiling import TRACER, span


# ----------------------------------------------------------- launch counts

def launch_counts() -> dict[str, int]:
    """Every kernel wrapper's launch count, flat: "flash_attention",
    "flash_attention_backward.<symbol>", "lane_shift.<symbol>",
    "graph_cond", "trace_stamp", "pose_gn", "match_taps", "rope", "layer_norm"."""
    counts = {"flash_attention": attention.flash_attention.launches,
              "graph_cond": if_node.launches, "pose_gn": pose_gn.pose_gn_rays.launches,
              "match_taps": match_taps.match_taps.launches, "rope": rope.rope.launches,
              "layer_norm": layer_norm.layer_norm.launches, **profiling.launches}
    for sym, n in attention.flash_attention_backward.launches.items():
        counts[f"flash_attention_backward.{sym}"] = n
    for sym, n in lane_shift.launches.items():
        counts[f"lane_shift.{sym}"] = n
    return counts


def launch_delta(before: dict[str, int], after: dict[str, int]) -> dict[str, int]:
    """after - before, the counters that changed only."""
    return {k: n - before.get(k, 0) for k, n in after.items() if n != before.get(k, 0)}


def add_launches(delta: dict[str, int], times: int = 1) -> None:
    """Add `times` x `delta` (of `launch_delta`) to the wrappers' counts."""
    for name, n in delta.items():
        n *= times
        group, _, sym = name.partition(".")
        if name == "flash_attention":
            attention.flash_attention.launches += n
        elif name == "graph_cond":
            if_node.launches += n
        elif name == "pose_gn":
            pose_gn.pose_gn_rays.launches += n
        elif name == "match_taps":
            match_taps.match_taps.launches += n
        elif name == "rope":
            rope.rope.launches += n
        elif name == "layer_norm":
            layer_norm.layer_norm.launches += n
        elif name in profiling.launches:
            profiling.launches[name] += n
        elif group == "flash_attention_backward":
            attention.flash_attention_backward.launches[sym] += n
        elif group == "lane_shift":
            lane_shift.launches[sym] += n
        else:
            raise KeyError(f"unknown launch counter {name!r}")


# ------------------------------------------------------------------ branch

def select(pred: torch.Tensor, values, keep) -> tuple:
    return tuple(torch.where(pred, v, k) for v, k in zip(values, keep))


def branch(pred: torch.Tensor, fn: Callable, args: tuple, keep: tuple) -> tuple:
    """``fn(*args)`` where `pred` is set, `keep` elsewhere (tuples of
    tensors of the same shapes), by computing both and selecting."""
    if pred.is_cuda and torch.cuda.is_current_stream_capturing():
        raise RuntimeError("branch: the select form under stream capture; a captured window "
                           "takes its WindowGraph's branch (an IF node)")
    return select(pred, fn(*args), keep)


def _lib() -> ctypes.CDLL:
    from mast3r_slam_torch.ops import build

    lib = build.load("graph_cond")
    if lib.graph_cond_if.argtypes is None:
        lib.graph_cond_if.argtypes = [ctypes.c_void_p] * 3
        lib.graph_cond_if.restype = ctypes.c_int
    return lib


def if_node(pred: torch.Tensor, body: torch.cuda.CUDAGraph) -> None:
    """Add to the graph the current stream is capturing a conditional IF
    node that runs a copy of `body` (captured with ``keep_graph=True``) when
    the bool `pred` on the card is set; counts the setter kernel's launch."""
    if pred.device.type != "cuda" or pred.dtype != torch.bool or pred.numel() != 1:
        raise ValueError(f"if_node: pred must be one bool on the card, got {pred.dtype} "
                         f"{tuple(pred.shape)} on {pred.device}")
    if not torch.cuda.is_current_stream_capturing():
        raise RuntimeError("if_node: the current stream is not capturing")
    err = _lib().graph_cond_if(torch.cuda.current_stream(pred.device).cuda_stream,
                               pred.contiguous().data_ptr(), body.raw_cuda_graph())
    if err != 0:
        raise RuntimeError(f"graph_cond_if failed: cudaError {err}")
    if_node.launches += 1


if_node.launches = 0


class _Body:
    """A branch body captured on its own: static inputs and outputs, the
    graph (kept uninstantiated: IF nodes take copies of it) and the launches
    of one run."""

    def __init__(self, cache: "GraphCache", fn: Callable, args: tuple):
        self.inputs = tuple(a.clone() for a in args)
        fn(*self.inputs)  # warm-up on the body's own inputs
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)
        runs = cache.body_runs  # made before the capture, which would record its fill
        before = launch_counts()
        with torch.cuda.graph(self.graph, pool=torch.cuda.graph_pool_handle(),
                              stream=cache.stream, capture_error_mode="thread_local"):
            self.outputs = tuple(fn(*self.inputs))
            runs.add_(1)
        self.launches = launch_delta(before, launch_counts())


class _CaptureBranch:
    """The branch a `WindowGraph` gives the step: during the warm-up the
    select form, after capturing the body graph of each new (fn, argument
    shapes); during the capture an IF node running that body."""

    def __init__(self, cache: "GraphCache"):
        self.cache = cache
        self.capturing = False
        self.used: set = set()

    def __call__(self, pred, fn, args, keep):
        key = (fn.__code__, tuple((tuple(a.shape), a.dtype) for a in args))
        body = self.cache.bodies.get(key)
        if not self.capturing:
            if body is None:
                with span("graph.capture", body=fn.__qualname__):
                    body = self.cache.bodies[key] = _Body(self.cache, fn, args)
                TRACER.count("graph.captures")
            return select(pred, fn(*args), keep)
        if body is None:
            raise RuntimeError("a branch the capture reached was not reached by its warm-up")
        self.used.add(key)
        for dst, src in zip(body.inputs, args):
            dst.copy_(src)
        if_node(pred, body.graph)
        return select(pred, body.outputs, keep)


# ------------------------------------------------------------ window graph

class WindowGraph:
    """One window program ``fn(inputs, branch) -> {name: tensor}`` captured
    at the shapes of `inputs` ({name: tensor}, on the card or the host).
    `run(inputs)` copies them into the static inputs, replays, counts
    `launches` and returns clones of the outputs. `body_launches` are the
    launches of one run of the branch body (at most one body per window), for
    the drain to count per promotion. `host_launches` is what one `run`
    issues from the host: copies in, the replay, clones out. `stamps` are the
    labels of the tracer's stamps captured into it (`profiling.Tracer.window`;
    empty when it was captured with the tracer off): each replay fills one
    row."""

    def __init__(self, cache: "GraphCache", fn: Callable, inputs: dict):
        before = launch_counts()
        cond = _CaptureBranch(cache)
        self.inputs = {k: _on(cache.device, v) for k, v in inputs.items()}
        cur = torch.cuda.current_stream(cache.device)
        cache.stream.wait_stream(cur)
        with torch.cuda.stream(cache.stream):  # the warm-up, on throwaway copies
            fn({k: v.clone() for k, v in self.inputs.items()}, cond)
        cur.wait_stream(cache.stream)
        self.graph = torch.cuda.CUDAGraph()
        cond.capturing = True
        mark = launch_counts()
        with TRACER.capture() as stamps, torch.cuda.graph(
                self.graph, pool=cache.pool, stream=cache.stream,
                capture_error_mode="thread_local"):
            self.outputs = fn(self.inputs, cond)
        self.stamps = list(stamps)
        self.launches = launch_delta(mark, launch_counts())
        if len(cond.used) > 1:
            raise RuntimeError(f"a window graph with {len(cond.used)} branch bodies")
        self.body_launches = dict(cache.bodies[next(iter(cond.used))].launches) if cond.used \
            else {}
        add_launches(launch_delta(launch_counts(), before))  # set-up, not the window's
        self.host_launches = len(self.inputs) + 1 + len(self.outputs)

    def run(self, inputs: dict) -> dict:
        with span("graph.copy_in"):
            for k, v in inputs.items():
                self.inputs[k].copy_(v)
        with span("graph.replay"):
            self.graph.replay()
        if self.stamps:
            TRACER.replayed(self.stamps)
        TRACER.count("graph.replays")
        add_launches(self.launches)
        with span("graph.clone_out"):
            return {k: v.clone() for k, v in self.outputs.items()}


def _on(device: torch.device, x: torch.Tensor) -> torch.Tensor:
    """A copy of `x` on `device`, allocated outside any graph's pool."""
    return torch.empty(x.shape, dtype=x.dtype, device=device).copy_(x)


def window_key(imgs: torch.Tensor, calib: bool, out_hw: tuple) -> tuple:
    """What a captured window program is specific to: the window's length
    and image shape and dtype, the core (calibrated or rays), the decode's
    output shape, and the config the step reads while it is captured
    (``runtime.trace`` in it keeps traced graphs, which hold the tracer's
    stamps, apart from untraced ones)."""
    return (tuple(imgs.shape), imgs.dtype, calib, tuple(out_hw), repr(get_config()))


def param_signature(module: Optional[torch.nn.Module]) -> tuple:
    """Address, dtype and shape of every parameter and buffer of `module`:
    it changes when weights are replaced (quantized, dequantized, moved),
    not when they are overwritten in place."""
    if module is None:
        return ()
    return tuple((t.data_ptr(), t.dtype, tuple(t.shape))
                 for t in chain(module.parameters(), module.buffers()))


class GraphCache:
    """One tracker's window graphs by key, the branch bodies, the memory pool
    the window graphs share, the stream they are captured on, and
    `body_runs`, the device counter every branch body adds one to. The
    graphs are dropped when `lookup` sees another parameter signature."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.graphs: dict = {}
        self.bodies: dict = {}
        self.signature: Optional[tuple] = None
        self._pool = self._stream = self._body_runs = None

    @property
    def pool(self):
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        return self._pool

    @property
    def stream(self) -> torch.cuda.Stream:
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        return self._stream

    @property
    def body_runs(self) -> torch.Tensor:
        if self._body_runs is None:
            self._body_runs = torch.zeros((), dtype=torch.int64, device=self.device)
        return self._body_runs

    def lookup(self, key, signature: tuple):
        """The graph of `key`, or None; first drops every graph and body when
        `signature` is not the one they were captured under."""
        if signature != self.signature:
            self.graphs.clear()
            self.bodies.clear()
            self.signature = signature
        return self.graphs.get(key)

    def window(self, key, signature: tuple, fn: Callable, inputs: dict,
               shape: Optional[tuple] = None) -> WindowGraph:
        """The graph of `key`, captured from `fn` at `inputs` on first use
        (inside a ``graph.capture`` span that carries `shape`)."""
        graph = self.lookup(key, signature)
        if graph is None:
            with span("graph.capture", shape=shape):
                graph = self.graphs[key] = WindowGraph(self, fn, inputs)
            TRACER.count("graph.captures")
        return graph
