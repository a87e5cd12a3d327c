"""The comparison that decides ``correct``: each sampled frame's step, as the
timed path produced it, against the plain reference (`reference.step`) given
the same weights, the same frames and the keyframe state the step started
from, layer by layer.

The window's rows carry the frame's encoding, its two-view pointmap and
confidence, its pose and the fused keyframe pointmap, and not the matches,
descriptors or descriptor confidences. So the network is compared end to
end, and the solve and the fusion stage by stage: the reference solves the
pose from the program's own pointmap and confidence (with its own matches
and descriptor confidences), and fuses with the program's pose.

Numbers (relative gaps are ||program - reference|| / ||reference|| in
float64; ``<name>_med`` is the median over the sampled frames, ``<name>``
the worst frame):

* ``feat_bias``, ``pts_bias``, ``conf_bias``: the encoder's output, the
  frame view's pointmap and its log-confidence (the decoder and the DPT
  head): the error averaged over every token or pixel of every sampled
  frame, channel by channel, as its root mean square over the root mean
  square of the reference. Rounding noise averages out of it; an error that
  every token shares (such as one from the weights) does not;
* ``feat_rel``, ``pts_rel``, ``conf_rel``: the same per frame;
* ``pose_rel``: the frame's gathered points moved by the program's pose and
  by the reference's float32 solve of the same problem; ``pose_cost``: the
  problem's robust cost at the program's pose over its cost at the
  reference's, less one; ``init_rel``: the pose the step started from
  against the reference's (how far the solve moved);
* ``held``: frames where the program's pose is the pose it started from
  (to 1e-6), ``held_ref`` where the reference's first step was a zero step
  (its float32 factorization failed, or the step left float32's range),
  ``held_apart`` where exactly one of them held;
* ``fused_rel``, ``fused_bias``: the fused keyframe pointmap against the
  reference's float32 fusion of the reference's keyframe view, moved by the
  program's pose, into the state the step started from;
* ``unique_gap``: the share of keyframe pixels the matches claim,
  program against the reference's own step;
* ``events``: frames whose event (tracked, new keyframe, skipped) differs
  from the reference's own step's.

With ``controls`` the stages' controls are read too, under
``control.<name>``: the reference itself in the program's place one
precision below the float32 the configuration states for the solve and the
fusion, i.e. the solve and the fusion in bfloat16.

A cell's file names the numbers it compares and their limits. Numbers it
does not name are printed only.
"""

from __future__ import annotations

import math

import numpy as np

from slam_bench import weights
from slam_bench.frames import DriftStream, network_input
from slam_bench.settings import settings_of


def _finite_rows(a, b):
    """(a, b) as float64 [rows, channels] on the rows the reference b holds
    finite, or None where a is not finite on one of them. A random network
    can put a pixel at infinity, and then both sides do."""
    import torch

    a, b = a.double().reshape(b.shape[0], -1), b.double().reshape(b.shape[0], -1)
    keep = torch.isfinite(b).all(1)
    a, b = a[keep], b[keep]
    return (a, b) if bool(torch.isfinite(a).all()) else None


def _rel(a, b) -> float:
    import torch

    ab = _finite_rows(a, b)
    if ab is None:
        return math.inf
    a, b = ab
    return float(torch.linalg.vector_norm(a - b) / torch.clamp(torch.linalg.vector_norm(b),
                                                               min=1e-30))


def reference_net(cell, seed: int, dev):
    import torch

    from slam_bench.reference.network import Net, NetSizes, set_float32_exact

    set_float32_exact()
    sizes = NetSizes.from_config({**cell.config["network"], "gelu": cell.config["gelu"]})
    with torch.device("meta"):
        meta = Net(sizes)
    served = weights.make(meta, seed, dev, cell.config["precision"])
    net = Net(sizes).to(dev)
    for name, p in net.named_parameters():  # each leaf in its served dtype
        p.data = served[name]
    del served
    return net.eval()


class Bias:
    """The error averaged over rows, channel by channel, as its root mean
    square over the reference's root mean square."""

    def __init__(self):
        self.err, self.sq, self.n, self.bad = 0.0, 0.0, 0, False

    def add(self, prog, ref) -> None:
        ab = _finite_rows(prog, ref)
        if ab is None:
            self.bad = True
            return
        prog, ref = ab
        self.err = self.err + (prog - ref).sum(0)
        self.sq += float((ref * ref).sum())
        self.n += ref.shape[0]

    def value(self) -> float:
        import torch

        if self.bad:
            return math.inf
        mean = self.err / self.n
        return float(torch.sqrt((mean * mean).mean() / (self.sq / (self.n * mean.numel()))))


def slam_steps(cell, seed: int, samples: list, dev, controls: bool = False,
               per_frame: bool = False) -> dict:
    """The numbers above over `samples` (the entry's `Sampler`). With
    `per_frame`, also ``frames``: each sampled frame's pose readings (the
    problem's cost at the starting pose, the program's, the reference's
    float32 and float64 solves' and, with `controls`, the bfloat16 solve's;
    which of them held; the system's `conditioning` at the start)."""
    import torch

    from slam_bench.reference import step as ref

    if not samples:
        return {"samples": 0}
    settings = settings_of(cell)
    tcfg, mcfg = settings["tracking"], settings["matching"]
    if (tcfg["robust"], tcfg["filtering_mode"]) != ("huber", "weighted_pointmap"):
        raise ValueError("the reference step is the huber, weighted-pointmap one")
    c = cell.config
    res, patch = c["resolution"], c["network"]["patch_size"]
    stream = DriftStream.from_traffic(seed, cell.traffic["frames"])
    net = reference_net(cell, seed, dev)

    def image(fid: int) -> torch.Tensor:
        u8 = network_input(stream.frame(fid), res, patch)
        return torch.from_numpy(np.ascontiguousarray(u8)).to(dev).float() / 255.0 * 2.0 - 1.0

    kf_cache: dict = {}
    frames: list = []
    per: dict = {}  # name -> the value of each sampled frame
    bias = {k: Bias() for k in ("feat", "pts", "conf", "fused", "control.fused")}

    def keep(name: str, v: float) -> None:
        per.setdefault(name, []).append(math.inf if math.isnan(v) else v)

    def pose_numbers(prefix: str, prob: dict, T: torch.Tensor, T_ref: torch.Tensor) -> None:
        m = prob["mask"]
        if not bool(m.any()):
            return
        Xg = prob["Xf_g"][m]
        keep(prefix + "pose_rel", _rel(ref.act(T, Xg), ref.act(T_ref, Xg)))
        keep(prefix + "pose_cost", ref.cost(prob, T, tcfg) / ref.cost(prob, T_ref, tcfg) - 1.0)

    with torch.no_grad():
        for s in sorted(samples, key=lambda s: s["fid"]):
            s = {k: v.to(dev) if isinstance(v, torch.Tensor) else v for k, v in s.items()}
            if s["kf_fid"] not in kf_cache:
                f, p = net.encode(image(s["kf_fid"])[None])
                kf_cache = {s["kf_fid"]: (f[0], p[0])}
            kf_feat, kf_pos = kf_cache[s["kf_fid"]]
            state = dict(kf_X=s["p_kf_X"], kf_C=s["p_kf_C"], kN=s["kN"],
                         T_prev=ref.sim3_to_mat(s["p_T_WCf"]), kf_T=ref.sim3_to_mat(s["p_kf_T"]))
            r = ref.decode_step(net, image(s["fid"]), kf_feat, kf_pos, mcfg)
            # the network, end to end
            for name, prog, want in (("feat", s["feat"], r["feat"]),
                                     ("pts", s["frame_X"], r["Xff"]),
                                     ("conf", torch.log(s["frame_C"]), torch.log(r["Cff"]))):
                keep(f"{name}_rel", _rel(prog, want))
                bias[name].add(prog, want)
            # the reference's own step: its statistics and event
            own = ref.pose_problem(r["Xff"], r["Cff"], r["Qff"], r["Qkf"], r["idx"], r["valid"],
                                   state, tcfg)
            stats = own["stats"] + [r["hit"].double().mean().item()]
            keep("unique_gap", abs(float(s["stats"][2]) - stats[2]))
            keep("events", float(int(round(float(s["stats"][3]))) != ref.decide(stats, tcfg)))
            # the solve, from the program's own pointmap and confidence
            prob = ref.pose_problem(s["frame_X"], s["frame_C"], r["Qff"], r["Qkf"], r["idx"],
                                    r["valid"], state, tcfg)
            T_ref, held_ref = ref.solve(prob, tcfg)
            T_prog = ref.inv(state["kf_T"]) @ ref.sim3_to_mat(s["T_WCf"])
            pose_numbers("", prob, T_prog, T_ref)
            pose_numbers("init_", prob, prob["T_init"], T_ref)
            m = prob["mask"]
            held = bool(m.any()) and _rel(ref.act(T_prog, prob["Xf_g"][m]),
                                          ref.act(prob["T_init"], prob["Xf_g"][m])) < 1e-6
            keep("held", float(held))
            keep("held_ref", float(held_ref))
            keep("held_apart", float(held != held_ref))
            if per_frame:
                T_64, held_64 = ref.solve(prob, tcfg, torch.float64)
                fr = dict(fid=s["fid"], rows=int(prob["mask"].sum()), held=held,
                          held_ref=held_ref, held_64=held_64,
                          rho=ref.conditioning(prob, prob["T_init"], tcfg),
                          **{f"c_{k}": ref.cost(prob, T, tcfg) for k, T in (
                              ("init", prob["T_init"]), ("prog", T_prog), ("ref", T_ref),
                              ("ref64", T_64))})
                frames.append(fr)
            # the fusion, with the program's pose
            Xkk = ref.act(T_prog, r["Xkf"].double())
            fused = ref.fuse(state["kf_X"], state["kf_C"], s["kN"], Xkk, r["Ckf"])
            keep("fused_rel", _rel(s["ret_X"], fused))
            bias["fused"].add(s["ret_X"], fused)
            if controls:
                T_ctl, held_ctl = ref.solve(prob, tcfg, torch.bfloat16)
                pose_numbers("control.", prob, T_ctl, T_ref)
                if per_frame:
                    frames[-1].update(c_ctl=ref.cost(prob, T_ctl, tcfg), held_ctl=held_ctl)
                X_ctl = ref.fuse(state["kf_X"], state["kf_C"], s["kN"], Xkk, r["Ckf"],
                                 torch.bfloat16)
                keep("control.fused_rel", _rel(X_ctl, fused))
                bias["control.fused"].add(X_ctl, fused)
    counts = ("events", "held", "held_ref", "held_apart")
    out = {name: max(v) for name, v in per.items() if name not in counts}
    out.update({f"{name}_med": float(np.median(v)) for name, v in per.items()
                if name not in counts})
    for pre in ("", "control."):  # the median frame's cost gap, either way
        if pre + "pose_cost_med" in out:
            out[pre + "pose_cost_gap"] = abs(out[pre + "pose_cost_med"])
    out.update({name: int(sum(per[name])) for name in counts})
    out.update({f"{name}_bias": b.value() for name, b in bias.items() if b.n})
    out["samples"] = len(samples)
    if per_frame:
        out["frames"] = frames
    return out


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {value, limit}}): every limited number present,
    finite and at or under its limit, and at least one frame sampled. A
    value that is missing or not finite is given as None."""
    values = {name: numbers.get(name) for name in limits}
    values = {n: v if v is not None and math.isfinite(v) else None for n, v in values.items()}
    ok = numbers.get("samples", 0) > 0 and all(
        v is not None and v <= limits[n] for n, v in values.items())
    return ok, {n: {"value": values[n], "limit": limits[n]} for n in limits}
