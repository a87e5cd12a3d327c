"""The yardstick's arithmetic: model FLOPs per event, the attention kernel's
bound per launch, and the H100's peaks.

FLOPs are the matrix products and convolutions of the network (2 per
multiply-add; normalisations, softmax and elementwise work are left out),
enumerated from a configuration file's widths and the decode's pixel grid.
The enumeration is a rewrite of the JAX-era `benchmarks/cost_model.py` for
the port's network (its DPT head runs each fusion block's 1x1 conv before
the x2 resize, the pts3d conv at the full image size) and the H100's peaks;
`tests/test_bench_cost.py` holds it to torch's FLOP counter on the plain
reference network.

Events (the harness's log of what the port ran, by time):

* ``step``: one tracked frame: an encode and a two-view decode, both heads;
* ``mono``: a promotion's self-pair decode: both decoders, head 1 only;
* ``init``: the first frame: an encode and a mono decode;
* ``backend``: a symmetric backend decode of ``pairs`` keyframe pairs: one
  two-view decode, both heads, at batch 2 * pairs.
"""

from __future__ import annotations

from dataclasses import dataclass

# NVIDIA H100 SXM data sheet, dense: bf16 tensor cores, HBM3.
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
ATTENTION_SYMBOL = "flash_fwd_kernel"  # csrc/flash_attention.cu's forward kernel


@dataclass(frozen=True)
class Shapes:
    """Widths of a configuration and the token grid it decodes at."""

    enc_dim: int
    enc_depth: int
    enc_heads: int
    dec_dim: int
    dec_depth: int
    dec_heads: int
    patch: int
    feat_dim: int
    height: int
    width: int

    @classmethod
    def from_config(cls, cfg: dict) -> "Shapes":
        n, i = cfg["network"], cfg["input"]
        return cls(n["enc_embed_dim"], n["enc_depth"], n["enc_num_heads"], n["dec_embed_dim"],
                   n["dec_depth"], n["dec_num_heads"], n["patch_size"], n["local_feat_dim"],
                   i["height"], i["width"])

    @property
    def tokens(self) -> int:
        return (self.height // self.patch) * (self.width // self.patch)


def _attn(s: int, d: int, skv: int | None = None) -> float:
    """q k^T and p v over all heads: 2 * s * skv * d each."""
    return 4.0 * s * (s if skv is None else skv) * d


def encode_flops(m: Shapes) -> float:
    s, d = m.tokens, m.enc_dim
    block = 2.0 * s * d * 3 * d + _attn(s, d) + 2.0 * s * d * d + 2 * 2.0 * s * d * 4 * d
    return 2.0 * s * (m.patch * m.patch * 3) * d + m.enc_depth * block


def decoder_flops(m: Shapes) -> float:
    """Both decoders over both views (a mono decode runs them too)."""
    s, e, d = m.tokens, m.enc_dim, m.dec_dim
    block = (2.0 * s * d * 3 * d + _attn(s, d) + 2.0 * s * d * d
             + 4 * 2.0 * s * d * d + _attn(s, d) + 2 * 2.0 * s * d * 4 * d)
    return 2 * (2.0 * s * e * d + m.dec_depth * block)


def head_flops(m: Shapes, features: int = 256, dims=(96, 192, 384, 768)) -> float:
    """One view's CatMLP-DPT head: the DPT pts3d/conf head and the local
    feature MLP. Pixel counts are in tokens; the pyramid is x4, x2, x1, /2."""
    s = m.tokens
    hooks = (m.enc_dim, m.dec_dim, m.dec_dim, m.dec_dim)
    pix = (16 * s, 4 * s, s, s / 4)
    f = 0.0
    for i, (hd, ld, px) in enumerate(zip(hooks, dims, pix)):
        f += 2.0 * s * hd * ld  # 1x1 reassemble
        if i == 0:
            f += 2.0 * px * ld * ld  # ConvT 4x4 stride 4: one tap per output pixel
        elif i == 1:
            f += 2.0 * px * ld * ld  # ConvT 2x2 stride 2
        elif i == 3:
            f += 2.0 * px * 9 * ld * ld  # conv 3x3 stride 2
        f += 2.0 * px * 9 * ld * features  # layer_rn 3x3
    ff = features * features
    for k, px in ((4, s / 4), (3, s), (2, 4 * s), (1, 16 * s)):
        units = 1 if k == 4 else 2  # refinenet4 has no skip unit
        f += units * 2 * 2.0 * px * 9 * ff + 2.0 * px * ff  # RCU convs, 1x1 out_conv
    full = m.height * m.width
    f += 2.0 * (64 * s) * 9 * features * (features // 2)  # head conv 1, at 8x the grid
    f += 2.0 * full * 9 * (features // 2) * 32 + 2.0 * full * 32 * 4
    idim = m.enc_dim + m.dec_dim
    f += 2.0 * s * idim * 4 * idim + 2.0 * s * 4 * idim * (m.feat_dim + 1) * m.patch ** 2
    return f


def event_flops(m: Shapes, kind: str, pairs: int = 0) -> float:
    enc, dec, head = encode_flops(m), decoder_flops(m), head_flops(m)
    if kind == "step":
        return enc + dec + 2 * head
    if kind == "mono":
        return dec + head
    if kind == "init":
        return enc + dec + head
    if kind == "backend":
        return 2 * pairs * (dec + 2 * head)
    raise ValueError(f"unknown event {kind!r}")


def attention_bound_s(b: int, h: int, sq: int, skv: int, d: int = 64, itemsize: int = 2) -> float:
    """The least time one attention launch can take: the larger of its
    operations over the bf16 peak and its q, k, v, o bytes over HBM's."""
    ops = 4.0 * b * h * sq * skv * d
    nbytes = itemsize * b * h * d * (2 * sq + 2 * skv)
    return max(ops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)


def event_attention(m: Shapes, kind: str, pairs: int = 0) -> list[tuple[int, float]]:
    """(launches, bound seconds per launch) of the attention an event runs."""
    s = m.tokens
    enc = (m.enc_depth, attention_bound_s(1, m.enc_heads, s, s, m.enc_dim // m.enc_heads))
    dec_b = 2 * pairs if kind == "backend" else 1
    dec = (4 * m.dec_depth,
           attention_bound_s(dec_b, m.dec_heads, s, s, m.dec_dim // m.dec_heads))
    return {"step": [enc, dec], "mono": [dec], "init": [enc, dec], "backend": [dec]}[kind]


def window_flops(m: Shapes, ev: dict) -> float:
    """FLOPs of an event count (``step``, ``mono``, ``init``, and the pairs of
    each backend decode under ``backend_pairs``)."""
    f = sum(ev.get(k, 0) * event_flops(m, k) for k in ("step", "mono", "init"))
    return f + sum(event_flops(m, "backend", p) for p in ev.get("backend_pairs", []))


def window_attention(m: Shapes, ev: dict) -> tuple[int, float]:
    """(launches, summed bound seconds) of the attention an event count runs."""
    parts = [(ev.get(k, 0), event_attention(m, k)) for k in ("step", "mono", "init")]
    parts += [(1, event_attention(m, "backend", p)) for p in ev.get("backend_pairs", [])]
    launches = sum(n * c for n, per in parts for c, _ in per)
    return launches, sum(n * c * b for n, per in parts for c, b in per)
