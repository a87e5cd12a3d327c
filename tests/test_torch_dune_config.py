"""The configs of the patch-14 `dunemast3r` family (models/mast3r.py) against
the JAX package's, field for field, and at full width (the base variant,
768-wide encoder, on the meta device and through `jax.eval_shape`, so
nothing is allocated) every parameter that `params_from_flax`'s rules carry
across, by name and torch layout. Exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mast3r_slam_tpu.models import MASt3RConfig as JaxMASt3RConfig
from mast3r_slam_tpu.models.mast3r import MASt3RNet as JaxMASt3RNet
from mast3r_slam_torch.models import MASt3RConfig, MASt3RNet, io, load_mast3r, mast3r

FIELDS = ("enc_embed_dim", "enc_depth", "enc_num_heads", "patch_size", "dec_embed_dim",
          "dec_depth", "dec_num_heads", "head_type", "local_feat_dim", "rope_base")


@pytest.mark.parametrize("variant", ["small", "base"])
def test_dunemast3r_configs_match_jax(variant):
    ours = MASt3RConfig.dunemast3r(variant, "bf16")
    theirs = JaxMASt3RConfig.dunemast3r(variant, "bf16")
    assert {f: getattr(ours, f) for f in FIELDS} == {f: getattr(theirs, f) for f in FIELDS}
    assert ours.patch_size == 14 and ours.dtype == torch.bfloat16
    assert ours.enc_embed_dim // ours.enc_num_heads == 64  # the attention kernel's head width
    with pytest.raises(ValueError, match="variant"):
        MASt3RConfig.dunemast3r("large")


def test_dunemast3r_base_parameters_carry_across_at_full_width():
    cfg = MASt3RConfig.dunemast3r("base")
    with torch.device("meta"):
        net = MASt3RNet(cfg)
    ours = {k: tuple(v.shape) for k, v in net.state_dict().items()}
    jnet = JaxMASt3RNet(JaxMASt3RConfig.dunemast3r("base"))
    img = jax.ShapeDtypeStruct((1, 252, 336, 3), jnp.float32)
    shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0), img, img)
    theirs = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        keys = tuple(p.key for p in path)
        name = io._flax_path_to_torch_name(keys)
        zeros = np.broadcast_to(np.float32(0), leaf.shape)  # a view: no memory
        theirs[name] = io._to_torch_layout(name, zeros).shape
    assert set(ours) == set(theirs)
    assert {k: v for k, v in ours.items() if theirs[k] != v} == {}
    assert ours["patch_embed.proj.weight"] == (768, 3, 14, 14)
    assert ours["enc_blocks.11.attn.qkv.weight"] == (2304, 768)
    assert ours["downstream_head1.head_local_features.fc2.weight"][0] == 25 * 14 * 14


class _Built(Exception):
    pass


def test_load_mast3r_builds_the_family_on_request(monkeypatch):
    """load_mast3r -> MASt3RModel.create with the family's config (the net
    itself is not built here: the base variant holds 0.3 billion weights)."""

    def stop(cfg):
        raise _Built(cfg)

    monkeypatch.setattr(mast3r, "MASt3RNet", stop)
    for variant in ("small", "base"):
        with pytest.raises(_Built) as built:
            load_mast3r(model_type="dunemast3r", variant=variant, resolution=336,
                        precision="fp32", device="cpu")
        assert built.value.args[0] == MASt3RConfig.dunemast3r(variant, "fp32")
    assert mast3r._canonical_hw(336, 14) == (252, 336)
