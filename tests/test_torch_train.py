"""MASt3R training in the port (`parallel.train`) against JAX's
(`mast3r_slam_tpu.parallel.train`) on the CPU, the f32 tiny model carrying
the same flax weights (`params_from_flax`), on the batch of
`synthetic_pair_batch`.

* The three losses equal JAX's on the same inputs (rtol 1e-5, f32).
* `mast3r_loss`'s gradient for every parameter against `jax.grad` mapped
  through the weight map: within 1e-3 of each parameter's own largest JAX
  gradient magnitude, and no gradient zero where JAX's is not. f32: the gap
  is ~1e-6 of the model's largest gradient; relative to a parameter's own it
  reaches 3.7e-4 on the smallest ones (last decoder block's norm2, 1.3e-5 in
  magnitude), where the sums cancel.
* Attention's backward (`ops.attention.attention_backward`, the plain
  version of the card's backward kernels, from the forward's output and
  log-sum-exp, and autograd through `attention_reference`, the CPU's) against
  `jax.vjp` of `attention_xla`: f32 within 1e-5, bf16 within 2e-2 of the
  largest gradient (P and its cotangent rounded to bf16 on both sides, sums
  in other orders).
* 3 AdamW steps (`adamw`) against `optax.adamw(1e-4)` on the same
  gradients: within rtol 3e-7 (2 ulp: torch decays the parameter before
  the Adam step, optax adds wd·param to the update).
* The (dp 2 x tp 2) train step on 4 gloo ranks against the unsharded step,
  the ranks' valid masks different: the loss equals JAX's loss of the global
  batch (rtol 1e-5); every gradient within the band above of the
  unsharded step's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mast3r_slam_tpu.models import MASt3RConfig as JaxMASt3RConfig
from mast3r_slam_tpu.models import MASt3RModel as JaxMASt3RModel
from mast3r_slam_tpu.models.mast3r import MASt3RNet as JaxMASt3RNet
from mast3r_slam_tpu.ops.attention import attention_xla
from mast3r_slam_tpu.parallel import train as jtrain
from mast3r_slam_torch.models.io import params_from_flax
from mast3r_slam_torch.ops.attention import (attention_backward, attention_lse_reference,
                                             attention_reference)
from mast3r_slam_torch.parallel import train
from mast3r_slam_torch.parallel.mesh import spawn
from mast3r_slam_torch.parallel.trainer import synthetic_pair_batch
from test_torch_helpers import flax_tree
from test_torch_parallel_workers import tiny_model, train_rank

LOSS_RTOL = 1e-5
GRAD_REL = 1e-3


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for the port's training steps in this process:
    beside JAX's thread pool, torch's eight threads made a tiny-model step
    25x slower (0.19 s at one thread, 4.5 s at eight, on the 8-core CPU)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def pair():
    jm = JaxMASt3RModel.create(resolution=64, _test_cfg=JaxMASt3RConfig.tiny())
    state = params_from_flax(flax_tree(jm.params))
    return jm, state


def _batch(seed: int, b: int = 4, m: int = 8, ragged: bool = False) -> dict:
    batch = synthetic_pair_batch(np.random.default_rng(seed), b, 48, 64, m)
    if ragged:  # the second half of the batch (the second dp rank's) mostly invalid
        rng = np.random.default_rng(seed + 1)
        for key in ("valid1", "valid2"):
            v = rng.uniform(size=(b, 48, 64)) < np.array([0.9] * (b // 2) + [0.3] * (b - b // 2))[
                :, None, None]
            batch[key] = torch.from_numpy(v)
        batch["corr_valid"] = torch.from_numpy(rng.uniform(size=(b, m)) < 0.6)
    return batch


def _jnp(batch: dict) -> dict:
    return {k: jnp.asarray(v.numpy()) for k, v in batch.items()}


def _assert_grads(got: dict, want: dict):
    for name, w in want.items():
        g = got[name]
        w = w.numpy() if torch.is_tensor(w) else w
        scale = np.abs(w).max()
        assert g is not None, f"{name}: no gradient"
        err = np.abs(g.numpy() - w).max()
        assert err <= GRAD_REL * scale + 1e-12, (name, err, scale)
        if scale > 0:
            assert np.abs(g.numpy()).max() > 0, f"{name}: zero gradient where JAX's is not"


def test_losses_match_jax():
    rng = np.random.default_rng(0)
    pred = rng.normal(size=(2, 6, 8, 3)).astype(np.float32)
    gt = rng.normal(size=(2, 6, 8, 3)).astype(np.float32)
    conf = (1 + np.exp(rng.normal(size=(2, 6, 8)))).astype(np.float32)
    valid = rng.uniform(size=(2, 6, 8)) < 0.7
    want = jtrain.confidence_regression_loss(*map(jnp.asarray, (pred, conf, gt, valid)))
    got = train.confidence_regression_loss(*map(torch.from_numpy, (pred, conf, gt, valid)))
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)
    d1 = rng.normal(size=(2, 6, 8, 5)).astype(np.float32)
    d2 = rng.normal(size=(2, 6, 8, 5)).astype(np.float32)
    i1, i2 = (rng.integers(0, 48, (2, 7)).astype(np.int32) for _ in range(2))
    cv = rng.uniform(size=(2, 7)) < 0.8
    want = jtrain.matching_infonce_loss(*map(jnp.asarray, (d1, d2, i1, i2, cv)))
    got = train.matching_infonce_loss(*map(torch.from_numpy, (d1, d2, i1, i2, cv)))
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)


@pytest.fixture(scope="module")
def jax_loss(pair):
    """JAX's loss and its gradient, jitted once for the module."""
    net = JaxMASt3RNet(pair[0].cfg)
    return jax.jit(jax.value_and_grad(lambda p, b: jtrain.mast3r_loss(net, p, b), has_aux=True))


def _loss_and_grads(pair, jax_loss, batch):
    jm, state = pair
    (jloss, jaux), jgrads = jax_loss(jm.params, _jnp(batch))
    model = tiny_model(state, master_weights=True)
    loss, aux = train.mast3r_loss(model.net, batch)
    loss.backward()
    grads = {n: p.grad for n, p in model.net.named_parameters()}
    return (jloss, jaux, params_from_flax(flax_tree(jgrads))), (loss, aux, grads)


@pytest.mark.parametrize("ragged", [False, True])
def test_mast3r_loss_and_every_gradient_match_jax(pair, jax_loss, ragged):
    (jloss, jaux, jgrads), (loss, aux, grads) = _loss_and_grads(pair, jax_loss,
                                                                _batch(5, ragged=ragged))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=LOSS_RTOL)
    for k in ("regr", "match"):
        np.testing.assert_allclose(float(aux[k].detach()), float(jaux[k]), rtol=LOSS_RTOL)
    assert set(grads) == set(jgrads)
    _assert_grads(grads, jgrads)


# (dtype, Sq, Skv): Sq != Skv as cross attention has it, and ragged lengths
# (40 and 56 tokens, not multiples of the kernels' 64-row tiles).
ATTENTION_GRAD_CASES = [pytest.param(d, 40, 56, id=d) for d in ("float32", "bfloat16")] + [
    pytest.param(d, sq, skv, id=f"{d}-{sq}x{skv}")
    for d in ("float32", "bfloat16") for sq, skv in ((40, 40), (56, 56), (56, 40))]


@pytest.mark.parametrize("dtype,sq,skv", ATTENTION_GRAD_CASES)
def test_attention_backward_matches_jax_vjp(dtype, sq, skv):
    """The plain `attention_backward` (P from q, k and the forward's
    log-sum-exp, δ = rowsum(dO ∘ o)) and autograd through
    `attention_reference` against `jax.vjp` of JAX's `attention_xla`: f32
    within 1e-5 and bf16 within 2e-2 of each gradient's largest magnitude
    (in bf16, P, dP and dS are rounded at the same places on both sides, but
    o and δ come from the rounded output here, and sums run in other orders)."""
    rng = np.random.default_rng(1)
    q, k, v, do = (rng.normal(size=(2, 3, s, 64)).astype(np.float32)
                   for s in (sq, skv, skv, sq))
    jd = jnp.dtype(dtype)
    jq, jk, jv, jdo = (jnp.asarray(a, jd) for a in (q, k, v, do))
    _, vjp = jax.vjp(attention_xla, jq, jk, jv)
    want = [np.asarray(g, np.float32) for g in vjp(jdo)]
    td = getattr(torch, dtype)
    tq, tk, tv, tdo = (torch.from_numpy(np.array(a.astype(jnp.float32))).to(td)
                       for a in (jq, jk, jv, jdo))
    got = attention_backward(tq, tk, tv, attention_reference(tq, tk, tv),
                             attention_lse_reference(tq, tk), tdo)
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    attention_reference(*leaves).backward(tdo)
    band = 1e-5 if dtype == "float32" else 2e-2
    for g, a, w in zip(got, leaves, want):
        scale = np.abs(w).max()
        assert g.dtype == td
        np.testing.assert_allclose(g.float().numpy(), w, atol=band * scale, rtol=0)
        np.testing.assert_allclose(a.grad.float().numpy(), w, atol=band * scale, rtol=0)


def test_adamw_matches_optax():
    rng = np.random.default_rng(2)
    params = {"w": rng.normal(size=(5, 7)).astype(np.float32),
              "b": rng.normal(size=(7,)).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32) for k, v in params.items()}
             for _ in range(3)]
    opt = optax.adamw(1e-4)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = opt.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    topt = train.adamw(list(tp.values()))
    for g in grads:
        upd, state = opt.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        topt.step()
    for k in params:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), rtol=3e-7, atol=1e-8)
        assert not np.allclose(np.asarray(jp[k]), params[k], atol=1e-5, rtol=0)
    assert int(state[0].count) == int(topt.state[tp["w"]]["step"]) == 3


@pytest.fixture(scope="module")
def sharded(pair, tmp_path_factory):
    batches = [_batch(11, ragged=True), _batch(12)]
    ranks = spawn(train_rank, 4, (pair[1], batches, 2, 2), device="cpu",
                  workdir=str(tmp_path_factory.mktemp("ranks")))
    model = tiny_model(pair[1], master_weights=True)
    opt = train.adamw(model.net.parameters())
    step = train.make_train_step(model.net, opt)
    plain = []
    for b in batches:
        loss, aux = step(b)
        plain.append(((float(loss), float(aux["regr"]), float(aux["match"])),
                      {n: p.grad.clone() for n, p in model.net.named_parameters()}))
    return ranks, plain, batches


def test_sharded_step_matches_unsharded_and_jax_global_loss(pair, jax_loss, sharded):
    ranks, plain, batches = sharded
    (jloss, jaux), _ = jax_loss(pair[0].params, _jnp(batches[0]))
    for r in ranks:
        np.testing.assert_allclose(r["losses"][0], [float(jloss), float(jaux["regr"]),
                                                     float(jaux["match"])], rtol=LOSS_RTOL)
        np.testing.assert_allclose(r["losses"][0], plain[0][0], rtol=LOSS_RTOL)
        np.testing.assert_allclose(r["losses"][1], plain[1][0], rtol=1e-4)
        _assert_grads(r["grads"][0], plain[0][1])
    for name in ranks[0]["params"]:  # every rank holds the same whole model
        for r in ranks[1:]:
            torch.testing.assert_close(r["params"][name], ranks[0]["params"][name], rtol=0,
                                       atol=0)
