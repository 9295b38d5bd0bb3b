"""The port's mixture-of-experts blocks (parallel/ep.MoEMlp, models/vit's MoE
blocks, the train step's Switch auxiliary) against the JAX package on the
CPU, at test width: ViT patch 8, D 32, depth 4, 2 heads, 4 experts, every
2nd block MoE (blocks 1 and 3), f32, ``attn_impl="xla"``; inputs from a
numpy seed, weights carried from JAX's by models/convert.

Tolerances: ``MoEMlp`` at rtol 1e-5 / atol 1e-6; the MoE ViT's tokens at
atol 1e-5 (a LayerNorm of sums in another order); 3 steps with
``moe_aux_weight=0.01``: loss and ``moe_aux`` at rtol 1e-5, every leaf, the
teacher and the queue at tests/test_torch_timet.py's tolerances, with its
rule for Adam's eps regime carried over to the experts' leaves
(``_assert_close_adam``: a gradient within a few eps of zero, e.g. through
an expert whose GELU sits deep in its tail)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_timet import _assert_leaves_close, _flat
from timetuning_tpu.core import optimizer as jopt
from timetuning_tpu.core import timet as jt
from timetuning_tpu.models.extractor import FeatureExtractor as JFeatureExtractor
from timetuning_tpu.models.vit import ViTConfig as JViTConfig
from timetuning_tpu.models.vit import VisionTransformer as JVisionTransformer
from timetuning_tpu.parallel import ep as jep
from timetuning_tpu_torch.core import timet as tt
from timetuning_tpu_torch.core.optimizer import swav_optimizer
from timetuning_tpu_torch.models.convert import (
    timet_params_to_jax,
    timet_state_dict_from_jax,
    vit_state_dict_from_jax,
)
from timetuning_tpu_torch.models.vit import ViTConfig, VisionTransformer, is_moe_block
from timetuning_tpu_torch.parallel import ep
from torch_dp_worker import HEAD, K, torch_model

torch.set_num_threads(2)

VIT_MOE = dict(patch_size=8, embed_dim=32, depth=4, num_heads=2, img_size=32,
               moe_every_k=2, n_experts=4)
VIT_DENSE = dict(patch_size=8, embed_dim=32, depth=4, num_heads=2, img_size=32)
UNFREEZE = ("blocks.2", "blocks.3")
SCHED = dict(num_epochs=1, steps_per_epoch=10)
FRAMES, STEPS, N = 3, 3, 16
TOL = dict(rtol=1e-5, atol=1e-6)


def clips(n: int, b: int, seed: int = 0) -> np.ndarray:
    """[n, b, FRAMES, 32, 32, 3]: a smooth pattern that shifts from frame to
    frame, plus noise (tests/test_torch_timet.py's clips)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:32, 0:32] / 32.0
    out = np.empty((n, b, FRAMES, 32, 32, 3), np.float32)
    for i in range(n):
        for c in range(b):
            ph = rng.uniform(0, 2 * np.pi, 3)
            for f in range(FRAMES):
                base = np.stack([np.sin(6 * xx + ph[0] + 0.3 * f),
                                 np.cos(5 * yy + ph[1] - 0.2 * f),
                                 np.sin(4 * (xx + yy) + ph[2])], -1)
                out[i, c, f] = base + 0.3 * rng.standard_normal((32, 32, 3))
    return out


def jax_timet(vit_kw):
    fe = JFeatureExtractor(JVisionTransformer(JViTConfig(attn_impl="xla", **vit_kw)),
                           head_dims=HEAD)
    return jt.TimeT(feature_extractor=fe, n_prototypes=K)


def jax_params(vit_kw, seed=1):
    return jax_timet(vit_kw).init(jax.random.PRNGKey(seed),
                                  jnp.zeros((1, 32, 32, 3)))["params"]


def queue_draws(rngs, n_rows: int, n_store: int) -> list:
    return [np.asarray(jax.random.permutation(r, n_rows)[:n_store]) for r in rngs]


def jax_steps(vit_kw, params, data, rngs, cfg_kw):
    """JAX's single-device step (the trainable subtree, ``UNFREEZE``) on each
    global batch of ``data``: (losses, moe_aux values, final state)."""
    model = jax_timet(vit_kw)
    cfg = jt.TimeTConfig(n_prototypes=K, spatial_resolution=4, **SCHED, **cfg_kw)
    tx, mask = jopt.swav_optimizer(params, lr=1e-3, unfreeze_layers=UNFREEZE,
                                   opt_over_trainable=True, **SCHED)
    state = jt.init_state(model, cfg, tx, jax.random.PRNGKey(0), None, params=params,
                          trainable_mask=mask)
    step = jax.jit(jt.make_train_step(model, cfg, tx, trainable_mask=mask,
                                      opt_over_trainable=True))
    losses, auxes = [], []
    for clip, rng in zip(data, rngs):
        state, m = step(state, jnp.asarray(clip), rng)
        losses.append(float(m["loss"]))
        auxes.append(float(m["moe_aux"]) if "moe_aux" in m else None)
    return losses, auxes, state


# Adam's full step over the run at the backbone lr (1e-4, cosine over 10
# steps): an expert element that JAX moved by less than half of it had a
# gradient within a few eps (1e-8) of zero, where Adam's normalisation turns
# the last bits of the gradient (a GELU deep in its tail, a sum in another
# order) into a visible part of the step, in either package
ADAM_RUN_STEP = 1e-4 * sum(0.5 * (1 + np.cos(np.pi * t / 10)) for t in range(STEPS))


def _assert_close_adam(got, want, init):
    """``_assert_leaves_close``, but for the experts' stacked leaves: an
    element off TOL must be in Adam's eps regime (see ``ADAM_RUN_STEP``),
    within a tenth of the run's step, and at most 1 in 1,000 of a leaf."""
    moe = {k for k in want if "['moe']['" in k and "router" not in k}
    _assert_leaves_close({k: got[k] for k in got if k not in moe},
                         {k: want[k] for k in want if k not in moe})
    for k in moe:
        g, w = got[k], want[k]
        off = ~np.isclose(g, w, **TOL)
        assert off.sum() <= max(1, w.size // 1000), (k, off.sum())
        assert np.all(np.abs(w - init[k])[off] < 0.5 * ADAM_RUN_STEP), k
        assert np.all(np.abs(g - w)[off] < 0.1 * ADAM_RUN_STEP), k


def assert_queue_close(got, want):
    """The queue at TOL, but for at most 1 in 1,000 of its entries within
    1e-5: its rows are the teacher's features, and the teacher carries the
    experts' elements of Adam's eps regime (``_assert_close_adam``)."""
    off = ~np.isclose(got, want, **TOL)
    assert off.sum() <= max(1, want.size // 1000), off.sum()
    assert np.all(np.abs(got - want)[off] < 1e-5)


def assert_matches_jax_state(params, teacher, jstate, init):
    """Gathered (whole-layout) student and teacher against JAX's; ``init``
    the JAX params the run started from."""
    got, init = _flat(timet_params_to_jax(params)), _flat(init)
    assert got.keys() == _flat(jstate.params).keys()
    _assert_close_adam(got, _flat(jstate.params), init)
    _assert_close_adam(_flat(timet_params_to_jax({**params, **teacher})),
                       _flat(jstate.teacher_params), init)


def _moe_pair(E=4, H=32, cf=2.0, gs=0, D=16):
    jm = jep.MoEMlp(n_experts=E, hidden_dim=H, capacity_factor=cf, group_size=gs)
    x = np.random.default_rng(0).normal(size=(4, 8, D)).astype(np.float32)
    params = jm.init(jax.random.PRNGKey(0), x)["params"]
    tm = ep.MoEMlp(D, E, H, cf, gs)
    tm.load_state_dict({"router.weight": torch.tensor(np.asarray(params["router"]["kernel"]).T),
                        **{k: torch.tensor(np.asarray(params[k]))
                           for k in ("w1", "b1", "w2", "b2")}})
    return jm, params, tm, x


@pytest.mark.parametrize("cf", [2.0, 0.5])
@pytest.mark.parametrize("gs", [0, -1, 8])
def test_moe_mlp_matches_jax(gs, cf):
    """Group sizes 0 (one global group), -1 (a group a sample) and 8; at
    capacity factor 0.5 tokens overflow and come out 0 on both sides; the
    Switch auxiliary equals the value JAX sows."""
    jm, params, tm, x = _moe_pair(cf=cf, gs=gs)
    want, inter = jm.apply({"params": params}, x, mutable=["intermediates"])
    with ep.collect_aux() as auxes:
        got = tm(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    np.testing.assert_allclose(float(auxes[0].detach()),
                               float(inter["intermediates"]["aux_loss"][0]), rtol=1e-5)
    dropped = np.all(got == 0, axis=-1)
    if cf == 0.5:
        assert dropped.sum() > 0 and np.all(np.asarray(want)[dropped] == 0)
    with pytest.raises(ValueError, match="does not divide"):
        ep.MoEMlp(16, 4, 32, group_size=5)(torch.zeros(4, 8, 16))


def test_moe_vit_tree_forward_and_convert_round_trip():
    """Blocks 1 and 3 are MoE (``blocks.i.moe.{router, w1, b1, w2, b2}``,
    experts stacked), 0 and 2 dense; JAX's tree carried in gives JAX's
    tokens, and carried back it is JAX's tree, leaf for leaf."""
    jv = JVisionTransformer(JViTConfig(attn_impl="xla", **VIT_MOE))
    x = np.random.default_rng(1).normal(size=(3, 32, 32, 3)).astype(np.float32)
    params = jv.init(jax.random.PRNGKey(0), x)["params"]
    vit = VisionTransformer(ViTConfig(**VIT_MOE))
    sd = vit_state_dict_from_jax(params)
    assert set(sd) == set(vit.state_dict())
    assert [is_moe_block(vit.config, i) for i in range(4)] == [False, True, False, True]
    assert sd["blocks.1.moe.w1"].shape == (4, 32, 128)
    assert sd["blocks.3.moe.router.weight"].shape == (4, 32)
    assert "blocks.1.mlp.fc1.weight" not in sd and "blocks.0.mlp.fc1.weight" in sd
    vit.load_state_dict(sd)
    with torch.no_grad():
        got = vit(torch.from_numpy(x))["tokens"].numpy()
    np.testing.assert_allclose(got, np.asarray(jv.apply({"params": params}, x)["tokens"]),
                               rtol=1e-5, atol=1e-5)
    back, want = _flat(timet_params_to_jax(vit.state_dict())), _flat(params)
    assert back.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)


def test_upcycle_matches_jax():
    """Every expert a copy of its block's dense MLP, every shared leaf
    copied, the routers kept: the port's upcycling of the port's dense
    weights equals JAX's upcycling of the same weights."""
    dense_p = JVisionTransformer(JViTConfig(attn_impl="xla", **VIT_DENSE)).init(
        jax.random.PRNGKey(2), jnp.zeros((1, 32, 32, 3)))["params"]
    jcfg = JViTConfig(attn_impl="xla", **VIT_MOE)
    moe_p = JVisionTransformer(jcfg).init(jax.random.PRNGKey(3),
                                          jnp.zeros((1, 32, 32, 3)))["params"]
    want = jep.upcycle_dense_to_moe(dense_p, moe_p, jcfg)
    got = ep.upcycle_dense_to_moe(vit_state_dict_from_jax(dense_p),
                                  vit_state_dict_from_jax(moe_p), ViTConfig(**VIT_MOE))
    g, w = _flat(timet_params_to_jax(got)), _flat(want)
    assert g.keys() == w.keys()
    for k in w:
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    assert torch.equal(got["blocks.3.moe.w1"][2], got["blocks.3.moe.w1"][0])


MOE_CONFIGS = {
    # name: TimeTConfig kwargs
    "full": dict(use_queue=True, queue_size=48, moe_aux_weight=0.01),
    "frozen_trunk": dict(frozen_trunk_blocks=2, moe_aux_weight=0.01),
}


@pytest.mark.parametrize("name", list(MOE_CONFIGS))
def test_three_moe_steps_match_jax(monkeypatch, name):
    """3 steps of the MoE TimeT (blocks 2, 3, head and prototypes trainable:
    block 3's router and experts among them) with ``moe_aux_weight=0.01``:
    loss, ``moe_aux``, every leaf, the teacher and the queue against JAX's
    step. The queue (20 rows a step) fills at the third step."""
    cfg_kw = MOE_CONFIGS[name]
    params = jax_params(VIT_MOE)
    data = clips(STEPS, 2)
    rngs = list(jax.random.split(jax.random.PRNGKey(7), STEPS))
    jl, ja, jstate = jax_steps(VIT_MOE, params, data, rngs, cfg_kw)

    draws = iter(queue_draws(rngs, 2 * N, min(20, cfg_kw.get("queue_size", 20))))
    monkeypatch.setattr(tt, "queue_store_indices",
                        lambda n, k, g: torch.from_numpy(next(draws).astype(np.int64)))
    model = torch_model(timet_state_dict_from_jax(params), VIT_MOE)
    cfg = tt.TimeTConfig(n_prototypes=K, spatial_resolution=4, **SCHED, **cfg_kw)
    opt, mask = swav_optimizer(model, lr=1e-3, unfreeze_layers=UNFREEZE,
                               opt_over_trainable=True, **SCHED)
    state = tt.init_state(model, cfg, opt, trainable_mask=mask)
    step = tt.make_train_step(model, cfg, opt, trainable_mask=mask, opt_over_trainable=True)
    losses, auxes = [], []
    for clip in data:
        state, m = step(state, torch.from_numpy(clip), None)
        losses.append(float(m["loss"]))
        auxes.append(float(m["moe_aux"]))
    np.testing.assert_allclose(losses, jl, rtol=1e-5)
    np.testing.assert_allclose(auxes, ja, rtol=1e-5)
    assert all(1.0 - 1e-5 <= a <= 4.0 + 1e-5 for a in auxes)
    assert_matches_jax_state(model.state_dict(), state.teacher, jstate, params)
    if cfg_kw.get("use_queue"):
        assert state.queue_fill == int(jstate.queue_fill) == 48
        assert_queue_close(state.queue.numpy(), np.asarray(jstate.queue))


def test_moe_aux_guard():
    """An auxiliary weight with no MoE block on the grad path is refused at
    build time, as JAX refuses it: a dense backbone, or a trunk that holds
    every MoE block."""
    dense = torch_model(vit_kw=VIT_DENSE)
    opt, _ = swav_optimizer(dense, num_steps=10)
    cfg = tt.TimeTConfig(n_prototypes=K, spatial_resolution=4, moe_aux_weight=0.01)
    with pytest.raises(ValueError, match="no MoE block on the grad path"):
        tt.make_train_step(dense, cfg, opt)
    moe = torch_model(vit_kw=dict(VIT_MOE, depth=2))
    opt, mask = swav_optimizer(moe, num_steps=10, unfreeze_layers=())
    with pytest.raises(ValueError, match=r"MoE blocks \[1\], grad path starts at block 2"):
        tt.make_train_step(moe, dataclasses.replace(cfg, frozen_trunk_blocks=2), opt,
                           trainable_mask=mask)
    tt.make_train_step(moe, dataclasses.replace(cfg, frozen_trunk_blocks=1), opt,
                       trainable_mask=mask)
