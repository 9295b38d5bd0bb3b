"""The port's SwAV optimizer (timetuning_tpu_torch/core/optimizer.py) against
the JAX package's optax chain: the masks' groups, the schedules, and 5 AdamW
steps leaf by leaf on the same weights and gradients (f32, 1e-6)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from timetuning_tpu.core import optimizer as jopt
from timetuning_tpu.core import schedules as jsched
from timetuning_tpu_torch.core import optimizer as topt
from timetuning_tpu_torch.core import schedules as tsched

torch.set_num_threads(2)

STEPS, LR = 5, 1e-2


def _jax_tree(seed=0):
    rng = np.random.default_rng(seed)

    def a(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    def block():
        return {"attn": {"qkv": {"kernel": a(4, 12), "bias": a(12)}},
                "norm1": {"scale": a(4), "bias": a(4)}}

    return {
        "prototypes": a(5, 3),
        "feature_extractor": {
            "head": {"lin0": {"kernel": a(4, 3), "bias": a(3)}},
            "backbone": {"cls_token": a(1, 1, 4), "pos_embed": a(1, 5, 4),
                         "norm": {"scale": a(4), "bias": a(4)},
                         "blocks_1": block(), "blocks_10": block(),
                         "blocks_11": block()},
        },
    }


def _to_torch_names(tree):
    """The JAX tree's leaves under the port's parameter names (kernels
    transposed to torch's [out, in])."""
    out = {}
    for path, v in jax.tree_util.tree_leaves_with_path(tree):
        segs = [p.key for p in path]
        v = np.asarray(v)
        if segs[-1] == "kernel":
            segs[-1], v = "weight", v.T
        elif segs[-1] == "scale":
            segs[-1] = "weight"
        name = ".".join(segs).replace("blocks_", "blocks.")
        out[name] = torch.nn.Parameter(torch.from_numpy(np.array(v, copy=True)))
    return out


def _jax_name(path):
    segs = [p.key for p in path]
    segs[-1] = {"kernel": "weight", "scale": "weight"}.get(segs[-1], segs[-1])
    return ".".join(segs).replace("blocks_", "blocks.")


@pytest.mark.parametrize("unfreeze", [("blocks.1",), ("blocks_10", "blocks.11"),
                                      ("feature_extractor.backbone",), ()])
def test_build_masks_groups_match_jax(unfreeze):
    """Whole-segment matching: "blocks.1" unfreezes block 1 and not blocks 10
    and 11; the three masks agree with JAX leaf by leaf, cls_token and
    pos_embed ([1, 1, D], decayed when they train) included."""
    tree = _jax_tree()
    jgroups, jtrain, jdecay = jopt.build_masks(tree, unfreeze)
    tgroups, ttrain, tdecay = topt.build_masks(_to_torch_names(tree), unfreeze)
    for jt_, tt_ in ((jgroups, tgroups), (jtrain, ttrain), (jdecay, tdecay)):
        want = {_jax_name(p): v for p, v in jax.tree_util.tree_leaves_with_path(jt_)}
        assert tt_ == want
    if unfreeze == ("blocks.1",):
        assert tgroups["feature_extractor.backbone.blocks.1.attn.qkv.weight"] == "backbone"
        assert tgroups["feature_extractor.backbone.blocks.10.attn.qkv.weight"] == "frozen"
        assert tgroups["prototypes"] == "head"
    if unfreeze == ("feature_extractor.backbone",):
        assert tdecay["feature_extractor.backbone.cls_token"]
        assert not tdecay["feature_extractor.backbone.norm.weight"]


def test_schedules_match_jax():
    for args in ((0.04, 0.4, 1, 50), (0.995, 1.0, 3, 7)):
        np.testing.assert_array_equal(tsched.cosine_scheduler(*args),
                                      jsched.cosine_scheduler(*args))
    np.testing.assert_array_equal(tsched.cosine_scheduler(1.0, 0.1, 4, 5, warmup_epochs=1),
                                  jsched.cosine_scheduler(1.0, 0.1, 4, 5, warmup_epochs=1))
    np.testing.assert_array_equal(tsched.cosine_annealing_lr(0.1, 9),
                                  jsched.cosine_annealing_lr(0.1, 9))
    sched = tsched.cosine_scheduler(0.04, 0.4, 1, 5)
    for step in (0, 3, 4, 99):                       # clamped to the last entry
        assert tsched.schedule_at(sched, step) == pytest.approx(
            float(jsched.schedule_at(sched, jnp.asarray(step))), rel=1e-7)
    opt, _ = topt.swav_optimizer(_to_torch_names(_jax_tree()), lr=LR, num_steps=20)
    jlr = optax.cosine_decay_schedule(LR, 20, alpha=0.0)
    for count in (0, 1, 7, 20, 25):
        assert opt.lr_at(count) == pytest.approx(float(jlr(count)), rel=1e-6, abs=1e-12)


def _grads(tree, step):
    rng = np.random.default_rng(100 + step)
    return jax.tree.map(lambda v: rng.standard_normal(v.shape).astype(np.float32), tree)


@pytest.mark.parametrize("opt_over_trainable", [False, True])
@pytest.mark.parametrize("num_steps", [100, 3])
def test_five_adamw_steps_match_optax_chain(opt_over_trainable, num_steps):
    """Same weights, same per-step gradients; ``num_steps=3`` runs past the
    schedules' end (both clamp). Frozen leaves never move."""
    tree = _jax_tree(1)
    unfreeze = ("blocks.11", "blocks.10")
    tx, jmask = jopt.swav_optimizer(tree, lr=LR, num_steps=num_steps,
                                    unfreeze_layers=unfreeze,
                                    opt_over_trainable=opt_over_trainable)
    jparams = jax.tree.map(jnp.asarray, tree)
    sub = (lambda t: jopt.trainable_subtree(t, jmask)) if opt_over_trainable else (lambda t: t)
    jstate = tx.init(sub(jparams))

    tparams = _to_torch_names(tree)
    opt, tmask = topt.swav_optimizer(tparams, lr=LR, num_steps=num_steps,
                                     unfreeze_layers=unfreeze,
                                     opt_over_trainable=opt_over_trainable)
    for step in range(STEPS):
        g = _grads(tree, step)
        updates, jstate = tx.update(sub(jax.tree.map(jnp.asarray, g)), jstate, sub(jparams))
        jparams = jopt.merge_subtree(jparams, optax.apply_updates(sub(jparams), updates))
        for name, gt in _to_torch_names(g).items():
            if tmask[name]:
                tparams[name].grad = gt.detach()
        opt.step()
        opt.zero_grad()
    want = _to_torch_names(jparams)
    start = _to_torch_names(tree)
    for name, p in tparams.items():
        np.testing.assert_allclose(p.detach().numpy(), want[name].detach().numpy(),
                                   rtol=1e-6, atol=1e-6, err_msg=name)
        assert torch.equal(p, start[name]) != tmask[name], name
    assert opt.count == STEPS


def test_schedules_are_read_at_the_optimizers_own_counter():
    tparams = _to_torch_names(_jax_tree(2))
    opt, mask = topt.swav_optimizer(tparams, lr=LR, num_steps=10, opt_over_trainable=True)
    for name, p in tparams.items():
        if mask[name]:
            p.grad = torch.ones_like(p)
    opt.step()
    assert opt.count == 1
    decayed = [g for g in opt.adamw.param_groups if g["decays"]]
    assert decayed and all(g["weight_decay"] == pytest.approx(0.04) for g in decayed)
    assert all(g["weight_decay"] == 0 for g in opt.adamw.param_groups if not g["decays"])
    assert {g["lr"] for g in opt.adamw.param_groups} == {LR, LR / 10}
    assert opt.weight_decay_at(10_000) == pytest.approx(
        float(tsched.cosine_scheduler(0.04, 0.4, 1, 10)[-1]))
