"""The port's train step (timetuning_tpu_torch/core/timet.py) against the JAX
package's ``make_train_step`` on the same weights and clips, at a tiny size
(3 blocks, width 32, 32 px, 8 prototypes, head (48, 24), B = 2, 3 frames),
f32, JAX with ``attn_impl="xla"`` on the CPU. After 3 steps: every step's
loss to 1e-5 relative, every parameter, teacher leaf and queue row to 1e-5.
Also ``start_block`` / ``stop_block`` against JAX, and the routing of the
differentiated pass around the kernels that have no backward."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from timetuning_tpu.core import optimizer as jopt
from timetuning_tpu.core import timet as jt
from timetuning_tpu.models.extractor import FeatureExtractor as JFeatureExtractor
from timetuning_tpu.models.vit import ViTConfig as JViTConfig
from timetuning_tpu.models.vit import VisionTransformer as JVisionTransformer
from timetuning_tpu_torch.core import timet as tt
from timetuning_tpu_torch.core.optimizer import swav_optimizer
from timetuning_tpu_torch.models.convert import (
    timet_params_to_jax,
    timet_state_dict_from_jax,
)
from timetuning_tpu_torch.models.extractor import FeatureExtractor
from timetuning_tpu_torch.models.vit import ViTConfig, VisionTransformer
from timetuning_tpu_torch.ops import kernel_lib
from torch_dp_worker import single_rank_group

torch.set_num_threads(2)

VIT = dict(patch_size=8, embed_dim=32, depth=3, num_heads=2, img_size=32)
HEAD, K = (48, 24), 8
UNFREEZE = ("blocks.1", "blocks.2")
B, FRAMES, STEPS = 2, 3, 3
TOL = dict(rtol=1e-5, atol=1e-6)


def _jax_model():
    fe = JFeatureExtractor(JVisionTransformer(JViTConfig(attn_impl="xla", **VIT)),
                           head_dims=HEAD)
    return jt.TimeT(feature_extractor=fe, n_prototypes=K)


def _torch_model(dtype=torch.float32, attn_impl="auto"):
    vit = VisionTransformer(ViTConfig(dtype=dtype, attn_impl=attn_impl, **VIT))
    return tt.TimeT(FeatureExtractor(vit, VIT["embed_dim"], HEAD), K)


def _clips(n, seed=0):
    """Clips with structure: a smooth pattern that shifts from frame to
    frame, plus noise, so propagation and argmax are not decided by ties."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:32, 0:32] / 32.0
    out = np.empty((n, B, FRAMES, 32, 32, 3), np.float32)
    for i in range(n):
        for b in range(B):
            ph = rng.uniform(0, 2 * np.pi, 3)
            for f in range(FRAMES):
                base = np.stack([np.sin(6 * xx + ph[0] + 0.3 * f),
                                 np.cos(5 * yy + ph[1] - 0.2 * f),
                                 np.sin(4 * (xx + yy) + ph[2])], -1)
                out[i, b, f] = base + 0.3 * rng.standard_normal((32, 32, 3))
    return out


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


def _assert_leaves_close(got, want):
    """Leaf by leaf at TOL, but for the key third of a qkv bias: softmax is
    invariant to a shift of all its scores, so the loss does not depend on
    the key bias and its gradient is rounding noise (~1e-10) around an exact
    zero, which Adam's normalisation turns into steps of full size and
    either sign in both packages. That third is held to the steps' size."""
    assert got.keys() >= want.keys()
    for k in want:
        g, w = got[k], want[k]
        if k.endswith("['attn']['qkv']['bias']"):
            D = g.shape[0] // 3
            assert np.abs(g[D:2 * D]).max() <= STEPS * 1e-3
            g, w = np.delete(g, np.s_[D:2 * D]), np.delete(w, np.s_[D:2 * D])
        np.testing.assert_allclose(g, w, err_msg=k, **TOL)


def _run_both(monkeypatch, cfg_kw, masked: bool, opt_over_trainable: bool):
    """3 steps of both packages from the same weights; returns per-step
    losses and the final (params, teacher, queue) of each side."""
    jmodel = _jax_model()
    params = jmodel.init(jax.random.PRNGKey(1), jnp.zeros((1, 32, 32, 3)))["params"]
    sched = dict(num_epochs=1, steps_per_epoch=10)
    clips = _clips(STEPS)
    rngs = jax.random.split(jax.random.PRNGKey(7), STEPS)

    # --- JAX
    jcfg = jt.TimeTConfig(n_prototypes=K, spatial_resolution=4, **sched, **cfg_kw)
    tx, jmask = jopt.swav_optimizer(params, lr=1e-3, unfreeze_layers=UNFREEZE,
                                    opt_over_trainable=opt_over_trainable, **sched)
    jstate = jt.init_state(
        jmodel, jcfg, tx, jax.random.PRNGKey(0), None, params=params,
        trainable_mask=jmask if opt_over_trainable else None)
    jstep = jax.jit(jt.make_train_step(
        jmodel, jcfg, tx, trainable_mask=jmask if masked else None,
        opt_over_trainable=opt_over_trainable))
    jlosses = []
    for clip, rng in zip(clips, rngs):
        jstate, m = jstep(jstate, jnp.asarray(clip), rng)
        jlosses.append(float(m["loss"]))

    # --- the port, the queue's choice replaced by the indices JAX drew
    n_store = min(B * 10, cfg_kw.get("queue_size", 16384))
    drawn = iter([np.asarray(jax.random.permutation(r, B * 16)[:n_store]) for r in rngs])
    monkeypatch.setattr(tt, "queue_store_indices",
                        lambda n, k, g: torch.from_numpy(next(drawn).astype(np.int64)))
    tmodel = _torch_model()
    tmodel.load_state_dict(timet_state_dict_from_jax(params))
    tcfg = tt.TimeTConfig(n_prototypes=K, spatial_resolution=4, **sched, **cfg_kw)
    opt, tmask = swav_optimizer(tmodel, lr=1e-3, unfreeze_layers=UNFREEZE,
                                opt_over_trainable=opt_over_trainable, **sched)
    tstate = tt.init_state(tmodel, tcfg, opt,
                           trainable_mask=tmask if opt_over_trainable else None)
    tstep = tt.make_train_step(tmodel, tcfg, opt,
                               trainable_mask=tmask if masked else None,
                               opt_over_trainable=opt_over_trainable)
    tlosses = []
    for clip in clips:
        tstate, m = tstep(tstate, torch.from_numpy(clip), None)
        tlosses.append(float(m["loss"]))
    return (jlosses, jstate), (tlosses, tstate, tmodel)


def _assert_same(jax_side, torch_side, use_teacher=True):
    (jlosses, jstate), (tlosses, tstate, tmodel) = jax_side, torch_side
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
    want = _flat(jstate.params)
    got = _flat(timet_params_to_jax(tmodel.state_dict()))
    assert got.keys() == want.keys()
    _assert_leaves_close(got, want)
    if use_teacher:
        # leaves the port's teacher does not hold are the student's own
        teacher = {**tmodel.state_dict(), **tstate.teacher}
        _assert_leaves_close(_flat(timet_params_to_jax(teacher)),
                             _flat(jstate.teacher_params))
    assert tstate.step == int(jstate.step) == STEPS
    assert tstate.opt.count == STEPS


CONFIGS = {
    "full_tree": (dict(), False, False),
    "frozen_trunk": (dict(frozen_trunk_blocks=1), True, True),
    "no_teacher": (dict(use_teacher=False), True, False),
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_three_steps_match_jax(monkeypatch, name):
    cfg_kw, masked, oot = CONFIGS[name]
    j, t = _run_both(monkeypatch, cfg_kw, masked, oot)
    _assert_same(j, t, use_teacher=cfg_kw.get("use_teacher", True))
    assert t[0][0] != t[0][-1]                      # the steps did move the loss


def test_mask_features_first_step_matches_jax(monkeypatch):
    """With ``mask_features`` the two packages are comparable for one step
    only: the masked background features are exact zeros, and the gradient
    of ``jnp.linalg.norm`` at zero is 0 / 0, so the JAX step's first update
    turns its parameters into NaN (its later losses read 0), while torch's
    norm has gradient 0 there and the port goes on training. The first loss
    sees the same masks, codes and labels on both sides."""
    cfg_kw = dict(frozen_trunk_blocks=1, mask_features=True)
    (jlosses, _), (tlosses, tstate, tmodel) = _run_both(monkeypatch, cfg_kw, True, True)
    np.testing.assert_allclose(tlosses[0], jlosses[0], rtol=1e-5)
    assert np.isfinite(tlosses).all() and tlosses[-1] < tlosses[0]
    assert all(torch.isfinite(p).all() for p in tmodel.parameters())
    assert all(torch.isfinite(t).all() for t in tstate.teacher.values())


def test_queue_fills_and_turns_ready_inside_the_run(monkeypatch):
    """queue_size 40, 20 rows stored a step: not ready in step 1, ready from
    step 2 (the insert comes before the Sinkhorn), rolling in step 3."""
    cfg_kw = dict(frozen_trunk_blocks=1, use_queue=True, queue_size=40)
    j, t = _run_both(monkeypatch, cfg_kw, True, True)
    _assert_same(j, t)
    (_, jstate), (_, tstate, _) = j, t
    assert tstate.queue_fill == int(jstate.queue_fill) == 40
    # rows of order 1 computed with parameters that agree to 1e-5
    np.testing.assert_allclose(tstate.queue.numpy(), np.asarray(jstate.queue),
                               rtol=1e-5, atol=1e-5)


def test_queue_draw_is_a_seeded_permutation_prefix():
    g = torch.Generator().manual_seed(5)
    idx = tt.queue_store_indices(32, 20, g)
    assert idx.shape == (20,) and len(set(idx.tolist())) == 20
    assert 0 <= int(idx.min()) and int(idx.max()) < 32
    again = tt.queue_store_indices(32, 20, torch.Generator().manual_seed(5))
    assert torch.equal(idx, again)
    assert torch.equal(idx, torch.randperm(32, generator=torch.Generator().manual_seed(5))[:20])
    assert not torch.equal(idx, tt.queue_store_indices(32, 20, g))


def _port_run(opt_over_trainable, seed=3):
    torch.manual_seed(0)
    model = _torch_model().init_weights(torch.Generator().manual_seed(seed))
    cfg = tt.TimeTConfig(n_prototypes=K, spatial_resolution=4, num_epochs=1,
                         steps_per_epoch=10, frozen_trunk_blocks=1)
    opt, mask = swav_optimizer(model, lr=1e-3, unfreeze_layers=UNFREEZE, num_steps=10,
                               opt_over_trainable=opt_over_trainable)
    state = tt.init_state(model, cfg, opt,
                          trainable_mask=mask if opt_over_trainable else None)
    step = tt.make_train_step(model, cfg, opt, trainable_mask=mask,
                              opt_over_trainable=opt_over_trainable)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    losses = [float(step(state, torch.from_numpy(c))[1]["loss"]) for c in _clips(STEPS)]
    return model, state, mask, before, losses, step


def test_full_tree_and_trainable_subtree_trajectories_are_equal():
    m_full, s_full, mask, before, l_full, _ = _port_run(False)
    m_sub, s_sub, _, _, l_sub, _ = _port_run(True)
    assert l_full == l_sub
    for (n, a), b in zip(m_full.named_parameters(), m_sub.parameters()):
        assert torch.equal(a, b), n
        # frozen leaves bit-identical, trainable leaves moved
        assert torch.equal(a, before[n]) != mask[n], n
    assert set(s_sub.teacher) == {n for n, t in mask.items() if t}
    for n, t in s_sub.teacher.items():
        assert torch.equal(t, s_full.teacher[n]), n
    for n, t in s_full.teacher.items():
        if not mask[n]:
            # the full-tree EMA mixes a frozen leaf with itself: one rounding
            torch.testing.assert_close(t, before[n], rtol=1e-6, atol=1e-9, msg=n)
    np.testing.assert_allclose(m_sub.prototypes.norm(dim=-1).detach().numpy(), 1, rtol=1e-6)


def test_teacher_lies_between_its_old_value_and_the_student():
    """One step's EMA, in the reference's direction: the new teacher is
    0.5% of the old one and 99.5% of the new student."""
    model, state, _, _, _, step = _port_run(True)
    name = "feature_extractor.head.lin0.weight"
    old = state.teacher[name].clone()
    step(state, torch.from_numpy(_clips(1, seed=9)[0]))
    t, s = state.teacher[name], dict(model.named_parameters())[name].detach()
    lo, hi = torch.minimum(old, s), torch.maximum(old, s)
    assert bool(((t >= lo - 1e-7) & (t <= hi + 1e-7)).all())
    assert float((t - s).abs().max()) < 0.01 * float((old - s).abs().max()) + 1e-7


@pytest.mark.parametrize("k", [1, 2])
def test_start_and_stop_block_match_jax(k):
    jmodel = JVisionTransformer(JViTConfig(attn_impl="xla", **VIT))
    x = np.random.default_rng(k).standard_normal((2, 32, 32, 3)).astype(np.float32)
    params = jmodel.init(jax.random.PRNGKey(2), jnp.asarray(x))["params"]
    from timetuning_tpu_torch.models.convert import vit_state_dict_from_jax

    tmodel = VisionTransformer(ViTConfig(**VIT))
    tmodel.load_state_dict(vit_state_dict_from_jax(params))
    jtrunk = jmodel.apply({"params": params}, jnp.asarray(x), stop_block=k)
    jtail = jmodel.apply({"params": params}, jtrunk["hidden"], start_block=k,
                         want_attention=True)
    with torch.no_grad():
        ttrunk = tmodel(torch.from_numpy(x), stop_block=k)
        ttail = tmodel(ttrunk["hidden"], start_block=k, want_attention=True)
        whole = tmodel(torch.from_numpy(x), want_attention=True)
    assert set(ttrunk) == {"hidden", "grid"} and ttrunk["grid"] == jtrunk["grid"] == (4, 4)
    np.testing.assert_allclose(ttrunk["hidden"].numpy(), np.asarray(jtrunk["hidden"]),
                               rtol=1e-5, atol=1e-5)
    for key in ("tokens", "attention"):
        np.testing.assert_allclose(ttail[key].numpy(), np.asarray(jtail[key]),
                                   rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(ttail[key], whole[key], rtol=1e-6, atol=1e-6)


def test_trainable_leaf_inside_the_trunk_is_refused():
    model = _torch_model()
    opt, mask = swav_optimizer(model, unfreeze_layers=UNFREEZE, num_steps=10)
    cfg = tt.TimeTConfig(n_prototypes=K, frozen_trunk_blocks=2)
    with pytest.raises(ValueError, match="blocks.1.* lies inside the trunk"):
        tt.make_train_step(model, cfg, opt, trainable_mask=mask)
    mask2 = dict(mask) | {"feature_extractor.backbone.pos_embed": True}
    with pytest.raises(ValueError, match="pos_embed lies inside the trunk"):
        tt.make_train_step(model, dataclasses.replace(cfg, frozen_trunk_blocks=1),
                           opt, trainable_mask=mask2)
    tt.make_train_step(model, dataclasses.replace(cfg, frozen_trunk_blocks=1), opt,
                       trainable_mask=mask)


def test_unported_config_fields_raise():
    """``axis_name`` names the default process group: without one it is
    refused, with one (here of one rank; 2 ranks: tests/test_torch_dp.py)
    the step builds, and a ``world_size`` other than the group's is
    refused. ``moe_aux_weight`` on a backbone without MoE blocks is
    refused as JAX refuses it (the MoE step itself: tests/test_torch_moe.py).""" 
    model = _torch_model()
    opt, _ = swav_optimizer(model, num_steps=10)
    with pytest.raises(RuntimeError, match="axis_name='data' needs an initialized"):
        tt.make_train_step(model, tt.TimeTConfig(axis_name="data"), opt)
    with single_rank_group():
        tt.make_train_step(model, tt.TimeTConfig(axis_name="data"), opt)
        with pytest.raises(ValueError, match="world_size=2 but the process group has 1"):
            tt.make_train_step(model, tt.TimeTConfig(axis_name="data", world_size=2), opt)
    with pytest.raises(ValueError, match="moe_aux_weight=0.01 but no MoE block"):
        tt.make_train_step(model, tt.TimeTConfig(moe_aux_weight=0.01), opt)
    with pytest.raises(ValueError, match="requires trainable_mask"):
        tt.make_train_step(model, tt.TimeTConfig(), opt, opt_over_trainable=True)


def test_forced_kernel_impl_refuses_the_attention_probabilities():
    """``attn_impl="pallas"`` with ``mask_features`` (which needs the last
    block's probabilities) raises, as the JAX dispatcher does."""
    model = _torch_model(attn_impl="pallas")
    x = torch.from_numpy(_clips(1)[0][:, 0])
    with torch.no_grad():
        model(x)
        with pytest.raises(RuntimeError, match="mask_features"):
            model(x, want_attention=True)


def test_bf16_step_routes_the_grad_path_around_the_block_kernels():
    """A bf16 ``auto`` model: a differentiated call through the block
    kernels' wrappers (once refused) now differentiates, the kernels' own
    Functions giving the plain composition's gradient; the step reroutes its
    differentiated pass to plain attention by default and trains. A model
    forced to "pallas" differentiates through kernel 10's Function."""
    x = torch.from_numpy(_clips(1)[0])
    model = _torch_model(torch.bfloat16).init_weights(torch.Generator().manual_seed(0))
    feats, _ = model(x[:, 0])
    feats.float().square().sum().backward()
    grads = [p.grad for p in model.feature_extractor.backbone.blocks[2].parameters()]
    assert all(g is not None and torch.isfinite(g).all() for g in grads)
    assert any(g.abs().sum() > 0 for g in grads)
    for impl in ("auto", "pallas"):
        model = _torch_model(torch.bfloat16, impl).init_weights(
            torch.Generator().manual_seed(0))
        cfg = tt.TimeTConfig(n_prototypes=K, spatial_resolution=4, num_epochs=1,
                             steps_per_epoch=10, frozen_trunk_blocks=1)
        opt, mask = swav_optimizer(model, lr=1e-3, unfreeze_layers=UNFREEZE,
                                   num_steps=10, opt_over_trainable=True)
        state = tt.init_state(model, cfg, opt, trainable_mask=mask)
        step = tt.make_train_step(model, cfg, opt, trainable_mask=mask,
                                  opt_over_trainable=True)
        before = model.feature_extractor.backbone.blocks[2].attn.qkv.weight.detach().clone()
        kernel_lib.reset_launch_counts()
        _, metrics = step(state, x)
        assert torch.isfinite(metrics["loss"])
        after = model.feature_extractor.backbone.blocks[2].attn.qkv.weight
        assert not torch.equal(before, after)
        assert sum(kernel_lib.launch_counts().values()) == 0     # CPU: plain versions


def test_pretrained_weights_graft_by_name():
    model = _torch_model()
    opt, _ = swav_optimizer(model, num_steps=10)
    w = torch.full((48, 32), 0.5)
    tt.init_state(model, tt.TimeTConfig(n_prototypes=K), opt,
                  pretrained_params={"feature_extractor.head.lin0.weight": w})
    assert torch.equal(model.feature_extractor.head.lin0.weight, w)
    with pytest.raises(KeyError, match="not in model tree"):
        tt.init_state(model, tt.TimeTConfig(n_prototypes=K), opt,
                      pretrained_params={"nope": w})
    with pytest.raises(ValueError, match="shape mismatch"):
        tt.init_state(model, tt.TimeTConfig(n_prototypes=K), opt,
                      pretrained_params={"prototypes": w})
