"""The port's ZeRO-1 (core/optimizer ``swav_optimizer_zero1`` /
``Zero1Optimizer``, core/timet's ZeRO-1 step, core/checkpoint's gathered
flat moments and the layout migrations) on the CPU: 2 gloo ranks, spawned
(tests/torch_dp_worker.py), against the JAX package's ZeRO-1 step
shard_mapped over 2 of the conftest's CPU devices and against the port's
replicated subtree step, at test width (tests/test_zero1.py's model), f32.

Tolerances: losses at rtol 1e-5; parameters and teacher at rtol 1e-5 / atol
1e-6 with the key third of a qkv bias held to Adam's step size
(tests/test_torch_timet.py); the Adam moments at rtol 1e-4 plus 1e-5 of each
leaf's largest moment (their gradients are sums taken in another order, so
a moment near zero differs by ~1e-6 of the leaf's scale), after the scale of JAX's summed gradient (see
``test_zero1_matches_jax_zero1``). The migrations are exact."""

import jax
import numpy as np
import pytest
import torch

from test_torch_dp import (
    STEPS,
    WORLD,
    assert_replicas_identical,
    assert_state_matches_jax,
    clips,
    jax_dp_steps,
    jax_params,
)
from test_torch_timet import _assert_leaves_close, _flat
from timetuning_tpu.core import optimizer as jopt
from timetuning_tpu_torch.core import checkpoint, timet as tt
from timetuning_tpu_torch.core.optimizer import (
    migrate_subtree_to_zero1,
    migrate_zero1_to_subtree,
    swav_optimizer,
    swav_optimizer_zero1,
    validate_zero1_fingerprint,
    zero1_plan_with_padding,
)
from timetuning_tpu_torch.models.convert import (
    timet_params_to_jax,
    timet_state_dict_from_jax,
)
from torch_dp_worker import K, SCHED, UNFREEZE, single_rank_group, spawn, torch_model

torch.set_num_threads(2)
B_LOCAL = 2
KW = dict(lr=1e-3, unfreeze_layers=UNFREEZE, **SCHED)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """3 steps at 2 ranks with ZeRO-1 (saved at the end) and with the
    replicated subtree optimizer, and JAX's ZeRO-1 steps on the same inputs."""
    params = jax_params()
    sd = timet_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params))
    data = clips(STEPS, WORLD * B_LOCAL, seed=3)
    rngs = list(jax.random.split(jax.random.PRNGKey(11), STEPS))
    save_dir = str(tmp_path_factory.mktemp("zero1_ckpt"))
    job = [dict(kind="step", name="zero1", state_dict=sd, cfg={}, clips=data,
                zero1=True, save_dir=save_dir),
           dict(kind="step", name="subtree", state_dict=sd, cfg={}, clips=data)]
    ranks = spawn(job, str(tmp_path_factory.mktemp("zero1_ranks")), WORLD, timeout=240)
    jl, jstate, jplan = jax_dp_steps(params, data, rngs, {}, True, True, zero1=True)
    return dict(sd=sd, ranks=ranks, jl=jl, jstate=jstate, jplan=jplan, save_dir=save_dir)


def _flat_moments(ranks):
    """The ranks' moment chunks, in rank order: the [padded] vectors."""
    return {k: torch.cat([r["zero1"]["zero1"][k] for r in ranks]) for k in ("mu", "nu")}


def _named_trainable():
    model = torch_model()
    _, mask = swav_optimizer(model, opt_over_trainable=True, **KW)
    return dict(model.named_parameters()), mask


def test_zero1_matches_jax_zero1(runs):
    ranks, jstate = runs["ranks"], runs["jstate"]
    for got in ranks:
        np.testing.assert_allclose(got["zero1"]["losses"], runs["jl"], rtol=1e-5)
        assert_state_matches_jax(got["zero1"], jstate)
    named, mask = _named_trainable()
    flat = _flat_moments(ranks)
    plan = swav_optimizer_zero1(torch_model(), world_size=WORLD, **KW)[2]
    assert flat["mu"].shape[0] == plan.padded == runs["jplan"].padded
    payload = {"layout": "zero1", "count": STEPS, **flat, "decay_vec": plan.decay_vec}
    by_name = migrate_zero1_to_subtree(payload, named, mask)["state"]
    jsub = jopt.migrate_zero1_to_subtree(jstate.opt_state, jstate.params,
                                         jopt.build_masks(jstate.params, UNFREEZE)[1])
    # JAX's shard_mapped step differentiates the replicated parameters, so
    # its gradient arrives summed over the devices (the transpose of the
    # implicit pvary is a psum) before its own psum_scatter / world: its
    # moments are those of WORLD x the mean gradient. The port averages, as
    # the reference's DDP does; Adam's update is the same up to eps.
    for key, moments, scale in (("exp_avg", jsub[0].mu, WORLD),
                                ("exp_avg_sq", jsub[0].nu, WORLD ** 2)):
        got = _flat(timet_params_to_jax({n: s[key] * scale for n, s in by_name.items()}))
        want = _flat(moments)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                       atol=1e-5 * np.abs(want[k]).max(), err_msg=k)


def test_zero1_trajectory_equals_the_replicated_one(runs):
    """tests/test_zero1.py's trajectory test: ZeRO-1 and the replicated
    subtree optimizer over 3 steps, on the same gradients."""
    for got in runs["ranks"]:
        z, s = got["zero1"], got["subtree"]
        np.testing.assert_allclose(z["losses"], s["losses"], rtol=1e-5)
        _assert_leaves_close(_flat(timet_params_to_jax(z["params"])),
                             _flat(timet_params_to_jax(s["params"])))
        _assert_leaves_close(_flat(timet_params_to_jax({**z["params"], **z["teacher"]})),
                             _flat(timet_params_to_jax({**s["params"], **s["teacher"]})))


def test_zero1_state_is_split_and_the_rest_replicated(runs):
    ranks = runs["ranks"]
    z = [r["zero1"] for r in ranks]
    padded = z[0]["zero1"]["padded"]
    plan = swav_optimizer_zero1(torch_model(), world_size=WORLD, **KW)[2]
    assert padded == plan.padded and padded % WORLD == 0 and padded >= plan.length
    for r in z:
        assert r["zero1"]["chunk"] == padded // WORLD
        assert r["zero1"]["mu"].numel() == r["zero1"]["nu"].numel() == padded // WORLD
        assert r["partition"]["opt"] == "per_rank"
        assert not any(k.startswith("opt.") for k in r["replicated"])
    assert_replicas_identical(z)
    assert not torch.equal(z[0]["zero1"]["mu"], z[1]["zero1"]["mu"])


def test_layout_migrations_are_exact_and_refuse_another_trainable_set():
    model = torch_model()
    opt, mask = swav_optimizer(model, opt_over_trainable=True, **KW)
    named = dict(model.named_parameters())
    g = torch.Generator().manual_seed(0)
    for _ in range(2):
        for n, p in named.items():
            if mask[n]:
                p.grad = torch.randn(p.shape, generator=g)
        opt.step()
        opt.zero_grad()
    payload = checkpoint._opt_payload(opt)
    plan = swav_optimizer_zero1(model, world_size=3, **KW)[2]
    z = migrate_subtree_to_zero1(payload, plan)
    assert z["mu"].shape[0] == plan.padded and z["mu"][plan.length:].abs().max() == 0
    back = migrate_zero1_to_subtree(z, named, mask)
    assert back["count"] == payload["count"] == 2
    assert back["state"].keys() == payload["state"].keys()
    for n, st in payload["state"].items():
        for k in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(back["state"][n][k], st[k]), (n, k)
    bad = dict(z, mu=z["mu"].clone())
    if plan.padded > plan.length:
        bad["mu"][-1] = 1.0
        with pytest.raises(ValueError, match="nonzero moments beyond"):
            migrate_zero1_to_subtree(bad, named, mask)
    other = dict(mask, **{n: True for n in named if "blocks.0." in n})
    with pytest.raises(ValueError, match="fingerprint|different trainable set"):
        migrate_zero1_to_subtree(z, named, other)
    with pytest.raises(ValueError, match="fingerprint"):
        validate_zero1_fingerprint(1 - plan.decay_vec, plan)
    repad = zero1_plan_with_padding(plan, plan.padded + 5)
    assert repad.world == 1 and repad.chunk == repad.padded == plan.padded + 5
    assert torch.equal(repad.decay_vec[:plan.length], plan.decay_vec[:plan.length])


def test_zero1_needs_a_data_axis_and_the_subtree():
    model = torch_model()
    opt, mask, _ = swav_optimizer_zero1(model, world_size=2, **KW)
    cfg = tt.TimeTConfig(n_prototypes=K, spatial_resolution=4)
    with pytest.raises(ValueError, match="requires opt_over_trainable=True and a data axis"):
        tt.make_train_step(model, cfg, opt, trainable_mask=mask, opt_over_trainable=True)
    with single_rank_group():
        cfg = tt.TimeTConfig(n_prototypes=K, spatial_resolution=4, axis_name="data")
        with pytest.raises(ValueError, match="splits over 2 ranks"):
            tt.make_train_step(model, cfg, opt, trainable_mask=mask, opt_over_trainable=True)
        opt, mask, _ = swav_optimizer_zero1(model, world_size=1, **KW)
        with pytest.raises(ValueError, match="requires opt_over_trainable=True"):
            tt.make_train_step(model, cfg, opt, trainable_mask=mask)
        tt.make_train_step(model, cfg, opt, trainable_mask=mask, opt_over_trainable=True)


def test_world2_zero1_checkpoint_resumes_at_world1(runs):
    """The ZeRO-1 save at 2 ranks (rank 0 wrote the gathered [padded]
    moments): its padding read back with ``saved_zero1_padding``, loaded at
    world 1 into the subtree optimizer and into a one-chunk ZeRO-1
    optimizer, both exactly the moments the ranks held; a step on from it."""
    ranks = runs["ranks"]
    padded = ranks[0]["zero1"]["zero1"]["padded"]
    assert checkpoint.saved_zero1_padding(runs["save_dir"]) == padded
    flat = _flat_moments(ranks)
    for zero1 in (False, True):
        model = torch_model(runs["sd"])
        if zero1:
            opt, mask, plan = swav_optimizer_zero1(model, world_size=1, **KW)
        else:
            opt, mask = swav_optimizer(model, opt_over_trainable=True, **KW)
        cfg = tt.TimeTConfig(n_prototypes=K, spatial_resolution=4, **SCHED)
        state = tt.init_state(model, cfg, opt, trainable_mask=mask)
        state, epoch = checkpoint.load_checkpoint(runs["save_dir"], state)
        assert epoch == 1 and state.step == STEPS and opt.count == STEPS
        for n, p in model.state_dict().items():
            assert torch.equal(p, ranks[0]["zero1"]["params"][n]), n
        if zero1:
            assert torch.equal(opt.mu[:plan.length], flat["mu"][:plan.length])
            assert torch.equal(opt.nu[:plan.length], flat["nu"][:plan.length])
        else:
            mu = torch.cat([opt.adamw.state[p]["exp_avg"].reshape(-1)
                            for n, p in model.named_parameters() if mask[n]])
            assert torch.equal(mu, flat["mu"][:mu.numel()])
            step = tt.make_train_step(model, cfg, opt, trainable_mask=mask,
                                      opt_over_trainable=True)
            state, m = step(state, torch.from_numpy(clips(1, 2, seed=9)[0]), None)
            assert np.isfinite(float(m["loss"])) and opt.count == STEPS + 1
