"""One dispatch a program: the port's CUDA graphs (runtime.CapturedCall) and
what they need of the code they capture.

Here, on the CPU (where ``CapturedCall`` calls its function directly):

* the train step (``core/train.make_full_step``) keeps the address of every
  state tensor (parameters, teacher, queue, AdamW moments) over 3 steps,
  through the queue turning ready: a graph reads them by address;
* the step's device work takes its learning rates, weight decay and EMA
  momentum from the staged table alone, the update equals torch's AdamW
  with the schedules' floats (rtol 1e-6: another order of the same
  rounding) and the EMA the host-float formula bit for bit, at every step
  of a schedule that moves at every step;
* the augmentation's contrast and hue selection, computed for every clip
  and selected (fixed shapes), equals JAX's ``augment_batch`` at
  tests/test_torch_augment.py's tolerance on draws with no contrast or hue
  clip and on draws with several of each, and dispatches the same ops on
  the same shapes for both;
* ``CapturedCall`` on CPU tensors calls its function directly.

On the card (marker ``cuda``, skipped here; ``python -m pytest --noconftest
-m cuda tests/test_torch_graphs.py``): graphed against eager bit for bit on
the dino-s16 propagation group, the in-training eval's feature function
(with and without the attention) and diagnostics' scores function, the
loaded serving program (each call's output its own) and 3 train steps
through the queue turning ready, with the kernel launches of a call equal;
the training driver's loss read waits for its own step, not the next; the
checkpoint writer's files equal synchronous saves of the graphed step.
"""

import numpy as np
import pytest
import torch

from timetuning_tpu_torch.core import timet as tt
from timetuning_tpu_torch.core import train as ttrain
from timetuning_tpu_torch.core.optimizer import swav_optimizer
from timetuning_tpu_torch.core.schedules import cosine_scheduler, schedule_at
from timetuning_tpu_torch.data import transforms as ttf
from timetuning_tpu_torch.models.extractor import FeatureExtractor
from timetuning_tpu_torch.models.vit import ViTConfig, VisionTransformer
from timetuning_tpu_torch.ops import kernel_lib
from timetuning_tpu_torch.runtime import CapturedCall

torch.set_num_threads(2)

VIT = dict(patch_size=8, embed_dim=32, depth=3, num_heads=2, img_size=32)
HEAD, K = (48, 24), 8
UNFREEZE = ("blocks.1", "blocks.2")
B, F, BUF, STEPS = 2, 3, 40, 3
# the schedules span the 3 steps: every scheduled value moves at every step
SCHED = dict(num_epochs=1, steps_per_epoch=STEPS)


def _model(seed=1):
    vit = VisionTransformer(ViTConfig(**VIT))
    model = tt.TimeT(FeatureExtractor(vit, VIT["embed_dim"], HEAD), K)
    return model.init_weights(torch.Generator().manual_seed(seed))


def _build(graphed=True, seed=1):
    """A tiny TimeT with a queue of 40 rows that the 2-clip batch (16
    patches a frame, 20 rows stored a step) fills at step 2."""
    model = _model(seed)
    cfg = tt.TimeTConfig(n_prototypes=K, spatial_resolution=4, frozen_trunk_blocks=1,
                         use_queue=True, queue_size=40, **SCHED)
    opt, mask = swav_optimizer(model, lr=1e-3, unfreeze_layers=UNFREEZE,
                               opt_over_trainable=True, **SCHED)
    state = tt.init_state(model, cfg, opt, trainable_mask=mask)
    step = ttrain.make_full_step(model, cfg, opt, ttf.AugmentConfig(out_size=32),
                                 trainable_mask=mask, opt_over_trainable=True,
                                 graphed=graphed)
    return model, cfg, state, step


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 256, (n, B, F, BUF, BUF, 3), dtype=np.uint8)
    sizes = np.array([[48, 64], [60, 40]], np.int32)
    gmeans = rng.uniform(60, 200, (n, B, F)).astype(np.float32)
    return frames, sizes, gmeans




def test_step_keeps_the_state_tensors_addresses():
    _, _, state, step = _build()
    before = {k: t.data_ptr() for k, t in tt.state_tensors(state).items()}
    kinds = {k.split(".")[0] for k in before}
    assert kinds == {"params", "teacher", "opt", "queue"}, kinds
    assert any(k.endswith(".exp_avg_sq") for k in before)
    fills = []
    frames, sizes, gmeans = _batches(STEPS)
    for i in range(STEPS):
        state, _ = step(state, torch.from_numpy(frames[i]), torch.from_numpy(sizes),
                        torch.from_numpy(gmeans[i]), ttrain.step_generator(1, i))
        fills.append(state.queue_fill)
        after = {k: t.data_ptr() for k, t in tt.state_tensors(state).items()}
        assert after == before, [k for k in before if after.get(k) != before[k]]
    assert fills == [20, 40, 40]                  # ready from step 2 on
    assert state.step == state.opt.count == STEPS


def test_device_step_reads_its_schedule_from_the_table():
    """Two equal states whose host counters differ (so the schedules would
    give other floats) step alike on the same staged table: the device work
    reads no scheduled value from the host."""
    runs = []
    for count in (0, 2):
        model, cfg, state, _ = _build()
        state.opt.count = state.step = count
        base = tt.make_train_step(model, cfg, state.opt,
                                  trainable_mask=state.opt.trainable_mask,
                                  opt_over_trainable=True)
        runs.append((state, base))
    clip = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (B, F, 32, 32, 3)).astype(np.float32))
    plans = [base.plan(state, B, torch.Generator().manual_seed(5)) for state, base in runs]
    assert plans[0].scalars != plans[1].scalars
    assert torch.equal(plans[0].idx, plans[1].idx)
    table = torch.tensor(plans[0].scalars)
    for state, base in runs:
        base.device_step(state, clip, plans[0].idx, table, plans[0].queue_ready)
    a, b = (tt.state_tensors(s) for s, _ in runs)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_update_and_ema_follow_a_moving_schedule():
    """At each of 3 steps: every scheduled value has moved; the trainable
    leaves equal torch's AdamW stepped with the schedules' floats on the
    step's own gradients (recovered as the update's inputs), and the
    teacher equals ``t (1 - m) + p m`` in host floats bit for bit."""
    model, cfg, state, step = _build()
    names = [n for n, m in state.opt.trainable_mask.items() if m]
    named = dict(model.named_parameters())
    ref_params = {n: named[n].detach().clone().requires_grad_(True) for n in names}
    groups = []
    for g in state.opt.adamw.param_groups:
        ps = [ref_params[n] for n, p in named.items() if any(p is q for q in g["params"])]
        groups.append(dict(params=ps, lr_factor=g["lr_factor"], decays=g["decays"]))
    ref = torch.optim.AdamW(groups, lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=0.0, foreach=False)
    m_sched = cosine_scheduler(cfg.ema_start, cfg.ema_end, cfg.num_epochs,
                               cfg.steps_per_epoch)
    captured = {}
    apply = state.opt.apply

    def spy(grads, table):                  # the step's gradients, as given
        captured.update({p: g.clone() for p, g in grads.items()})
        apply(grads, table)

    state.opt.apply = spy
    frames, sizes, gmeans = _batches(STEPS)
    seen = []
    for i in range(STEPS):
        teacher = {n: t.clone() for n, t in state.teacher.items()}
        lr, wd = state.opt.lr_at(i), state.opt.weight_decay_at(i)
        m = schedule_at(m_sched, i)
        seen.append((lr, wd, m))
        state, metrics = step(state, torch.from_numpy(frames[i]), torch.from_numpy(sizes),
                              torch.from_numpy(gmeans[i]), ttrain.step_generator(1, i))
        assert metrics["momentum"] == m
        for g in ref.param_groups:
            g["lr"] = lr * g["lr_factor"]
            g["weight_decay"] = wd if g["decays"] else 0.0
        for n in names:
            ref_params[n].grad = captured[named[n]]
        ref.step()
        for n in names:
            got = named[n].detach()
            want = ref_params[n].detach()
            if n == "prototypes":           # renormalised after the update
                want = want / (torch.linalg.vector_norm(want, dim=-1, keepdim=True) + 1e-12)
            torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-7, msg=n)
            ref_params[n].data.copy_(got)   # each step from the same point
            if n != "prototypes":
                ema = teacher[n].mul(1.0 - m).add(got * m)
                assert torch.equal(state.teacher[n], ema), n
    for a, b in zip(seen, seen[1:]):
        assert all(x != y for x, y in zip(a, b)), seen


def test_contrast_and_hue_selection_has_fixed_shapes_and_matches_jax():
    """Fixed-size selection (every clip's gray mean and hue, kept where the
    clip drew them, as JAX's ``lax.switch`` under ``vmap``): the same ops on
    the same shapes whatever the draws, and JAX's values on draws with no
    contrast or hue clip and on draws with several of each."""
    import jax
    import jax.numpy as jnp
    from test_torch_augment import CHAIN, _frames, jax_params

    from timetuning_tpu.data import transforms as jt

    n = 6
    frames = _frames((n, 2, 40, 48, 3), seed=21)
    sizes = np.array([[480, 854], [720, 405], [64, 64]] * 2, np.int32)
    gmeans = np.random.default_rng(22).uniform(20, 230, (n, 2)).astype(np.float32)
    gmeans[:, 1] = np.nan                # the buffer's own mean for these
    found = {}
    for seed in range(64):
        key = jax.random.PRNGKey(seed)
        p = jax_params(key, n, 2, jt.AugmentConfig())
        jit, op = p.column("jitter") > 0, p.column("op")
        nc, nh = int((jit & (op == 1)).sum()), int((jit & (op == 3)).sum())
        if nc == nh == 0:
            found.setdefault("none", (key, p))
        if nc >= 2 and nh >= 2:
            found.setdefault("several", (key, p))
        if len(found) == 2:
            break
    assert found.keys() == {"none", "several"}, found.keys()

    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            shapes = [tuple(a.shape) for a in args if isinstance(a, torch.Tensor)]
            self.seen.append((str(func), shapes))
            return out

    cfg = ttf.AugmentConfig(out_size=24)
    # a first call fills the per-device constant caches, as a graph's warm-up
    ttf.apply_augment(torch.from_numpy(frames), found["none"][1], cfg,
                      torch.from_numpy(sizes), torch.from_numpy(gmeans))
    traces = []
    for key, params in found.values():
        want, _ = jt.augment_batch(key, jnp.asarray(frames), None,
                                   jt.AugmentConfig(out_size=24),
                                   src_sizes=jnp.asarray(sizes),
                                   gray_means=jnp.asarray(gmeans))
        with Ops() as ops:
            got, _ = ttf.apply_augment(torch.from_numpy(frames), params, cfg,
                                       torch.from_numpy(sizes), torch.from_numpy(gmeans))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **CHAIN)
        traces.append(ops.seen)
    assert traces[0] == traces[1]


def test_captured_call_on_cpu_tensors_calls_fn():
    calls = []

    def fn(x, flag):
        calls.append(flag)
        return x * 2, None

    program = CapturedCall(fn)
    x = torch.arange(3.0)
    outs = [program(x, i, key=i) for i in range(3)]
    assert calls == [0, 1, 2]
    assert torch.equal(outs[2][0], x * 2) and outs[2][1] is None
    assert CapturedCall(fn, group=object())(x, 7)[0] is not None and calls[-1] == 7


# ------------------------------------------------------------------ #
# on the card


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (and nvcc to build the kernels)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _launches(fn):
    torch.cuda.synchronize()
    kernel_lib.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, {k: v for k, v in kernel_lib.launch_counts().items() if v}


@pytest.mark.cuda
def test_graphed_propagation_group_equals_eager(dev):
    from timetuning_tpu_torch.cli import propagate as prop
    from timetuning_tpu_torch.models.registry import get_backbone

    args = prop.build_parser().parse_args([
        "--architecture", "dino-s16", "--compute_dtype", "bfloat16",
        "--n_last_frames", "4", "--size_mask_neighborhood", "12", "--clip_batch", "2"])
    bb = get_backbone("dino-s16", dtype=torch.bfloat16, device=dev)
    rng = np.random.default_rng(0)
    frames = torch.from_numpy(rng.integers(0, 256, (2, 5, 240, 320, 3), np.uint8)).to(dev)
    onehots = torch.from_numpy(np.eye(4, dtype=np.float32)[
        rng.integers(0, 4, (2, 196))].transpose(0, 2, 1).copy()).to(dev)
    eager = prop.group_program(args, bb, graphed=False)
    graphed = prop.group_program(args, bb)
    want, n_eager = _launches(lambda: eager(frames, onehots).clone())
    for i in range(3):                      # eager, capture + replay, replay
        got, n_graphed = _launches(lambda: graphed(frames, onehots).clone())
        assert torch.equal(got, want), i
        assert n_graphed == n_eager, (i, n_graphed, n_eager)
    assert {"preprocess", "attention_block", "mlp_block", "propagation"} <= n_eager.keys()


def _s16_timet(dev):
    from timetuning_tpu_torch.models.vit import vit_small

    vit = VisionTransformer(vit_small(16, img_size=224, dtype=torch.bfloat16))
    model = tt.TimeT(FeatureExtractor(vit, 384, (1024, 1024, 512, 256)), 200)
    return model.init_weights(torch.Generator().manual_seed(0)).to(dev)


@pytest.mark.cuda
def test_graphed_eval_feature_and_diagnostics_equal_eager(dev):
    """``make_eval_feature_fn`` with and without the attention and
    ``make_diagnostics_scores_fn`` at dino-s16 width, bf16, 6 images."""
    model = _s16_timet(dev)
    x = torch.from_numpy(np.random.default_rng(3).integers(
        0, 256, (6, 224, 224, 3), np.uint8)).to(dev)
    cases = {"features": [ttrain.make_eval_feature_fn(model, 224, graphed=g)
                          for g in (False, True)],
             "diagnostics": [ttrain.make_diagnostics_scores_fn(model, 224, graphed=g)
                             for g in (False, True)]}
    for name, (eager, graphed) in cases.items():
        for want in ((False, True) if name == "features" else (None,)):
            args = (x,) if want is None else (x, want)
            want_out, n_eager = _launches(lambda: eager(*args))
            for i in range(3):              # eager, capture + replay, replay
                got, n_graphed = _launches(lambda: graphed(*args))
                assert len(got) == len(want_out)
                for a, b in zip(got, want_out):
                    assert (a is None and b is None) or torch.equal(a, b), (name, want, i)
                assert n_graphed == n_eager, (name, want, i, n_graphed, n_eager)
            assert {"attention_block", "mlp_block"} <= n_eager.keys(), (name, n_eager)


@pytest.mark.cuda
def test_graphed_serving_program_equals_eager(dev, tmp_path):
    from timetuning_tpu_torch.cli import export as texport

    blob, _, _, em = texport.export_features("dino-s16", None, 4, 224, "bfloat16",
                                             symbolic_batch=True, device="cuda")
    path = str(tmp_path / "f.pt2")
    texport.save_exported(path, blob, em)
    eager = texport.load_exported(path, graphed=False)
    graphed = texport.load_exported(path)
    rng = np.random.default_rng(1)
    kept = []                               # a call's output outlives later calls
    for batch in (4, 5):
        x = torch.from_numpy(rng.integers(0, 256, (batch, 224, 224, 3), np.uint8)).to(dev)
        with torch.no_grad():
            want, n_eager = _launches(lambda: eager(x).clone())
            for i in range(3):
                got, n_graphed = _launches(lambda: graphed(x))
                assert torch.equal(got, want), (batch, i)
                assert n_graphed == n_eager, (batch, i, n_graphed, n_eager)
            kept.append((got, want))
    for got, want in kept:
        assert torch.equal(got, want)


def _s16_train(dev, graphed):
    """The flagship TimeT (``torch_dp_worker.flagship``: dino-s16 width,
    bf16), its state and its full step, with a queue of 80 rows and a
    schedule over ``STEPS`` steps; and ``STEPS`` batches of 4 clips of 3
    frames."""
    from torch_dp_worker import flagship

    _, _, _, state, step = flagship(dev, torch.bfloat16, sched=SCHED,
                                    full_step=dict(graphed=graphed), use_queue=True,
                                    queue_size=80)
    rng = np.random.default_rng(2)
    frames = torch.from_numpy(rng.integers(0, 256, (STEPS, 4, 3, 256, 320, 3), np.uint8)).to(dev)
    sizes = torch.tensor([[480, 854]] * 4, device=dev)
    gmeans = torch.full((4, 3), float("nan"), device=dev)
    return state, step, (frames, sizes, gmeans)


@pytest.mark.cuda
def test_graphed_train_steps_equal_eager(dev):
    """3 steps at dino-s16 width, bf16, 4 clips of 3 frames (the queue of
    80 rows ready at step 2), a schedule over the 3 steps."""
    runs = []
    for graphed in (False, True):
        state, step, (frames, sizes, gmeans) = _s16_train(dev, graphed)
        losses, counts = [], []
        for i in range(STEPS):
            (state, m), n = _launches(lambda: step(state, frames[i], sizes, gmeans,
                                                   ttrain.step_generator(1, i)))
            losses.append(float(m["loss"]))
            counts.append(n)
        runs.append((losses, counts, tt.state_tensors(state)))
    (le, ce, te), (lg, cg, tg) = runs
    assert le == lg and ce == cg, (le, lg, ce, cg)
    assert te.keys() == tg.keys()
    for k in te:
        assert torch.equal(te[k], tg[k]), k


@pytest.mark.cuda
def test_checkpoint_writer_saves_graphed_steps(dev, tmp_path):
    """``core/checkpoint``'s writer on the graphed step at dino-s16 width: a
    save through it right after each step's replay is queued, and a
    synchronous save after it, write equal files bit for bit; the writer's
    host buffers are pinned and the same storages at every save."""
    from timetuning_tpu_torch.core import checkpoint as tck

    state, step, (frames, sizes, gmeans) = _s16_train(dev, graphed=True)
    writer = tck.CheckpointWriter()
    staged = []
    to_host = writer.to_host
    writer.to_host = lambda payload: staged.append(to_host(payload)) or staged[-1]
    for i in range(STEPS):
        state, _ = step(state, frames[i], sizes, gmeans, ttrain.step_generator(1, i))
        for kind in ("thread", "sync"):
            (tmp_path / f"{kind}{i}").mkdir()
        tck.save_checkpoint(state, str(tmp_path / f"thread{i}"), i, meta={"i": i},
                            writer=writer)
        tck.save_checkpoint(state, str(tmp_path / f"sync{i}"), i, meta={"i": i})
    writer.join()
    for i in range(STEPS):
        _assert_same_tree(
            torch.load(tmp_path / f"thread{i}" / "checkpoint.pt", weights_only=True),
            torch.load(tmp_path / f"sync{i}" / "checkpoint.pt", weights_only=True), str(i))
    first = dict(_leaves(staged[0]))
    assert len(staged) == STEPS and len(first) > 100
    assert all(t.is_pinned() for t in first.values())
    for later in staged[1:]:
        assert {k: t.data_ptr() for k, t in _leaves(later)} == {
            k: t.data_ptr() for k, t in first.items()}


def _leaves(tree, path=""):
    if torch.is_tensor(tree):
        yield path, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}.{k}")


def _assert_same_tree(a, b, path):
    assert type(a) is type(b), path
    if isinstance(a, dict):
        assert list(a) == list(b), path
        for k in a:
            _assert_same_tree(a[k], b[k], f"{path}.{k}")
    elif torch.is_tensor(a):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    else:
        assert a == b, path


@pytest.mark.cuda
def test_loss_read_waits_for_its_own_step_alone(dev):
    """``core/train``'s loss read: step n's loss, copied to pinned memory
    behind step n, reads exactly while step n + 1 (queued before the read)
    still runs; a plain ``float`` of a device loss waits for every step
    queued before it, step n + 1 too. Each stub step makes its loss, then
    sleeps ~0.1 s on the card."""
    def step(n):
        loss = torch.full((), float(n), device=dev) + 0.25
        torch.cuda._sleep(200_000_000)
        done = torch.cuda.Event()
        done.record()
        return loss, done

    torch.cuda.synchronize()
    loss0, end0 = step(0)
    value0, ready0 = ttrain.queue_loss_copy(loss0)
    _, end1 = step(1)
    got = ttrain.read_queued_loss(value0, ready0)
    assert end0.query() and not end1.query()
    assert got == 0.25 and value0.is_pinned()
    torch.cuda.synchronize()
    loss2, _ = step(2)
    _, end3 = step(3)
    assert float(loss2) == 2.25 and end3.query()
