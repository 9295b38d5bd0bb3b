"""The port stands alone: a fresh interpreter imports every module of
``timetuning_tpu_torch``, runs its two CLIs and a train step on the CPU, and
has then loaded neither jax, flax, optax nor any module of the JAX
package."""

import os
import subprocess
import sys

import cv2
import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHECK = """
import sys
bad = sorted(m for m in sys.modules
             if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'timetuning_tpu'))
assert not bad, f'imported: {bad}'
"""


def _run(code):
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-c", code + _CHECK], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """A DAVIS tree (2 videos of 6 frames, a moving red box) and a Pascal VOC
    tree (6 images, 3 a split), 64x64."""
    davis = tmp_path_factory.mktemp("davis_alone")
    for v in range(2):
        fdir = davis / "JPEGImages" / "480p" / f"video{v}"
        adir = davis / "Annotations" / "480p" / f"video{v}"
        fdir.mkdir(parents=True)
        adir.mkdir(parents=True)
        for f in range(6):
            img = np.full((64, 64, 3), 30, np.uint8)
            y = 16 + f + 3 * v
            img[y:y + 24, 20:44] = [220, 40, 40]
            cv2.imwrite(str(fdir / f"{f:05d}.jpg"), img)
            ann = np.zeros((64, 64), np.uint8)
            ann[y:y + 24, 20:44] = 1
            cv2.imwrite(str(adir / f"{f:05d}.png"), ann)
    voc = tmp_path_factory.mktemp("voc_alone")
    for sub in ("images", "SegmentationClass", "SegmentationClassAug", "sets"):
        (voc / sub).mkdir()
    names = [f"img{i}" for i in range(6)]
    for i, n in enumerate(names):
        img = np.full((64, 64, 3), 40, np.uint8)
        mask = np.zeros((64, 64), np.uint8)
        img[8 + 2 * i:32 + 2 * i, 16:48] = [200, 60, 60]
        mask[8 + 2 * i:32 + 2 * i, 16:48] = 1
        cv2.imwrite(str(voc / "images" / f"{n}.jpg"), img)
        for sub in ("SegmentationClass", "SegmentationClassAug"):
            cv2.imwrite(str(voc / sub / f"{n}.png"), mask)
    (voc / "sets" / "val.txt").write_text("\n".join(names[:3]))
    (voc / "sets" / "trainaug.txt").write_text("\n".join(names[3:]))
    return str(davis), str(voc)


def test_every_module_imports_and_the_clis_run_without_the_jax_package(trees):
    davis, voc = trees
    out = _run(f"""
import importlib, pkgutil
import timetuning_tpu_torch
names = [m.name for m in pkgutil.walk_packages(timetuning_tpu_torch.__path__,
                                               'timetuning_tpu_torch.')]
for name in names:
    importlib.import_module(name)
print('modules', len(names))
from timetuning_tpu_torch.cli import linear_probe, propagate
assert propagate.main(['--device', 'cpu', '--architecture', 'vit-tiny-test',
                       '--data_root', {davis!r}, '--num_frames', '4',
                       '--n_last_frames', '2', '--size_mask_neighborhood', '2',
                       '--input_resolution', '64', '--num_workers', '2']) == 0
assert linear_probe.main(['--device', 'cpu', '--architecture', 'vit-tiny-test',
                          '--pascal_root', {voc!r}, '--batch_size', '2',
                          '--num_classes', '2', '--num_epochs', '1',
                          '--input_resolution', '32', '--mask_size', '16']) == 0
""")
    n_modules = int(out.split("modules ")[1].split()[0])
    assert n_modules >= 30
    assert "J&F: " in out and "val mIoU" in out


def test_cbfe_and_the_whole_zoo_run_without_the_jax_package(trees):
    """``cli/cbfe --device cpu`` on the VOC tree, ``cli/propagate
    --use_optical_flow`` on the DAVIS tree, and every name of the zoo built
    (seeded, full width) and applied to one small image."""
    davis, voc = trees
    out = _run(f"""
import torch
from timetuning_tpu_torch.cli import cbfe, propagate
from timetuning_tpu_torch.models.registry import ARCHITECTURES, get_backbone
assert cbfe.main(['--device', 'cpu', '--architecture', 'vit-tiny-test',
                  '--pascal_root', {voc!r}, '--batch_size', '3', '--num_clusters', '6',
                  '--input_resolution', '32', '--resolution', '16',
                  '--eval_resolution', '16', '--num_eval_clusters', '2']) == 0
assert propagate.main(['--device', 'cpu', '--architecture', 'vit-tiny-test',
                       '--data_root', {davis!r}, '--num_frames', '4',
                       '--input_resolution', '64', '--num_workers', '2',
                       '--use_optical_flow', 'true']) == 0
with torch.inference_mode():
    for name in ARCHITECTURES:
        bb = get_backbone(name, device='cpu')
        feats, _ = bb.apply(torch.zeros(1, 32, 32, 3))
        assert feats.shape[-1] == bb.feature_dim, name
print('zoo', len(ARCHITECTURES))
""")
    assert "threshold=" in out and "J&F: " in out and "zoo 18" in out


def test_export_and_parity_run_without_the_jax_package(tmp_path):
    """``cli/export --device cpu`` writes a symbolic-batch program of
    vit-tiny-test and checks it; a second fresh interpreter loads it with
    ``load_exported`` alone (no model module gets imported) and runs it;
    ``cli/parity --device cpu`` runs stage 1 on a made-up reference-layout
    checkpoint."""
    program, pth = str(tmp_path / "f.pt2"), str(tmp_path / "TimeT.pth")
    out = _run(f"""
import torch
from timetuning_tpu_torch.cli import export, parity
from timetuning_tpu_torch.eval.parity_oracle import build_oracle, build_oracle_head
assert export.main(['--device', 'cpu', '--architecture', 'vit-tiny-test',
                    '--input_resolution', '32', '--batch_size', '2',
                    '--compute_dtype', 'float32', '--symbolic_batch', 'true',
                    '--out', {program!r}]) == 0
torch.manual_seed(0)
sd = {{f'feature_extractor.backbone.{{k}}': v for k, v in
      build_oracle(img_size=32, patch_size=8, dim=32, depth=2, heads=2).state_dict().items()}}
sd.update({{f'feature_extractor.head.{{k}}': v
           for k, v in build_oracle_head((48, 24), 32).state_dict().items()}})
sd['prototypes'] = torch.nn.functional.normalize(torch.randn(8, 24), dim=-1)
torch.save(sd, {pth!r})
assert parity.main(['--device', 'cpu', '--architecture', 'vit-tiny-test',
                    '--input_resolution', '32', '--timet_pth', {pth!r}]) == 0
""")
    assert "symbolic-batch check: batch 3 ok" in out
    assert "prototype scores max|Δ|" in out and "FAIL" not in out
    out = _run(f"""
import sys, torch
from timetuning_tpu_torch.cli.export import load_exported
fn = load_exported({program!r})
print('features', tuple(fn(torch.zeros(5, 32, 32, 3, dtype=torch.uint8)).shape))
models = sorted(m for m in sys.modules if m.startswith('timetuning_tpu_torch.models'))
assert not models, models
""")
    assert "features (5, 16, 32)" in out


def test_a_train_step_runs_without_the_jax_package():
    out = _run("""
import torch
from timetuning_tpu_torch.core.optimizer import swav_optimizer
from timetuning_tpu_torch.core.timet import TimeT, TimeTConfig, init_state, make_train_step
from timetuning_tpu_torch.models.extractor import FeatureExtractor
from timetuning_tpu_torch.models.vit import ViTConfig, VisionTransformer
g = torch.Generator().manual_seed(0)
vit = VisionTransformer(ViTConfig(patch_size=8, embed_dim=32, depth=3, num_heads=2,
                                  img_size=32, dtype=torch.bfloat16))
model = TimeT(FeatureExtractor(vit, 32, (48, 24)), 8).init_weights(g)
cfg = TimeTConfig(n_prototypes=8, spatial_resolution=4, num_epochs=1, steps_per_epoch=10,
                  frozen_trunk_blocks=1, use_queue=True, queue_size=40)
opt, mask = swav_optimizer(model, unfreeze_layers=('blocks.1', 'blocks.2'), num_steps=10,
                           opt_over_trainable=True)
state = init_state(model, cfg, opt, trainable_mask=mask)
step = make_train_step(model, cfg, opt, trainable_mask=mask, opt_over_trainable=True)
clip = torch.randn(2, 3, 32, 32, 3, generator=g)
for _ in range(3):
    state, metrics = step(state, clip, g)
print('loss', float(metrics['loss']), 'fill', state.queue_fill)
""")
    assert "fill 40" in out and np.isfinite(float(out.split("loss ")[1].split()[0]))


def test_no_source_file_of_the_port_names_the_jax_package_in_code():
    """``timetuning_tpu`` appears in the port, in chip_smoke.py and in the
    tools that import the port only in comments and docstrings: no import,
    no path, no string that is executed."""
    import ast

    tools = os.path.join(ROOT, "tools")
    files = [os.path.join(tools, n) for n in sorted(os.listdir(tools)) if n.endswith(".py")
             and "from timetuning_tpu_torch" in open(os.path.join(tools, n)).read()]
    assert len(files) >= 4, files
    files.append(os.path.join(ROOT, "chip_smoke.py"))
    for base, _, names in os.walk(os.path.join(ROOT, "timetuning_tpu_torch")):
        files += [os.path.join(base, n) for n in names if n.endswith(".py")]
    for path in files:
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            mods = []
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            for mod in mods:
                assert mod.split(".")[0] not in ("timetuning_tpu", "jax", "flax", "optax"), (
                    f"{path}: imports {mod}")
    assert not os.path.exists(os.path.join(ROOT, "timetuning_tpu_torch", "_host.py"))


def test_train_and_evaluate_clis_run_without_the_jax_package(trees, tmp_path):
    """``cli/train`` (2 steps: 2 videos, batch 2, 2 epochs; the Pascal eval
    at epoch 0 with the best model exported) and ``cli/evaluate`` in a fresh
    interpreter. The metrics writer's TensorBoard mirror goes through torch's
    SummaryWriter, which imports TensorFlow where it is installed, and
    TensorFlow imports jax: TensorFlow is kept out, so what is checked is the
    port's own imports."""
    davis, voc = trees
    out = _run(f"""
import sys
sys.modules['tensorflow'] = None
from timetuning_tpu_torch.cli import evaluate, train
assert train.main(['--device', 'cpu', '--architecture', 'vit-tiny-test',
                   '--dataset', 'davis', '--data_root', {davis!r},
                   '--pascal_root', {voc!r}, '--eval_num_clusters', '2',
                   '--log_dir', {str(tmp_path)!r}, '--batch_size', '2',
                   '--num_epochs', '2', '--num_frames', '3', '--num_workers', '2',
                   '--num_clusters', '8', '--input_resolution', '32',
                   '--n_last_frames', '2', '--size_mask_neighborhood', '1',
                   '--compute_dtype', 'float32', '--unfreeze_layers', 'blocks.1',
                   '--seed', '3']) == 0
assert evaluate.main(['--device', 'cpu', '--architecture', 'vit-tiny-test',
                      '--dataset', 'davis_val', '--data_root', {davis!r},
                      '--batch_size', '2', '--num_frames', '2',
                      '--input_resolution', '32', '--eval_resolution', '16',
                      '--num_clusters', '2', '--evaluation_protocol', 'dataset-wise',
                      '--num_workers', '2']) == 0
""")
    assert "done: run_dir=" in out and "score: " in out
    best = float(out.split("best=")[1].split()[0])
    assert 0.0 <= best <= 1.0
    assert 0.0 <= float(out.split("score: ")[1].split()[0]) <= 1.0


def test_the_data_parallel_step_runs_without_the_jax_package(tmp_path):
    """A fresh interpreter imports ``parallel/*`` and runs 2 gloo ranks
    (tests/torch_dp_worker.py) of 2 steps with the queue and of 2 with
    ZeRO-1 on seeded weights; neither it nor the ranks load jax, flax, optax
    or the JAX package."""
    out = _run(f"""
import sys
sys.path.insert(0, 'tests')
import numpy as np
import torch
import timetuning_tpu_torch.parallel
from timetuning_tpu_torch.parallel import mesh
from torch_dp_worker import spawn, torch_model
model = torch_model()
model.init_weights(torch.Generator().manual_seed(0))
sd = model.state_dict()
clips = np.random.default_rng(0).standard_normal((2, 4, 3, 32, 32, 3)).astype(np.float32)
job = [dict(kind='step', name='queue', state_dict=sd, cfg=dict(use_queue=True, queue_size=40),
            clips=clips),
       dict(kind='step', name='zero1', state_dict=sd, cfg={{}}, clips=clips, zero1=True)]
ranks = spawn(job, {str(tmp_path)!r}, 2, timeout=180)
for name in ('queue', 'zero1'):
    a, b = (r[name] for r in ranks)
    assert a['losses'] == b['losses'] and np.isfinite(a['losses']).all()
    assert all(torch.equal(a['replicated'][k], b['replicated'][k]) for k in a['replicated'])
assert not any(r['foreign_modules'] for r in ranks), [r['foreign_modules'] for r in ranks]
print('ranks', len(ranks), mesh.DATA_AXIS)
""")
    assert "ranks 2 data" in out


def test_the_moe_ep_and_tp_steps_run_without_the_jax_package(tmp_path):
    """A fresh interpreter imports ``parallel/ep`` and ``parallel/tp``, runs
    2 MoE steps with the Switch auxiliary in bf16 (the MoE block's branch
    in plain ops), and 2 gloo ranks of a 1 x 2 expert mesh and of a 1 x 2
    model mesh (tests/torch_dp_worker.py); neither it nor the ranks load
    jax, flax, optax or the JAX package."""
    out = _run(f"""
import sys
sys.path.insert(0, 'tests')
import numpy as np
import torch
from timetuning_tpu_torch.parallel import ep, tp
from timetuning_tpu_torch.core.optimizer import swav_optimizer
from timetuning_tpu_torch.core.timet import TimeTConfig, init_state, make_train_step
from torch_dp_worker import spawn, torch_model
moe_vit = dict(patch_size=8, embed_dim=32, depth=2, num_heads=2, img_size=32,
               moe_every_k=2, n_experts=4)
g = torch.Generator().manual_seed(0)
model = torch_model(vit_kw=dict(moe_vit, dtype=torch.bfloat16)).init_weights(g)
cfg = TimeTConfig(n_prototypes=8, spatial_resolution=4, num_epochs=1, steps_per_epoch=10,
                  moe_aux_weight=0.01)
opt, mask = swav_optimizer(model, unfreeze_layers=('blocks.1',), num_steps=10,
                           opt_over_trainable=True)
state = init_state(model, cfg, opt, trainable_mask=mask)
step = make_train_step(model, cfg, opt, trainable_mask=mask, opt_over_trainable=True)
clip = torch.randn(2, 3, 32, 32, 3, generator=g)
for _ in range(2):
    state, metrics = step(state, clip, g)
assert 1.0 <= float(metrics['moe_aux']) <= 4.0 and np.isfinite(float(metrics['loss']))
sd = torch_model(vit_kw=moe_vit).init_weights(torch.Generator().manual_seed(1)).state_dict()
dense = torch_model().init_weights(torch.Generator().manual_seed(2)).state_dict()
clips = np.random.default_rng(0).standard_normal((2, 2, 3, 32, 32, 3)).astype(np.float32)
x = clips[0, :, 0]
base = dict(kind='mesh_step', dp=1, n=2, cfg={{}}, unfreeze=('blocks.1',), clips=clips,
            draws=[], x=x)
job = [dict(base, name='ep', mesh='ep', state_dict=sd, vit=moe_vit),
       dict(base, name='tp', mesh='tp', state_dict=dense,
            vit=dict(patch_size=8, embed_dim=32, depth=2, num_heads=2, img_size=32))]
ranks = spawn(job, {str(tmp_path)!r}, 2, timeout=180)
for name in ('ep', 'tp'):
    a, b = (r[name] for r in ranks)
    assert a['losses'] == b['losses'] and np.isfinite(a['losses']).all()
assert not any(r['foreign_modules'] for r in ranks), [r['foreign_modules'] for r in ranks]
print('ranks', len(ranks), ep.EXPERT_AXIS, tp.MODEL_AXIS)
""")
    assert "ranks 2 expert model" in out


def test_sp_pp_and_a_mesh_export_run_without_the_jax_package(tmp_path):
    """A fresh interpreter imports ``parallel/sp`` and ``parallel/pp`` and
    runs 2 gloo ranks (tests/torch_dp_worker.py) of a 1 x 2 seq and a 1 x 2
    pipe forward, the pipe's with its backward, and of a 1 x 2 seq mesh
    export (``cli/export``) loaded back; neither it nor the ranks load jax,
    flax, optax or the JAX package."""
    out = _run(f"""
import sys
sys.path.insert(0, 'tests')
import numpy as np
import torch
from timetuning_tpu_torch.parallel import pp, sp
from timetuning_tpu_torch.models.vit import ViTConfig, VisionTransformer
from torch_dp_worker import spawn
vit = dict(patch_size=8, embed_dim=32, depth=2, num_heads=2, img_size=32)
sd = VisionTransformer(ViTConfig(**vit)).init_weights(torch.Generator().manual_seed(0)).state_dict()
x = np.random.default_rng(0).standard_normal((2, 32, 32, 3)).astype(np.float32)
frames = np.random.default_rng(1).integers(0, 256, (2, 32, 32, 3), np.uint8)
base = dict(kind='seq_pipe', dp=1, n=2, vit=vit, state_dict=sd, x=x)
program = dict(architecture='vit-tiny-test', model_path=None, batch_size=2,
               input_resolution=32, compute_dtype='float32', device='cpu',
               sequence_parallel=2)
job = [dict(base, name='sp', mesh='sp'), dict(base, name='pp', mesh='pp', grad=True),
       dict(kind='export_mesh', name='export', programs=dict(sp=program),
            dir={str(tmp_path)!r}, frames=frames),
       dict(kind='load_mesh', name='load', frames=frames,
            paths=dict(sp={str(tmp_path / 'sp.json')!r}))]
ranks = spawn(job, {str(tmp_path / 'ranks')!r}, 2, timeout=180)
for r in ranks:
    assert torch.allclose(r['sp']['tokens'], r['pp']['tokens'], atol=1e-5)
    assert torch.allclose(r['load']['sp']['program'], r['export']['sp']['live'], atol=1e-6)
    assert r['pp']['grads']
assert not any(r['foreign_modules'] for r in ranks)
print('ranks', len(ranks), sp.SEQ_AXIS, pp.PIPE_AXIS)
""")
    assert "ranks 2 seq pipe" in out
