"""The port's main paths on the card, each against its own reference: the
checks no kernel test, graph test or benchmark cell holds. Skipped without a
card. This file imports no jax:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_card_paths.py

* the propagation eval (``cli/propagate``'s groups and J&F) in bf16 through
  the kernels against f32, at ViT-S/16 224 and ViT-S/8 448;
* the linear probe at ViT-S/8 448 in f32 (the flash kernel);
* the flagship train step (ViT-S/16 224 at full width, 32 clips) with the
  kernels on the grad path (``grad_attn_impl=None``), with ``remat``, and
  with ``attn_impl="pallas"``, each against the default step; the f32 step
  on the card against the host's;
* the augmentation on the card against the host; K3 at the train step's
  shape; the in-training eval's feature function against the plain
  preprocess and the plain blocks;
* the zoo's feature path, every registry name at full width, bf16 against
  f32 (CNNs: the card against the host), and ``mocov3-s16`` at 576 px;
* CBFE and ``cli/parity`` stages 1-4 on synthetic trees;
* MoE in one process, and the multi-rank paths through two gloo ranks that
  share the card (``tests/torch_dp_worker.spawn``): dp (default and
  ZeRO-1, kernel 11's cross-rank form), ep, tp, sp and pp, and the five
  multi-device serving programs, each against one process.

Every run also launches the kernels of its path; each test's docstring
gives its bound and why.
"""

import os

import numpy as np
import pytest
import torch

from benchmark import generate
from timetuning_tpu_torch.models.registry import ARCHITECTURES
from timetuning_tpu_torch.ops import kernel_lib

pytestmark = [pytest.mark.cuda,
              pytest.mark.skipif(not torch.cuda.is_available(),
                                 reason="needs a CUDA card (and nvcc to build the kernels)")]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (and nvcc to build the kernels)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _launched(fn):
    """``fn()`` and the kernel launches it made."""
    torch.cuda.synchronize()
    kernel_lib.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, kernel_lib.launch_counts()


def _cosine(got, want) -> float:
    """The least per-token cosine of two token tensors."""
    return float(torch.nn.functional.cosine_similarity(
        got.float(), want.float(), dim=-1).min())


def _davis_clips(dev, n: int = 2, frames: int = 12):
    """``n`` DAVIS-size (480 x 854) clips of a textured box over noise and its
    mask: on a one-colour box the patches of a random-init ViT differ only by
    a faint position signal, which bf16 erases, so bf16 and f32 would then
    propagate otherwise with no kernel involved."""
    f, a = generate.clips(11, n, frames, 480, 854, (1, 1), True, "noise", dev)
    return list(zip(f, a))


def _switch_kept(expert, n_experts: int, capacity: int):
    """The tokens a Switch layer keeps ([G, S] top-1 experts, a routing
    group a row): a token's slot in its expert's queue under the capacity."""
    onehot = torch.nn.functional.one_hot(expert, n_experts).float()
    return (torch.cumsum(onehot, dim=1) * onehot).sum(-1) - 1 < capacity


def _pascal_tree(root: str, dev, n_train: int, n_val: int) -> None:
    """A Pascal VOC tree in the loader's layout (``images/``,
    ``SegmentationClass[Aug]/``, ``sets/{trainaug,val}.txt``): 500 x 375
    images of one or two boxes over a gradient, the boxes' ids as classes."""
    import cv2

    for sub in ("images", "SegmentationClass", "SegmentationClassAug", "sets"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    imgs, masks = generate.clips(13, n_train + n_val, 1, 375, 500, (1, 2), False,
                                 "gradient", dev)
    names = [f"{i:06d}" for i in range(n_train + n_val)]
    for n, img, mask in zip(names, imgs[:, 0], masks[:, 0]):
        cv2.imwrite(os.path.join(root, "images", f"{n}.jpg"), img[..., ::-1])
        for sub in ("SegmentationClass", "SegmentationClassAug"):
            cv2.imwrite(os.path.join(root, sub, f"{n}.png"), mask)
    for split, part in (("trainaug", names[:n_train]), ("val", names[n_train:])):
        with open(os.path.join(root, "sets", f"{split}.txt"), "w") as f:
            f.write("\n".join(part))


# -------------------------------------------------------------- evaluations


@pytest.mark.parametrize("arch,size,kernels", [
    ("dino-s16", 224, {"bfloat16": ("attention_block", "mlp_block", "propagation",
                                    "preprocess"), "float32": ("propagation",)}),
    ("dino-s8", 448, {"bfloat16": ("flash_attention", "ln_dense", "dense_residual",
                                   "mlp_rows", "propagation", "preprocess"),
                      "float32": ("flash_attention", "propagation")}),
])
def test_propagation_eval_in_bf16_against_f32(dev, arch, size, kernels):
    """``cli/propagate``'s per-group compute and scoring on two clips, in bf16
    through the kernels and in f32: |J&F(bf16) - J&F(f32)| <= 0.05."""
    from timetuning_tpu_torch.cli import propagate as prop
    from timetuning_tpu_torch.models.registry import get_backbone

    clips = _davis_clips(dev)
    scores = {}
    for dtype in ("bfloat16", "float32"):
        args = prop.build_parser().parse_args([
            "--architecture", arch, "--compute_dtype", dtype, "--input_resolution",
            str(size), "--n_last_frames", "4", "--size_mask_neighborhood", "12",
            "--topk", "5", "--clip_batch", "2"])
        bb = get_backbone(arch, dtype=prop.compute_dtype(args), device=dev)
        res, counts = _launched(lambda: prop.evaluate_clips(
            args, bb, clips, dev, program=prop.group_program(args, bb)))
        assert all(counts[k] > 0 for k in kernels[dtype]), (dtype, counts)
        scores[dtype] = res["jf"]
    assert all(np.isfinite(v) for s in scores.values() for v in s.values()), scores
    assert abs(scores["bfloat16"]["J&F"] - scores["float32"]["J&F"]) <= 0.05, scores


def test_linear_probe_at_s8_in_f32(dev):
    """``cli/linear_probe``'s train and validate at dino-s8 448 in f32 (its
    attention the flash kernel): two epochs of two SGD steps on in-memory
    batches, validation on a third; the loss and the mIoU finite, the mIoU
    in [0, 1]."""
    from timetuning_tpu_torch.cli import linear_probe as lp
    from timetuning_tpu_torch.models.registry import get_backbone

    args = lp.build_parser().parse_args([
        "--pascal_root", "(in-memory batches)", "--architecture", "dino-s8",
        "--input_resolution", "448", "--batch_size", "2", "--num_epochs", "2"])
    imgs, ids = generate.clips(2, 6, 1, 448, 448, (1, 1), False, "noise", dev)
    masks = 7 * torch.nn.functional.interpolate(torch.from_numpy(ids).float(), size=(100, 100)
                                                ).to(torch.uint8).numpy()[:, 0]
    batches = [(imgs[i:i + 2, 0], masks[i:i + 2]) for i in (0, 2, 4)]
    lines = []
    out, counts = _launched(lambda: lp.train_and_validate(
        args, get_backbone("dino-s8", dtype=torch.float32, device=dev), batches[:2],
        batches[2:], dev, lines.append))
    loss = float(lines[-1].split("loss=")[1].split()[0])
    assert np.isfinite(loss) and all(np.isfinite(v) for v in out.values()), lines
    assert 0.0 <= out["best_miou"] <= 1.0 and counts["flash_attention"] > 0, (out, counts)


def test_eval_feature_function_against_the_plain_blocks(dev):
    """The in-training eval's feature function (``make_eval_feature_fn``: K4
    224 -> 224, K1 and K2 in each of the 12 blocks) at dino-s16 on 6 Pascal
    images against the plain preprocess and the plain blocks on the same
    model, both on the card; the plain forward launches no kernel. Bound:
    per-token cosine >= 0.999 (bf16 rounding over 12 blocks)."""
    from timetuning_tpu_torch.core.train import make_eval_feature_fn
    from timetuning_tpu_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD
    from timetuning_tpu_torch.ops import preprocess_cuda as pc
    from torch_dp_worker import flagship

    model = flagship(dev, torch.bfloat16)[0]
    x = torch.from_numpy(generate.clips(3, 6, 1, 224, 224, (1, 2), False, "gradient",
                                        dev)[0][:, 0]).to(dev)
    got, counts = _launched(lambda: make_eval_feature_fn(model, 224)(x)[0].float())
    with torch.no_grad():
        want, plain = _launched(lambda: model(
            pc.eval_preprocess_plain(x, 224, IMAGENET_MEAN, IMAGENET_STD), use_head=False,
            attn_impl="xla")[0].float())
    assert {k: counts[k] for k in ("preprocess", "attention_block", "mlp_block")} == {
        "preprocess": 1, "attention_block": 12, "mlp_block": 12}, counts
    assert not any(plain.values()), plain
    assert torch.isfinite(got).all() and _cosine(got, want) >= 0.999


# --------------------------------------------------------------- train step


def test_train_step_routes_agree_with_the_default(dev):
    """The flagship's first step at 32 clips, bf16, from the same weights on
    the same batch: the default (K1 and K2 in the 14 no-grad blocks, plain
    attention on the grad path, K3 and K11 once); ``attn_impl="pallas"`` (K10
    in all 16 blocks, its backward through the autograd Function);
    ``grad_attn_impl=None`` (the block kernels and their backward on the grad
    path: 16 launches of K1 and K2); the same with ``ViTConfig.remat`` (18:
    the grad path's blocks again in the backward). The forced and the grad
    path's first loss within 2e-3 of the default's (relative); the forced
    first update's signs agree with the default's on >= 0.95 of a head leaf
    and of block 10's qkv (Adam's first update is -lr * sign(g)), the latter
    moved; remat's loss equal to the grad path's and its update's signs on
    >= 0.99."""
    from torch_dp_worker import flagship, train_clips

    clip = train_clips(32, dev)
    probe = "feature_extractor.backbone.blocks.10.attn.qkv.weight"
    head = "feature_extractor.head.lin3.weight"
    configs = {"default": ({}, {"attention_block": 14, "mlp_block": 14, "mha": 0}),
               "pallas": (dict(attn_impl="pallas"),
                          {"attention_block": 0, "mlp_block": 0, "mha": 16}),
               "grad": (dict(grad_attn_impl=None), {"attention_block": 16, "mlp_block": 16}),
               "remat": (dict(grad_attn_impl=None, remat=True),
                         {"attention_block": 18, "mlp_block": 18})}
    runs = {}
    for name, (kw, want) in configs.items():
        model, _, _, state, step = flagship(dev, torch.bfloat16, **kw)
        before = {n: dict(model.named_parameters())[n].detach().clone() for n in (probe, head)}
        (_, metrics), counts = _launched(lambda: step(state, clip))
        assert {k: counts[k] for k in want} == want, (name, counts)
        assert counts["propagation"] == 1 and counts["sinkhorn"] == 1, (name, counts)
        runs[name] = (float(metrics["loss"]), {
            n: dict(model.named_parameters())[n].detach() - before[n] for n in before})
        del model, state, step

    def agree(a, b, leaf):
        return float((torch.sign(runs[a][1][leaf]) == torch.sign(runs[b][1][leaf]))
                     .float().mean())

    loss = runs["default"][0]
    assert np.isfinite(loss)
    for name in ("pallas", "grad"):
        assert abs(runs[name][0] - loss) / loss <= 2e-3, (name, runs[name][0], loss)
    assert min(agree("pallas", "default", n) for n in (probe, head)) >= 0.95
    assert float(runs["pallas"][1][probe].abs().max()) > 0
    assert runs["remat"][0] == runs["grad"][0] and agree("remat", "grad", probe) >= 0.99


def test_augmentation_on_the_card_equals_the_host(dev):
    """``apply_augment`` on the card against the host on the same drawn
    values: 8 clips of 4 frames of boxes over a colour gradient (smooth:
    a crop box an ulp apart moves a value by little), a 256 buffer to 224,
    native 480 x 854, TF32 off; bound 1e-4 on the normalised output (the
    products sum in another order)."""
    from timetuning_tpu_torch.data import transforms as tf

    cfg = tf.AugmentConfig()
    bank, _ = generate.clips(6, 8, 4, 256, 256, (3, 3), False, "gradient", dev)
    frames, gmeans = torch.from_numpy(bank), torch.from_numpy(generate.pil_gray_means(bank))
    sizes = torch.tensor([[480, 854]] * 8)
    params = tf.draw_augment_params(torch.Generator().manual_seed(3), 8, 4, cfg)
    want, _ = tf.apply_augment(frames, params, cfg, sizes, gmeans)
    got, _ = tf.apply_augment(frames.to(dev), params, cfg, sizes.to(dev), gmeans.to(dev))
    assert got.is_cuda and float((got.cpu() - want).abs().max()) <= 1e-4


def test_propagation_kernel_at_the_train_step_shape(dev):
    """K3 at the step's shape: 32 clips of 4 frames of 196 patches, D 384,
    200 label channels, n_last 7, radius 6, top-k 5, bf16, on lattice
    features (``torch_dp_worker.lattice_features``: every dot product exact, so
    no top-k near-tie), against its plain version: every value within rtol
    1e-4, atol 1e-5 (f32 sums in another order) and the argmax channel
    equal on >= 99.9 % of the rows."""
    from timetuning_tpu_torch.ops import propagation_cuda as prc
    from torch_dp_worker import lattice_features

    rng = np.random.default_rng(200)
    feats = torch.from_numpy(lattice_features(rng, (32, 4, 196))).to(dev, torch.bfloat16)
    seg0 = torch.softmax(torch.from_numpy(rng.standard_normal((32, 200, 196)).astype(
        np.float32)).to(dev) * 3, dim=1)
    kw = dict(n_last=7, radius=6, topk=5)
    got = prc.propagate_labels_batch_cuda(feats, seg0, **kw)
    want = prc.propagate_labels_batch_plain(feats, seg0, **kw)
    assert bool(torch.isclose(got, want, rtol=1e-4, atol=1e-5).all())
    assert float((got.argmax(2) == want.argmax(2)).float().mean()) >= 0.999


def test_f32_train_step_on_the_card_equals_the_host(dev):
    """One f32 step of the flagship at 2 clips on the card (plain attention,
    K3, K11) against the same step on the host (the matvec form): the loss
    within 1e-3 (relative); the update of a leaf of block 11 of equal sign
    on >= 0.98 of its entries and equal to rtol 1e-3 on >= 0.98 (a gradient
    entry at rounding level may flip Adam's first update)."""
    from torch_dp_worker import flagship, train_clips

    clip = train_clips(2, dev, seed=2)
    leaf = "feature_extractor.backbone.blocks.11.mlp.fc2.weight"
    out = {}
    for device in (dev, torch.device("cpu")):
        model, _, _, state, step = flagship(device, torch.float32)
        before = dict(model.named_parameters())[leaf].detach().clone()
        (_, metrics), counts = _launched(lambda: step(state, clip.to(device)))
        out[device.type] = (float(metrics["loss"]),
                            (dict(model.named_parameters())[leaf].detach() - before).cpu())
        if device.type == "cuda":
            assert counts["propagation"] == 1 and counts["sinkhorn"] == 1, counts
    (l_card, u_card), (l_host, u_host) = out["cuda"], out["cpu"]
    assert np.isfinite(l_card) and abs(l_card - l_host) / abs(l_host) <= 1e-3
    assert float((torch.sign(u_card) == torch.sign(u_host)).float().mean()) >= 0.98
    assert float(torch.isclose(u_card, u_host, rtol=1e-3, atol=1e-7).float().mean()) >= 0.98


# ---------------------------------------------------------------------- zoo

_CNNS = ("resnet18", "resnet50", "swav", "dul", "motion_grouping")


@pytest.mark.parametrize("name", ARCHITECTURES)
def test_zoo_feature_path_in_bf16_against_f32(dev, name):
    """A registry name at full width, seeded, on the eval feature path (2
    uint8 480 x 854 frames -> ``eval_preprocess_batch`` -> the backbone at
    224), in bf16 and f32. ViTs, STEGO and MAE: the bf16 tokens against the
    f32 plain forward, per-token cosine >= 0.999; CNNs: the f32 tokens on
    the card against the host's within 1e-4 of their scale (TF32 off). In
    bf16 the preprocess, and the block kernels for the ViTs that take them
    (the test ViTs, MAE and the CNNs launch none)."""
    from timetuning_tpu_torch.data.transforms import eval_preprocess_batch
    from timetuning_tpu_torch.models.registry import VIT_NAMES, get_backbone

    frames = torch.from_numpy(generate.clips(11, 1, 2, 480, 854, (1, 1), True, "noise",
                                             dev)[0][0]).to(dev)
    blocks = name in VIT_NAMES[2:] or name == "stego"
    feats = {}
    for dtype in (torch.bfloat16, torch.float32):
        bb = get_backbone(name, dtype=dtype, device=dev)

        def fwd(bb=bb, x=frames, dtype=dtype):
            with torch.inference_mode():
                return bb.apply(eval_preprocess_batch(x, out_size=224, compute_dtype=dtype))[0]

        feats[dtype], counts = _launched(fwd)
        assert torch.isfinite(feats[dtype].float()).all(), dtype
        launched = {k for k, v in counts.items() if v}
        if dtype == torch.bfloat16 and blocks:
            assert {"preprocess", "attention_block", "mlp_block"} <= launched, counts
        elif dtype == torch.bfloat16:
            assert "preprocess" in launched, counts
            assert not launched & {"attention_block", "mlp_block", "mha"}, counts
        if name in _CNNS and dtype == torch.float32:
            with torch.inference_mode():
                host = get_backbone(name, dtype=dtype, device="cpu").apply(
                    eval_preprocess_batch(frames.cpu(), out_size=224))[0]
            err = float((feats[dtype].cpu() - host).abs().max())
            assert err <= 1e-4 * float(host.abs().max()), err
    if name not in _CNNS:
        assert _cosine(feats[torch.bfloat16], feats[torch.float32]) >= 0.999


def test_mocov3_s16_above_512_px(dev):
    """``mocov3-s16`` (12 heads of 32) at 576 px, 1,297 tokens (the row
    kernels and the flash core): bf16 against f32, per-token cosine >=
    0.999."""
    from timetuning_tpu_torch.models.registry import get_backbone

    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 576, 576, 3)).astype(np.float32)).to(dev)
    with torch.inference_mode():
        want = get_backbone("mocov3-s16", dtype=torch.float32, device=dev).module(x)["tokens"]
        bb = get_backbone("mocov3-s16", dtype=torch.bfloat16, device=dev)
        got, counts = _launched(lambda: bb.module(x)["tokens"])
    assert all(counts[k] > 0 for k in ("flash_attention", "ln_dense", "dense_residual",
                                       "mlp_rows")), counts
    assert torch.isfinite(got.float()).all() and _cosine(got, want) >= 0.999


# ------------------------------------------------------------- CBFE, parity


def test_cbfe_on_the_card(dev, tmp_path):
    """``cli/cbfe.run_cbfe`` at its defaults (dino-s16 at 448, k = 300 at
    resolution 100, 21 eval clusters, f32: no kernel) on a synthetic Pascal
    tree of 32 trainaug and 16 val images through the real loader: the five
    numbers in [0, 1], the threshold on the 0.05 grid. Before it, the
    feature function on the card against the host's (per-token cosine >=
    0.9999) and ``evaluate_bf_score`` on the card against the host's on the
    same masks (within 1e-6)."""
    from timetuning_tpu_torch.cli import cbfe
    from timetuning_tpu_torch.data.pascal import pascal_loader
    from timetuning_tpu_torch.eval.bfscore import evaluate_bf_score
    from timetuning_tpu_torch.models.registry import get_backbone

    root = str(tmp_path)
    _pascal_tree(root, dev, 32, 16)
    args = cbfe.build_parser().parse_args(["--pascal_root", root, "--device", "cuda"])
    imgs, masks = next(iter(pascal_loader(4, root, "val", args.resolution,
                                          args.input_resolution)))
    got, want = (cbfe.make_feature_fn(get_backbone(args.architecture, device=d),
                                      args.input_resolution, d)(imgs)
                 for d in (dev, "cpu"))
    assert _cosine(got[0].cpu(), want[0]) >= 0.9999
    gt = torch.from_numpy(np.stack([m > 0 for m in masks]))
    fg = torch.nn.functional.interpolate(got[1][:, None].float(),
                                         size=gt.shape[-2:])[:, 0].cpu() > 0.5
    assert abs(evaluate_bf_score(gt.to(dev), fg.to(dev))
               - evaluate_bf_score(gt.numpy(), fg.numpy())) <= 1e-6
    res, counts = _launched(lambda: cbfe.run_cbfe(args, log=lambda m: None))
    assert not any(counts.values()), counts
    vals = [res[k] for k in ("threshold", "train_jaccard", "val_jaccard", "val_bf",
                             "masked_miou")]
    assert all(np.isfinite(v) and 0.0 <= v <= 1.0 for v in vals), res
    assert abs(res["threshold"] * 20 - round(res["threshold"] * 20)) <= 1e-9, res


def test_parity_stages_one_to_four_on_the_card(dev, tmp_path):
    """``cli/parity`` stages 1-4 on a made-up full-size dino-s16 TimeT.pth in
    the reference's layout (the oracle's seeded weights, a head [1024, 1024,
    512, 256] as ``nn.Sequential`` indices, 200 unit prototypes), a DAVIS
    tree of two 8-frame clips and a Pascal tree of 16 val images: exit code
    0, stage 1's three rows within the CLI's atols, the five metrics finite
    in [0, 1]; the propagation kernel launched."""
    import json

    import cv2

    from timetuning_tpu_torch.cli import parity as cli_parity
    from timetuning_tpu_torch.eval.parity_oracle import build_oracle, build_oracle_head

    torch.manual_seed(0)
    sd = {f"feature_extractor.backbone.{k}": v for k, v in
          build_oracle(224, 16, 384, 12, 6).state_dict().items()}
    sd.update({f"feature_extractor.head.{k}": v for k, v in
               build_oracle_head((1024, 1024, 512, 256), 384).state_dict().items()})
    sd["prototypes"] = torch.nn.functional.normalize(torch.randn(200, 256), dim=-1)
    pth = str(tmp_path / "TimeT.pth")
    torch.save(sd, pth)
    for v, (frames, annots) in enumerate(_davis_clips(dev, frames=8)):
        fdir, adir = (tmp_path / "davis" / sub / "480p" / f"video{v}"
                      for sub in ("JPEGImages", "Annotations"))
        fdir.mkdir(parents=True)
        adir.mkdir(parents=True)
        for i, (img, ann) in enumerate(zip(frames, annots)):
            cv2.imwrite(str(fdir / f"{i:05d}.jpg"), img[..., ::-1])
            cv2.imwrite(str(adir / f"{i:05d}.png"), ann)
    _pascal_tree(str(tmp_path / "voc"), dev, 0, 16)
    report = str(tmp_path / "report.json")
    rc, counts = _launched(lambda: cli_parity.main([
        "--timet_pth", pth, "--architecture", "dino-s16", "--davis_root",
        str(tmp_path / "davis"), "--num_frames", "8", "--pascal_root", str(tmp_path / "voc"),
        "--proto_clustering", "true", "--num_workers", "2", "--report_json", report,
        "--device", "cuda"]))
    with open(report) as f:
        rows = json.load(f)["rows"]
    gated = [r for r in rows if r["expected"] is not None]
    metrics = [r for r in rows if r["expected"] is None]
    assert rc == 0 and len(gated) == 3 and all(r["pass"] for r in gated), rows
    assert len(metrics) == 5 and all(np.isfinite(r["value"]) and 0 <= r["value"] <= 1
                                     for r in metrics), rows
    assert counts["propagation"] > 0, counts


# ---------------------------------------------------------------------- MoE


def test_moe_vit_on_the_card(dev, tmp_path):
    """The MoE ViT-S/16 (every 2nd block a Switch MoE of 8 experts, capacity
    1.25) sparse-upcycled from the seeded dense weights, in one process:

    * f32, block 1, 8 x 197 tokens: the MoE branch equals its top-1 gate
      times the dense MLP on the tokens its expert keeps (within 1e-4), and
      is exactly 0 on the tokens past the capacity;
    * 8 frames in bf16 (K1 in all 12 blocks, K2 in the 6 dense ones)
      against f32 on the tokens routed alike in all 6 MoE blocks (top-1
      routing is discrete: a near-tie routes a token otherwise): per-token
      cosine >= 0.999, and >= 0.999 on average over all tokens;
    * 3 flagship steps at 8 clips with ``moe_aux_weight`` 0.01 (block 11, on
      the grad path, is MoE): the loss falls, ``moe_aux`` in [1, 8], K1 14,
      K2 7, K3 1 and K11 1 a step;
    * the ``--moe_every_k 2 --moe_experts 8`` export: its round trip within
      1e-3 of the live forward, one call launching the preprocess once, K1
      12 and K2 6 times."""
    import dataclasses

    from timetuning_tpu_torch.cli import export as texport
    from timetuning_tpu_torch.models.vit import VisionTransformer
    from timetuning_tpu_torch.ops.fused_block import _ln
    from timetuning_tpu_torch.parallel.ep import MoEMlp, switch_capacity
    from torch_dp_worker import MOE, card_steps, flagship, moe_vit, train_clips

    dense, moe = (m.to(dev).eval() for m in moe_vit(torch.bfloat16))
    bm, bd = moe.blocks[1], dense.blocks[1]
    x = torch.randn(8, 197, 384, generator=torch.Generator().manual_seed(11)).to(dev)
    with torch.no_grad():
        y = _ln(x, bm.norm2.weight, bm.norm2.bias)
        got, dense_out = bm.moe(y), bd.mlp(y)
        gate, expert = torch.softmax(y @ bm.moe.router.weight.t(), dim=-1).max(dim=-1)
    kept = _switch_kept(expert, MOE["n_experts"], switch_capacity(
        197, MOE["moe_capacity_factor"], MOE["n_experts"]))
    want = torch.where(kept[..., None], gate[..., None] * dense_out, 0.0)
    assert float((got - want).abs().max()) <= 1e-4 and bool((got[~kept] == 0).all())

    routes = {}

    def hook(mod, args, _out):
        y = args[0]
        B, Sq = y.shape[:2]
        G, Sg = mod.groups(B, Sq)
        e = torch.softmax(torch.nn.functional.linear(
            y.reshape(G, Sg, -1), mod.router.weight.to(y.dtype)).float(), dim=-1).argmax(-1)
        keep = _switch_kept(e, mod.n_experts, switch_capacity(Sg, mod.capacity_factor,
                                                               mod.n_experts))
        routes.setdefault(y.dtype, []).append(torch.where(keep, e, -1).reshape(B, Sq))

    moe32 = VisionTransformer(dataclasses.replace(moe.config, dtype=torch.float32)
                              ).to(dev).eval()
    moe32.load_state_dict(moe.state_dict())
    frames = train_clips(2, dev, seed=7).flatten(0, 1)
    handles = [m.register_forward_hook(hook) for net in (moe, moe32) for m in net.modules()
               if isinstance(m, MoEMlp)]
    with torch.no_grad():
        got, counts = _launched(lambda: moe(frames)["tokens"])
        want = moe32(frames)["tokens"]
    for h in handles:
        h.remove()
    same = torch.stack([a == b for a, b in zip(routes[torch.bfloat16],
                                                routes[torch.float32])]).all(dim=0)
    cos = torch.nn.functional.cosine_similarity(got.float(), want.float(), dim=-1)
    assert float(cos[same].min()) >= 0.999 and float(cos.mean()) >= 0.999
    assert counts["attention_block"] == 12 and counts["mlp_block"] == 6, counts
    del moe32, dense, moe

    model, _, _, state, step = flagship(dev, torch.bfloat16, moe=True, moe_aux_weight=0.01)
    run = card_steps(state, step, train_clips(8, dev), 3)
    losses, aux = run["losses"], run["aux"]
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
    assert all(1.0 <= a <= MOE["n_experts"] for a in aux), aux
    assert {k: run["counts"][k] for k in ("attention_block", "mlp_block", "propagation",
                                          "sinkhorn")} == {
        "attention_block": 42, "mlp_block": 21, "propagation": 3, "sinkhorn": 3}, run
    del model, state, step

    blob, live, shape, _ = texport.export_features(
        "dino-s16", None, 2, 224, "bfloat16", moe_every_k=2, moe_experts=8, device="cuda")
    (tmp_path / "moe.pt2").write_bytes(blob)
    fn = texport.load_exported(str(tmp_path / "moe.pt2"))
    x = torch.from_numpy(np.random.default_rng(0).integers(0, 256, shape, np.uint8)).to(dev)
    with torch.no_grad():
        got, counts = _launched(lambda: fn(x).clone())
        want = live(x)
    assert float((got.float() - want.float()).abs().max()) <= 1e-3
    assert {k: counts[k] for k in ("preprocess", "attention_block", "mlp_block")} == {
        "preprocess": 1, "attention_block": 12, "mlp_block": 6}, counts


# ---------------------------------------------- two gloo ranks on the card


def _spawn(job, workdir, timeout=600):
    """``job`` on 2 gloo ranks sharing the card, the kernels built before."""
    from torch_dp_worker import spawn

    kernel_lib.library()
    ranks = spawn(job, str(workdir), 2, timeout=timeout, device="cuda:0")
    assert not any(r["foreign_modules"] for r in ranks)
    return ranks


def test_dp_steps_on_the_card(dev, tmp_path):
    """Data parallelism, 2 ranks of 8 clips: 3 flagship bf16 steps, default
    and ZeRO-1: both ranks' losses equal and falling on their repeated
    batches, the replicated state bit-identical, kernel 11's cross-rank form
    ``dp_launches(10)`` times a step and neither the one-process kernel 11 nor
    the matvec form at all; the cross-rank form on the step's own scores
    against the plain group form and, gathered, against the one-launch
    kernel 11 on the concatenated scores (each within 1e-6); 2 f32 steps at
    2 x 4 clips against one process on the 8: the first loss within 1e-4
    (relative), the trainable parameters within 4e-4 (two Adam steps of lr
    1e-4) and equal to rtol 1e-3 on >= 0.99 of the entries."""
    from timetuning_tpu_torch.ops import sinkhorn_cuda as sk
    from torch_dp_worker import flagship, train_clips

    ranks = _spawn([dict(kind="card_dp", name="dp", clips=8, device="cuda:0")], tmp_path)
    runs = [r["dp"] for r in ranks]
    for name in ("default", "zero1"):
        for run in runs:
            c = run[name]["counts"]
            assert all(c[k] > 0 for k in ("attention_block", "mlp_block", "propagation")), c
            assert c["sinkhorn_dp"] == 3 * sk.dp_launches(10) and c["sinkhorn"] == 0, c
            assert run[name]["plain_calls"] == 0 and run[name]["mismatches"] == 0, run[name]
        losses = runs[0][name]["losses"]
        assert losses == runs[1][name]["losses"] and losses[-1] < losses[0], losses
    assert max(run["sinkhorn"]["err"] for run in runs) <= 1e-6, runs[0]["sinkhorn"]
    assert runs[0]["sinkhorn"]["err_global"] <= 1e-6, runs[0]["sinkhorn"]

    model, _, mask, state, step = flagship(dev, torch.float32)
    clip = torch.cat([train_clips(4, dev, seed=200 + r) for r in range(2)])
    losses = [float(step(state, clip)[1]["loss"]) for _ in range(2)]
    got = runs[0]["f32"]
    assert abs(got["losses"][0] - losses[0]) / abs(losses[0]) <= 1e-4, (got["losses"], losses)
    pairs = [(got["params"][n], p.detach().cpu()) for n, p in model.named_parameters()
             if mask[n]]
    assert max(float((a - b).abs().max()) for a, b in pairs) <= 4e-4
    close = torch.cat([torch.isclose(a, b, rtol=1e-3, atol=1e-6).reshape(-1) for a, b in pairs])
    assert float(close.float().mean()) >= 0.99


def test_training_driver_over_two_ranks_then_resume_on_the_card(dev, tmp_path):
    """``run_training`` of the flagship on 2 ranks of 8 clips, through the
    loader, the graphed step and the epoch-top saves (a writer a rank, joined
    over gloo): 2 epochs of 4 steps, then a resume for a third in the same
    run dir: steps 8 then 12 on both ranks, one run dir, 12 finite losses,
    the replicated state bit-identical; kernel 11's cross-rank form and never
    the one-process one. Then ``cli/train --multihost true
    --tensor_parallel 2``, an epoch of 2 steps and a resumed second in one
    run dir (meta: tensor_parallel 2), and one process resuming that
    checkpoint for a third epoch (step 6)."""
    import json

    from timetuning_tpu_torch.core.train import run_training
    from torch_dp_worker import driver_config, free_port

    logs = tmp_path / "logs"
    ranks = _spawn([dict(kind="card_driver", name="drv", clips=8, device="cuda:0",
                         log_dir=str(logs), ports=[free_port(), free_port()])],
                   tmp_path / "ranks", timeout=900)
    d0, d1 = (r["drv"] for r in ranks)
    assert (d0["first"]["step"], d0["resumed"]["step"], d1["resumed"]["step"]) == (8, 12, 12)
    run_dir = d0["first"]["run_dir"]
    assert run_dir == d0["resumed"]["run_dir"] == d1["first"]["run_dir"]
    assert d0["mismatches"] == d1["mismatches"] == 0
    for run in (d0["first"], d0["resumed"], d1["first"], d1["resumed"]):
        c = run["counts"]
        assert all(c[k] > 0 for k in ("attention_block", "mlp_block", "propagation",
                                      "sinkhorn_dp")) and c["sinkhorn"] == 0, c
    rows = [json.loads(x) for x in open(os.path.join(run_dir, "metrics.jsonl"))]
    losses = [x["value"] for x in rows if x["tag"] == "Loss/train"]
    assert len(losses) == 12 and np.isfinite(losses).all(), losses

    dirs = [[x.split("run_dir=")[1].split()[0] for x in out.splitlines()
             if x.startswith("done: run_dir=")][0] for out in d0["cli"]]
    assert dirs[0] == dirs[1]
    assert json.load(open(os.path.join(dirs[0], "checkpoint_meta.json")))[
        "tensor_parallel"] == 2
    one = run_training(driver_config(dev, str(logs / "cli"), 8, data_root="16", num_epochs=3,
                                     max_steps_per_epoch=2, load_checkpoint=True,
                                     use_queue=True, queue_size=4096))
    assert one["run_dir"] == dirs[0] and one["global_step"] == 6
    assert np.isfinite(one["final_loss"])


@pytest.mark.parametrize("kind", ["ep", "tp"])
def test_ep_and_tp_meshes_on_the_card(dev, tmp_path, kind):
    """The flagship on a dp 1 x 2 mesh of 2 ranks: ``ep`` the MoE ViT of
    ``test_moe_vit_on_the_card`` (4 of the 8 experts a rank), ``tp`` the
    dense one (half of qkv, fc1, proj and fc2 a rank, plain attention),
    against one process: the bare ViT's tokens on 4 frames (per-token
    cosine >= 0.999), 3 bf16 steps at 8 clips (losses within 1e-2,
    relative; both ranks' equal), 2 f32 steps at 4 clips (within 1e-5); the
    replicated state bit-identical; the launches of the steps (ep: K1 14, K2
    7, K11 1 a step; tp: no K1 or K2, K3 and K11 once a step). tp: the f32
    state's checkpoint (``save_checkpoint`` over the data group, no writer)
    loaded into one process equals the ranks' gathered parameters."""
    from timetuning_tpu_torch.models.vit import VisionTransformer, vit_small
    from timetuning_tpu_torch.parallel import tp
    from torch_dp_worker import flagship, moe_vit, train_clips

    ranks = _spawn([dict(kind="card_mesh", name="mesh", mesh=kind, clips=8,
                         device="cuda:0", ckpt=str(tmp_path / "tp_state"))], tmp_path)
    runs = [r["mesh"] for r in ranks]
    if kind == "ep":
        vit = moe_vit(torch.bfloat16)[1]
        kw = dict(moe=True, moe_aux_weight=0.01)
    else:
        vit = VisionTransformer(vit_small(16, img_size=224, dtype=torch.bfloat16,
                                          attn_impl="xla")).init_weights(
            torch.Generator().manual_seed(0))
        kw = dict(shard=tp.force_xla_attention)
    with torch.no_grad():
        tokens = vit.to(dev).eval()(train_clips(1, dev, seed=7)[0])["tokens"].float().cpu()
    want = {}
    for dtype, n, clips, seed in ((torch.bfloat16, 3, 8, 300), (torch.float32, 2, 4, 301)):
        _, _, _, state, step = flagship(dev, dtype, **kw)
        clip = train_clips(clips, dev, seed=seed)
        want[dtype] = [float(step(state, clip)[1]["loss"]) for _ in range(n)]
        del state, step
    for run in runs:
        assert _cosine(run["tokens"], tokens) >= 0.999
        assert run["mismatches"] == 0
    r0 = runs[0]
    assert r0["losses"] == runs[1]["losses"]
    assert max(abs(a - b) / abs(b) for a, b in zip(r0["losses"], want[torch.bfloat16])) <= 1e-2
    assert max(abs(a - b) / abs(b) for a, b in zip(r0["f32"], want[torch.float32])) <= 1e-5
    c = r0["counts"]
    if kind == "ep":
        w1 = "params.feature_extractor.backbone.blocks.11.moe.w1"
        assert all(run["shapes"][w1][0] == 4 for run in runs)
        assert (c["attention_block"], c["mlp_block"], c["sinkhorn"]) == (42, 21, 3), c
        assert all(1.0 <= a <= 8 for a in r0["aux"]), r0["aux"]
    else:
        b0 = "params.feature_extractor.backbone.blocks.0."
        assert {k[len(b0):]: v for k, v in r0["shapes"].items() if k.startswith(b0)} == {
            "attn.qkv.weight": (576, 384), "attn.qkv.bias": (576,),
            "attn.proj.weight": (384, 192), "mlp.fc1.weight": (768, 384),
            "mlp.fc1.bias": (768,), "mlp.fc2.weight": (384, 768)}
        assert (c["attention_block"], c["mlp_block"], c["propagation"], c["sinkhorn"]) == (
            0, 0, 3, 3), c
        from timetuning_tpu_torch.core.checkpoint import load_checkpoint

        model, _, _, state, _ = flagship(dev, torch.float32)
        load_checkpoint(str(tmp_path / "tp_state"), state)
        assert [k for k, v in model.state_dict().items()
                if not torch.equal(v.cpu(), r0["gathered"][k])] == []


def test_sp_and_pp_forwards_on_the_card(dev, tmp_path):
    """2 ranks: ``dino-s8`` at 448 on one image on a dp 1 x sp 2 mesh (1,569
    rows a slab: K7, K5/6 with the local queries against the gathered keys,
    K8, K9, 12 each a rank in bf16; K5/6 in f32), and ``dino-s16`` at 224 on
    4 images on a dp 1 x pp 2 mesh at n_micro 2 (auto) and 4 (K1 and K2 6 a
    tick a stage in bf16), each against the one-process forward: bf16
    per-token cosine >= 0.999, f32 max |diff| <= 1e-4 (TF32 off); a pipe
    rank holds less than 0.6 of the model's parameter bytes."""
    from timetuning_tpu_torch.models.registry import get_backbone
    from torch_dp_worker import train_clips

    x224 = train_clips(1, dev, seed=7)[0]
    x448 = torch.nn.functional.interpolate(x224[:1].permute(0, 3, 1, 2), size=(448, 448),
                                           mode="bilinear").permute(0, 2, 3, 1).contiguous()
    ranks = _spawn([dict(kind="card_seq_pipe", name="sp_pp", x224=x224.cpu().numpy(),
                         x448=x448.cpu().numpy(), n_micro=(None, 4), device="cuda:0")],
                   tmp_path)
    runs = [r["sp_pp"] for r in ranks]
    for dtype in (torch.bfloat16, torch.float32):
        bf16 = dtype == torch.bfloat16
        for arch, x, keys in (("dino-s8", x448, [("sp", dtype)]),
                              ("dino-s16", x224, [("pp", dtype, nm) for nm in (None, 4)])):
            vit = get_backbone(arch, dtype=dtype, device=dev).module.eval()
            with torch.no_grad():
                want = vit(x)["tokens"].float().cpu()
            for key in keys:
                for run in runs:
                    got = run[key]["tokens"]
                    assert (_cosine(got, want) >= 0.999 if bf16 else
                            float((got - want).abs().max()) <= 1e-4), key
                    c = run[key]["counts"]
                    if key[0] == "sp":
                        kernels = (("ln_dense", "flash_attention", "dense_residual", "mlp_rows")
                                   if bf16 else ("flash_attention",))
                        assert all(c[k] == 12 for k in kernels), (key, c)
                    else:
                        ticks = (key[2] or 2) + 1
                        n = 6 * ticks if bf16 else 0
                        assert (c["attention_block"], c["mlp_block"]) == (n, n), (key, c)
                        assert run[key]["param_bytes"] < 0.6 * run[key]["whole_bytes"]


def test_mesh_serving_programs_on_the_card(dev, tmp_path):
    """The five multi-device ``cli/export`` programs, bf16 (tp 2, ep 2 on the
    upcycled MoE, sp 2 at dino-s8 448 on one image, pp 2 and dp 2 at
    dino-s16 224 on 4), each exported by 2 ranks (a program a rank and a
    manifest) and loaded by 2 fresh ranks: the round trip against the live
    mesh forward within 1e-3, the features against the one-device
    program's (per-token cosine >= 0.999), the tp and pp programs smaller
    than the one-device program, and one call's launches a rank. The
    one-device programs: their round trip against the live forward within
    1e-3, one call launching the preprocess once and its blocks' kernels
    12 times each."""
    import io
    import json

    from timetuning_tpu_torch.cli import export as texport

    base = dict(model_path=None, compute_dtype="bfloat16", device="cuda:0")
    arch = {"s16": dict(architecture="dino-s16", input_resolution=224, batch_size=4),
            "s8": dict(architecture="dino-s8", input_resolution=448, batch_size=1)}
    programs = {"tp": ("s16", dict(tensor_parallel=2)),
                "ep": ("s16", dict(expert_parallel=2, moe_every_k=2, moe_experts=8)),
                "sp": ("s8", dict(sequence_parallel=2)),
                "pp": ("s16", dict(pipeline_parallel=2)),
                "dp": ("s16", dict(data_parallel=2))}
    rng = np.random.default_rng(21)
    frames = {k: rng.integers(0, 256, (a["batch_size"], a["input_resolution"],
                                       a["input_resolution"], 3), np.uint8)
              for k, a in arch.items()}
    out = str(tmp_path / "programs")
    os.makedirs(out)
    job = [dict(kind="export_mesh", name=k, dir=out, frames=frames[k], device="cuda:0",
                programs={n: {**base, **arch[k], **flags}
                          for n, (a, flags) in programs.items() if a == k})
           for k in arch]
    ex = _spawn(job, tmp_path / "export", timeout=900)
    paths = {n: os.path.join(out, f"{n}.json") for n in programs}
    ld = _spawn([dict(kind="load_mesh", name=k, paths={n: paths[n] for n, (a, _) in
                                                       programs.items() if a == k},
                      frames=frames[k], device="cuda:0") for k in arch],
                tmp_path / "load", timeout=900)
    one_counts = {"s16": {"preprocess": 1, "attention_block": 12, "mlp_block": 12},
                  "s8": {"preprocess": 1, "ln_dense": 12, "flash_attention": 12,
                         "dense_residual": 12, "mlp_rows": 12}}
    want_counts = {"tp": {"preprocess": 1},
                   "ep": {"preprocess": 1, "attention_block": 12, "mlp_block": 6},
                   "sp": one_counts["s8"], "pp": {"preprocess": 1, "attention_block": 18,
                                                  "mlp_block": 18},
                   "dp": one_counts["s16"]}
    one = {}
    for name, (k, flags) in programs.items():
        moe = {f: v for f, v in flags.items() if f.startswith("moe_")}
        key = (k, tuple(moe))
        if key not in one:
            blob, live, _, _ = texport.export_features(**base, **arch[k], **moe)
            x = torch.from_numpy(frames[k]).to(dev)
            fn = texport.load_exported(io.BytesIO(blob))
            with torch.no_grad():
                got, counts = _launched(lambda: fn(x).clone())
                assert float((got.float() - live(x).float()).abs().max()) <= 1e-3, key
            if not moe:
                assert {c: counts[c] for c in one_counts[k]} == one_counts[k], (key, counts)
            one[key] = (len(blob), got.float().cpu())
            del blob, live, fn
        size, want = one[key]
        b = arch[k]["batch_size"] // flags.get("data_parallel", 1)
        for e, lo in zip(ex, ld):
            e, lo = e[k][name], lo[k][name]
            d = lo["coords"][0]
            assert float((lo["program"].float() - e["live"].float()).abs().max()) <= 1e-3, name
            assert _cosine(lo["program"], want[d * b:(d + 1) * b]) >= 0.999, name
            assert {c: lo["launches"][c] for c in want_counts[name]} == want_counts[name], (
                name, lo["launches"])
        if name in ("tp", "pp"):
            with open(paths[name]) as f:
                rank_bytes = [r["bytes"] for r in json.load(f)["ranks"]]
            assert max(rank_bytes) < size, (name, rank_bytes, size)
