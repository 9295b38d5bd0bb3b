"""The port's backbone zoo (timetuning_tpu_torch/models/) against the JAX
package's: every registry name's metadata, each family's forward on the same
weights (carried over by models/convert.py) and the same numpy-seeded
inputs, reference-layout checkpoints loaded by both packages, and the DUL,
MAE and MoCo losses on the same (mirrored) random draws."""

import ast

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_kmeans import mirror_keys
from torch_dp_worker import single_rank_group
from timetuning_tpu.models import registry as jreg
from timetuning_tpu_torch.models import convert
from timetuning_tpu_torch.models import registry as treg

torch.set_num_threads(2)


def _perturb(tree, seed, scale=0.05):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + scale * rng.standard_normal(np.shape(a)).astype(np.float32),
        tree)


def _stats(tree, seed):
    """Random running statistics: means ~0.1, variances in [0.5, 2]."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        if path[-1].key == "var":
            return rng.uniform(0.5, 2.0, np.shape(a)).astype(np.float32)
        return (0.1 * rng.standard_normal(np.shape(a))).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, tree)


def _close(got, want, rel=1e-4, atol=1e-5):
    """max |got - want| within ``rel`` of the output's scale plus ``atol``."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max() + atol, (err, np.abs(want).max())


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# ------------------------------------------------------------------ registry

@pytest.mark.parametrize("name", treg.ARCHITECTURES)
def test_registry_metadata_matches_jax(monkeypatch, name):
    """Feature dim, patch size, drop_cls, fixed grid and the token grid at
    224 and 448 of every name the JAX registry dispatches (its weights are
    not built: only the metadata is compared)."""
    monkeypatch.setattr(jreg, "_init_variables", lambda *a, **k: {"params": {}})
    j = jreg.get_backbone(name)
    t = treg.get_backbone(name, device="cpu")
    assert (t.patch_size, t.feature_dim, t.drop_cls, t.fixed_resolution, t.name) == (
        j.patch_size, j.feature_dim, j.drop_cls, j.fixed_resolution, j.name)
    for size in (224, 448):
        assert t.spatial_resolution(size) == j.spatial_resolution(size), size
    assert next(t.module.parameters()).device == torch.device("cpu")


def test_registry_tables_and_weight_urls():
    assert treg.PRETRAINED_URLS == jreg.PRETRAINED_URLS
    assert treg.REFERENCE_SPATIAL_RESOLUTIONS == jreg.REFERENCE_SPATIAL_RESOLUTIONS
    for arch in treg.PRETRAINED_URLS:
        assert treg.get_backbone_weights(arch) == jreg.get_backbone_weights(arch)
    with pytest.raises(KeyError):
        treg.get_backbone_weights("nope")
    with pytest.raises(ValueError, match="unknown backbone"):
        treg.get_backbone("nope", device="cpu")


# ------------------------------------------------------------------ resnets

@pytest.mark.parametrize("depth", [18, 50])
def test_resnet_forward_matches_jax(depth):
    """The pre-BN tap of the last block (f32, BN on random running
    statistics), at 64 x 64 (a 2 x 2 grid); bound 1e-4 of the output's
    scale: f32 sums in another order over 18 / 50 layers."""
    from timetuning_tpu.models import resnet as jres
    from timetuning_tpu_torch.models import resnet as tres

    jm = jres.resnet18() if depth == 18 else jres.resnet50()
    v = jm.init(jax.random.PRNGKey(depth), jnp.zeros((1, 64, 64, 3)))
    v = {"params": _perturb(v["params"], depth), "batch_stats": _stats(v["batch_stats"], depth)}
    tm = tres.resnet18() if depth == 18 else tres.resnet50()
    tm.load_state_dict(convert.resnet_state_dict_from_jax(v), strict=False)
    x = _x((2, 64, 64, 3), depth)
    want = jm.apply(v, jnp.asarray(x))
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x))
    assert got["grid"] == tuple(want["grid"]) == (2, 2) and got["attention"] is None
    _close(got["tokens"], want["tokens"])


def test_dul_forward_matches_jax_up_and_down_to_its_grid():
    """The stride-8 ResNet18 and its fixed 28 x 28 grid: at 64 (8 x 8,
    resized up) and at 240 (30 x 30, antialiased down)."""
    from timetuning_tpu.models import dul as jdul
    from timetuning_tpu_torch.models import dul as tdul

    jm = jdul.DulBackbone()
    v = jm.init(jax.random.PRNGKey(3), jnp.zeros((1, 64, 64, 3)))
    v = {"params": _perturb(v["params"], 3), "batch_stats": _stats(v["batch_stats"], 3)}
    tm = tdul.DulBackbone()
    tm.load_state_dict(convert.dul_state_dict_from_jax(v), strict=False)
    for size in (64, 240):
        x = _x((1, size, size, 3), size)
        want = jm.apply(v, jnp.asarray(x))
        with torch.no_grad():
            got = tm.eval()(torch.from_numpy(x))
        assert got["tokens"].shape == (1, 28 * 28, 512) and got["grid"] == (28, 28)
        _close(got["tokens"], want["tokens"])


def test_motion_grouping_backbone_and_autoencoder_match_jax():
    """The zoo's encoder adapter (64 -> 16 x 16 -> resized to 56) and the
    whole autoencoder at 32 x 32 on the same slot noise (JAX's draw for
    its key); bound 1e-4 of scale (InstanceNorm and the slot iterations in
    another order)."""
    from timetuning_tpu.models import slot_attention as jsa
    from timetuning_tpu_torch.models import slot_attention as tsa

    jb = jsa.MotionGroupingBackbone(autoencoder=jsa.SlotAttentionAutoEncoder())
    v = {"params": _perturb(jb.init(jax.random.PRNGKey(0),
                                    jnp.zeros((1, 64, 64, 3)))["params"], 1)}
    tb = tsa.MotionGroupingBackbone()
    tb.load_state_dict(convert.motion_grouping_state_dict_from_jax(v))
    x = _x((1, 64, 64, 3), 2)
    with torch.no_grad():
        got = tb(torch.from_numpy(x))
    _close(got["tokens"], jb.apply(v, jnp.asarray(x))["tokens"])

    ja = jsa.SlotAttentionAutoEncoder(resolution=(32, 32))
    key = jax.random.PRNGKey(5)
    va = {"params": _perturb(ja.init(jax.random.PRNGKey(1), jnp.zeros((2, 32, 32, 3)),
                                     rng=key)["params"], 4)}
    ta = tsa.SlotAttentionAutoEncoder(resolution=(32, 32))
    ta.load_state_dict(convert.motion_grouping_state_dict_from_jax(va))
    x = _x((2, 32, 32, 3), 6)
    want = ja.apply(va, jnp.asarray(x), rng=key)
    noise = np.array(jax.random.normal(key, (2, 5, 64)))
    with torch.no_grad():
        got = ta(torch.from_numpy(x), noise=torch.from_numpy(noise))
    for g, w in zip(got, want):
        _close(g, w, rel=2e-4)
    np.testing.assert_allclose(got[2].sum(dim=1).numpy(), 1.0, atol=1e-5)


# ------------------------------------------------------------------ MoCo-v3

@pytest.mark.parametrize("train", [False, True])
def test_conv_stem_matches_jax_in_both_bn_modes(train):
    """ConvStem at embed 64 on 32 x 32: eval mode on the running statistics;
    train mode on the batch's, and the running statistics' update
    (momentum 0.9, the biased variance) equal too."""
    from timetuning_tpu.models import moco as jmoco
    from timetuning_tpu_torch.models import moco as tmoco

    jm = jmoco.ConvStem(embed_dim=64)
    v = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    v = {"params": _perturb(v["params"], 7), "batch_stats": _stats(v["batch_stats"], 7)}
    tm = tmoco.ConvStem(embed_dim=64)
    tm.load_state_dict(convert.conv_stem_state_dict_from_jax(v))
    x = _x((4, 32, 32, 3), 8)
    if train:
        want, upd = jm.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])
    else:
        want, upd = jm.apply(v, jnp.asarray(x)), None
    with torch.no_grad():
        got = tm(torch.from_numpy(x), train=train)
    _close(got, want)
    if train:
        after = convert.conv_stem_state_dict_from_jax({"batch_stats": upd["batch_stats"]})
        own = tm.state_dict()
        for k, w in after.items():
            _close(own[k], w, rel=1e-5, atol=1e-6)


def test_moco_predictor_import_and_contrastive_loss_match_jax():
    """The predictor from an official-layout ``nn.Sequential`` state dict, in
    eval and train mode, and the InfoNCE loss on its outputs."""
    from timetuning_tpu.models import moco as jmoco
    from timetuning_tpu_torch.models import moco as tmoco

    rng = np.random.default_rng(9)
    sd = {"predictor.0.weight": rng.standard_normal((48, 16)).astype(np.float32) / 4,
          "predictor.1.weight": rng.uniform(0.5, 1.5, 48).astype(np.float32),
          "predictor.1.bias": (0.1 * rng.standard_normal(48)).astype(np.float32),
          "predictor.1.running_mean": (0.1 * rng.standard_normal(48)).astype(np.float32),
          "predictor.1.running_var": rng.uniform(0.5, 2, 48).astype(np.float32),
          "predictor.3.weight": rng.standard_normal((8, 48)).astype(np.float32) / 7,
          "predictor.4.running_mean": (0.1 * rng.standard_normal(8)).astype(np.float32),
          "predictor.4.running_var": rng.uniform(0.5, 2, 8).astype(np.float32)}
    jm = jmoco.MoCoPredictor(hidden_dim=48, out_dim=8)
    jv = jmoco.import_moco_predictor(sd)
    tm = tmoco.MoCoPredictor(16, 48, 8)
    tm.load_state_dict(tmoco.import_moco_predictor(sd))
    carried = convert.moco_predictor_state_dict_from_jax(jv)
    assert carried.keys() == tm.state_dict().keys()
    assert all(torch.equal(carried[k], v) for k, v in tm.state_dict().items())
    x = _x((6, 16), 10)
    for train in (False, True):
        kw = dict(train=True, mutable=["batch_stats"]) if train else {}
        out = jm.apply(jv, jnp.asarray(x), **kw)
        want = out[0] if train else out
        with torch.no_grad():
            got = tm(torch.from_numpy(x), train=train)
        _close(got, want)
    k = _x((6, 8), 11)
    for q in (np.asarray(want), k):
        lw = float(jmoco.contrastive_loss(jnp.asarray(q), jnp.asarray(k)))
        lt = float(tmoco.contrastive_loss(torch.from_numpy(np.array(q)), torch.from_numpy(k)))
        assert abs(lt - lw) <= 1e-5 * max(1.0, abs(lw)), (lt, lw)
    # over a group: the keys gathered over the ranks (here a group of one,
    # where the gathered keys are the rank's own; 2 ranks: tests/test_torch_dp.py)
    with pytest.raises(RuntimeError, match="initialized torch.distributed"):
        tmoco.contrastive_loss(torch.from_numpy(k), torch.from_numpy(k), axis_name="data")
    with single_rank_group():
        lg = float(tmoco.contrastive_loss(torch.from_numpy(k[::-1].copy()),
                                          torch.from_numpy(k), axis_name="data"))
    lw = float(jmoco.contrastive_loss(jnp.asarray(k[::-1].copy()), jnp.asarray(k)))
    assert abs(lg - lw) <= 1e-5 * max(1.0, abs(lw)), (lg, lw)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moco_vit_with_32_wide_heads_matches_jax(dtype):
    """A two-block ViT with heads of 32 (MoCo-v3 ViT-S/16's width; embed 64,
    two heads): f32 at 1e-4 of scale; bf16 through the block kernels' plain
    versions against the JAX blocks in bf16, per-token cosine >= 0.999."""
    from timetuning_tpu.models.vit import ViTConfig as JCfg
    from timetuning_tpu.models.vit import VisionTransformer as JViT
    from timetuning_tpu_torch.models.vit import ViTConfig, VisionTransformer

    cfg = dict(patch_size=8, embed_dim=64, depth=2, num_heads=2, img_size=32)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (
        jnp.bfloat16, torch.bfloat16)
    jm = JViT(JCfg(**cfg, dtype=jdt, attn_impl="xla"))
    p = _perturb(jm.init(jax.random.PRNGKey(2), jnp.zeros((1, 32, 32, 3)))["params"], 12)
    tm = VisionTransformer(ViTConfig(**cfg, dtype=tdt))
    tm.load_state_dict(convert.vit_state_dict_from_jax(p))
    x = _x((2, 32, 32, 3), 13)
    want = np.asarray(jm.apply({"params": p}, jnp.asarray(x))["tokens"], np.float32)
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x))["tokens"].float()
    if dtype == "float32":
        _close(got, want)
        return
    cos = torch.nn.functional.cosine_similarity(got, torch.from_numpy(want), dim=-1)
    assert cos.min() >= 0.999, cos.min()


# ---------------------------------------------------------------------- MAE

def _mae_pair(seed=0):
    from timetuning_tpu.models import mae as jmae
    from timetuning_tpu_torch.models import mae as tmae

    kw = dict(img_size=32, patch_size=8, embed_dim=64, depth=2, num_heads=2,
              decoder_embed_dim=32, decoder_depth=1, decoder_num_heads=2)
    jm = jmae.MAEViT(**kw)
    v = jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, 32, 32, 3)), mask_ratio=0.75,
                rng=jax.random.PRNGKey(1), method=jmae.MAEViT.pretrain)
    v = {"params": _perturb(v["params"], seed + 20)}
    tm = tmae.MAEViT(**kw)
    tm.load_state_dict(convert.mae_state_dict_from_jax(v))
    return jm, v, tm.eval()


def test_mae_encoder_matches_jax_at_any_grid():
    """The encoder at its own 32 (4 x 4) and at 48 (6 x 6: the sin-cos table
    rebuilt for the runtime grid)."""
    jm, v, tm = _mae_pair()
    for size in (32, 48):
        x = _x((2, size, size, 3), size)
        want = jm.apply(v, jnp.asarray(x))
        with torch.no_grad():
            got = tm(torch.from_numpy(x))
        assert got["grid"] == tuple(want["grid"])
        _close(got["tokens"], want["tokens"])


def test_mae_pretrain_matches_jax_on_mirrored_noise():
    """``pretrain`` (mask 75 %, encode, decode, normalised-pixel loss) on the
    masking noise JAX draws for its key: the mask, the prediction and the
    loss."""
    from timetuning_tpu.models import mae as jmae

    jm, v, tm = _mae_pair(1)
    x = _x((2, 32, 32, 3), 3)
    key = jax.random.PRNGKey(4)
    loss_j, pred_j, mask_j = jm.apply(v, jnp.asarray(x), 0.75, key,
                                      method=jmae.MAEViT.pretrain)
    noise = torch.from_numpy(np.array(jax.random.uniform(key, (2, 16))))
    with torch.no_grad():
        loss_t, pred_t, mask_t = tm.pretrain(torch.from_numpy(x), 0.75, noise=noise)
    np.testing.assert_array_equal(mask_t.numpy(), np.asarray(mask_j))
    assert float(mask_t.sum()) == 2 * 12
    _close(pred_t, pred_j)
    assert abs(float(loss_t) - float(loss_j)) <= 1e-5 * abs(float(loss_j)), (loss_t, loss_j)
    np.testing.assert_array_equal(tm.patchify(torch.from_numpy(x)).numpy(),
                                  np.asarray(jm.apply(v, jnp.asarray(x),
                                                      method=jmae.MAEViT.patchify)))


# ---------------------------------------------------------------------- STEGO

def test_stego_featurizer_matches_jax():
    """A two-block ViT-S/8-shaped featurizer (embed 32) and the projection,
    f32, with the last block's attention."""
    from timetuning_tpu.models import stego as jst
    from timetuning_tpu.models.vit import ViTConfig as JCfg
    from timetuning_tpu.models.vit import VisionTransformer as JViT
    from timetuning_tpu_torch.models import stego as tst
    from timetuning_tpu_torch.models.vit import ViTConfig, VisionTransformer

    cfg = dict(patch_size=8, embed_dim=32, depth=2, num_heads=2, img_size=32)
    jm = jst.StegoFeaturizer(backbone=JViT(JCfg(**cfg, attn_impl="xla")), dim=12)
    v = {"params": _perturb(jm.init(jax.random.PRNGKey(0),
                                    jnp.zeros((1, 32, 32, 3)))["params"], 30)}
    tm = tst.StegoFeaturizer(VisionTransformer(ViTConfig(**cfg)), dim=12)
    tm.load_state_dict(convert.stego_state_dict_from_jax(v))
    x = _x((2, 32, 32, 3), 31)
    want = jm.apply(v, jnp.asarray(x), want_attention=True)
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x), want_attention=True)
    _close(got["tokens"], want["tokens"])
    _close(got["attention"], want["attention"])


# ------------------------------------------------- reference-layout checkpoints

def _both(name, path, monkeypatch=None):
    return jreg.get_backbone(name, path), treg.get_backbone(name, path, device="cpu")


def _features_agree(j, t, size, seed=0, rel=1e-4):
    x = _x((1, size, size, 3), seed)
    want = np.asarray(j.apply(jnp.asarray(x))[0])
    with torch.no_grad():
        got = t.apply(torch.from_numpy(x))[0].numpy()
    _close(got, want, rel=rel)


def _randomise_bn(module, seed):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.copy_(0.1 * torch.randn(m.running_mean.shape, generator=g))
                m.running_var.copy_(0.5 + torch.rand(m.running_var.shape, generator=g))
                m.weight.copy_(0.5 + torch.rand(m.weight.shape, generator=g))
                m.bias.copy_(0.1 * torch.randn(m.bias.shape, generator=g))


def test_resnet18_torchvision_checkpoint_loads_in_both(tmp_path):
    from timetuning_tpu_torch.models import resnet as tres

    m = treg.seeded_init(tres.resnet18(), torch.Generator().manual_seed(4))
    _randomise_bn(m, 4)
    sd = {f"module.{k}": v for k, v in m.state_dict().items()}
    sd["module.fc.weight"] = torch.zeros(10, 512)           # a classifier head
    path = str(tmp_path / "r18.pth")
    torch.save(sd, path)
    _features_agree(*_both("resnet18", path), 64)


def test_dul_framework_checkpoint_loads_in_both(tmp_path):
    from timetuning_tpu_torch.models import dul as tdul
    from timetuning_tpu_torch.models import resnet as tres

    net = treg.seeded_init(tdul.DulResNet18(), torch.Generator().manual_seed(5))
    _randomise_bn(net, 5)
    sd = {f"module.fast_net.backbone.{k}": v for k, v in net.state_dict().items()}
    path = str(tmp_path / "dul.pth")
    torch.save({"model": sd}, path)
    _features_agree(*_both("dul", path), 64, seed=1, rel=2e-4)


def test_motion_grouping_checkpoint_loads_in_both(tmp_path):
    layers, cin = [], 3
    for v in (64, "MP", 128, "MP", 256):
        if v == "MP":
            layers.append(torch.nn.MaxPool2d(2, 2, ceil_mode=True))
            continue
        for _ in range(2):
            layers += [torch.nn.Conv2d(cin, v, 5, padding=2),
                       torch.nn.InstanceNorm2d(v, affine=True), torch.nn.ReLU()]
            cin = v
    torch.manual_seed(3)
    enc = torch.nn.Sequential(*layers)
    with torch.no_grad():
        for m in enc.modules():
            if isinstance(m, torch.nn.InstanceNorm2d):
                m.weight.uniform_(0.5, 1.5)
                m.bias.normal_(0, 0.1)
    path = str(tmp_path / "mg.pth")
    torch.save({"model_state_dict": {f"encoder_cnn.{k}": v
                                     for k, v in enc.state_dict().items()}}, path)
    _features_agree(*_both("motion_grouping", path), 64, seed=2)


def _tiny_vit_patches(monkeypatch, heads=2):
    """The ViT-S builders of both registries at a test width (embed 64,
    two blocks; ``heads`` of 64 / heads)."""
    from timetuning_tpu.models import moco as jmoco
    from timetuning_tpu.models.vit import ViTConfig as JCfg
    from timetuning_tpu_torch.models import moco as tmoco
    from timetuning_tpu_torch.models.vit import ViTConfig

    def tiny(cls, patch=16):
        def build(*a, dtype=None, **kw):
            p = a[0] if a else patch
            extra = {} if dtype is None else {"dtype": dtype}
            return cls(patch_size=p, embed_dim=64, depth=2, num_heads=heads,
                       img_size=32, **extra)
        return build

    monkeypatch.setattr(jreg, "vit_small", tiny(JCfg))
    monkeypatch.setattr(treg, "vit_small", tiny(ViTConfig))
    monkeypatch.setattr(jmoco, "moco_vit_small", tiny(JCfg))
    monkeypatch.setattr(tmoco, "moco_vit_small", tiny(ViTConfig))


def _vit_sd(seed, patch):
    from timetuning_tpu_torch.models.vit import ViTConfig, VisionTransformer

    m = VisionTransformer(ViTConfig(patch_size=patch, embed_dim=64, depth=2,
                                    num_heads=2, img_size=32))
    m.init_weights(torch.Generator().manual_seed(seed))
    with torch.no_grad():
        for n, p in m.named_parameters():
            if n.endswith("bias") or "norm" in n:
                p.add_(0.05 * torch.randn(p.shape, generator=torch.Generator().manual_seed(seed)))
    return m.state_dict()


def test_mocov3_checkpoint_loads_in_both(tmp_path, monkeypatch):
    """The MoCo-v3 release's layout (``module.base_encoder.`` prefix, a
    ``state_dict`` container, a head the backbone ignores) at heads of 32."""
    _tiny_vit_patches(monkeypatch)
    sd = {f"module.base_encoder.{k}": v for k, v in _vit_sd(6, 16).items()}
    sd["module.base_encoder.head.weight"] = torch.zeros(4, 64)
    path = str(tmp_path / "moco.pth.tar")
    torch.save({"state_dict": sd}, path)
    j, t = _both("mocov3-s16", path)
    assert t.module.config.embed_dim // t.module.config.num_heads == 32
    _features_agree(j, t, 32, seed=3)


def test_stego_checkpoint_loads_in_both(tmp_path, monkeypatch):
    """The released ``.ckpt`` layout: ``net.model.<timm key>``,
    ``net.cluster1``, ``net.cluster2.{0,2}`` as 1 x 1 convolutions, and a
    probe the featurizer ignores."""
    _tiny_vit_patches(monkeypatch)
    g = torch.Generator().manual_seed(7)
    sd = {f"net.model.{k}": v.numpy() for k, v in _vit_sd(7, 8).items()}
    for name, (o, i) in (("cluster1", (12, 64)), ("cluster2.0", (64, 64)),
                         ("cluster2.2", (12, 64))):
        sd[f"net.{name}.weight"] = (torch.randn(o, i, 1, 1, generator=g) / 8).numpy()
        sd[f"net.{name}.bias"] = (0.1 * torch.randn(o, generator=g)).numpy()
    sd["linear_probe.weight"] = np.zeros((3, 12), np.float32)
    path = str(tmp_path / "stego.ckpt")
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in sd.items()}}, path)
    j, t = _both("stego", path)
    assert t.feature_dim == j.feature_dim == 12
    _features_agree(j, t, 32, seed=4)


def test_mae_checkpoint_loads_in_both(tmp_path, monkeypatch):
    """The MAE release's layout (a ``model`` container; the decoder, the mask
    token and the fixed position tables in the file are not the encoder's):
    the encoder's keys load in both."""
    from timetuning_tpu.models import mae as jmae
    from timetuning_tpu_torch.models import mae as tmae

    kw = dict(img_size=32, patch_size=8, embed_dim=64, depth=2, num_heads=2,
              decoder_embed_dim=32, decoder_depth=1, decoder_num_heads=2)
    monkeypatch.setattr(jmae, "mae_vit_base", lambda **k: jmae.MAEViT(**kw, **k))
    monkeypatch.setattr(tmae, "mae_vit_base", lambda **k: tmae.MAEViT(**kw, **k))
    m = tmae.MAEViT(**kw)
    treg.seeded_init(m, torch.Generator().manual_seed(8))
    sd = dict(m.state_dict())
    sd["pos_embed"] = torch.zeros(1, 17, 64)
    sd["decoder_pos_embed"] = torch.zeros(1, 17, 32)
    path = str(tmp_path / "mae.pth")
    torch.save({"model": sd}, path)
    j, t = _both("mae", path)
    _features_agree(j, t, 32, seed=5)


# ------------------------------------------------------------------- losses

def test_dul_framework_loss_matches_jax_on_the_same_anchor_grids():
    """view 1 [B, T+1, K, h, w], view 2 [B, T-1, K, h, w], L2-normalised
    over K as the framework's embeddings are (logits within 1 / T); the
    anchor grids JAX draws for its key, handed to the port. Bound 1e-5
    relative: f32 sums in another order."""
    from timetuning_tpu.models import dul as jdul
    from timetuning_tpu_torch.models import dul as tdul

    def unit(a):
        return (a / np.linalg.norm(a, axis=2, keepdims=True)).astype(np.float32)

    k1, k2 = unit(_x((2, 4, 8, 8, 8), 40)), unit(_x((2, 2, 8, 8, 8), 41))
    key = jax.random.PRNGKey(3)
    want = jdul.dul_framework_loss(jnp.asarray(k1), jnp.asarray(k2), key)
    k_grid, k_ref = jax.random.split(key)
    idx = torch.from_numpy(np.asarray(jdul._sample_grid_indices(k_grid, 2, 8, 8, 4)))
    idx_ref = torch.from_numpy(np.asarray(jdul._sample_grid_indices(k_ref, 2, 8, 8, 4)))
    got = tdul.dul_framework_loss(torch.from_numpy(k1), torch.from_numpy(k2),
                                  sample_idx=idx, sample_idx_ref=idx_ref)
    for name in ("main", "temp", "cross_key"):
        assert abs(float(got[name]) - float(want[name])) <= 1e-5 * abs(float(want[name])) + 1e-6, name
    drawn = tdul.sample_grid_indices(torch.Generator().manual_seed(0), 2, 8, 8, 4)
    assert drawn.shape == (2, 4, 4) and int(drawn.min()) >= 0 and int(drawn.max()) < 64


def test_space_time_cluster_loss_matches_jax_on_mirrored_kmeans(monkeypatch):
    from timetuning_tpu.models import dul as jdul
    from timetuning_tpu_torch.models import dul as tdul

    f = _x((2, 3, 16, 8), 50)
    key = jax.random.PRNGKey(6)
    want = float(jdul.space_time_cluster_loss(jnp.asarray(f), n_clusters=3, rng=key))
    mirror_keys(monkeypatch, list(jax.random.split(key, 2)))
    got = float(tdul.space_time_cluster_loss(torch.from_numpy(f), n_clusters=3))
    assert abs(got - want) <= 1e-5 * abs(want), (got, want)


# --------------------------------------------- the zoo through the eval CLIs

@pytest.fixture(scope="module")
def davis_tree(tmp_path_factory):
    """Two 6-frame 64 x 64 clips of a moving textured box."""
    import cv2

    root = tmp_path_factory.mktemp("davis_zoo")
    tex = np.random.default_rng(0).integers(80, 255, (24, 24, 3), dtype=np.uint8)
    for v in range(2):
        fdir = root / "JPEGImages" / "480p" / f"video{v}"
        adir = root / "Annotations" / "480p" / f"video{v}"
        fdir.mkdir(parents=True)
        adir.mkdir(parents=True)
        for f in range(6):
            img = np.full((64, 64, 3), 30, np.uint8)
            y = 16 + f + 3 * v
            img[y:y + 24, 20:44] = tex
            cv2.imwrite(str(fdir / f"{f:05d}.jpg"), img)
            ann = np.zeros((64, 64), np.uint8)
            ann[y:y + 24, 20:44] = 1
            cv2.imwrite(str(adir / f"{f:05d}.png"), ann)
    return str(root)


@pytest.mark.parametrize("arch,cli", [("resnet18", "evaluate"), ("dul", "propagate")])
def test_non_vit_backbones_through_the_eval_clis_match_jax(tmp_path, davis_tree, capsys,
                                                           monkeypatch, arch, cli):
    """A CNN of the zoo on a reference-layout checkpoint through the eval
    CLIs' feature path: ``cli/evaluate`` (dataset-wise, k-means on JAX's
    draws) with resnet18 and ``cli/propagate`` (J&F) with DUL's fixed 28 x
    28 grid, against the JAX CLIs: the same scores to 1e-5."""
    from timetuning_tpu.cli import evaluate as jev
    from timetuning_tpu.cli import propagate as jprop
    from timetuning_tpu_torch.cli import evaluate as tev
    from timetuning_tpu_torch.cli import propagate as tprop
    from timetuning_tpu_torch.models import dul as tdul
    from timetuning_tpu_torch.models import resnet as tres

    g = torch.Generator().manual_seed(9)
    net = tres.resnet18() if arch == "resnet18" else tdul.DulResNet18()
    treg.seeded_init(net, g)
    _randomise_bn(net, 9)
    prefix = "module." if arch == "resnet18" else "module.fast_net.backbone."
    sd = {prefix + k: v for k, v in net.state_dict().items()}
    path = str(tmp_path / f"{arch}.pth")
    torch.save(sd if arch == "resnet18" else {"model": sd}, path)
    common = ["--architecture", arch, "--model_path", path, "--dataset", "davis_val",
              "--data_root", davis_tree, "--num_workers", "2"]
    if cli == "evaluate":
        argv = common + ["--batch_size", "2", "--num_frames", "2", "--input_resolution",
                         "64", "--eval_resolution", "16", "--num_clusters", "2",
                         "--evaluation_protocol", "dataset-wise"]
        assert jev.main(argv) == 0
        want = float(capsys.readouterr().out.split("score: ")[1].split()[0])
        mirror_keys(monkeypatch, [jax.random.PRNGKey(1)])
        assert tev.main(argv + ["--device", "cpu"]) == 0
        got = float(capsys.readouterr().out.split("score: ")[1].split()[0])
    else:
        argv = common + ["--num_frames", "4", "--n_last_frames", "2",
                         "--size_mask_neighborhood", "4", "--input_resolution", "64"]
        assert jprop.main(argv) == 0
        want = capsys.readouterr().out.split("J&F: ")[1]
        assert tprop.main(argv + ["--device", "cpu"]) == 0
        got = capsys.readouterr().out.split("J&F: ")[1]
        want, got = (ast.literal_eval(s.strip().splitlines()[0])["J&F"] for s in (want, got))
    assert 0.0 < want <= 1.0 and abs(got - want) <= 1e-5, (got, want)
