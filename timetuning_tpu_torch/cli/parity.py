"""Real-artifact parity harness, on PyTorch: one command to run once the
published checkpoint and datasets are mounted.

    python -m timetuning_tpu_torch.cli.parity --timet_pth TimeT.pth \\
        [--davis_root /data/davis] [--pascal_root /data/voc] \\
        [--expected_davis_jf 0.65] [--expected_pascal_miou 0.125]

Counterpart of ``timetuning_tpu/cli/parity.py``: the same seven stages,
flags, report rows, ``--report_json`` schema and exit codes, plus
``--device`` (the card unless ``cpu``). Each stage runs only if its
artifact is given:

  1. import fidelity (needs only the .pth): the port's ViT loaded through
     the registry's importer against the torch oracle
     (eval/parity_oracle.py) built from the same state dict, on a fixed
     random batch at the checkpoint's native resolution: patch embedding,
     dense features (through the projection head, held to
     ``build_oracle_head``, where the checkpoint has one) and prototype
     scores;
  2. DAVIS propagation (reference mask_propagation.py:717-842: 25 uniform
     frames, n_last 4, neighbourhood 12, top-k 5): J, J&F, frame-wise mIoU;
  3. Pascal dataset-wise clustering mIoU (reference evaluation.py:373-485:
     k = 21, eval resolution input / 2, k-means, Hungarian);
  4. Pascal prototype-argmax clustering (``--proto_clustering``; reference
     clustering.py:85-117);
  5. the linear probe (``--linear_probe``; reference linear_finetune.py);
  6. CBFE + boundary F (``--cbfe``; reference
     cluster_based_foreground_extraction.py:281-348);
  7. the training trajectory (``--train_trajectory``; reference
     time_tuning.py:637-645).

Each stage prints a row; a row with an ``--expected_*`` value is gated
(|ours - expected| <= tolerance), one without reports its number. Exit code
1 if any gate fails.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.nn.functional as F

from timetuning_tpu_torch.cli.train import str2bool

_HEADS = {  # timm geometry per supported parity architecture
    "dino-s16": 6, "dino-s8": 6, "msn-s16": 6, "ibot-s16": 6, "leopart": 6,
    "dino-b16": 12, "vit": 12, "vit-tiny-test": 2, "vit-tiny-test-p4": 2,
}

_BACKBONE = "feature_extractor.backbone."


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("timetuning_tpu_torch.parity")
    p.add_argument("--timet_pth", type=str, required=True,
                   help="published TimeT.pth (or any backbone .pth with the "
                        "feature_extractor.backbone.<timm key> contract)")
    p.add_argument("--architecture", type=str, default="dino-s16",
                   choices=sorted(_HEADS))
    p.add_argument("--davis_root", type=str, default=None)
    p.add_argument("--pascal_root", type=str, default=None)
    p.add_argument("--input_resolution", type=int, default=224)
    p.add_argument("--eval_resolution", type=int, default=None,
                   help="default input/2 (reference time_tuning.py:603)")
    p.add_argument("--pascal_clusters", type=int, default=21)
    p.add_argument("--num_frames", type=int, default=25)
    p.add_argument("--n_last_frames", type=int, default=4)
    p.add_argument("--size_mask_neighborhood", type=int, default=12)
    p.add_argument("--topk", type=int, default=5)
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--expected_davis_jf", type=float, default=None,
                   help="reference J&F to gate against")
    p.add_argument("--expected_davis_miou", type=float, default=None)
    p.add_argument("--expected_pascal_miou", type=float, default=None)
    p.add_argument("--tolerance", type=float, default=0.005,
                   help="metric gate half-width, in FRACTION units (the "
                        "metrics here are [0, 1] fractions): 0.005 == the "
                        "0.5 mIoU points of 'within 0.5 of the reference'")
    p.add_argument("--feature_atol", type=float, default=5e-3,
                   help="max |Δ| gate for dense features vs the torch oracle")
    p.add_argument("--embed_atol", type=float, default=1e-4,
                   help="max |Δ| gate for the patch-embedding tokens")
    p.add_argument("--streaming", type=str2bool, default=False,
                   help="bounded-memory Pascal dataset-wise protocol")
    p.add_argument("--proto_clustering", type=str2bool, default=False)
    p.add_argument("--expected_pascal_proto_miou", type=float, default=None)
    p.add_argument("--linear_probe", type=str2bool, default=False)
    p.add_argument("--linear_probe_epochs", type=int, default=50)
    p.add_argument("--linear_resolution", type=int, default=448)
    p.add_argument("--linear_mask_size", type=int, default=100)
    p.add_argument("--linear_batch_size", type=int, default=64)
    p.add_argument("--expected_linear_miou", type=float, default=None)
    p.add_argument("--cbfe", type=str2bool, default=False)
    p.add_argument("--cbfe_clusters", type=int, default=300)
    p.add_argument("--cbfe_input_resolution", type=int, default=448)
    p.add_argument("--cbfe_resolution", type=int, default=100)
    p.add_argument("--cbfe_batch_size", type=int, default=32)
    p.add_argument("--expected_cbfe_miou", type=float, default=None)
    p.add_argument("--expected_cbfe_jaccard", type=float, default=None)
    p.add_argument("--train_trajectory", type=str2bool, default=False,
                   help="train from --timet_pth (pass the DINO init here, "
                        "not the finished TimeT) on --ytvos_root with the "
                        "reference config and gate the final in-training "
                        "Pascal Scores/localization")
    p.add_argument("--ytvos_root", type=str, default=None)
    p.add_argument("--trajectory_epochs", type=int, default=24)
    p.add_argument("--trajectory_batch_size", type=int, default=128)
    p.add_argument("--expected_localization", type=float, default=0.125)
    p.add_argument("--trajectory_tolerance", type=float, default=0.01)
    p.add_argument("--report_json", type=str, default=None,
                   help="write the per-stage report as JSON: a list of "
                        "{metric, value, expected, tolerance, pass} rows "
                        "plus a summary")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda, and an error where there "
                        "is no card; pass cpu to run on the host)")
    return p


class _Report:
    def __init__(self):
        self.rows = []
        self.failed = False

    def add(self, name, ours, expected, tol):
        if expected is None:
            status = "REPORT"
        elif abs(ours - expected) <= tol:
            status = "PASS"
        else:
            status = "FAIL"
            self.failed = True
        self.rows.append((name, ours, expected, tol, status))
        exp = "—" if expected is None else f"{expected:.6g}"
        print(f"{name:<38} ours={ours:<12.6g} ref={exp:<10} "
              f"tol={tol:<8.3g} {status}")

    def summary(self, report_json: str | None = None):
        n_pass = sum(r[-1] == "PASS" for r in self.rows)
        n_fail = sum(r[-1] == "FAIL" for r in self.rows)
        n_rep = sum(r[-1] == "REPORT" for r in self.rows)
        print(f"\nparity: {n_pass} passed, {n_fail} failed, "
              f"{n_rep} report-only")
        if report_json:
            import json

            payload = {
                "rows": [
                    {
                        "metric": name,
                        "value": float(ours),
                        "expected": None if expected is None else float(expected),
                        "tolerance": float(tol),
                        "pass": None if status == "REPORT" else status == "PASS",
                    }
                    for name, ours, expected, tol, status in self.rows
                ],
                "summary": {
                    "passed": n_pass, "failed": n_fail,
                    "report_only": n_rep, "ok": not self.failed,
                },
            }
            with open(report_json, "w") as f:
                json.dump(payload, f, indent=1)
            print(f"report written: {report_json}")
        return 1 if self.failed else 0


def _import_stage(args, report: _Report, device):
    """Stage 1: checkpoint import + torch-oracle numerical parity. Returns
    (the TimeT model on ``device``, the imported params, the head dims)."""
    from timetuning_tpu_torch.core.timet import TimeT
    from timetuning_tpu_torch.eval.parity_oracle import (
        build_oracle_head,
        oracle_from_state_dict,
    )
    from timetuning_tpu_torch.models.convert import timet_state_dict_from_jax
    from timetuning_tpu_torch.models.extractor import FeatureExtractor
    from timetuning_tpu_torch.models.import_torch import (
        head_dims_from_params,
        load_torch_state_dict,
        strip_prefixes,
        timet_params_from_torch,
    )
    from timetuning_tpu_torch.models.registry import get_backbone

    sd = load_torch_state_dict(args.timet_pth)
    if not any(k.startswith(_BACKBONE) for k in sd):
        # a plain backbone release: lift it into the TimeT.pth key contract
        sd = {f"{_BACKBONE}{k}": v for k, v in strip_prefixes(sd).items()}
    imported = timet_params_from_torch(sd)
    head_dims = head_dims_from_params(imported["feature_extractor"].get("head", {}))
    n_protos = imported.get("prototypes", np.zeros((200, 1))).shape[0]

    # the backbone through the registry's importer (the checkpoint's own
    # file); the head and prototypes from the imported tree
    bb = get_backbone(args.architecture, args.timet_pth, device=device)
    try:
        n_pos = sd[f"{_BACKBONE}pos_embed"].shape[1] - 1
        patch = sd[f"{_BACKBONE}patch_embed.proj.weight"].shape[-1]
        img = int(round(float(n_pos) ** 0.5)) * int(patch)
    except KeyError:
        img = args.input_resolution
    model = TimeT(FeatureExtractor(bb.module, bb.feature_dim, head_dims, bb.drop_cls),
                  n_prototypes=n_protos,
                  prototype_dim=None if head_dims else bb.feature_dim).to(device)
    rest = {k: v for k, v in timet_state_dict_from_jax(imported).items()
            if not k.startswith(_BACKBONE)}
    missing = set(model.load_state_dict(rest, strict=False).missing_keys)
    if any(not k.startswith(_BACKBONE) for k in missing - {"prototypes"}):
        raise ValueError(f"parity: the checkpoint's head does not load: {sorted(missing)}")
    model.eval()

    backbone_sd = {k[len(_BACKBONE):]: v for k, v in sd.items()
                   if k.startswith(_BACKBONE)}
    oracle = oracle_from_state_dict(backbone_sd, img, _HEADS[args.architecture])
    x = np.random.default_rng(0).normal(size=(2, 3, img, img)).astype(np.float32)
    with torch.no_grad():
        embed_t = oracle.embed(torch.from_numpy(x)).numpy()
        tokens_t, _ = oracle(torch.from_numpy(x))
        tokens_t = tokens_t.numpy()
        want_feats = tokens_t[:, 1:]
        if head_dims:
            head = build_oracle_head(head_dims, tokens_t.shape[-1])
            head.load_state_dict({
                f"{2 * j}.{p}": torch.as_tensor(sd[f"feature_extractor.head.{2 * j}.{p}"])
                for j in range(len(head_dims)) for p in ("weight", "bias")})
            want_feats = head(torch.from_numpy(want_feats)).numpy()
        want_scores = None
        if "prototypes" in imported:
            f = F.normalize(torch.from_numpy(want_feats), dim=-1)
            p = torch.as_tensor(np.asarray(imported["prototypes"]))
            want_scores = (f @ p.t()).numpy()

        xt = torch.from_numpy(x.transpose(0, 2, 3, 1).copy()).to(device)
        embed_p = _patch_embed(bb.module, xt).cpu().numpy()
        feats_t, _ = model(xt, use_head=bool(head_dims))
        feats_p = feats_t.float().cpu().numpy()
        report.add("patch_embed max|Δ| (vs torch)",
                   float(np.abs(embed_p - embed_t).max()), 0.0, args.embed_atol)
        report.add("dense features max|Δ| (vs torch)",
                   float(np.abs(feats_p - want_feats).max()), 0.0, args.feature_atol)
        if want_scores is not None:
            scores = model.similarity(feats_t).float().cpu().numpy()
            report.add("prototype scores max|Δ| (vs torch)",
                       float(np.abs(scores - want_scores).max()), 0.0,
                       args.feature_atol)
    return model, imported, head_dims


def _patch_embed(vit, x_nhwc):
    """Patch-embedding tokens of the port's ViT: conv + flatten (as
    ``OracleViT.embed``)."""
    pe = vit.patch_embed.proj
    y = F.conv2d(x_nhwc.permute(0, 3, 1, 2), pe.weight, pe.bias,
                 stride=pe.stride)
    return y.flatten(2).transpose(1, 2)


def _feature_fn(forward, device, input_resolution):
    """An Evaluator's feature function: uint8 frames -> (features, None),
    the eval preprocess with the canonical 0.229 std (reference
    leoloader.py:246, as every Pascal eval of the repo) in f32."""
    from timetuning_tpu_torch.data.transforms import IMAGENET_STD, eval_preprocess_batch

    @torch.no_grad()
    def feature_fn(frames, want_attention=False):
        x = eval_preprocess_batch(torch.as_tensor(np.asarray(frames)).to(device),
                                  out_size=input_resolution, std=IMAGENET_STD)
        return forward(x), None

    return feature_fn


def main(argv=None) -> int:
    from timetuning_tpu_torch.runtime import resolve_device

    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    # the faithful f32 path: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report = _Report()

    print(f"== stage 1: checkpoint import fidelity ({args.timet_pth}) ==")
    model, imported, head_dims = _import_stage(args, report, device)

    if args.davis_root:
        print("\n== stage 2: DAVIS semi-supervised propagation ==")
        from timetuning_tpu_torch.cli import propagate as cli_prop

        pargs = cli_prop.build_parser().parse_args([
            "--architecture", args.architecture,
            "--model_path", args.timet_pth,
            "--dataset", "davis_val",
            "--data_root", args.davis_root,
            "--num_frames", str(args.num_frames),
            "--n_last_frames", str(args.n_last_frames),
            "--size_mask_neighborhood", str(args.size_mask_neighborhood),
            "--topk", str(args.topk),
            "--input_resolution", str(args.input_resolution),
            "--num_workers", str(args.num_workers),
            "--device", str(device),
        ])
        res = cli_prop.run_propagation(pargs, metrics=("jf", "miou"))
        report.add("DAVIS J (propagation)", float(res["jf"]["J"]), None,
                   args.tolerance)
        report.add("DAVIS J&F (propagation)", float(res["jf"]["J&F"]),
                   args.expected_davis_jf, args.tolerance)
        report.add("DAVIS mIoU (frame-wise, reference scoring)",
                   float(res["miou"]), args.expected_davis_miou, args.tolerance)

    if args.pascal_root:
        print("\n== stage 3: Pascal dataset-wise clustering mIoU ==")
        from timetuning_tpu_torch.data.pascal import pascal_loader
        from timetuning_tpu_torch.eval.evaluator import Evaluator
        from timetuning_tpu_torch.models.registry import get_backbone

        bb = get_backbone(args.architecture, args.timet_pth, device=device)
        res_sp = bb.spatial_resolution(args.input_resolution)
        eval_res = args.eval_resolution or args.input_resolution // 2
        loader = pascal_loader(60, args.pascal_root, "val", eval_res,
                               args.input_resolution)
        ev = Evaluator(
            data_iter_factory=lambda: iter(loader),
            feature_fn=_feature_fn(lambda x: bb.apply(x)[0], device,
                                   args.input_resolution),
            spatial_resolution=res_sp, num_classes=args.pascal_clusters,
            involve_bg=True, ignore_index=255)
        score = ev.evaluate(evaluation_protocol="dataset-wise",
                            eval_resolution=eval_res,
                            num_clusters=args.pascal_clusters,
                            streaming=args.streaming)
        report.add("Pascal mIoU (dataset-wise, k=21)", float(score),
                   args.expected_pascal_miou, args.tolerance)

    if args.proto_clustering and args.pascal_root:
        # stage 3 ran (the same pascal_root gate): its res_sp, eval_res and
        # loader are live here
        print("\n== stage 4: Pascal prototype-argmax clustering mIoU ==")
        from timetuning_tpu_torch.eval.evaluator import Evaluator

        if "prototypes" not in imported:
            raise SystemExit(
                "--proto_clustering needs a checkpoint with a prototype bank "
                "(TimeT.pth has one; plain backbone releases do not)")
        ev = Evaluator(
            data_iter_factory=lambda: iter(loader),
            feature_fn=_feature_fn(lambda x: model(x, use_head=bool(head_dims))[0],
                                   device, args.input_resolution),
            spatial_resolution=res_sp, num_classes=args.pascal_clusters,
            involve_bg=True, ignore_index=255, clustering_algorithm="prototypes",
            prototypes=np.asarray(imported["prototypes"]))
        score = ev.evaluate(evaluation_protocol="dataset-wise",
                            eval_resolution=eval_res,
                            num_clusters=args.pascal_clusters,
                            streaming=args.streaming)
        report.add("Pascal mIoU (prototype argmax)", float(score),
                   args.expected_pascal_proto_miou, args.tolerance)

    if args.linear_probe and args.pascal_root:
        print("\n== stage 5: Pascal linear probe mIoU ==")
        from timetuning_tpu_torch.cli.linear_probe import run_linear_probe

        lp = run_linear_probe(argparse.Namespace(
            architecture=args.architecture, model_path=args.timet_pth,
            pascal_root=args.pascal_root, batch_size=args.linear_batch_size,
            num_classes=args.pascal_clusters, num_epochs=args.linear_probe_epochs,
            input_resolution=args.linear_resolution,
            mask_size=args.linear_mask_size, lr=0.01, device=str(device)))
        report.add("Pascal linear-probe mIoU (best)", float(lp["best_miou"]),
                   args.expected_linear_miou, args.tolerance)

    if args.cbfe and args.pascal_root:
        print("\n== stage 6: CBFE foreground extraction + masked mIoU ==")
        from timetuning_tpu_torch.cli.cbfe import run_cbfe

        cb = run_cbfe(argparse.Namespace(
            architecture=args.architecture, model_path=args.timet_pth,
            pascal_root=args.pascal_root, batch_size=args.cbfe_batch_size,
            num_clusters=args.cbfe_clusters,
            input_resolution=args.cbfe_input_resolution,
            resolution=args.cbfe_resolution, eval_resolution=args.cbfe_resolution,
            num_eval_clusters=args.pascal_clusters, many_to_one=True,
            device=str(device)))
        report.add("CBFE val Jaccard", cb["val_jaccard"],
                   args.expected_cbfe_jaccard, args.tolerance)
        report.add("CBFE val boundary-F", cb["val_bf"], None, args.tolerance)
        report.add("CBFE masked mIoU (many-to-one)", cb["masked_miou"],
                   args.expected_cbfe_miou, args.tolerance)

    if args.train_trajectory and args.ytvos_root and args.pascal_root:
        print("\n== stage 7: training-trajectory replication "
              f"({args.trajectory_epochs} epochs on {args.ytvos_root}) ==")
        import json
        import os

        from timetuning_tpu_torch.core.train import TrainingConfig, run_training

        # the reference trainer's config (time_tuning.py:617-645 defaults)
        result = run_training(TrainingConfig(
            architecture=args.architecture, model_path=args.timet_pth,
            dataset="ytvos", data_root=args.ytvos_root,
            pascal_root=args.pascal_root,
            log_dir=os.path.join(os.path.dirname(args.report_json)
                                 if args.report_json else ".", "trajectory_logs"),
            batch_size=args.trajectory_batch_size,
            num_epochs=args.trajectory_epochs, eval_every=4,
            eval_num_clusters=args.pascal_clusters,
            input_resolution=args.input_resolution,
            num_workers=args.num_workers, device=str(device)))
        traj = []
        with open(os.path.join(result["run_dir"], "metrics.jsonl")) as f:
            for line in f:
                row = json.loads(line)
                if row.get("tag") == "Scores/localization":
                    traj.append((row["step"], round(row["value"], 4)))
        print(f"  Scores/localization trajectory: {traj}")
        final = traj[-1][1] if traj else float("nan")
        report.add("trajectory final Scores/localization", final,
                   args.expected_localization, args.trajectory_tolerance)

    return report.summary(report_json=args.report_json)


if __name__ == "__main__":
    raise SystemExit(main())
