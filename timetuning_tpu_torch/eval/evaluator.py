"""Evaluation harness: the three clustering-mIoU protocols.

Counterpart of ``timetuning_tpu/eval/evaluator.py`` (reference ``Evaluator``
+ ``evaluate_localizations``, evaluation.py:250-485):
  * frame-wise: Hungarian / many-to-one match per frame, mean over frames;
  * sample-wise: one match per clip, mean over clips;
  * dataset-wise: the whole set's features clustered together, one global
    match (ignore-index pixels excluded, the Pascal ``!= 255`` filter of
    evaluation.py:303-306); ``streaming=True`` is its bounded-memory form.

The harness takes an iterator factory yielding ``(frames [B, F, H, W, 3],
annotations [B, F, h, w])`` host arrays and a ``feature_fn``. Feature
extraction, attention masking, PCA, k-means and the upsampling run on the
features' device; the confusion matrix and the matching on the host.
"""

from __future__ import annotations

import logging
from typing import Callable, Iterable

import numpy as np
import torch

from timetuning_tpu_torch.eval.clustering import (
    cluster_features,
    default_generator,
    proto_clustering,
)
from timetuning_tpu_torch.eval.metrics import PredsmIoU
from timetuning_tpu_torch.models.extractor import apply_attention_mask
from timetuning_tpu_torch.ops.resize import resize_nearest


def evaluate_localizations(preds_eval: PredsmIoU, gts: np.ndarray,
                           preds: np.ndarray, evaluation_protocol: str,
                           many_to_one: bool = False,
                           precision_based: bool = False,
                           ignore_index: int | None = None,
                           logging_directory: str | None = None,
                           clip_offset: int = 0) -> float:
    """Match cluster maps [B, F, h, w] to annotations under a protocol;
    returns the mean mIoU (reference evaluation.py:250-310). With
    ``logging_directory``, writes per-clip gifs of the matched and the raw
    cluster maps (:270-300). Host code, as the JAX package's."""
    from timetuning_tpu_torch.obs.viz import colorize_segmentation, write_gif

    B, F = preds.shape[:2]
    scores = []

    def log_clip(i, reordered_frames, raw_frames, clip_score):
        if logging_directory is None:
            return
        import os

        sub = os.path.join(logging_directory, evaluation_protocol)
        os.makedirs(sub, exist_ok=True)
        n = clip_offset + i
        write_gif([colorize_segmentation(f) for f in reordered_frames],
                  os.path.join(sub, f"score_{clip_score:.3f}_reordered_{n}.gif"))
        write_gif([colorize_segmentation(f) for f in raw_frames],
                  os.path.join(sub, f"score_{clip_score:.3f}_inorder_{n}.gif"))

    if evaluation_protocol == "frame-wise":
        for i in range(B):
            clip_scores, reordered = [], []
            for j in range(F):
                preds_eval.update(gts[i, j].reshape(-1), preds[i, j].reshape(-1))
                s, _, _, _, mapping, _ = preds_eval.compute(
                    True, many_to_one, precision_based)
                clip_scores.append(s)
                if logging_directory is not None:
                    reordered.append(preds_eval.remap(preds[i, j], mapping))
                preds_eval.reset()
            scores += clip_scores
            log_clip(i, reordered, list(preds[i]), float(np.mean(clip_scores)))
    elif evaluation_protocol == "sample-wise":
        for i in range(B):
            for j in range(F):
                preds_eval.update(gts[i, j].reshape(-1), preds[i, j].reshape(-1))
            s, _, _, _, mapping, _ = preds_eval.compute(
                True, many_to_one, precision_based)
            scores.append(s)
            if logging_directory is not None:
                log_clip(i, [preds_eval.remap(preds[i, j], mapping) for j in range(F)],
                         list(preds[i]), float(s))
            preds_eval.reset()
    elif evaluation_protocol == "dataset-wise":
        if logging_directory is not None:
            logging.getLogger("timetuning_tpu_torch.eval").warning(
                "gif logging is a frame-/sample-wise feature (reference "
                "evaluation.py:255-300): no artifacts for dataset-wise")
        _update_dataset(preds_eval, gts, preds, ignore_index)
        scores.append(preds_eval.compute(True, many_to_one, precision_based)[0])
        preds_eval.reset()
    else:
        raise ValueError(f"unknown protocol {evaluation_protocol}")
    return float(np.mean(scores))


def _update_dataset(metric: PredsmIoU, gts, preds, ignore_index) -> None:
    for i in range(preds.shape[0]):
        for j in range(preds.shape[1]):
            g = gts[i, j].reshape(-1)
            p = preds[i, j].reshape(-1)
            if ignore_index is not None:
                keep = g != ignore_index
                g, p = g[keep], p[keep]
            metric.update(g, p)


def evaluate_propagation(preds_eval: PredsmIoU, gts: np.ndarray,
                         preds: np.ndarray) -> float:
    """Mean per-object propagation J over clips (reference
    evaluation.py:228-246)."""
    B, F = preds.shape[:2]
    all_scores = []
    for i in range(B):
        preds_eval.reset()
        for j in range(F):
            preds_eval.update_frame(gts[i, j].reshape(-1), preds[i, j].reshape(-1))
        all_scores += preds_eval.compute_propagation_score(True)
    preds_eval.reset()
    return float(np.mean(all_scores))


def _resized_annotations(annotations, r: int) -> np.ndarray:
    a = torch.from_numpy(np.asarray(annotations).astype(np.float32))
    return resize_nearest(a, (r, r)).numpy().astype(np.int64)


def _clips(frames, annotations):
    """Image datasets ([B, H, W, 3]) as one-frame clips."""
    frames = torch.as_tensor(np.asarray(frames))
    annotations = np.asarray(annotations)
    if frames.dim() == 4:
        frames, annotations = frames[:, None], annotations[:, None]
    return frames, annotations


class Evaluator:
    """Owns the data iterator, the feature function and the metric; runs the
    protocols.

    ``feature_fn(frames [B F, H, W, 3] uint8, want_attention) -> (features
    [B F, N, D], attentions)``, on whatever device it runs the model.

    The reference's asymmetries are kept for score parity (evaluation.py:
    387-485): precomputed ``fg_masks`` apply only on the dataset-wise and
    streaming paths (:418-427), and ``uvos`` binarises annotations only on
    the frame-/sample-wise path (:464-467)."""

    def __init__(self, data_iter_factory: Callable[[], Iterable], feature_fn,
                 spatial_resolution: int, num_classes: int = 10,
                 involve_bg: bool = True, clustering_algorithm: str = "k-means",
                 prototypes=None, uvos: bool = False,
                 fg_masks: np.ndarray | None = None,
                 ignore_index: int | None = 255,
                 logger: logging.Logger | None = None,
                 logging_directory: str | None = None):
        self.data_iter_factory = data_iter_factory
        self.feature_fn = feature_fn
        self.res = spatial_resolution
        self.metric = PredsmIoU(max(num_classes, 256), max(num_classes, 256),
                                involve_bg=involve_bg)
        self.clustering_algorithm = clustering_algorithm
        self.prototypes = prototypes
        self.uvos = uvos
        self.fg_masks = fg_masks
        self.ignore_index = ignore_index
        self.logger = logger or logging.getLogger("timetuning_tpu_torch.eval")
        self.logging_directory = logging_directory

    def _extract(self, frames, use_mask):
        B, F = frames.shape[:2]
        feats, attn = self.feature_fn(frames.reshape((B * F,) + frames.shape[2:]),
                                      use_mask)
        N, D = feats.shape[-2:]
        feats = feats.float().reshape(B, F, N, D)
        if use_mask and attn is not None and self.fg_masks is None:
            feats, _ = apply_attention_mask(feats, attn, self.res)
        return feats

    def _cluster(self, feats, protocol, eval_res, k, use_annotations, annotations):
        if self.clustering_algorithm == "k-means":
            return cluster_features(
                feats, k, eval_res, protocol,
                annotations=annotations if use_annotations else None).cpu().numpy()
        if self.clustering_algorithm == "prototypes":
            if self.prototypes is None:
                raise ValueError("clustering_algorithm='prototypes' needs prototypes")
            return proto_clustering(feats, self._protos(feats), eval_res,
                                    num_classes=k).cpu().numpy()
        raise ValueError(self.clustering_algorithm)

    def _protos(self, like):
        return torch.as_tensor(np.asarray(self.prototypes, np.float32)).to(like.device)

    def _fg_mask(self, feats, masks):
        """Multiply [B, F, N, D] features by FG masks ([B, F, h, w] or
        [B F, h, w]) taken down to the patch grid."""
        B, F = feats.shape[:2]
        m = torch.as_tensor(np.asarray(masks, np.float32)).to(feats.device)
        m = resize_nearest(m.reshape(B, F, *m.shape[-2:]), (self.res, self.res))
        return feats * m.reshape(B, F, -1, 1)

    def _mask_batch(self, feats, offset):
        """Precomputed FG masks for a batch: ``fg_masks`` is clip-level
        [clips, F, h, w] or frame-level [frames, h, w]; ``offset`` counts the
        clips consumed so far."""
        if self.fg_masks is None:
            return feats
        B, F = feats.shape[:2]
        if np.ndim(self.fg_masks) == 4:
            return self._fg_mask(feats, self.fg_masks[offset:offset + B])
        return self._fg_mask(feats, self.fg_masks[offset * F:(offset + B) * F])

    def _evaluate_dataset_streaming_protos(self, many_to_one, eval_resolution,
                                           num_clusters, use_mask,
                                           precision_based) -> float:
        """Bounded-memory dataset-wise prototype-argmax protocol: one pass,
        the prototype merge computed once."""
        r = eval_resolution
        offset = 0
        merge = None
        if num_clusters is not None and num_clusters < np.shape(self.prototypes)[0]:
            from timetuning_tpu_torch.eval.clustering import prototype_merge_table

            merge = prototype_merge_table(
                torch.as_tensor(np.asarray(self.prototypes, np.float32)),
                num_clusters).numpy()
        for batch in self.data_iter_factory():
            frames, annotations = _clips(batch[0], batch[1])
            feats = self._mask_batch(self._extract(frames, use_mask), offset)
            preds = proto_clustering(feats, self._protos(feats), r).cpu().numpy()
            if merge is not None:
                preds = merge[preds]
            _update_dataset(self.metric, _resized_annotations(annotations, r),
                            preds, self.ignore_index)
            offset += preds.shape[0]
        score = self.metric.compute(True, many_to_one, precision_based)[0]
        self.metric.reset()
        self.logger.info("dataset-wise score %s (streaming, prototypes)", score)
        return score

    def _evaluate_dataset_streaming(self, many_to_one: bool,
                                    eval_resolution: int, num_clusters: int,
                                    use_mask: bool, precision_based: bool,
                                    pca_dim: int = 50,
                                    sample_cap: int | None = None,
                                    use_annotations: bool = False) -> float:
        """Bounded-memory dataset-wise protocol (the JAX package's): pass 1
        folds PCA moments and keeps a bounded sample of upsampled pixels for
        the k-means fit (faiss itself fits on <= 256 k points); pass 2
        reduces, upsamples, assigns and updates the confusion matrix batch by
        batch. Standardise + PCA and bilinear upsampling are both linear, so
        reduce-then-upsample equals upsample-then-reduce."""
        from timetuning_tpu_torch.ops import kmeans as km
        from timetuning_tpu_torch.ops.resize import patch_grid_to_image

        k = num_clusters
        r = eval_resolution
        if self.clustering_algorithm == "prototypes":
            return self._evaluate_dataset_streaming_protos(
                many_to_one, r, k, use_mask, precision_based)
        if sample_cap is None:
            sample_cap = max(256 * k, 16384)
        generator = default_generator()

        def upsampled(feats):
            B, F, N, D = feats.shape
            res = int(round(N ** 0.5))
            return patch_grid_to_image(feats.reshape(B * F, N, D), (res, res), (r, r))

        moments = None
        samples = []
        offset = n_batches = 0
        uniq: set = set()
        for batch in self.data_iter_factory():
            frames, annotations = _clips(batch[0], batch[1])
            if use_annotations:
                uniq |= set(np.unique(_resized_annotations(annotations, r)).tolist())
            feats = self._mask_batch(self._extract(frames, use_mask), offset)
            B, F, N, D = feats.shape
            if moments is None:
                moments = km.init_moments(D)
            moments = km.update_moments(moments, feats.reshape(B * F * N, D))
            maps = upsampled(feats).reshape(-1, D)
            n_take = min(max(sample_cap // 8, 1024), maps.shape[0])
            if n_take < maps.shape[0]:
                # with replacement, as the JAX package draws it
                idx = torch.randint(0, maps.shape[0], (n_take,), generator=generator)
                maps = maps[idx.to(maps.device)]
            samples.append(maps.cpu().numpy())
            offset += B
            n_batches += 1
        if moments is None:
            raise ValueError("empty evaluation dataset")
        if use_annotations and uniq:
            k = len(uniq)
        device = feats.device
        pca = km.pca_from_moments(moments, min(pca_dim, samples[0].shape[-1]),
                                  device=device)
        sample = np.concatenate(samples, axis=0)
        if sample.shape[0] > sample_cap:
            keep = np.random.default_rng(1).choice(sample.shape[0], sample_cap,
                                                   replace=False)
            sample = sample[keep]
        fit = km.kmeans(km.apply_pca(pca, torch.from_numpy(sample).to(device)), k,
                        default_generator(), n_iter=50, n_redo=5)
        self.logger.info("streaming dataset-wise: fit k=%d on %d sampled pixels "
                         "(%d batches, objective %.4g)", k, sample.shape[0],
                         n_batches, float(fit.objective))

        offset = 0
        for batch in self.data_iter_factory():
            frames, annotations = _clips(batch[0], batch[1])
            feats = self._mask_batch(self._extract(frames, use_mask), offset)
            B, F, N, D = feats.shape
            res = int(round(N ** 0.5))
            red = km.apply_pca(pca, feats.reshape(B * F * N, D))
            maps = patch_grid_to_image(red.reshape(B * F, N, -1), (res, res), (r, r))
            preds = km.kmeans_assign(maps.reshape(B * F * r * r, -1), fit.centroids)
            preds = preds.reshape(B, F, r, r).cpu().numpy()
            _update_dataset(self.metric, _resized_annotations(annotations, r),
                            preds, self.ignore_index)
            offset += B
        score = self.metric.compute(True, many_to_one, precision_based)[0]
        self.metric.reset()
        self.logger.info("dataset-wise score %s (streaming)", score)
        return score

    def evaluate(self, many_to_one: bool = False,
                 evaluation_protocol: str = "frame-wise",
                 eval_resolution: int = 112, num_clusters: int = 10,
                 use_mask: bool = False, use_annotations: bool = False,
                 precision_based: bool = False, streaming: bool = False,
                 sample_cap: int | None = None) -> float:
        if evaluation_protocol == "dataset-wise" and streaming:
            return self._evaluate_dataset_streaming(
                many_to_one=many_to_one, eval_resolution=eval_resolution,
                num_clusters=num_clusters, use_mask=use_mask,
                precision_based=precision_based, sample_cap=sample_cap,
                use_annotations=use_annotations)
        if evaluation_protocol == "dataset-wise":
            feats_all, annots_all = [], []
            for batch in self.data_iter_factory():
                frames, annotations = _clips(batch[0], batch[1])
                feats_all.append(self._extract(frames, use_mask))
                annots_all.append(annotations)
            feats = torch.cat(feats_all, dim=0)
            annotations = np.concatenate(annots_all, axis=0)
            if self.fg_masks is not None:
                feats = self._fg_mask(feats, self.fg_masks)
            annotations = _resized_annotations(annotations, eval_resolution)
            cluster_maps = self._cluster(feats, evaluation_protocol,
                                         eval_resolution, num_clusters,
                                         use_annotations, annotations)
            score = evaluate_localizations(
                self.metric, annotations, cluster_maps, evaluation_protocol,
                many_to_one, precision_based, ignore_index=self.ignore_index,
                logging_directory=self.logging_directory)
            self.logger.info("dataset-wise score %s", score)
            return score

        batch_scores = []
        clips_seen = 0
        for batch in self.data_iter_factory():
            frames, annotations = _clips(batch[0], batch[1])
            feats = self._extract(frames, use_mask)
            if self.uvos:
                annotations = (annotations > 0).astype(np.int64)
            annotations = _resized_annotations(annotations, eval_resolution)
            cluster_maps = self._cluster(feats, evaluation_protocol,
                                         eval_resolution, num_clusters,
                                         use_annotations, annotations)
            batch_scores.append(evaluate_localizations(
                self.metric, annotations, cluster_maps, evaluation_protocol,
                many_to_one, precision_based,
                logging_directory=self.logging_directory,
                clip_offset=clips_seen))
            clips_seen += int(annotations.shape[0])
            self.logger.info("batch score %s", batch_scores[-1])
        # the dataset score is the mean of per-batch scores (evaluation.py:483)
        return float(np.mean(batch_scores))
