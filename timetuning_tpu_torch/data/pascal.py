# The port's own copy of timetuning_tpu/data/pascal.py (host code: numpy, no JAX), with its
# imports of the package renamed; tests/test_torch_host_copies.py pins it to the original.
"""Pascal VOC (Leopart-layout) loader + SBD augmented-annotation setup.

Reference: leoloader.py:185-264 (``VOCDataset``/``pascal_loader`` over the
``images`` / ``SegmentationClass[Aug]`` / ``sets/<split>.txt`` layout) and
data_loader.py:823-1042 (``pascalVOCLoader`` with SBD .mat pre-encoding).

Both reference paths resize images to (train_size)² bilinear and masks to
(val_size)² nearest, normalizing with the *canonical* ImageNet std 0.229
(leoloader.py:246-251 — unlike the video path's 0.228 typo; SURVEY.md §2.5).
This loader yields uint8 host batches; resize+normalize run on device
(data/transforms.eval_preprocess_batch with std=IMAGENET_STD).
"""

from __future__ import annotations

import os
from typing import Iterator

import numpy as np

try:
    import cv2
except Exception:  # pragma: no cover
    cv2 = None


class PascalVOCDataset:
    """images/*.jpg + SegmentationClass[Aug]/*.png + sets/<split>.txt."""

    def __init__(self, root: str, image_set: str = "val"):
        seg_folder = (
            "SegmentationClassAug" if "train" in image_set else "SegmentationClass"
        )
        self.image_dir = os.path.join(root, "images")
        self.seg_dir = os.path.join(root, seg_folder)
        split_f = os.path.join(root, "sets", image_set + ".txt")
        with open(split_f) as f:
            names = [x.strip() for x in f if x.strip()]
        self.images = [os.path.join(self.image_dir, n + ".jpg") for n in names]
        self.masks = [os.path.join(self.seg_dir, n + ".png") for n in names]

    def __len__(self):
        return len(self.images)

    def __getitem__(self, i: int):
        raw = cv2.imread(self.images[i])
        assert raw is not None, f"failed to decode {self.images[i]}"
        img = cv2.cvtColor(raw, cv2.COLOR_BGR2RGB)
        # VOC SegmentationClass masks are palette-indexed PNGs whose pixel
        # values are CLASS IDS (255 = ignore border). cv2 would expand the
        # palette to colors (class 1 → luma ~38, ignore → ~220, never 255);
        # PIL 'P' mode returns the raw indices, like the reference's PIL
        # reads (leoloader.py). SegmentationClassAug files are plain
        # grayscale and decode identically either way.
        from PIL import Image

        with Image.open(self.masks[i]) as im:
            mask = np.asarray(
                im if im.mode in ("P", "L") else im.convert("L")
            ).astype(np.uint8)
        return img, mask


class PascalLoader:
    """Iterator of (images_u8 [B, S, S, 3], masks_u8 [B, s, s]) host batches."""

    def __init__(
        self,
        dataset: PascalVOCDataset,
        batch_size: int,
        image_size: int = 224,
        mask_size: int = 112,
        shuffle: bool = False,
        seed: int = 1,
    ):
        self.ds = dataset
        self.batch_size = batch_size
        self.image_size = image_size
        self.mask_size = mask_size
        self.shuffle = shuffle
        self.seed = seed

    def __len__(self):
        return (len(self.ds) + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        order = np.arange(len(self.ds))
        if self.shuffle:
            np.random.default_rng(self.seed).shuffle(order)
        for s in range(0, len(order), self.batch_size):
            idx = order[s : s + self.batch_size]
            imgs = np.zeros((len(idx), self.image_size, self.image_size, 3), np.uint8)
            masks = np.zeros((len(idx), self.mask_size, self.mask_size), np.uint8)
            for k, i in enumerate(idx):
                img, mask = self.ds[int(i)]
                imgs[k] = cv2.resize(
                    img, (self.image_size, self.image_size), interpolation=cv2.INTER_LINEAR
                )
                masks[k] = cv2.resize(
                    mask, (self.mask_size, self.mask_size), interpolation=cv2.INTER_NEAREST
                )
            yield imgs, masks


def pascal_loader(
    batch_size: int,
    root: str,
    split: str,
    val_size: int,
    train_size: int = 448,
) -> PascalLoader:
    """Reference-signature factory (leoloader.py:241-264): images at
    ``train_size``, masks at ``val_size``; deterministic order (the reference
    hard-disables shuffling, leoloader.py:262)."""
    ds = PascalVOCDataset(root, image_set=split)
    return PascalLoader(
        ds, batch_size, image_size=train_size, mask_size=val_size, shuffle=False
    )


def setup_sbd_annotations(voc_root: str, sbd_root: str) -> int:
    """Pre-encode the augmented-train annotation set into
    ``SegmentationClassAug`` pngs: VOC's own ``SegmentationClass`` masks
    (the 2012-only annotations a trainaug split needs) PLUS the SBD .mat
    ground truth (reference ``pascalVOCLoader.setup_annotations``,
    data_loader.py:1001-1042, which writes both; VOC takes precedence for
    overlapping names, like the reference's later trainval write).
    Returns number of files written."""
    import scipy.io

    out_dir = os.path.join(voc_root, "SegmentationClassAug")
    os.makedirs(out_dir, exist_ok=True)
    count = 0

    # VOC first (authoritative for overlaps). Palette indices ARE the class
    # ids — decode through PIL 'P' mode, never cv2 (see PascalVOCDataset).
    seg_dir = os.path.join(voc_root, "SegmentationClass")
    if os.path.isdir(seg_dir):
        from PIL import Image

        for fn in sorted(os.listdir(seg_dir)):
            if not fn.endswith(".png"):
                continue
            dst = os.path.join(out_dir, fn)
            if os.path.exists(dst):
                continue
            with Image.open(os.path.join(seg_dir, fn)) as im:
                seg = np.asarray(
                    im if im.mode in ("P", "L") else im.convert("L")
                ).astype(np.uint8)
            cv2.imwrite(dst, seg)
            count += 1

    mat_dir = os.path.join(sbd_root, "dataset", "cls")
    for fn in sorted(os.listdir(mat_dir)):
        if not fn.endswith(".mat"):
            continue
        name = fn[:-4]
        dst = os.path.join(out_dir, name + ".png")
        if os.path.exists(dst):
            continue
        mat = scipy.io.loadmat(os.path.join(mat_dir, fn))
        seg = mat["GTcls"][0]["Segmentation"][0].astype(np.uint8)
        cv2.imwrite(dst, seg)
        count += 1
    return count
