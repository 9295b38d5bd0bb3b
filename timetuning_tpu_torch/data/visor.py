# The port's own copy of timetuning_tpu/data/visor.py (host code, no JAX);
# tests/test_torch_host_copies.py pins it to the original.
"""EPIC-VISOR → DAVIS-layout conversion utilities.

Reference: visor_handler.py:7-93 — unzip sparse VISOR releases and reshape
them into ``JPEGImages/<video>/*.jpg`` + ``Annotations/<video>/*.png`` trees.
"""

from __future__ import annotations

import os
import shutil
import zipfile


def extract_zips(zip_dir: str, out_dir: str) -> list[str]:
    """Extract every zip in ``zip_dir`` into ``out_dir``; returns the
    extracted top-level directories."""
    os.makedirs(out_dir, exist_ok=True)
    extracted: list[str] = []
    seen: set[str] = set()
    for fn in sorted(os.listdir(zip_dir)):
        if not fn.endswith(".zip"):
            continue
        with zipfile.ZipFile(os.path.join(zip_dir, fn)) as zf:
            zf.extractall(out_dir)
            # report what was ACTUALLY extracted — a zip's members need
            # not live under a directory named like the zip file
            for name in zf.namelist():
                top = name.split("/", 1)[0]
                if top and top not in seen:
                    seen.add(top)
                    extracted.append(os.path.join(out_dir, top))
    return extracted


def group_frames_by_video(flat_dir: str, out_root: str, sep: str = "_frame_") -> int:
    """VISOR names frames ``<video>_frame_<idx>.jpg`` in one flat directory;
    regroup them into per-video subdirectories (DAVIS layout). Returns the
    number of videos created."""
    os.makedirs(out_root, exist_ok=True)
    videos = set()
    for fn in sorted(os.listdir(flat_dir)):
        base, ext = os.path.splitext(fn)
        if sep not in base:
            continue
        video, frame = base.rsplit(sep, 1)
        vdir = os.path.join(out_root, video)
        os.makedirs(vdir, exist_ok=True)
        shutil.copy2(os.path.join(flat_dir, fn), os.path.join(vdir, frame + ext))
        videos.add(video)
    return len(videos)


def visor_to_davis(visor_root: str, out_root: str) -> None:
    """Full conversion: images + annotations into DAVIS-style trees."""
    group_frames_by_video(
        os.path.join(visor_root, "images"), os.path.join(out_root, "JPEGImages")
    )
    group_frames_by_video(
        os.path.join(visor_root, "annotations"), os.path.join(out_root, "Annotations")
    )
