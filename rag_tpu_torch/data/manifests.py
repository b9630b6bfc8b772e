"""DrivingStereo and cross-domain manifest builders: per-scene filename
lists.

Counterpart of rag_tpu/data/manifests.py, copied whole. The reference ships
only pre-built lists with absolute paths into its authors' machines (400
train / 100 test per weather scene, 4 columns "left right disp disp_R"
with the disparity path duplicated). These builders write equivalent lists
from any local DrivingStereo "different weathers" download:

    root/{scene}/left-image-half-size/<stem>.jpg
    root/{scene}/right-image-half-size/<stem>.jpg
    root/{scene}/disparity-map-half-size/<stem>.png

in the scene task order cloudy -> foggy -> rainy -> sunny, under the
reference's file names, and the Cityscapes, KITTI-raw and KITTI-stereo
lists of the cross-domain evaluation in their 3-column layouts.

The DrivingStereo split's shuffle is seeded with ``seed + hash(scene) %
1000``, as in rag_tpu: Python salts ``hash`` of a string per process, so
two processes split a scene alike only under one PYTHONHASHSEED.

Usage:
    python -m rag_tpu_torch.data.manifests /data/DrivingStereo out/filenames \
        --train 400 --test 100 --seed 0
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np

# task order: src/run.py:155-158
SCENES = ("cloudy", "foggy", "rainy", "sunny")

LEFT_DIR = "left-image-half-size"
RIGHT_DIR = "right-image-half-size"
DISP_DIR = "disparity-map-half-size"
IMG_EXTS = (".jpg", ".png", ".jpeg")


def _scan_scene(root: str, scene: str) -> List[Dict[str, str]]:
    """All complete (left, right, disp) triplets of one scene, sorted by
    frame stem (deterministic)."""
    ldir = os.path.join(root, scene, LEFT_DIR)
    rdir = os.path.join(root, scene, RIGHT_DIR)
    ddir = os.path.join(root, scene, DISP_DIR)
    if not os.path.isdir(ldir):
        raise FileNotFoundError(f"no {LEFT_DIR} under {root}/{scene}")
    triplets = []
    for fn in sorted(os.listdir(ldir)):
        stem, ext = os.path.splitext(fn)
        if ext.lower() not in IMG_EXTS:
            continue
        right = None
        for e in IMG_EXTS:
            if os.path.exists(os.path.join(rdir, stem + e)):
                right = os.path.join(rdir, stem + e)
                break
        disp = os.path.join(ddir, stem + ".png")
        if right is None or not os.path.exists(disp):
            continue  # incomplete triplet
        triplets.append({"left": os.path.join(ldir, fn), "right": right,
                         "disp": disp})
    return triplets


def _format_line(t: Dict[str, str]) -> str:
    # 4-column reference format; disp_R column duplicates disp (the
    # reference lists do the same and nothing reads column 4)
    return f"{t['left']} {t['right']} {t['disp']} {t['disp']}"


def build_drivingstereo_manifests(
    root: str,
    out_dir: str,
    train_per_scene: int = 400,
    test_per_scene: int = 100,
    seed: Optional[int] = 0,
    scenes: Sequence[str] = SCENES,
) -> Dict[str, str]:
    """Write drivingstereo_{scene}_{train,test}.txt (+ _all_ unions).

    seed: seeded shuffle before the split (None = keep sorted order).
    Returns {list_name: path}. Raises if a scene has fewer frames than
    train+test."""
    os.makedirs(out_dir, exist_ok=True)
    written: Dict[str, str] = {}
    all_train: List[str] = []
    all_test: List[str] = []
    for scene in scenes:
        triplets = _scan_scene(root, scene)
        need = train_per_scene + test_per_scene
        if len(triplets) < need:
            raise ValueError(
                f"scene {scene}: {len(triplets)} complete triplets < "
                f"{need} (train {train_per_scene} + test {test_per_scene})")
        idx = np.arange(len(triplets))
        if seed is not None:
            idx = np.random.default_rng(seed + hash(scene) % 1000).permutation(idx)
        train = [_format_line(triplets[i]) for i in idx[:train_per_scene]]
        test = [_format_line(triplets[i])
                for i in idx[train_per_scene:train_per_scene + test_per_scene]]
        for split, lines in (("train", train), ("test", test)):
            name = f"drivingstereo_{scene}_{split}.txt"
            path = os.path.join(out_dir, name)
            with open(path, "w") as f:
                f.write("\n".join(lines) + "\n")
            written[name] = path
        all_train += train
        all_test += test
    for split, lines in (("train", all_train), ("test", all_test)):
        name = f"drivingstereo_all_{split}.txt"
        path = os.path.join(out_dir, name)
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")
        written[name] = path
    return written


# ---------------------------------------------------------------------------
# Cross-domain manifests (the "4-KRCD" eval of run_rag_self.sh:4):
# KITTI 2012+2015, KITTI-raw campus drives, Cityscapes bremen. The reference
# ships these lists with absolute author-machine paths
# (src_self/filenames/cross_dataset/*.txt); these builders regenerate the
# same 3-column layouts from any local download so --eval-only cross-domain
# evaluation is reproducible without hand-written lists.
# ---------------------------------------------------------------------------


def _write_list(out_dir: str, name: str, lines: List[str],
                written: Dict[str, str]):
    path = os.path.join(out_dir, name)
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    written[name] = path


def _shuffled_split(lines: List[str], train_n: Optional[int],
                    test_n: Optional[int], seed: Optional[int]):
    idx = np.arange(len(lines))
    if seed is not None:
        idx = np.random.default_rng(seed).permutation(idx)
    if train_n is None:  # reference-like ~85/15 split
        train_n = len(lines) - (test_n or max(len(lines) // 6, 1))
    if test_n is None:
        test_n = len(lines) - train_n
    assert train_n + test_n <= len(lines), (train_n, test_n, len(lines))
    return ([lines[i] for i in idx[:train_n]],
            [lines[i] for i in idx[train_n:train_n + test_n]])


def scan_cityscapes(root: str, city: str = "bremen",
                    split: str = "train") -> List[str]:
    """3-column lines for one Cityscapes city: leftImg8bit / rightImg8bit /
    disparity (matching bremen_{train,test}.txt — the reference reads the
    disparity PNGs with the same /256 decode it uses everywhere)."""
    ldir = os.path.join(root, "leftImg8bit", split, city)
    if not os.path.isdir(ldir):
        raise FileNotFoundError(ldir)
    lines = []
    for fn in sorted(os.listdir(ldir)):
        if not fn.endswith("_leftImg8bit.png"):
            continue
        stem = fn[:-len("_leftImg8bit.png")]
        right = os.path.join(root, "rightImg8bit", split, city,
                             stem + "_rightImg8bit.png")
        disp = os.path.join(root, "disparity", split, city,
                            stem + "_disparity.png")
        if os.path.exists(right) and os.path.exists(disp):
            lines.append(f"{os.path.join(ldir, fn)} {right} {disp}")
    return lines


def build_cityscapes_manifests(root: str, out_dir: str,
                               city: str = "bremen",
                               train_n: Optional[int] = 260,
                               test_n: Optional[int] = 56,
                               seed: Optional[int] = 0) -> Dict[str, str]:
    """{city}_{train,test}.txt (reference: bremen 260/56 of the 316
    train-split frames)."""
    os.makedirs(out_dir, exist_ok=True)
    lines = scan_cityscapes(root, city)
    n = len(lines)
    train_n = min(train_n, n - 1) if train_n else None
    test_n = min(test_n, n - (train_n or 0)) if test_n else None
    train, test = _shuffled_split(lines, train_n, test_n, seed)
    written: Dict[str, str] = {}
    _write_list(out_dir, f"{city}_train.txt", train, written)
    _write_list(out_dir, f"{city}_test.txt", test, written)
    return written


def scan_kitti_raw(root: str, split: str = "train",
                   drives: Optional[Sequence[str]] = None) -> List[str]:
    """3-column lines for KITTI-raw drives with depth-annotated disparity
    (campus_{train,val}.txt layout):
        images/<date>/<drive>_sync/image_02/data/<frame>.png
        images/<date>/<drive>_sync/image_03/data/<frame>.png
        labels/data_depth_annotated/<split>/<drive>_sync/proj_disp/groundtruth/<frame>.png
    The split comes from the annotation directory itself (train/ vs val/),
    exactly like the reference's campus lists."""
    label_root = os.path.join(root, "labels", "data_depth_annotated", split)
    if not os.path.isdir(label_root):
        raise FileNotFoundError(label_root)
    lines = []
    for drive in sorted(os.listdir(label_root)):
        if drives is not None and not any(d in drive for d in drives):
            continue
        gt_dir = os.path.join(label_root, drive, "proj_disp", "groundtruth")
        if not os.path.isdir(gt_dir):
            continue
        date = drive[:10]
        img_base = os.path.join(root, "images", date, drive)
        for fn in sorted(os.listdir(gt_dir)):
            if not fn.endswith(".png"):
                continue
            left = os.path.join(img_base, "image_02", "data", fn)
            right = os.path.join(img_base, "image_03", "data", fn)
            if os.path.exists(left) and os.path.exists(right):
                lines.append(f"{left} {right} {os.path.join(gt_dir, fn)}")
    return lines


def build_kitti_raw_manifests(root: str, out_dir: str,
                              name: str = "campus",
                              drives: Optional[Sequence[str]] = None
                              ) -> Dict[str, str]:
    """{name}_{train,val}.txt from the depth-annotated train/val splits."""
    os.makedirs(out_dir, exist_ok=True)
    written: Dict[str, str] = {}
    for split in ("train", "val"):
        lines = scan_kitti_raw(root, split, drives)
        if lines:
            _write_list(out_dir, f"{name}_{split}.txt", lines, written)
    return written


def scan_kitti_stereo(root2012: Optional[str] = None,
                      root2015: Optional[str] = None) -> List[str]:
    """3-column lines for the KITTI 2012+2015 union (kitti1215_*.txt):
    2012 training/colored_0|colored_1|disp_occ, 2015
    training/image_2|image_3|disp_occ_0; only *_10.png GT frames."""
    lines = []
    layouts = []
    if root2012:
        layouts.append((root2012, "colored_0", "colored_1", "disp_occ"))
    if root2015:
        layouts.append((root2015, "image_2", "image_3", "disp_occ_0"))
    for root, l, r, d in layouts:
        ldir = os.path.join(root, "training", l)
        if not os.path.isdir(ldir):
            raise FileNotFoundError(ldir)
        for fn in sorted(os.listdir(ldir)):
            if not fn.endswith("_10.png"):
                continue
            right = os.path.join(root, "training", r, fn)
            disp = os.path.join(root, "training", d, fn)
            if os.path.exists(right) and os.path.exists(disp):
                lines.append(f"{os.path.join(ldir, fn)} {right} {disp}")
    return lines


def build_kitti_stereo_manifests(out_dir: str,
                                 root2012: Optional[str] = None,
                                 root2015: Optional[str] = None,
                                 train_n: Optional[int] = 360,
                                 val_n: Optional[int] = 34,
                                 seed: Optional[int] = 0) -> Dict[str, str]:
    """kitti1215_{train,val}.txt (reference: 360/34 of the 394 GT pairs)."""
    os.makedirs(out_dir, exist_ok=True)
    lines = scan_kitti_stereo(root2012, root2015)
    n = len(lines)
    train_n = min(train_n, n - 1) if train_n else None
    val_n = min(val_n, n - (train_n or 0)) if val_n else None
    train, val = _shuffled_split(lines, train_n, val_n, seed)
    written: Dict[str, str] = {}
    _write_list(out_dir, "kitti1215_train.txt", train, written)
    _write_list(out_dir, "kitti1215_val.txt", val, written)
    return written


def scene_lists(filenames_dir: str, scenes: Sequence[str] = SCENES):
    """(train_lists, test_lists) in task order (the CLI's
    --filenames-dir)."""
    tr = [os.path.join(filenames_dir, f"drivingstereo_{s}_train.txt")
          for s in scenes]
    te = [os.path.join(filenames_dir, f"drivingstereo_{s}_test.txt")
          for s in scenes]
    return tr, te


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("root", help="dataset root (for kitti_stereo: the "
                                "KITTI2012 root; add --root2015)")
    p.add_argument("out_dir", help="directory for the generated lists")
    p.add_argument("--dataset", default="drivingstereo",
                   choices=["drivingstereo", "cityscapes", "kitti_raw",
                            "kitti_stereo"],
                   help="list layout to build (cross-domain layouts mirror "
                        "src_self/filenames/cross_dataset)")
    p.add_argument("--train", type=int, default=None)
    p.add_argument("--test", type=int, default=None)
    p.add_argument("--seed", type=int, default=0,
                   help="split shuffle seed; --seed -1 keeps sorted order")
    p.add_argument("--city", default="bremen", help="cityscapes city")
    p.add_argument("--drives", nargs="*", default=None,
                   help="kitti_raw: restrict to drives containing these "
                        "substrings (e.g. 2011_09_28 = campus)")
    p.add_argument("--root2015", default=None,
                   help="kitti_stereo: KITTI2015 root (omit for 2012-only)")
    args = p.parse_args(argv)
    seed = None if args.seed < 0 else args.seed
    if args.dataset == "drivingstereo":
        written = build_drivingstereo_manifests(
            args.root, args.out_dir, args.train or 400, args.test or 100,
            seed)
    elif args.dataset == "cityscapes":
        written = build_cityscapes_manifests(
            args.root, args.out_dir, city=args.city,
            train_n=args.train or 260, test_n=args.test or 56, seed=seed)
    elif args.dataset == "kitti_raw":
        written = build_kitti_raw_manifests(args.root, args.out_dir,
                                            drives=args.drives)
    else:
        written = build_kitti_stereo_manifests(
            args.out_dir, root2012=args.root, root2015=args.root2015,
            train_n=args.train or 360, val_n=args.test or 34, seed=seed)
    for name, path in sorted(written.items()):
        with open(path) as f:
            n = sum(1 for _ in f)
        print(f"{name}: {n} lines -> {path}")


if __name__ == "__main__":
    main()
