"""The file datasets of the port against rag_tpu's, on the CPU: readers,
StereoDataset, the native data plane and the manifest builders.

Every case writes its own files under ``tmp_path``; nothing here compiles
a JAX step (rag_tpu's data modules are numpy).
- Readers bit for bit: PFM colour and gray in both byte orders, 8-bit RGB
  PNG, 16-bit disparity PNG, ImageNet normalization, ``resize_bilinear``,
  ``read_all_lines``.
- ``StereoDataset.get`` / ``batches`` on the Python path (crop, pad,
  ``resize_wide``, ``indices``, ``drop_last``): the port's tensors hold
  rag_tpu's numpy batches exactly.
- The two native libraries (each package builds its own): decoders equal,
  ``NativeStereoLoader(n_threads=1)`` batches equal; with 4 threads every
  sample is a valid crop of some entry. Which path a dataset takes is
  explicit, and ``native=True`` with a source that cannot build raises.
- The DrivingStereo, Cityscapes, KITTI-raw and KITTI-stereo builders,
  ``scene_lists`` and ``main`` write identical files.
- The port's sources name no path under rag_tpu/ and read no environment
  variable; its native library is built under build/.
"""

import os
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from cpu_threads import one_torch_thread  # noqa: F401 (autouse)
from rag_tpu.data import manifests as jman
from rag_tpu.data import readers as jread
from rag_tpu.data import stereo_dataset as jds
from rag_tpu.runtime import native as jnative
from rag_tpu_torch.data import manifests as tman
from rag_tpu_torch.data import readers as tread
from rag_tpu_torch.data import stereo_dataset as tds
from rag_tpu_torch.ops.cuda_lib import BUILD_ROOT
from rag_tpu_torch.runtime import native as tnative

ROOT = Path(__file__).resolve().parent.parent
KEYS = ("left", "right", "disparity")


def _png(path, arr):
    Image.fromarray(arr).save(path)
    return str(path)


def _pfm(path, arr, little=True, scale=1.0):
    color = arr.ndim == 3
    with open(path, "wb") as f:
        f.write(b"PF\n" if color else b"Pf\n")
        f.write(f"{arr.shape[1]} {arr.shape[0]}\n".encode())
        f.write(f"{-scale if little else scale}\n".encode())
        f.write(np.flipud(arr).astype("<f4" if little else ">f4").tobytes())
    return str(path)


def _scene(tmp_path, n=5, h=30, w=52, name="s", pfm=False, seed=0):
    """n frames: RGB left/right PNGs, disparity as a 16-bit PNG (or PFM);
    returns the list file (4 columns)."""
    d = tmp_path / name
    d.mkdir(exist_ok=True)
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(n):
        lp = _png(d / f"l{i}.png", rng.integers(0, 256, (h, w, 3), np.uint8))
        rp = _png(d / f"r{i}.png", rng.integers(0, 256, (h, w, 3), np.uint8))
        disp = rng.uniform(0, 40, (h, w))
        dp = (_pfm(d / f"d{i}.pfm", disp.astype(np.float32)) if pfm else
              _png(d / f"d{i}.png", (disp * 256).astype(np.uint16)))
        lines.append(f"{lp} {rp} {dp} {dp}")
    lst = tmp_path / f"{name}.txt"
    lst.write_text("\n".join(lines) + "\n")
    return str(lst)


def _np(batch):
    assert all(isinstance(batch[k], torch.Tensor) and
               batch[k].device.type == "cpu" and
               batch[k].dtype == torch.float32 for k in KEYS)
    return {k: batch[k].numpy() for k in KEYS}


def _assert_batches_equal(tb, jb):
    tb, jb = list(tb), list(jb)
    assert len(tb) == len(jb) and tb
    for t, j in zip(tb, jb):
        t = _np(t)
        for k in KEYS:
            assert t[k].shape == j[k].shape and t[k].dtype == j[k].dtype, k
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)


# -- readers ------------------------------------------------------------------

@pytest.mark.parametrize("color", [False, True])
@pytest.mark.parametrize("little", [True, False])
def test_read_pfm_matches(tmp_path, color, little):
    rng = np.random.default_rng(1)
    arr = rng.standard_normal((7, 11, 3) if color else (7, 11)).astype(np.float32)
    p = _pfm(tmp_path / "x.pfm", arr, little=little, scale=2.5)
    (t, ts), (j, js) = tread.read_pfm(p), jread.read_pfm(p)
    assert ts == js == 2.5 and t.dtype == j.dtype == np.float32
    np.testing.assert_array_equal(t, j)
    np.testing.assert_array_equal(t, arr)


def test_read_png_and_normalization_match(tmp_path):
    rng = np.random.default_rng(2)
    rgb = _png(tmp_path / "c.png", rng.integers(0, 256, (9, 13, 3), np.uint8))
    d16 = _png(tmp_path / "d.png", rng.integers(0, 65535, (9, 13), np.uint16))
    for t, j in ((tread.read_image(rgb), jread.read_image(rgb)),
                 (tread.read_png_disparity(d16), jread.read_png_disparity(d16))):
        assert t.dtype == j.dtype == np.float32
        np.testing.assert_array_equal(t, j)
    img = tread.read_image(rgb)
    norm = tread.normalize_imagenet(img)
    np.testing.assert_array_equal(norm, jread.normalize_imagenet(img))
    np.testing.assert_array_equal(tread.denormalize_imagenet(norm),
                                  jread.denormalize_imagenet(norm))
    lst = tmp_path / "l.txt"
    lst.write_text("a b c\n\n  d e f  \n")
    assert tread.read_all_lines(str(lst)) == jread.read_all_lines(str(lst))
    assert tds.load_file_list(str(lst)) == jds.load_file_list(str(lst))


@pytest.mark.parametrize("shape,out", [((9, 13), (5, 21)), ((9, 13, 3), (16, 7)),
                                       ((24, 40, 3), (24, 40))])
def test_resize_bilinear_matches(shape, out):
    img = np.random.default_rng(3).uniform(-2, 2, shape).astype(np.float32)
    t, j = tread.resize_bilinear(img, *out), jread.resize_bilinear(img, *out)
    assert t.dtype == j.dtype == np.float32 and t.shape == out + shape[2:]
    np.testing.assert_array_equal(t, j)


def test_protocol_constants_match():
    for k in ("TRAIN_CROP", "EVAL_PAD", "SELFSUP_EVAL_PAD",
              "SCENEFLOW_EVAL_PAD", "WIDE_THRESHOLD", "WIDE_RESIZE"):
        assert getattr(tds, k) == getattr(jds, k), k


# -- StereoDataset, Python path ----------------------------------------------

@pytest.fixture
def python_io(monkeypatch):
    """rag_tpu's datasets on their Python path (its env switch)."""
    monkeypatch.setenv("RAG_TPU_NATIVE_IO", "0")


@pytest.mark.parametrize("pfm", [False, True])
@pytest.mark.parametrize("drop_last", [True, False])
def test_training_batches_match(tmp_path, python_io, pfm, drop_last):
    lst = _scene(tmp_path, pfm=pfm)
    kw = dict(crop=(24, 12))
    t = tds.StereoDataset(lst, True, native=False, device="cpu", **kw)
    j = jds.StereoDataset(lst, True, **kw)
    for seed in (0, 3):
        _assert_batches_equal(t.batches(2, True, seed=seed, drop_last=drop_last),
                              j.batches(2, True, seed=seed, drop_last=drop_last))
    _assert_batches_equal(t.batches(2, False, indices=[4, 1, 2]),
                          j.batches(2, False, indices=[4, 1, 2]))
    assert not t.used_native and not j.used_native


def test_eval_batches_and_get_match(tmp_path):
    lst = _scene(tmp_path, n=3)
    t = tds.StereoDataset(lst, False, pad=(60, 36), device="cpu")
    j = jds.StereoDataset(lst, False, pad=(60, 36))
    _assert_batches_equal(t.batches(1, False, drop_last=False),
                          j.batches(1, False, drop_last=False))
    _assert_batches_equal(t.batches(2, False, drop_last=False),
                          j.batches(2, False, drop_last=False))
    gt, gj = t.get(1), j.get(1)
    assert gt.keys() == gj.keys()
    assert (gt["top_pad"], gt["right_pad"]) == (gj["top_pad"], gj["right_pad"]) == (6, 8)
    for k in KEYS:
        np.testing.assert_array_equal(gt[k], gj[k])
    with pytest.raises(ValueError):
        tds.StereoDataset(lst, False, pad=(40, 36), device="cpu").get(0)


def test_resize_wide_matches(tmp_path):
    """A frame over 1800 px wide resizes to 1024x512 with its disparity
    halved, then pads; a narrow one only pads."""
    wide = _scene(tmp_path, n=1, h=20, w=1830, name="wide")
    narrow = _scene(tmp_path, n=1, h=20, w=52, name="narrow")
    for lst in (wide, narrow):
        t = tds.StereoDataset(lst, False, pad=(1248, 576), resize_wide=True,
                              device="cpu")
        j = jds.StereoDataset(lst, False, pad=(1248, 576), resize_wide=True)
        _assert_batches_equal(t.batches(1, False, drop_last=False),
                              j.batches(1, False, drop_last=False))
    g = tds.StereoDataset(wide, False, pad=(1248, 576), resize_wide=True,
                          device="cpu").get(0)
    assert (g["top_pad"], g["right_pad"]) == (576 - 512, 1248 - 1024)
    assert not tds.StereoDataset(wide, True, resize_wide=True,
                                 device="cpu").native_eligible()


# -- the native data plane ---------------------------------------------------

def test_native_library_lives_under_build():
    lib = tnative.build()
    assert lib.is_file() and BUILD_ROOT in lib.parents
    assert tnative.native_available() and jnative.native_available()


def test_native_decoders_match(tmp_path):
    rng = np.random.default_rng(4)
    rgb = _png(tmp_path / "c.png", rng.integers(0, 256, (17, 23, 3), np.uint8))
    d16 = _png(tmp_path / "d.png", rng.integers(0, 65535, (17, 23), np.uint16))
    for p in (rgb, d16):
        np.testing.assert_array_equal(tnative.read_png_native(p),
                                      jnative.read_png_native(p))
    np.testing.assert_array_equal(tnative.read_png_native(rgb),
                                  tread.read_image(rgb))
    for color in (False, True):
        arr = rng.standard_normal((5, 9, 3) if color else (5, 9))
        p = _pfm(tmp_path / f"x{color}.pfm", arr.astype(np.float32))
        np.testing.assert_array_equal(tnative.read_pfm_native(p),
                                      jnative.read_pfm_native(p))
        np.testing.assert_array_equal(tnative.read_pfm_native(p),
                                      tread.read_pfm(p)[0])


@pytest.mark.parametrize("training", [True, False])
def test_single_thread_loaders_match(tmp_path, training):
    """One worker: both packages' loaders give the same samples in the same
    order (crops from one mt19937 stream, or the padded frames)."""
    entries = [ln.split()[:3] for ln in
               Path(_scene(tmp_path, n=3, pfm=not training)).read_text().split("\n")
               if ln]
    kw = dict(crop=(24, 12), pad=(60, 36), n_threads=1, seed=7)
    t = tnative.NativeStereoLoader(entries, training, **kw)
    j = jnative.NativeStereoLoader(entries, training, **kw)
    try:
        for batch in (2, 3, 4):
            bt, bj = t.next_batch(batch), j.next_batch(batch)
            for k in KEYS:
                np.testing.assert_array_equal(bt[k], bj[k], err_msg=k)
    finally:
        t.close()
        j.close()


def _valid_crop(sample, frames, crop):
    """Whether (left, right, disparity) is one crop of one entry."""
    cw, ch = crop
    for left, right, disp in frames:
        h, w = disp.shape
        for y in range(h - ch + 1):
            for x in range(w - cw + 1):
                if (np.array_equal(sample[2], disp[y:y + ch, x:x + cw])
                        and np.array_equal(sample[0], left[y:y + ch, x:x + cw])
                        and np.array_equal(sample[1], right[y:y + ch, x:x + cw])):
                    return True
    return False


def test_threaded_native_dataset_gives_valid_crops(tmp_path):
    """The default path of an eligible training set: four workers, the
    order the scheduler's; every sample is a crop of some entry as the
    Python readers decode it, and the batches are tensors on the device."""
    lst = _scene(tmp_path, n=3, h=14, w=26)
    ds = tds.StereoDataset(lst, True, crop=(16, 8), device="cpu")
    assert ds.native_eligible()
    frames = []
    for e in ds.entries:
        frames.append((tread.normalize_imagenet(tread.read_image(e[0])),
                       tread.normalize_imagenet(tread.read_image(e[1])),
                       tread.read_png_disparity(e[2])))
    n = 0
    for epoch in range(3):
        for b in ds.batches(2, True, seed=epoch, drop_last=False):
            b = _np(b)
            assert b["left"].shape == (b["left"].shape[0], 8, 16, 3)
            for i in range(b["left"].shape[0]):
                assert _valid_crop([b[k][i] for k in KEYS], frames, (16, 8))
                n += 1
    assert ds.used_native and n == 9


@pytest.mark.parametrize("case", ["eval", "indices", "native_off", "jpg"])
def test_python_path_where_not_eligible(tmp_path, case):
    lst = _scene(tmp_path, n=2)
    if case == "jpg":
        lines = Path(lst).read_text().replace("l0.png", "l0.jpg")
        Image.open(tmp_path / "s" / "l0.png").save(tmp_path / "s" / "l0.jpg")
        Path(lst).write_text(lines)
    ds = tds.StereoDataset(lst, case != "eval", crop=(24, 12), pad=(60, 36),
                           native=case != "native_off", device="cpu")
    kw = {"indices": [1, 0]} if case == "indices" else {}
    assert len(list(ds.batches(1, False, **kw))) == 2
    assert not ds.used_native


def test_native_build_failure_raises(tmp_path, monkeypatch):
    """native=True where the library cannot build: the compiler's output
    is raised, and no Python path stands in."""
    bad = tmp_path / "rag_runtime.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tnative, "SRC", bad)
    assert not tnative.native_available()
    ds = tds.StereoDataset(_scene(tmp_path, n=2), True, crop=(24, 12),
                           device="cpu")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        next(ds.batches(2, True))
    assert not ds.used_native


# -- manifests ---------------------------------------------------------------

def _touch(path):
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(b"")


def _fake_drivingstereo(root, n=7):
    for scene in tman.SCENES:
        for i in range(n):
            stem = f"2018-10-{i:02d}"
            _touch(root / scene / tman.LEFT_DIR / f"{stem}.jpg")
            if i != 3:  # one incomplete triplet a scene
                _touch(root / scene / tman.RIGHT_DIR / f"{stem}.jpg")
            _touch(root / scene / tman.DISP_DIR / f"{stem}.png")
        _touch(root / scene / tman.LEFT_DIR / "notes.txt")


def _same_files(a: Path, b: Path):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)) and names
    for n in names:
        assert (a / n).read_bytes() == (b / n).read_bytes(), n


@pytest.mark.parametrize("seed", [0, None])
def test_drivingstereo_manifests_match(tmp_path, seed):
    root = tmp_path / "ds"
    _fake_drivingstereo(root)
    wt = tman.build_drivingstereo_manifests(str(root), str(tmp_path / "t"),
                                            4, 2, seed=seed)
    wj = jman.build_drivingstereo_manifests(str(root), str(tmp_path / "j"),
                                            4, 2, seed=seed)
    assert sorted(wt) == sorted(wj) and len(wt) == 10
    _same_files(tmp_path / "t", tmp_path / "j")
    tr, te = tman.scene_lists(str(tmp_path / "t"))
    assert (tr, te) == jman.scene_lists(str(tmp_path / "t"))
    assert all(len(Path(p).read_text().split("\n")[0].split()) == 4 for p in tr)
    with pytest.raises(ValueError):
        tman.build_drivingstereo_manifests(str(root), str(tmp_path / "x"), 5, 2)


def test_cross_domain_manifests_match(tmp_path):
    root = tmp_path / "data"
    for i in range(8):  # Cityscapes bremen
        stem = f"bremen_{i:06d}_000019"
        _touch(root / "cs" / "leftImg8bit" / "train" / "bremen" / f"{stem}_leftImg8bit.png")
        _touch(root / "cs" / "rightImg8bit" / "train" / "bremen" / f"{stem}_rightImg8bit.png")
        _touch(root / "cs" / "disparity" / "train" / "bremen" / f"{stem}_disparity.png")
    for split, drive in (("train", "2011_09_28_drive_0001_sync"),
                         ("val", "2011_09_26_drive_0002_sync")):  # KITTI raw
        for i in range(3):
            fn = f"{i:010d}.png"
            _touch(root / "raw" / "labels" / "data_depth_annotated" / split
                   / drive / "proj_disp" / "groundtruth" / fn)
            for cam in ("image_02", "image_03"):
                _touch(root / "raw" / "images" / drive[:10] / drive / cam / "data" / fn)
    for year, dirs in (("2012", ("colored_0", "colored_1", "disp_occ")),
                       ("2015", ("image_2", "image_3", "disp_occ_0"))):
        for i in range(5):
            for d in dirs:
                _touch(root / year / "training" / d / f"{i:06d}_10.png")
            _touch(root / year / "training" / dirs[0] / f"{i:06d}_11.png")
    for pkg, out in ((tman, tmp_path / "t"), (jman, tmp_path / "j")):
        pkg.build_cityscapes_manifests(str(root / "cs"), str(out), train_n=5,
                                       test_n=2)
        pkg.build_kitti_raw_manifests(str(root / "raw"), str(out))
        pkg.build_kitti_stereo_manifests(str(out), str(root / "2012"),
                                         str(root / "2015"), train_n=7, val_n=2)
    _same_files(tmp_path / "t", tmp_path / "j")
    assert len(os.listdir(tmp_path / "t")) == 6


def test_manifest_main_matches(tmp_path, capsys):
    root = tmp_path / "ds"
    _fake_drivingstereo(root)
    argv = ["--train", "3", "--test", "2", "--seed", "0"]
    tman.main([str(root), str(tmp_path / "t"), *argv])
    out_t = capsys.readouterr().out
    jman.main([str(root), str(tmp_path / "j"), *argv])
    out_j = capsys.readouterr().out
    _same_files(tmp_path / "t", tmp_path / "j")
    assert out_t.replace(str(tmp_path / "t"), "") == \
        out_j.replace(str(tmp_path / "j"), "")


# -- the port's sources --------------------------------------------------------

def _code(path: Path) -> str:
    """A source file without comments and docstrings."""
    text = path.read_text()
    if path.suffix == ".py":
        text = re.sub(r'"""[\s\S]*?"""', "", text)
        return "\n".join(line.split("#")[0] for line in text.splitlines())
    text = re.sub(r"/\*[\s\S]*?\*/", "", text)
    return "\n".join(line.split("//")[0] for line in text.splitlines())


def test_port_names_no_rag_tpu_path_and_reads_no_env():
    """No source of the port names a path under rag_tpu/ in its code (its
    native library is built from its own copy of the C++ source), and
    neither the port nor chip_smoke.py reads an environment variable.
    (chip_smoke.py names the TPU kernels' sites in its report.)"""
    files = [p for p in sorted((ROOT / "rag_tpu_torch").rglob("*"))
             if p.suffix in (".py", ".cpp", ".cu", ".cuh")]
    path_re = re.compile(r"""["'](\.\./)*rag_tpu["'/\\]|/\s*["']rag_tpu["']""")
    env_re = re.compile(r"\bos\.environ\b|\bgetenv\b|\bos\.putenv\b")
    bad = []
    for p in files + [ROOT / "chip_smoke.py"]:
        code = _code(p)
        res = (path_re, env_re) if p in files else (env_re,)
        bad += [f"{p.relative_to(ROOT)}: {m.group(0)}"
                for r in res for m in r.finditer(code)]
    assert not bad, bad
    assert tnative.SRC.parent == ROOT / "rag_tpu_torch" / "runtime"
