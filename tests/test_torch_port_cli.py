"""The port's CLI against rag_tpu's, on the CPU.

- ``build_parser``: the same flags, and the same values for every flag
  for an empty argv and for a full one.
- ``main``'s configuration: for the same argv, the ExperimentConfig (cell,
  op and fine-tune stages), the stage-file cadence and the resume flag the
  driver gets equal rag_tpu's field by field, the mesh's and the
  scene-parallel search's included. Both drivers are stopped before any
  work.
- ``make_datasets``: equal batches, for styled synthetic scenes and for
  filename lists (``--filenames-dir`` of generated DrivingStereo lists;
  rag_tpu's native switch off, the port's datasets ``native=False``, so
  both read through the Python path).
- One tiny real-file run of the port's CLI on the CPU (PNG files, a
  filename list, stage checkpoints): ``result.json`` with rag_tpu's keys,
  the checkpoint, and ``--eval-only`` reading it back.
- The variants: ``--variant selfsup|depth`` build rag_tpu's driver
  class, config and datasets (the depth scenes and the selfsup pretrain
  and proxy sets equal rag_tpu's batches), and a 2-task run of each on
  the CPU writes a finite ``result.json`` with zero forgetting;
  ``--eval-only`` of the committed depth checkpoint reports rag_tpu's
  depth metrics.
- ``--bf16`` reaches the config as ``Precision(torch.bfloat16)`` where
  rag_tpu's flag sets its compute dtype to bfloat16, the spatial
  ``--mesh D M`` and ``--scene-parallel-search`` reach the config as
  rag_tpu's parser gives them, and without CUDA ``main`` raises unless
  asked for the CPU. The config's ``precision`` is float32 without it.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from cpu_threads import one_torch_thread  # noqa: F401 (autouse)
from rag_tpu import cli as jcli
from rag_tpu.continual import driver as jdriver
from rag_tpu_torch import cli as tcli
from rag_tpu_torch.continual import driver as tdriver
from rag_tpu_torch.data import manifests as tman
from rag_tpu_torch.ops.precision import Precision

KEYS = ("left", "right", "disparity")
FULL_ARGV = [
    "--seed", "3", "--experiment", "x", "--id", "7", "--output", "out",
    "--data-root", "/d", "--train-lists", "a.txt", "b.txt",
    "--test-lists", "c.txt", "--filenames-dir", "f", "--synthetic",
    "--synthetic-size", "5", "--synthetic-hw", "24", "48",
    "--synthetic-eval-hw", "36", "72", "--synthetic-eval-size", "3",
    "--c_epochs", "2", "--c_batch", "3", "--c_lr", "0.1", "--c_lr_a", "0.2",
    "--c_lamb", "0.3", "--skip-cell-search", "--o_epochs", "4",
    "--o_batch", "5", "--o_lr", "0.4", "--o_lr_a", "0.5", "--o_lamb", "0.6",
    "--o_size", "7", "--epochs", "8", "--batch", "9", "--lr", "0.7",
    "--lamb", "0.8", "--pretrain-epochs", "2", "--pretrain-batch", "3",
    "--pretrain-lr", "0.01", "--pretrain-list", "p.txt", "--proxy-list",
    "q.txt", "--num-tasks", "3", "--maxdisp", "96", "--train-router",
    "--router-epochs", "2", "--mesh", "1", "--checkpoint-dir", "ck",
    "--resume", "--stage-checkpoint-every", "5", "--eval-lists", "e.txt",
    "--eval-pad", "96", "192", "--train-crop", "48", "96", "--eval-task",
    "1", "--use-router"]


def _option_strings(parser):
    return sorted(s for a in parser._actions for s in a.option_strings)


@pytest.mark.parametrize("argv", [[], FULL_ARGV], ids=["defaults", "full"])
def test_parser_matches(argv):
    tp, jp = tcli.build_parser(), jcli.build_parser()
    assert _option_strings(tp) == _option_strings(jp)
    assert vars(tp.parse_args(argv)) == vars(jp.parse_args(argv))


class _Stop(Exception):
    pass


def _capture(base):
    """A driver class that records its config, cadence and resume flag at
    run() and stops there."""
    seen = {}

    class Capture(base):
        def run(self, train, valid, test, resume=False):
            seen.update(cfg=self.cfg, every=self.stage_checkpoint_every,
                        resume=resume, data=(train, valid, test))
            raise _Stop

    return Capture, seen


@pytest.mark.parametrize("extra", [
    [],
    ["--c_epochs", "3", "--c_batch", "2", "--c_lr", "0.004", "--c_lr_a", "0.5",
     "--c_lamb", "0.001", "--o_epochs", "4", "--o_batch", "2", "--o_lr",
     "0.002", "--o_lr_a", "0.3", "--o_lamb", "0.002", "--o_size", "3",
     "--epochs", "5", "--batch", "2", "--lr", "0.01", "--lamb", "0.004",
     "--num-tasks", "2", "--seed", "4", "--maxdisp", "96", "--train-router",
     "--router-epochs", "1", "--skip-cell-search", "--resume",
     "--stage-checkpoint-every", "2"]], ids=["defaults", "set"])
def test_config_matches(tmp_path, monkeypatch, extra):
    argv = ["--synthetic", "--synthetic-size", "2", "--synthetic-hw", "24",
            "48", "--output", str(tmp_path / "logs")] + extra
    tcls, t = _capture(tdriver.ContinualDriver)
    with pytest.raises(_Stop):
        tcli.main(argv, device="cpu", driver_cls=tcls)
    jcls, j = _capture(jdriver.ContinualDriver)
    monkeypatch.setattr(jdriver, "ContinualDriver", jcls)
    with pytest.raises(_Stop):
        jcli.main(argv)
    tc, jc = dataclasses.asdict(t["cfg"]), dataclasses.asdict(j["cfg"])
    for stage in ("cell", "train"):
        assert tc.pop(stage) == jc.pop(stage), stage
    assert tc.pop("op") == jc.pop("op")
    # rag_tpu keeps its precision in the environment, the port in the config
    assert tc.pop("precision") == dataclasses.asdict(Precision())
    assert tc == jc
    assert (t["every"], t["resume"]) == (j["every"], j["resume"])
    for td, jd in zip(t["data"], j["data"]):
        assert [len(d) for d in td] == [len(d) for d in jd]


def _write_frame(d, i, h, w, shift, rng):
    left = np.repeat(rng.integers(0, 256, (h, -(-w // 4), 3), np.uint8), 4,
                     axis=1)[:, :w]
    right = np.roll(left, -shift, axis=1)
    disp = np.full((h, w), shift * 256, np.uint16)
    paths = []
    for name, arr in (("l", left), ("r", right), ("d", disp)):
        p = os.path.join(d, f"{name}{i}.png")
        Image.fromarray(arr).save(p)
        paths.append(p)
    return paths


def _drivingstereo(root, n, h, w):
    """A fake DrivingStereo tree (PNG frames) of the four weather scenes."""
    rng = np.random.default_rng(0)
    for s in tman.SCENES:
        dirs = [os.path.join(root, s, k) for k in
                (tman.LEFT_DIR, tman.RIGHT_DIR, tman.DISP_DIR)]
        for d in dirs:
            os.makedirs(d, exist_ok=True)
        for i in range(n):
            for src, dst in zip(_write_frame(str(root), i, h, w, 4, rng), dirs):
                os.replace(src, os.path.join(dst, f"f{i:03d}.png"))


def _equal_batches(tds, jds, *args, **kw):
    tb, jb = list(tds.batches(*args, **kw)), list(jds.batches(*args, **kw))
    assert len(tb) == len(jb) and tb
    for t, j in zip(tb, jb):
        for k in KEYS:
            assert isinstance(t[k], torch.Tensor) and t[k].device.type == "cpu"
            np.testing.assert_array_equal(t[k].numpy(), np.asarray(j[k]),
                                          err_msg=k)


def test_make_datasets_synthetic_match():
    argv = ["--synthetic", "--synthetic-size", "3", "--synthetic-hw", "24",
            "48", "--synthetic-eval-hw", "36", "48", "--synthetic-eval-size",
            "2", "--num-tasks", "2", "--maxdisp", "96"]
    tsets = tcli.make_datasets(tcli.build_parser().parse_args(argv), "cpu")
    jsets = jcli.make_datasets(jcli.build_parser().parse_args(argv))
    for tg, jg in zip(tsets, jsets):
        for td, jd in zip(tg, jg):
            assert (td.h, td.w, td.seed, td.max_disp, td.style) == \
                (jd.h, jd.w, jd.seed, jd.max_disp, jd.style)
            _equal_batches(td, jd, 2, True, seed=1, drop_last=False)


def test_make_datasets_file_lists_match(tmp_path, monkeypatch):
    monkeypatch.setenv("RAG_TPU_NATIVE_IO", "0")
    _drivingstereo(tmp_path / "ds", 5, 30, 52)
    tman.build_drivingstereo_manifests(str(tmp_path / "ds"),
                                       str(tmp_path / "lists"), 3, 2)
    argv = ["--filenames-dir", str(tmp_path / "lists"), "--num-tasks", "2",
            "--train-crop", "12", "24", "--eval-pad", "36", "60"]
    targs = tcli.build_parser().parse_args(argv)
    jargs = jcli.build_parser().parse_args(argv)
    tsets = tcli.make_datasets(targs, "cpu")
    jsets = jcli.make_datasets(jargs)
    assert targs.train_lists == jargs.train_lists and len(targs.train_lists) == 2
    assert targs.test_lists == jargs.test_lists
    for group, (tg, jg) in enumerate(zip(tsets, jsets)):
        for td, jd in zip(tg, jg):
            assert (td.training, td.crop, td.pad) == \
                (jd.training, jd.crop, jd.pad)
            td.native = False   # the Python path, as rag_tpu's switch sets
            _equal_batches(td, jd, 2 if group == 0 else 1, group == 0,
                           seed=2, drop_last=False)


def test_real_file_run_and_eval_only(tmp_path):
    """A 1-task run over PNG lists (the training set streams through the
    port's native loader), then --eval-only of its checkpoint."""
    rng = np.random.default_rng(1)
    lists = {}
    for split, n in (("train", 4), ("test", 2)):
        d = tmp_path / split
        d.mkdir()
        lines = [" ".join(p + [p[2]]) for p in
                 (_write_frame(str(d), i, 36, 72, 4, rng) for i in range(n))]
        lists[split] = str(tmp_path / f"{split}.txt")
        with open(lists[split], "w") as f:
            f.write("\n".join(lines) + "\n")
    out, ckpt = str(tmp_path / "logs"), str(tmp_path / "ckpt")
    seen = {}

    class Driver(tdriver.ContinualDriver):
        def run(self, train, valid, test, resume=False):
            seen["train"] = train
            return super().run(train, valid, test, resume)

    matrix = tcli.main([
        "--train-lists", lists["train"], "--test-lists", lists["test"],
        "--num-tasks", "1", "--id", "realfile", "--output", out,
        "--checkpoint-dir", ckpt, "--c_epochs", "1", "--c_batch", "2",
        "--epochs", "1", "--batch", "2", "--train-crop", "24", "48",
        "--eval-pad", "36", "72", "--maxdisp", "24",
        "--stage-checkpoint-every", "1"], device="cpu", driver_cls=Driver,
        log=lambda *_: None)
    assert seen["train"][0].used_native
    with open(os.path.join(out, "drivingstereo_rag_0_realfile",
                           "result.json")) as f:
        result = json.load(f)
    assert sorted(result) == sorted(
        ["D1", "EPE", "loss", "Thres1", "Thres2", "Thres3", "mean_D1",
         "model_size_m", "elapsed_h"])
    assert result["EPE"] == matrix.m["EPE"].tolist()
    assert np.isfinite(result["mean_D1"])
    assert sorted(os.listdir(ckpt)) == ["arrays_task0.npz", "genotype_t0.json",
                                        "manifest_task0.json"]
    results = tcli.main(["--eval-only", "--checkpoint-dir", ckpt,
                         "--eval-lists", lists["test"], "--eval-pad", "36",
                         "72", "--maxdisp", "24"], device="cpu")
    assert list(results) == [lists["test"]]
    for k in ("D1", "EPE", "loss"):
        assert results[lists["test"]][k] == pytest.approx(
            matrix.m[k][0, 0], rel=1e-6, abs=0), k


# the id the case had when --bf16 was the part not ported: it now checks
# that the flag is ported
@pytest.mark.parametrize("argv", [["--bf16"]], ids=["argv5"])
def test_unported_flags_raise(tmp_path, monkeypatch, argv):
    """``--bf16`` no longer raises: the port's run gets
    ``Precision(torch.bfloat16)`` in its config where rag_tpu's flag sets
    its compute dtype to bfloat16. Both drivers are stopped before any
    work."""
    argv = argv + ["--synthetic", "--synthetic-size", "2", "--synthetic-hw",
                   "24", "48", "--output", str(tmp_path / "logs")]
    tcls, t = _capture(tdriver.ContinualDriver)
    with pytest.raises(_Stop):
        tcli.main(argv, device="cpu", driver_cls=tcls)
    assert t["cfg"].precision == Precision(torch.bfloat16)
    from rag_tpu.ops.precision import compute_dtype, feature_dtype

    monkeypatch.setenv("RAG_TPU_COMPUTE_DTYPE", "float32")  # restored after
    jcls, _ = _capture(jdriver.ContinualDriver)
    monkeypatch.setattr(jdriver, "ContinualDriver", jcls)
    with pytest.raises(_Stop):
        jcli.main(argv)
    # the port's feature net rides its compute dtype, as rag_tpu's does
    assert str(compute_dtype()) == str(feature_dtype()) == "bfloat16"


@pytest.mark.parametrize("argv", [
    ["--mesh", "2", "2"], ["--mesh", "1", "2"], ["--scene-parallel-search"]],
    ids=["argv2", "argv3", "argv4"])
def test_spatial_and_scene_parallel_flags_pass(argv):
    """The spatial axis and the scene-parallel search are ported: the
    config carries rag_tpu's mesh and search fields."""
    args = tcli.build_parser().parse_args(argv)
    jargs = jcli.build_parser().parse_args(argv)
    cfg = tcli.make_config(args)
    mesh = (jargs.mesh + [1])[:2] if jargs.mesh else [1, 1]
    assert [cfg.mesh_data, cfg.mesh_model] == mesh
    assert cfg.scene_parallel_search == jargs.scene_parallel_search


VARIANT_ARGV = ["--synthetic", "--synthetic-size", "4", "--synthetic-hw",
                "24", "48", "--num-tasks", "2", "--c_epochs", "1",
                "--c_batch", "2", "--o_epochs", "1", "--o_batch", "2",
                "--epochs", "1", "--batch", "2", "--maxdisp", "48",
                "--pretrain-epochs", "1", "--pretrain-batch", "2",
                "--train-router", "--router-epochs", "1"]
VARIANT_KEYS = {
    "selfsup": ["D1", "EPE", "loss", "Thres1", "Thres2", "Thres3", "mean_D1"],
    "depth": ["loss", "silog", "abs_rel", "log10", "rms", "sq_rel",
              "log_rms", "d1", "d2", "d3", "mean_silog"]}


@pytest.mark.parametrize("variant", ["selfsup", "depth"])
def test_variant_config_matches(tmp_path, monkeypatch, variant):
    """--variant selfsup|depth: the driver class, its config (SelfSupConfig
    with the pretrain flags) and the datasets' sizes as rag_tpu's main
    builds them."""
    argv = VARIANT_ARGV + ["--variant", variant, "--output",
                           str(tmp_path / "logs")]
    from rag_tpu.continual import depth_driver as jdd
    from rag_tpu.continual import self_supervised as jself
    from rag_tpu_torch.continual import depth_driver as tdd
    from rag_tpu_torch.continual import self_supervised as tself

    tbase, jbase, jmod, name = {
        "selfsup": (tself.SelfSupContinualDriver,
                    jself.SelfSupContinualDriver, jself,
                    "SelfSupContinualDriver"),
        "depth": (tdd.DepthContinualDriver, jdd.DepthContinualDriver, jdd,
                  "DepthContinualDriver")}[variant]
    tcls, t = _capture(tbase)
    with pytest.raises(_Stop):
        tcli.main(argv, device="cpu", driver_cls=tcls)
    jcls, j = _capture(jbase)
    monkeypatch.setattr(jmod, name, jcls)
    with pytest.raises(_Stop):
        jcli.main(argv)
    tc, jc = dataclasses.asdict(t["cfg"]), dataclasses.asdict(j["cfg"])
    assert type(t["cfg"]).__name__ == type(j["cfg"]).__name__
    assert tc.pop("precision") == dataclasses.asdict(Precision())
    assert tc == jc
    for td, jd in zip(t["data"], j["data"]):
        assert [len(d) for d in td] == [len(d) for d in jd]
        assert [type(d).__name__ for d in td] == [type(d).__name__ for d in jd]


@pytest.mark.parametrize("variant", ["selfsup", "depth"])
def test_variant_run(tmp_path, variant):
    """A 2-task --variant selfsup|depth run on the CPU writes a finite
    result.json with rag_tpu's keys, and a checkpoint of the variant."""
    out, ckpt = tmp_path / "logs", tmp_path / "ckpt"
    matrix = tcli.main(VARIANT_ARGV + [
        "--variant", variant, "--output", str(out), "--id", variant,
        "--checkpoint-dir", str(ckpt)], device="cpu", log=lambda *_: None)
    with open(out / f"drivingstereo_rag_0_{variant}" / "result.json") as f:
        result = json.load(f)
    assert sorted(result) == sorted(VARIANT_KEYS[variant] + [
        "model_size_m", "elapsed_h", "router"])
    head = VARIANT_KEYS[variant][-1]
    assert np.isfinite(result[head]) and np.isfinite(
        [result[k] for k in matrix.metric_names]).all()
    for k in matrix.metric_names:
        assert result[k][1][0] == result[k][0][0], k   # zero forgetting
    with open(ckpt / "manifest_task1.json") as f:
        assert json.load(f)["variant"] == (
            "depth" if variant == "depth" else "stereo")


def test_eval_only_of_depth_checkpoint():
    """--eval-only of the committed depth checkpoint: the depth metrics of
    task 2's path on a synthetic depth scene, as rag_tpu's --eval-only
    reports them (float32, within 1e-4 relative)."""
    ckpt = os.path.join(os.path.dirname(__file__), "..", "logs",
                        "canonical_depth_r3b")
    argv = ["--eval-only", "--checkpoint-dir", ckpt, "--synthetic-size", "2",
            "--synthetic-hw", "48", "96", "--eval-task", "2"]
    got = tcli.main(argv, device="cpu")
    ref = jcli.main(argv)
    assert list(got) == list(ref) == ["synthetic"]
    assert sorted(got["synthetic"]) == sorted(VARIANT_KEYS["depth"][:-1])
    for k, v in ref["synthetic"].items():
        assert np.isfinite(got["synthetic"][k]), k
        assert got["synthetic"][k] == pytest.approx(v, rel=1e-4, abs=1e-6), k


@pytest.mark.parametrize("split", [0, 1, 2])
def test_make_depth_datasets_synthetic_match(split):
    argv = ["--variant", "depth", "--synthetic", "--synthetic-size", "3",
            "--synthetic-hw", "24", "48", "--synthetic-eval-hw", "36", "48",
            "--synthetic-eval-size", "2", "--num-tasks", "2"]
    tsets = tcli.make_depth_datasets(tcli.build_parser().parse_args(argv),
                                     "cpu")
    jsets = jcli.make_depth_datasets(jcli.build_parser().parse_args(argv))
    for td, jd in zip(tsets[split], jsets[split]):
        assert (td.h, td.w, td.seed, td.max_depth, td.style) == \
            (jd.h, jd.w, jd.seed, jd.max_depth, jd.style)
        tb = list(td.batches(2, True, seed=1, drop_last=False))
        jb = list(jd.batches(2, True, seed=1, drop_last=False))
        assert len(tb) == len(jb) > 0
        for t, j in zip(tb, jb):
            for k in ("image", "depth"):
                np.testing.assert_array_equal(t[k].numpy(), j[k], err_msg=k)


def test_make_selfsup_aux_match():
    argv = ["--variant", "selfsup", "--synthetic-size", "3", "--synthetic-hw",
            "24", "48", "--maxdisp", "96"]
    taux = tcli.make_selfsup_aux(tcli.build_parser().parse_args(argv), "cpu")
    jaux = jcli.make_selfsup_aux(jcli.build_parser().parse_args(argv))
    for td, jd in zip(taux, jaux):
        assert (td.seed, td.max_disp, td.style) == (jd.seed, jd.max_disp,
                                                    jd.style)
        _equal_batches(td, jd, 2, True, seed=0, drop_last=False)


def test_main_needs_cuda_unless_asked_for_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main(["--synthetic", "--output", str(tmp_path)])
    assert not os.listdir(tmp_path)
