"""The data-parallel driver and CLI of the port (counterpart of
tests/test_mesh_driver.py): ``--mesh`` threads into ExperimentConfig as
rag_tpu's does, a mesh beyond the visible devices raises, a stage whose
batch does not divide by mesh_data falls back to single-process steps,
every rank ends each stage that fell back with rank 0's net, router
and choices, and (``-m slow``) a 2-task run of ``python -m rag_tpu_torch.cli --mesh
2`` on two gloo ranks gives the forgetting matrices of the run without a
mesh, for the stereo and the depth variants.

The slow runs go through a subprocess with one torch thread per process
(OMP_NUM_THREADS=1, inherited by the ranks it spawns) and a hard timeout
of TIMEOUT_S, past which its process group is killed and the test fails.
"""

import dataclasses
import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from cpu_threads import one_torch_thread  # noqa: F401 (autouse)
from rank_worlds import launch
from rag_tpu.cli import build_parser as jbuild_parser
from rag_tpu_torch import cli
from rag_tpu_torch.continual.driver import ContinualDriver, ExperimentConfig
from rag_tpu_torch.ops.precision import Precision
from rag_tpu_torch.data.synthetic import SyntheticStereoDataset
from rag_tpu_torch.parallel.mesh import Mesh
from rag_tpu_torch.parallel.multihost import MultihostBatcher
from rag_tpu_torch.search.growth import OpSearchConfig
from rag_tpu_torch.search.mdenas import CellSearchConfig

ROOT = Path(__file__).resolve().parent.parent
TIMEOUT_S = 120


@pytest.mark.parametrize("argv,mesh", [
    (["--mesh", "4", "2"], (4, 2)), (["--mesh", "8"], (8, 1)),
    (["--mesh", "2"], (2, 1)), ([], (1, 1))])
def test_cli_mesh_flag_threads_into_config(argv, mesh):
    args = cli.build_parser().parse_args(argv)
    assert args.mesh == jbuild_parser().parse_args(argv).mesh
    cfg = cli.make_config(args)
    assert (cfg.mesh_data, cfg.mesh_model) == mesh


def test_cli_mesh_too_large_raises(tmp_path):
    n = cli.visible_devices("cpu") + 1
    with pytest.raises(ValueError, match="devices"):
        cli.main(["--mesh", str(n), "--output", str(tmp_path)], device="cpu")
    assert not os.listdir(tmp_path)


# the id the case had when --bf16 (ROADMAP.md Queue 1 item 11) was the
# part not ported: it now checks that the flag is ported, beside a mesh
@pytest.mark.parametrize("argv,item", [(["--bf16"], "11")], ids=["argv2-11"])
def test_cli_unported_parts_name_their_items(tmp_path, argv, item):
    """``--bf16`` parses as rag_tpu's flag does and reaches the config as
    ``Precision(torch.bfloat16)``, with ``--mesh 2`` as without it."""
    for extra in ([], ["--mesh", "2"]):
        args = cli.build_parser().parse_args(argv + extra)
        assert args.bf16 and jbuild_parser().parse_args(argv + extra).bf16
        cfg = cli.make_config(args)
        assert cfg.precision == Precision(torch.bfloat16)
        assert cfg.mesh_data == (2 if extra else 1)


def test_mesh_without_process_group_raises():
    with pytest.raises(ValueError, match="process group"):
        ContinualDriver(ExperimentConfig(mesh_data=2), log=None,
                        device="cpu")


def _fake_mesh(data, hosts=1):
    return Mesh(data=data, rank=0, device=torch.device("cpu"), group=None,
                hosts=hosts)


def test_mesh_indivisible_batch_falls_back():
    lines = []
    mesh = _fake_mesh(4)
    driver = ContinualDriver(ExperimentConfig(mesh_data=4), log=lines.append,
                             device="cpu", mesh=mesh)
    assert driver._mesh_for(6, "fine-tune") is None
    assert driver._mesh_for(6, "fine-tune") is None
    assert driver._mesh_for(8, "fine-tune") is mesh
    assert [ln for ln in lines if "single-device" in ln] == [
        "[mesh] fine-tune: batch 6 not divisible by mesh_data 4 -> "
        "single-device steps"]
    with pytest.raises(ValueError):
        ContinualDriver(ExperimentConfig(mesh_data=2), device="cpu",
                        mesh=mesh)


def test_dist_data_reads_rank_shards_across_machines():
    ds = SyntheticStereoDataset(4, 12, 24, seed=0, device="cpu")
    one = ContinualDriver(ExperimentConfig(mesh_data=2), log=None,
                          device="cpu", mesh=_fake_mesh(2))
    assert one._dist_data(ds) is ds
    two = ContinualDriver(ExperimentConfig(mesh_data=2), log=None,
                          device="cpu", mesh=_fake_mesh(2, hosts=2))
    assert isinstance(two._dist_data(ds), MultihostBatcher)
    assert ContinualDriver(ExperimentConfig(), log=None,
                           device="cpu")._dist_data(ds) is ds


def test_fallback_stages_leave_every_rank_with_rank0s_state(tmp_path):
    """Two gloo ranks run two tasks and the router with batches of 3 over
    mesh_data 2 (tests/torch_sync_worker.py): every stage falls back to
    single-process steps, and each rank starts every stage from weights,
    or ends it with a genotype, probabilities or router, of its own.
    Both ranks hold the same net after each task, and the same genotypes,
    archis and router at the end, to the bit."""
    r0, r1 = launch(Path(__file__).resolve().parent / "torch_sync_worker.py",
                    2, tmp_path)
    log = json.loads(str(r0["log"]))
    for stage in ("fine-tune", "op-search"):
        assert (f"[mesh] {stage}: batch 3 not divisible by mesh_data 2 -> "
                "single-device steps") in log
    assert str(r0["genotypes"]) == str(r1["genotypes"])
    assert str(r0["archis"]) == str(r1["archis"])
    keys = sorted(k for k in r0 if k.startswith(("net/", "router/")))
    assert keys == sorted(k for k in r1 if k.startswith(("net/", "router/")))
    assert {k.split("/")[1] for k in keys} >= {"t0", "t1", "params", "opt"}
    for k in keys:
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)


RUN_ARGV = ["--synthetic", "--synthetic-size", "16", "--synthetic-hw", "24",
            "48", "--num-tasks", "2", "--c_epochs", "1", "--c_batch", "8",
            "--o_epochs", "1", "--o_batch", "8", "--o_size", "2",
            "--epochs", "2", "--batch", "8", "--maxdisp", "48",
            "--stage-checkpoint-every", "1"]


def _cli_run(tmp, argv):
    """python -m rag_tpu_torch.cli's main(argv, device="cpu") in a
    subprocess; returns result.json."""
    out = tmp / "logs"
    ckpt = tmp / "ckpt"
    code = ("import sys; from rag_tpu_torch.cli import main; "
            "main(sys.argv[1:], device='cpu')")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=str(ROOT) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    p = subprocess.Popen([sys.executable, "-c", code, *argv, "--output",
                          str(out), "--checkpoint-dir", str(ckpt)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         env=env, cwd=tmp, start_new_session=True)
    try:
        log, _ = p.communicate(timeout=TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        p.wait()
        pytest.fail(f"cli run still running after {TIMEOUT_S} s")
    assert p.returncode == 0, log.decode(errors="replace")[-4000:]
    res = out / "drivingstereo_rag_0_0" / "result.json"
    return json.loads(res.read_text()), log.decode(errors="replace")


@pytest.mark.slow
@pytest.mark.parametrize("variant,keys", [
    ("stereo", ("D1", "EPE", "loss")), ("depth", ("silog", "d1", "loss"))])
def test_cli_mesh2_matches_single_process(tmp_path, variant, keys):
    argv = RUN_ARGV + ["--variant", variant]
    (tmp_path / "w1").mkdir()
    (tmp_path / "w2").mkdir()
    one, _ = _cli_run(tmp_path / "w1", argv)
    two, log = _cli_run(tmp_path / "w2", argv + ["--mesh", "2"])
    assert "[mesh] 2-way dp over 2 ranks" in log
    for k in keys:
        a, b = np.asarray(one[k]), np.asarray(two[k])
        assert np.allclose(a, b, rtol=1e-3, atol=2e-3), (k, a, b)
    # rank 0 alone wrote the checkpoints: every task's, no stage file left
    files = sorted(os.listdir(tmp_path / "w2" / "ckpt"))
    assert not [f for f in files if f.endswith(".npz")
                and f.startswith(("cellsearch", "opsearch", "finetune"))]


def test_spatial_mesh_driver_matches_single_process(tmp_path):
    """Two gloo ranks run two tasks over a 1x2 mesh
    (tests/torch_spatial_driver_worker.py): the fine-tune takes the
    spatial steps, cell search and op search fall back to single-device
    steps on each rank (rag_tpu's dp_only rule), every rank ends with the
    same net to the bit, and the forgetting matrix is the run's without
    a mesh (float32: within the slow CLI runs' bounds)."""
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import torch_spatial_driver_worker as worker

    r0, r1 = launch(Path(worker.__file__), 2, tmp_path)
    log = json.loads(str(r0["log"]))
    assert "[mesh] 1-way dp x 2-way spatial over 2 ranks" in log
    for stage in ("cell-search", "op-search"):
        assert (f"[mesh] {stage}: stage supports dp only; mesh_model=2 -> "
                "single-device steps") in log
    assert not [ln for ln in log if ln.startswith("[mesh] fine-tune")]
    keys = sorted(k for k in r0 if k.startswith("net/"))
    assert keys and keys == sorted(k for k in r1 if k.startswith("net/"))
    for k in keys:
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
    matrix, _, _ = worker.run(None)
    for k in ("D1", "EPE", "loss"):
        a, b = matrix[k], r0[f"matrix/{k}"]
        assert np.allclose(a, b, rtol=1e-3, atol=2e-3), (k, a, b)
