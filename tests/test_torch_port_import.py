"""The port's legacy-checkpoint import (rag_tpu_torch/compat/torch_import.py)
against rag_tpu's (rag_tpu/compat/torch_import.py), on the CPU.

- The test writes a full-width legacy checkpoint itself, the way the
  reference saves one: a seeded port ``GrowableDepthNet`` grown to task 1
  with two candidates on some sites, under the reference's key names,
  OIHW weights, dormant BatchNorm tensors of the bn=False blocks and
  ``num_batches_tracked`` everywhere, through ``torch.save(...,
  _use_new_zipfile_serialization=False)`` (the format rag_tpu's
  torch-free reader parses).
- Both packages import it: equal ``info``, every leaf equal bit for bit,
  and the net the port wrote comes back exactly.
- ``depth_forward`` of the two imported nets on one seeded frame, in
  float64 within tests/test_torch_port_depth.py's 1e-10 of the largest
  depth.
- The round trip: the port's ``save_checkpoint`` of the imported net reads
  back through rag_tpu's ``load_checkpoint`` leaf for leaf.
- ``main`` on the CPU with ``--eval`` runs task 0 through the depth eval
  step.
- A crafted pickle that calls ``os.system`` raises and runs nothing.
- The reference's own checkpoints, where they are mounted (skipped
  without /root/reference, as tests/test_torch_import.py is).
"""

import collections
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from cpu_threads import one_torch_thread  # noqa: F401 (autouse)
from learn_parity import assert_trees_equal, np_tree, opt0
from rag_tpu.compat import torch_import as jimport
from rag_tpu.continual import state as jstate
from rag_tpu.models import depth as jdepth
from rag_tpu_torch.compat import torch_import as timport
from rag_tpu_torch.continual import state as tstate
from rag_tpu_torch.continual.depth_driver import SyntheticDepthDataset
from rag_tpu_torch.convert import to_torch
from rag_tpu_torch.models import depth as tdepth
from rag_tpu_torch.models.growable import GrowableDepthNet
from rag_tpu_torch.models.stereo import HEAD_NAMES, SITE_NAMES
from rag_tpu_torch.ops.cell import canonicalize_gene
from rag_tpu_torch.search.genotype import Genotype
from test_torch_port_train_slice import _jax_in

REF = "/root/reference/rag_depth/logs"
FWD_TOL = 1e-10            # depth, float64: of the largest depth
# every conv row of the reference's genotype layout but rows 2 and 5:
# skips on the canonical edges 2 and 6
GENE = canonicalize_gene([(0, 1), (1, 1), (2, 0), (3, 1), (5, 1), (6, 0)])
GENOTYPE = Genotype(normal=GENE, reduce=GENE)
# the sites whose new candidate wins task 1's selection
NEW_SITES = ("stem_2d1", "cell_2d2", "stem_3d0", "cell_3d5", "last_3_2d")
_STEM_KEYS = {v: k for k, v in timport._STEM_MAP.items()}
_BN_OFF = ("last_3_2d", "last_3_3d")   # ConvBR_2d(bn=False): a dormant BN


def _grown_net():
    """A seeded port depth net after task 1's growth: two candidates on
    NEW_SITES, one elsewhere, two of every head."""
    net = GrowableDepthNet.initial(GENOTYPE, seed=5, device="cpu")
    net.expand(1, GENOTYPE, seed=6)
    for i, s in enumerate(SITE_NAMES):
        net.p[i] = np.array([0.0, 1.0]) if s in NEW_SITES else np.array(
            [1.0, 0.0])
    net.select(1)
    return net


def _convbr_sd(sd, prefix, params, stats, bn_off, rng):
    """The reference's tensors of one ConvBR: OIHW weight, the BatchNorm
    (random dormant tensors for a bn=False block), num_batches_tracked."""
    w = params["w"].numpy()
    sd[f"{prefix}.conv.weight"] = torch.from_numpy(
        np.ascontiguousarray(np.transpose(w, (3, 2, 0, 1))))
    c = w.shape[-1]
    if bn_off:
        bn = {k: torch.from_numpy(rng.standard_normal(c).astype(np.float32))
              for k in ("weight", "bias", "running_mean", "running_var")}
    else:
        bn = {"weight": params["scale"], "bias": params["bias"],
              "running_mean": stats["mean"], "running_var": stats["var"]}
    for k, v in bn.items():
        sd[f"{prefix}.bn.{k}"] = v.clone()
    sd[f"{prefix}.bn.num_batches_tracked"] = torch.tensor(7)


def _cell_sd(sd, prefix, params, stats, gene, rng):
    _convbr_sd(sd, f"{prefix}.pre_preprocess", params["pre"], stats["pre"],
               False, rng)
    _convbr_sd(sd, f"{prefix}.preprocess", params["prep"], stats["prep"],
               False, rng)
    for row, (edge, op) in enumerate(gene):
        if op == 1:
            _convbr_sd(sd, f"{prefix}._ops.{row}", params["ops"][str(edge)],
                       stats["ops"][str(edge)], False, rng)


def write_legacy(net, path, task=1):
    """The net as the reference saves it (rag_depth/src/run.py:204-206)."""
    rng = np.random.default_rng(9)
    sd = collections.OrderedDict()
    for site in SITE_NAMES:
        for i, u in enumerate(net.units[site]):
            if site.startswith("cell_"):
                kind, c = site[5:7], site[7:]
                _cell_sd(sd, f"cells_{kind}.{c}.{i}", u.params, u.stats,
                         u.spec.gene, rng)
            else:
                _convbr_sd(sd, f"{_STEM_KEYS[site]}.{i}", u.params, u.stats,
                           site in _BN_OFF, rng)
    for h in HEAD_NAMES:
        for i, u in enumerate(net.heads[h]):
            _convbr_sd(sd, f"{h}.{i}", u.params, u.stats, h in _BN_OFF, rng)
    hp = net.depth_head.params
    sd["depth_head.conv1.weight"] = hp["w"].permute(3, 2, 0, 1).contiguous()
    sd["depth_head.conv1.bias"] = hp["bias1"].clone()
    torch.save({"task": task, "model": sd,
                "optimizer": {"state": {}, "param_groups": [{"lr": 0.001}]}},
               path, _use_new_zipfile_serialization=False)


@pytest.fixture(scope="module")
def imported(tmp_path_factory):
    net = _grown_net()
    path = str(tmp_path_factory.mktemp("legacy") / "checkpoint_task1.ckpt")
    write_legacy(net, path)
    return (net, path, timport.import_depth_checkpoint(path, "cpu"),
            jimport.import_depth_checkpoint(path))


def test_legacy_file_is_the_reference_format(imported):
    """Not a zip archive, and rag_tpu's torch-free reader parses it to the
    arrays torch.load gives."""
    _, path, _, _ = imported
    with open(path, "rb") as f:
        assert f.read(2) != b"PK"
    a, b = jimport.load_legacy_torch(path), timport.load_legacy_torch(path)
    assert a["task"] == b["task"] == 1
    assert list(a["model"]) == list(b["model"])
    for k in a["model"]:
        assert a["model"][k].dtype == b["model"][k].dtype, k
        np.testing.assert_array_equal(a["model"][k], b["model"][k], err_msg=k)


def test_info_equal(imported):
    _, _, (_, tinfo), (_, jinfo) = imported
    assert tinfo == jinfo
    assert tinfo["task"] == 1 and tinfo["unused"] == []
    assert {s for s, n in tinfo["candidates"].items() if n == 2} \
        == set(NEW_SITES)
    # 5 dormant BNs x 4 tensors, and every other BN's num_batches_tracked
    assert tinfo["skipped_dormant"] > 20


def test_leaves_equal_rag_tpu_and_the_written_net(imported):
    net, _, (tnet, _), (jnet, _) = imported
    for s in SITE_NAMES:
        assert len(tnet.units[s]) == len(jnet.units[s]) == len(net.units[s])
        for u, v, o in zip(tnet.units[s], jnet.units[s], net.units[s]):
            assert dataclasses.asdict(u.spec) == dataclasses.asdict(v.spec)
            assert u.spec == o.spec and u.born_task == v.born_task == 0
            for tree in ("params", "stats"):
                assert_trees_equal(np_tree(getattr(u, tree)),
                                   np_tree(getattr(v, tree)))
                assert_trees_equal(np_tree(getattr(u, tree)),
                                   np_tree(getattr(o, tree)))
    for h in HEAD_NAMES:
        assert len(tnet.heads[h]) == len(jnet.heads[h]) == 2
        for u, v in zip(tnet.heads[h], jnet.heads[h]):
            assert_trees_equal(np_tree(u.params), np_tree(v.params))
            assert_trees_equal(np_tree(u.stats), np_tree(v.stats))
    assert_trees_equal(np_tree(tnet.depth_head.params),
                       np_tree(jnet.depth_head.params))
    assert tnet.archis == [{k: int(v) for k, v in a.items()}
                           for a in jnet.archis]
    assert tnet.genotypes[0].normal == tuple(map(tuple,
                                                 jnet.genotypes[0].normal))
    assert tnet.genotypes == [GENOTYPE]


def test_depth_forward_matches_rag_tpu(imported):
    """Task 0's path of both imports on one seeded frame, float64."""
    _, _, (tnet, _), (jnet, _) = imported
    specs_j, params_j, stats_j = jnet.path(jnet.archis[0])
    specs_t, params_t, stats_t = tnet.path(tnet.archis[0])
    image = SyntheticDepthDataset(1, 48, 96, seed=3, device="cpu")._samples(
        )["image"].astype(np.float64)
    with _jax_in(np.float64):
        fwd = opt0(jax.jit(lambda p, s, x: jdepth.depth_forward(
            specs_j, p, s, x)[0]))
        ref = np.asarray(fwd(np_tree(jax.tree_util.tree_map(np.asarray,
                                                            params_j),
                                     np.float64),
                             np_tree(jax.tree_util.tree_map(np.asarray,
                                                            stats_j),
                                     np.float64), image))
    got, _ = tdepth.depth_forward(specs_t,
                                  to_torch(np_tree(params_t, np.float64),
                                           "cpu"),
                                  to_torch(np_tree(stats_t, np.float64),
                                           "cpu"),
                                  torch.from_numpy(image))
    assert got.shape == (1, 48, 96) and bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=FWD_TOL * float(np.abs(ref).max()))


def test_save_checkpoint_reads_back_in_rag_tpu(imported, tmp_path):
    """The depth branch of the port's save_checkpoint writes the imported
    net, and rag_tpu's loader reads every leaf back."""
    _, _, (tnet, info), (jnet, _) = imported
    tstate.save_checkpoint(str(tmp_path), tnet, task=0)
    back, manifest = jstate.load_checkpoint(str(tmp_path), 0)
    assert manifest["variant"] == "depth"
    for s in SITE_NAMES:
        assert len(back.units[s]) == info["candidates"][s]
        for u, v in zip(back.units[s], jnet.units[s]):
            assert dataclasses.asdict(u.spec) == dataclasses.asdict(v.spec)
            assert_trees_equal(np_tree(u.params), np_tree(v.params))
            assert_trees_equal(np_tree(u.stats), np_tree(v.stats))
    for h in HEAD_NAMES:
        for u, v in zip(back.heads[h], jnet.heads[h]):
            assert_trees_equal(np_tree(u.params), np_tree(v.params))
    assert_trees_equal(np_tree(back.depth_head.params),
                       np_tree(jnet.depth_head.params))


def test_main_eval_on_cpu(imported, capsys):
    _, path, _, _ = imported
    net, info, v = timport.main([path, "--eval"], device="cpu")
    assert info["task"] == 1 and net.size_m() > 0
    assert set(v) >= {"silog", "abs_rel", "d1"}
    assert all(np.isfinite(x) for x in v.values())
    assert "task-0 eval on synthetic scene" in capsys.readouterr().out


def test_crafted_pickle_raises_without_running(tmp_path, monkeypatch):
    """A stream whose pickle calls os.system: torch's restricted
    unpickler refuses the global before anything runs."""
    calls = []
    monkeypatch.setattr(os, "system", lambda *a: calls.append(a) or 0)
    path = tmp_path / "evil.ckpt"
    path.write_bytes(b"cos\nsystem\n(S'true'\ntR.")
    with pytest.raises(Exception):
        timport.load_legacy_torch(str(path))
    with pytest.raises(Exception):
        timport.import_depth_checkpoint(str(path), "cpu")
    assert calls == []


@pytest.mark.skipif(not os.path.isdir(REF),
                    reason="reference checkpoints not mounted")
@pytest.mark.parametrize("task", [0, 1, 2, 3])
def test_reference_checkpoints_import_as_rag_tpu(task):
    path = os.path.join(REF, f"checkpoint_task{task}.ckpt")
    tnet, tinfo = timport.import_depth_checkpoint(path, "cpu")
    jnet, jinfo = jimport.import_depth_checkpoint(path)
    assert tinfo == jinfo and tinfo["unused"] == []
    for s in SITE_NAMES:
        for u, v in zip(tnet.units[s], jnet.units[s]):
            assert_trees_equal(np_tree(u.params), np_tree(v.params))
