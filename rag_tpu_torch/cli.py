"""The experiment CLI: ``python -m rag_tpu_torch.cli``.

Counterpart of rag_tpu/cli.py, with every flag and default of its parser.
One run: filename lists (``--train-lists`` / ``--test-lists``, or a
``--filenames-dir`` of per-scene DrivingStereo lists as
``python -m rag_tpu_torch.data.manifests`` writes them) or styled
synthetic scenes -> datasets -> the variant's driver's ``run`` with stage
checkpoints and ``--resume`` -> ``{output}/{experiment}_rag_{seed}_{id}/
result.json``, as rag_tpu writes it. ``--variant`` picks the driver:
``stereo`` (ContinualDriver), ``selfsup`` (SelfSupContinualDriver, with
a supervised pretrain set and colour-transfer proxy pairs from
``--pretrain-list`` / ``--proxy-list`` or synthetic stand-ins) or
``depth`` (DepthContinualDriver on depth lists or synthetic depth
scenes). ``--eval-only`` evaluates a checkpoint over ``--eval-lists``
(or a synthetic scene) instead: stereo or depth, as its manifest says.

The run is on the card: ``main`` raises where CUDA is not available and
never carries on on the CPU; ``main(argv, device="cpu")`` runs it on the
CPU (the tests do). The kernels are the default path's
(``KernelVariants()``): rag_tpu picks its variants through environment
switches, which the port does not read.

``--mesh D [M]`` runs the experiment on D x M ranks, one per visible
CUDA device (D x M CPU processes over gloo with device="cpu"): D
data-parallel ranks, each batch's H split over M (the fine-tune's steps;
see continual.driver). ``main`` spawns them with torch.multiprocessing,
joined by a process group on a local port, and each runs the driver over
the mesh; rank 0 logs and writes the checkpoints and result.json. Where
a process group is already initialized (a launcher started the ranks),
``main`` runs as its rank instead. A mesh beyond the visible devices
raises ValueError. ``--scene-parallel-search`` runs every scene's cell
search at once before the task loop (search.scene_parallel). ``--bf16``
stores the activations in bfloat16 (``ops.precision.Precision(
torch.bfloat16)`` in the config, and for ``--eval-only``), as rag_tpu's
flag sets its compute dtype.

The styled synthetic scenes take WEATHER_STYLES[t % 4], as in rag_tpu, so
scenes t and t + 4 share a style.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Continual stereo on the H100 (the RAG capability "
                    "surface of rag_tpu, ported to PyTorch and CUDA)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--experiment", default="drivingstereo")
    p.add_argument("--id", default="0")
    p.add_argument("--output", default="logs")
    p.add_argument("--variant", choices=["stereo", "selfsup", "depth"],
                   default="stereo")

    # data
    p.add_argument("--data-root", default="", help="prefix for filename lists")
    p.add_argument("--train-lists", nargs="*", default=[],
                   help="per-scene train filename lists (left right disp)")
    p.add_argument("--test-lists", nargs="*", default=[])
    p.add_argument("--filenames-dir", default="",
                   help="directory of drivingstereo_{scene}_{split}.txt "
                        "lists (reference layout, or generated by "
                        "python -m rag_tpu_torch.data.manifests); sets "
                        "--train/--test-lists in canonical task order")
    p.add_argument("--synthetic", action="store_true",
                   help="run on synthetic stereograms (no real data needed)")
    p.add_argument("--synthetic-size", type=int, default=64)
    p.add_argument("--synthetic-hw", type=int, nargs=2, default=[96, 192])
    p.add_argument("--synthetic-eval-hw", type=int, nargs=2, default=None,
                   help="test-set geometry (e.g. 480 960 for the canonical "
                        "eval protocol); defaults to --synthetic-hw")
    p.add_argument("--synthetic-eval-size", type=int, default=None,
                   help="test pairs per scene (default: --synthetic-size)")

    # cell search stage (c_*)
    p.add_argument("--c_epochs", type=int, default=100)
    p.add_argument("--c_batch", type=int, default=8)
    p.add_argument("--c_lr", type=float, default=0.002)
    p.add_argument("--c_lr_a", type=float, default=0.01)
    p.add_argument("--c_lamb", type=float, default=3e-4)
    p.add_argument("--skip-cell-search", action="store_true")

    # op search stage (o_*)
    p.add_argument("--o_epochs", type=int, default=100)
    p.add_argument("--o_batch", type=int, default=6)
    p.add_argument("--o_lr", type=float, default=0.001)
    p.add_argument("--o_lr_a", type=float, default=0.01)
    p.add_argument("--o_lamb", type=float, default=3e-4)
    p.add_argument("--o_size", type=int, default=10)

    # fine-tune stage
    p.add_argument("--epochs", type=int, default=400)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--lr", type=float, default=0.001)
    p.add_argument("--lamb", type=float, default=0.003)

    # self-supervised variant: a supervised pretrain before each task's
    # photometric fine-tune, op search on colour-matched proxy pairs
    p.add_argument("--pretrain-epochs", type=int, default=9,
                   help="selfsup: supervised pretrain epochs per task")
    p.add_argument("--pretrain-batch", type=int, default=8)
    p.add_argument("--pretrain-lr", type=float, default=0.001)
    p.add_argument("--pretrain-list", default="",
                   help="selfsup: filename list of the supervised pretrain "
                        "set; synthetic stand-in when omitted")
    p.add_argument("--proxy-list", default="",
                   help="selfsup: filename list of the op-search proxy "
                        "pairs, colour-matched to each scene's left frames; "
                        "synthetic stand-in when omitted")

    p.add_argument("--num-tasks", type=int, default=4)
    p.add_argument("--maxdisp", type=int, default=192,
                   help="max disparity; cost volume depth = maxdisp // 3")

    # router
    p.add_argument("--train-router", action="store_true",
                   help="train the Scene Router after each task")
    p.add_argument("--router-epochs", type=int, default=3)

    # device mesh and parallel search
    p.add_argument("--mesh", type=int, nargs="+", default=None,
                   metavar=("DP", "SP"),
                   help="device mesh: --mesh D runs every stage's batch "
                        "over D ranks, one per GPU; --mesh D M also splits "
                        "the fine-tune's matching volumes' H over M ranks "
                        "of each")
    p.add_argument("--scene-parallel-search", action="store_true",
                   help="every scene's cell search at once before the "
                        "task loop, one CUDA stream per scene")

    # checkpointing
    p.add_argument("--checkpoint-dir", default="")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--stage-checkpoint-every", type=int, default=10,
                   help="mid-stage checkpoint cadence in epochs for the "
                        "three long stages (cell search, op search, "
                        "fine-tune); 0 disables")

    # cross-domain / checkpoint-only evaluation
    p.add_argument("--eval-only", action="store_true",
                   help="load --checkpoint-dir and evaluate --eval-lists "
                        "instead of training")
    p.add_argument("--eval-lists", nargs="*", default=[],
                   help="filename lists to evaluate in --eval-only mode")
    p.add_argument("--eval-pad", type=int, nargs=2, default=None,
                   metavar=("H", "W"),
                   help="eval pad geometry. Default: 480x960 for "
                        "training-run test sets; 576x1248 (fits KITTI and "
                        "wide-resized Cityscapes frames) in --eval-only mode")
    p.add_argument("--train-crop", type=int, nargs=2, default=[192, 384],
                   metavar=("H", "W"),
                   help="training random-crop geometry (reference: 192x384)")
    p.add_argument("--eval-task", type=int, default=None,
                   help="fixed task path for --eval-only (default: task 0; "
                        "with --use-router: per-frame routed)")
    p.add_argument("--use-router", action="store_true")
    p.add_argument("--bf16", action="store_true",
                   help="bf16-at-rest mixed precision for the activations "
                        "(float32 accumulation, parameters and statistics; "
                        "rag_tpu_torch.ops.precision)")
    return p


def precision_of(args):
    """The run's ops.precision.Precision: bfloat16 activations with
    --bf16, else float32."""
    from rag_tpu_torch.ops.precision import Precision

    return Precision(torch.bfloat16) if args.bf16 else Precision()


def visible_devices(device) -> int:
    """Devices a mesh may span: the visible CUDA devices, or the CPU's
    cores for device="cpu"."""
    if torch.device(device).type == "cuda":
        return torch.cuda.device_count()
    return os.cpu_count() or 1


def mesh_shape(args):
    """(data, model) of --mesh D [M]."""
    if not args.mesh:
        return 1, 1
    return args.mesh[0], (args.mesh[1] if len(args.mesh) > 1 else 1)


def mesh_size(args) -> int:
    """The ranks of --mesh: data x model."""
    data, model = mesh_shape(args)
    return data * model


def eval_only(args, device="cuda"):
    """Evaluate the checkpoint in --checkpoint-dir over each eval list
    (padded to --eval-pad, default 576x1248, wide frames resized) or a
    synthetic scene: routed per frame with --use-router and a saved
    router, else on --eval-task's path (default 0); a depth checkpoint
    through depth_eval_only. Returns {name: scalars}."""
    from rag_tpu_torch.continual.inference import RoutedInference
    from rag_tpu_torch.continual.state import (
        latest_task,
        load_checkpoint,
        load_router,
    )

    if not args.checkpoint_dir:
        raise ValueError("--eval-only requires --checkpoint-dir")
    last = latest_task(args.checkpoint_dir)
    if last is None:
        raise FileNotFoundError(f"no checkpoints in {args.checkpoint_dir}")
    net, manifest = load_checkpoint(args.checkpoint_dir, last, device=device)
    print(f"loaded checkpoint after task {manifest['task']}; "
          f"{len(net.archis)} task paths, {net.size_m():.3f} M params")
    if manifest.get("variant", "stereo") == "depth":
        return depth_eval_only(args, net, device)

    router = None
    if args.use_router:
        router = load_router(args.checkpoint_dir, device=device)
        if router is None:
            print("WARNING: no router.npz in the checkpoint dir; routed "
                  "eval needs a driver run with --train-router first. "
                  "Falling back to task-0 paths.")
        else:
            print(f"loaded Scene Router ({router.num_tasks} tasks)")
    engine = RoutedInference(net, router, maxdisp=args.maxdisp, device=device,
                             precision=precision_of(args))

    if args.eval_lists:
        from rag_tpu_torch.data.stereo_dataset import StereoDataset

        ph, pw = args.eval_pad or (576, 1248)
        datasets = [(f, StereoDataset(f, False, root=args.data_root,
                                      pad=(pw, ph), resize_wide=True,
                                      device=device))
                    for f in args.eval_lists]
    else:
        from rag_tpu_torch.data.synthetic import SyntheticStereoDataset

        h, w = args.synthetic_hw
        datasets = [("synthetic", SyntheticStereoDataset(
            args.synthetic_size, h, w, seed=123, device=device))]

    task = None if (args.use_router and router is not None) \
        else (args.eval_task or 0)
    results = {}
    for name, ds in datasets:
        scalars = engine.evaluate(ds, task=task)
        print(f"{name}: D1 {100*scalars.get('D1', 0):.2f}% "
              f"EPE {scalars.get('EPE', 0):.3f} "
              f"loss {scalars.get('loss', 0):.3f}")
        results[name] = scalars
    return results


def depth_eval_only(args, net, device="cuda"):
    """Evaluate a depth checkpoint's --eval-task path (default 0) over each
    eval list (depth lists, padded to 480x960) or a synthetic depth scene.
    Returns {name: depth metrics}."""
    from rag_tpu_torch.metrics.meters import AverageMeterDict
    from rag_tpu_torch.train.trainer import make_depth_eval_step

    if args.eval_lists:
        from rag_tpu_torch.data.depth_dataset import DepthDataset

        datasets = [(f, DepthDataset(f, False, root=args.data_root,
                                     device=device))
                    for f in args.eval_lists]
    else:
        from rag_tpu_torch.continual.depth_driver import SyntheticDepthDataset

        h, w = args.synthetic_hw
        datasets = [("synthetic", SyntheticDepthDataset(
            args.synthetic_size, h, w, seed=123, device=device))]

    specs, params, stats = net.path(net.archis[args.eval_task or 0])
    step = make_depth_eval_step(specs, precision=precision_of(args))
    results = {}
    for name, ds in datasets:
        v = AverageMeterDict().update_batched(
            [step(params, stats, b["image"], b["depth"])
             for b in ds.batches(1, False, seed=0, drop_last=False)]).mean()
        results[name] = v
        print(f"{name}: silog {v.get('silog', 0):.3f} "
              f"abs_rel {v.get('abs_rel', 0):.3f} rms {v.get('rms', 0):.3f} "
              f"d1 {v.get('d1', 0):.3f}")
    return results


def make_datasets(args, device="cuda"):
    """(train, valid, test) datasets per scene: the filename lists (from
    --filenames-dir when no --train-lists), or styled synthetic scenes
    with --synthetic or without lists."""
    if args.filenames_dir and not args.train_lists:
        from rag_tpu_torch.data.manifests import scene_lists

        tr, te = scene_lists(args.filenames_dir)
        args.train_lists = tr[:args.num_tasks]
        args.test_lists = te[:args.num_tasks]
    if args.synthetic or not args.train_lists:
        from rag_tpu_torch.data.synthetic import (
            WEATHER_STYLES,
            SyntheticStereoDataset,
        )

        h, w = args.synthetic_hw
        eh, ew = args.synthetic_eval_hw or (h, w)
        n = args.synthetic_size
        en = args.synthetic_eval_size or n
        # the weather scenes share geometry and differ in appearance; the
        # disparity bound is DrivingStereo's half-size range
        md = min(64.0, args.maxdisp / 3)
        style = lambda t: WEATHER_STYLES[t % len(WEATHER_STYLES)]
        mk = lambda s, t, hh, ww, nn: SyntheticStereoDataset(
            nn, hh, ww, seed=s, max_disp=md, style=style(t), device=device)
        train = [mk(10 + t, t, h, w, n) for t in range(args.num_tasks)]
        valid = [mk(20 + t, t, h, w, n) for t in range(args.num_tasks)]
        test = [mk(30 + t, t, eh, ew, en) for t in range(args.num_tasks)]
        return train, valid, test

    from rag_tpu_torch.data.stereo_dataset import StereoDataset

    ch, cw = args.train_crop
    ph, pw = args.eval_pad or (480, 960)
    train = [StereoDataset(f, True, root=args.data_root, crop=(cw, ch),
                           device=device) for f in args.train_lists]
    valid = [StereoDataset(f, False, root=args.data_root, pad=(pw, ph),
                           device=device) for f in args.train_lists]
    test = [StereoDataset(f, False, root=args.data_root, pad=(pw, ph),
                          device=device)
            for f in args.test_lists or args.train_lists]
    return train, valid, test


def make_depth_datasets(args, device="cuda"):
    """(train, valid, test) per scene for the depth variant: depth filename
    lists (from --filenames-dir when no --train-lists), or styled
    synthetic depth scenes with --synthetic or without lists."""
    if args.filenames_dir and not args.train_lists:
        from rag_tpu_torch.data.manifests import scene_lists

        tr, te = scene_lists(args.filenames_dir)
        args.train_lists = tr[:args.num_tasks]
        args.test_lists = te[:args.num_tasks]
    if args.synthetic or not args.train_lists:
        from rag_tpu_torch.continual.depth_driver import SyntheticDepthDataset
        from rag_tpu_torch.data.synthetic import WEATHER_STYLES

        h, w = args.synthetic_hw
        eh, ew = args.synthetic_eval_hw or (h, w)
        en = args.synthetic_eval_size or args.synthetic_size
        sty = lambda t: WEATHER_STYLES[t % len(WEATHER_STYLES)]
        mk = lambda s, n, hh, ww, t: SyntheticDepthDataset(
            n, hh, ww, seed=s, style=sty(t), device=device)
        train = [mk(10 + t, args.synthetic_size, h, w, t)
                 for t in range(args.num_tasks)]
        valid = [mk(20 + t, args.synthetic_size, h, w, t)
                 for t in range(args.num_tasks)]
        test = [mk(30 + t, en, eh, ew, t) for t in range(args.num_tasks)]
        return train, valid, test

    from rag_tpu_torch.data.depth_dataset import DepthDataset

    mk = lambda f, training: DepthDataset(f, training, root=args.data_root,
                                          device=device)
    return ([mk(f, True) for f in args.train_lists],
            [mk(f, False) for f in args.train_lists],
            [mk(f, False) for f in args.test_lists or args.train_lists])


def make_selfsup_aux(args, device="cuda"):
    """(pretrain_data, proxy_search_data) of the selfsup variant: the
    --pretrain-list and --proxy-list files as training StereoDatasets, or
    synthetic stand-ins (seeds 777 and 888, disparity up to 0.6 maxdisp)."""
    from rag_tpu_torch.data.stereo_dataset import StereoDataset
    from rag_tpu_torch.data.synthetic import SyntheticStereoDataset

    h, w = args.synthetic_hw

    def one(lst, seed):
        if lst:
            return StereoDataset(lst, True, root=args.data_root, device=device)
        return SyntheticStereoDataset(args.synthetic_size, h, w, seed=seed,
                                      max_disp=args.maxdisp * 0.6,
                                      device=device)

    return one(args.pretrain_list, 777), one(args.proxy_list, 888)


def make_config(args):
    """The run's ExperimentConfig (SelfSupConfig for --variant selfsup),
    as rag_tpu's main builds it."""
    from rag_tpu_torch.continual.driver import ExperimentConfig, TrainConfig
    from rag_tpu_torch.continual.self_supervised import SelfSupConfig
    from rag_tpu_torch.search.growth import OpSearchConfig
    from rag_tpu_torch.search.mdenas import CellSearchConfig

    cfg_cls, extra = ExperimentConfig, {}
    if args.variant == "selfsup":
        cfg_cls = SelfSupConfig
        extra = dict(pretrain_epochs=args.pretrain_epochs,
                     pretrain_batch=args.pretrain_batch,
                     pretrain_lr=args.pretrain_lr)
    return cfg_cls(
        cell=CellSearchConfig(epochs=args.c_epochs, batch=args.c_batch,
                              lr=args.c_lr, lr_a=args.c_lr_a,
                              weight_decay=args.c_lamb, seed=args.seed),
        op=OpSearchConfig(epochs=args.o_epochs, batch=args.o_batch,
                          lr=args.o_lr, lr_a=args.o_lr_a,
                          weight_decay=args.o_lamb, o_size=args.o_size,
                          seed=args.seed),
        train=TrainConfig(epochs=args.epochs, batch=args.batch, lr=args.lr,
                          weight_decay=args.lamb),
        num_tasks=args.num_tasks,
        seed=args.seed,
        skip_cell_search=args.skip_cell_search,
        maxdisp=args.maxdisp,
        use_router=args.train_router,
        router_epochs=args.router_epochs,
        mesh_data=mesh_shape(args)[0],
        mesh_model=mesh_shape(args)[1],
        scene_parallel_search=args.scene_parallel_search,
        precision=precision_of(args),
        **extra,
    )


def make_driver(args, device="cuda", driver_cls=None, **kw):
    """(driver, (train, valid, test)) of the run's variant. ``driver_cls``
    replaces the variant's driver class (a subclass of it)."""
    from rag_tpu_torch.continual.depth_driver import DepthContinualDriver
    from rag_tpu_torch.continual.driver import ContinualDriver
    from rag_tpu_torch.continual.self_supervised import SelfSupContinualDriver

    cfg = make_config(args)
    if args.variant == "depth":
        data = make_depth_datasets(args, device)
        return (driver_cls or DepthContinualDriver)(cfg, device=device,
                                                    **kw), data
    data = make_datasets(args, device)
    if args.variant == "selfsup":
        pretrain, proxy = make_selfsup_aux(args, device)
        return (driver_cls or SelfSupContinualDriver)(
            cfg, pretrain_data=pretrain, proxy_search_data=proxy,
            device=device, **kw), data
    return (driver_cls or ContinualDriver)(cfg, device=device, **kw), data


def _rank_main(rank, argv, device, address, world, driver_cls, log):
    """One spawned rank of a --mesh run: join the group, run main."""
    import torch.distributed as dist

    from rag_tpu_torch.parallel.multihost import initialize_multihost

    dev = (torch.device("cuda", rank) if torch.device(device).type == "cuda"
           else torch.device("cpu"))
    initialize_multihost(address, world, rank, device=dev)
    try:
        main(argv, device=dev, driver_cls=driver_cls, log=log)
    finally:
        dist.destroy_process_group()


def _spawn_ranks(args, argv, device, driver_cls, log):
    """Run the experiment on mesh_size(args) spawned ranks; returns the
    ForgettingMatrix rank 0 wrote to result.json."""
    import torch.multiprocessing as mp

    from rag_tpu_torch.metrics.meters import ForgettingMatrix
    from rag_tpu_torch.parallel.multihost import local_address

    n = mesh_size(args)
    mp.start_processes(_rank_main, args=(argv, str(device), local_address(),
                                         n, driver_cls, log),
                       nprocs=n, start_method="spawn")
    path = os.path.join(args.output,
                        f"{args.experiment}_rag_{args.seed}_{args.id}",
                        "result.json")
    with open(path) as f:
        result = json.load(f)
    names = [k for k, v in result.items()
             if isinstance(v, list) and v and isinstance(v[0], list)]
    matrix = ForgettingMatrix(args.num_tasks, names)
    for k in names:
        matrix.m[k] = np.asarray(result[k], np.float64)
    return matrix


def main(argv=None, device="cuda", driver_cls=None, log=print):
    """Run the CLI on ``device``. Returns the ForgettingMatrix of a
    training run, or --eval-only's {name: scalars}. ``driver_cls`` (a
    subclass of the variant's driver) and ``log`` let a caller observe the
    run. With --mesh N > 1 and no process group yet, the run goes to N
    spawned ranks (see the module docstring)."""
    import torch.distributed as dist

    args = build_parser().parse_args(argv)
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("rag_tpu_torch.cli runs on a CUDA device and none "
                           "is available; main(argv, device='cpu') runs it "
                           "on the CPU")
    n = mesh_size(args)
    if n > visible_devices(device):
        raise ValueError(f"--mesh {n} needs {n} devices, "
                         f"{visible_devices(device)} visible")
    if args.eval_only:
        return eval_only(args, device)
    if n > 1 and not dist.is_initialized():
        return _spawn_ranks(args, argv, device, driver_cls, log)
    from rag_tpu_torch.parallel.mesh import barrier
    from rag_tpu_torch.utils.logging import MetricWriter

    lead = not dist.is_initialized() or dist.get_rank() == 0
    exp_name = f"{args.experiment}_rag_{args.seed}_{args.id}"
    log_dir = os.path.join(args.output, exp_name)
    writer = MetricWriter(log_dir if lead else None, echo=False)
    driver, (train, valid, test) = make_driver(
        args, device, driver_cls, writer=writer, log=log,
        checkpoint_dir=args.checkpoint_dir or None)

    driver.stage_checkpoint_every = args.stage_checkpoint_every
    tstart = time.time()
    matrix = driver.run(train, valid, test, resume=args.resume)
    if lead:
        write_result(args, driver, matrix, test, log_dir, tstart)
    barrier(driver.mesh)
    writer.close()
    return matrix


def write_result(args, driver, matrix, test, log_dir, tstart) -> None:
    """Print the run's matrices and write result.json into log_dir."""
    # every tracked forgetting matrix lands in result.json
    result = {k: matrix.m[k].tolist() for k in matrix.metric_names}
    if args.variant != "depth":
        print("D1 matrix (%):\n" + matrix.format("D1", scale=100,
                                                 fmt="{:6.2f}"))
        print("EPE matrix:\n" + matrix.format("EPE"))
        print(f"Mean D1 after {args.num_tasks} tasks: "
              f"{100 * matrix.mean_final('D1'):.2f}%")
        print(f"Forgetting (D1): {100 * matrix.forgetting('D1'):.2f}%")
        result["mean_D1"] = matrix.mean_final("D1")
    else:
        print("silog matrix:\n" + matrix.format("silog"))
        print("delta1 matrix:\n" + matrix.format("d1"))
        print(f"Mean silog after {args.num_tasks} tasks: "
              f"{matrix.mean_final('silog'):.3f}")
        result["mean_silog"] = matrix.mean_final("silog")
    print(f"Model size: {driver.net.size_m():.3f} M params")
    print(f"Elapsed: {(time.time() - tstart) / 3600:.2f} h")

    if driver.router is not None:
        acc = driver.router.accuracy(test)
        print(f"Scene Router accuracy: {100 * acc:.1f}%")

    result.update(model_size_m=driver.net.size_m(),
                  elapsed_h=(time.time() - tstart) / 3600)
    if driver.router_eval is not None:
        result["router"] = driver.router_eval
    with open(os.path.join(log_dir, "result.json"), "w") as f:
        json.dump(result, f, indent=2)


if __name__ == "__main__":
    main()
