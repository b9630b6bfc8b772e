#!/usr/bin/env python3
"""Smoke run of the rag_tpu_torch port on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py [--profile DIR] [--small-only]

Two paths run through every phase but learn and cli: the default path (kernels
A-G) and the variant path, KernelVariants(conv3d_dblock, resize_kernel, shear_stem) all
on, where kernel H (kernel A's engine with four output planes a block)
takes kernel A's place, kernel I the matrix resizes, and the shear stem
(tap maps + kernels J and K) kernels B, E and F. Kernels A, B, D-F and
H-K each have a bf16
instance (bf16 at rest, ops.precision.Precision(torch.bfloat16)), which
the bf16 phase drives and the kernels phase checks; its launches count
apart (the wrapper's launches_bf16) and its report entry is its own.

Phases, in order; any failure exits non-zero and no phase swallows an
exception:

  1. device        require CUDA (no CPU fallback), print the card;
  2. build         compile the port's CUDA kernels from rag_tpu_torch/csrc
                   with nvcc (one process per source, all at once), load them;
  3. record        restore the committed 4-task checkpoint
                   logs/canonical_learn_r4 onto the card and answer one
                   1x480x960 request per task path, on each path, with each
                   kernel's PLAIN version in its wrapper's place, recording
                   every call each kernel would get (its shapes and its real
                   activations);
  4. record-train  the same for one training step of each training
                   configuration (task 3's fine-tune stage, task 0's stage;
                   batch 4, 192x384 crops, maxdisp 192), on each path,
                   keeping the plain step's updates and statistics; and
                   the first train step of the learn phase's supernet
                   (batch 8, 192x384), recording its calls of kernels A and
                   D (no other kernel may run there), and the selfsup
                   phase's photometric step, recording its calls; then
                   per path one bf16 request (task 0's path) and one bf16
                   step of task 0's configuration, recording the bf16
                   instances' calls (their keys carry "[bf16]");
  5. kernels       hold all eleven kernels (A-C, H-J forward, D-G, K
                   backward) against their plain versions on the card, at
                   every recorded shape and at small shapes, and time kernel,
                   plain version and a library yardstick with CUDA events
                   (H beside kernel A at its own plan, I beside
                   F.interpolate or aten's upsample_trilinear3d_backward
                   and through its C entry alone, J and K beside kernels
                   B and E+F; A with one output plane per block and with
                   its 4-byte copies, E at other chunk sizes, D's two
                   passes apart;
                   B beside kernel A on the materialized cost volume, F
                   beside kernel D on it, alone and with the volume's build,
                   and F's two passes apart; G's two passes apart, as
                   CUDA-graph replays);
                   kernel A's weight pass is held bit for bit against its
                   plain version (kernel B's plan among its plans), two
                   launches of every kernel and bf16 instance on the same
                   inputs against each other under torch.equal
                   ("repeat_bit_identical"), and J and K against their
                   plain versions bit for bit on integer-valued inputs;
                   the bf16 instances at their recorded shapes (each timed
                   beside its float32 instance on the upcast arguments,
                   "f32_ms") and at the small shapes, a bf16 output held
                   to one bf16 ulp of its largest value beyond the float32
                   tolerance; every one also equal to the float32
                   instance's output on the upcast arguments at the same
                   plan, rounded to bf16 (D's and F's dW and K's maps
                   outright), under torch.equal ("f32_equal"), with
                   the copy path taken ("vec", which must hold at every
                   main-path call); E's bf16 line also times it with 8-byte
                   pieces of four ("piece4_ms"); B's line also times the shear-collapsed
                   stem in plain PyTorch (ops.fused_stem.cost_stem_z) at
                   B's arguments;
  6. serve         per path, in turns (default, variants, variants,
                   default): set every launch count to 0, answer 3 requests
                   per task path through RoutedInference.predict, read the
                   counts (each kernel of the path must have launched, no
                   other), and check every disparity: finite, in [0, 191],
                   within tolerance of the path's plain disparity (the
                   variant path's also of the default path's);
  7. route         load the committed Scene Router (logs/canonical_learn_r4/
                   router.npz) onto the card and build the canonical run's
                   four styled test scenes there (SyntheticStereoDataset,
                   16 frames of 480x960 each, seeds 30-33, one weather style
                   each); route all 64 left frames on the card and again on
                   the CPU in float32 (the ids must be equal) and print the
                   scene accuracy and confusion matrix beside result.json's;
                   then per path, in the same turns, every launch count set
                   to 0: each scene through RoutedInference(net, router)
                   .evaluate(task=None) against evaluate(task=t) (equal
                   metrics where every frame was routed to its own task;
                   D1 and EPE printed beside result.json's routed values),
                   3 routed requests per scene beside the same requests with
                   the task given (ms/request, equal disparity where routed
                   right), the counts read (each kernel of the path
                   launched, no other); the router alone timed with CUDA
                   events; a fresh router trained on the card for 3 epochs
                   of batch 8 on four styled scenes of 32 pairs at 192x384
                   (its first Adam step within 1e-4 relative L2 of the same
                   step on the CPU, losses finite and falling; accuracy on
                   the test scenes printed, not gated);
  8. train         per path, in the same turns: set every launch count to 0,
                   take 3 steps of each training configuration through
                   make_train_step, read the counts, check the loss and
                   every updated leaf finite and the first step against the
                   path's plain step of phase 4; print ms/step, training
                   pairs/s and peak memory;
     bf16          per path, in turns (float32, bf16, bf16, float32): 3
                   requests per task path through RoutedInference and 3
                   steps of task 0's configuration, precision=
                   Precision(torch.bfloat16) or float32, every launch
                   count (both instances) at 0 first. Gates: bf16 serving
                   launches A, B, C (default) or H, I, J, C (variants) and
                   training A-G or H-K, C, D, G, their bf16 instances
                   where they have one, no float32 instance of those, and
                   I's bf16 instance as often as the float32 turn's I;
                   each task path's bf16 disparity
                   against the float32 one within tests/test_bf16.py's
                   bounds (|mean difference| < 1 px, mean |difference| <
                   5 px); the first bf16 step's loss within 5 % of the
                   float32 one's; every parameter, statistic and momentum
                   leaf float32 and finite. ms/request, ms/step and peak
                   memory beside float32's;
                   then the float32 probe, default path: both TF32
                   switches on, as a CLI user has them, one step of each
                   train builder (make_train_step, make_selfsup_train_step
                   and make_depth_train_step, the supernet's and the depth
                   supernet's steps, the stereo and depth op search's) with
                   a probe on the feature net's first conv that must see
                   both switches off while its backward runs and both on
                   after the step; each step's dp/lr against the same step
                   with the switches off (relative L2 <= FP32_PROBE_RTOL)
                   and against one whose backward runs outside the float32
                   scope (relative L2 > FP32_PROBE_RTOL: the gate catches a
                   backward in TF32);
     dp            a world of one NCCL process group on the card: 3 steps
                   of task 0's configuration through make_train_step(
                   mesh=make_mesh(1)), every launch count set to 0 first;
                   the first step against phase 4's plain step (STEP_RTOL,
                   STATS_RTOL) and against the same step without a mesh,
                   kernels A-G launched and no other, DP_ALL_REDUCES
                   all-reduces a step (the CPU test's count at world 2);
                   ms/step and pairs/s beside the train phase's; DP_PAIRS
                   steps without a mesh and dp steps interleaved, each
                   timed on the host clock; then
                   parallel.scaling.measure_scaling's world-1 row (with
                   --profile, one more dp step profiled). One visible
                   device: no scaling is claimed;
     sp            the spatial (model-axis) step: a world of two gloo
                   ranks sharing the one card (NCCL refuses two ranks on
                   one device), mesh data 1 x model 2, each a process of
                   this script (--sp-rank); 3 steps of task 0's
                   configuration through make_sharded_train_step, every
                   launch count at 0 first (H slabs of 32/16/8 rows by
                   scale): the first step against phase 4's plain step
                   (STEP_RTOL, STATS_RTOL) and against the unsharded
                   kernel step, each rank launching A-G and no other
                   kernel, at the unsharded steps' counts; one 480x960
                   eval step through make_sharded_eval_step, its rows of
                   the disparity and its EPE and loss within SERVE_ATOL of
                   the unsharded ones; ms/step, halo and gather bytes a
                   step and peak memory per rank. Any rank's failure fails
                   the run. Two ranks on one card over gloo: no scaling
                   is measured;
  9. learn         the port's continual-learning path on the default
                   path: ContinualDriver.run over two styled synthetic
                   scenes (WEATHER_STYLES[0] and [1]; 32 train pairs and 8
                   valid pairs at 192x384, 8 test frames at 480x960) with
                   run_rag_tpu.sh's hyperparameters, its epochs cut to 2
                   (router 1), full width; per task cell search, (task 1:
                   expand, op search, select), fine-tune, the forgetting
                   row, checkpoints to a temporary directory, the router.
                   Every stage starts with every launch count at 0 and
                   prints its seconds, pairs/s, peak memory and launches.
                   Gates: cell search runs kernels A and D only, op search
                   and fine-tune A, B, C, D and G (E where a feature-net
                   site trains, F where stem_3d0 does) and each evaluation
                   A, B and C only; the first supernet step through the
                   kernels against the plain one of phase 4 (STEP_RTOL,
                   STATS_RTOL); each genotype parse_genotype(p) of its
                   search, every p row summing to 1, archis[1] and
                   model_to_train by select's rule from the op search's p,
                   every logged value finite; matrix[1, 0] equal to
                   matrix[0, 0] in all six metrics (ZERO_FORGET_RTOL where
                   not bit-equal); the final checkpoint reloaded on the card
                   reproducing matrix[1, u] through RoutedInference
                   (ROUNDTRIP_RTOL), routed accuracy printed;
     scenes        SceneParallelCellSearch over the learn phase's two
                   scenes with its cell configuration, one CUDA stream per
                   scene on the card, every launch count at 0 first: each
                   scene's sampled ops equal to the learn phase's
                   sequential search's, p within SCENES_P_ATOL, genotypes
                   equal, kernels A and D only; its seconds beside the two
                   sequential searches run again, in turns (parallel,
                   sequential, sequential, parallel), and each under the
                   profiler for its device-busy share (the union of the
                   device's busy intervals over the wall);
 10. cli           python -m rag_tpu_torch.cli's path on files, default path:
                   a fake DrivingStereo tree (cloudy and foggy, 24 + 8
                   frames of 400x881 PNG each, a seeded smooth texture seen
                   through a disparity plane of at most 64 px; rainy and
                   sunny link to them) and its lists from
                   python -m rag_tpu_torch.data.manifests; the host
                   pipeline alone (batch 4 of 192x384 crops to the card,
                   native loader vs Python readers, pairs/s); a full
                   2-task cli.main run (run_rag_tpu.sh's hyperparameters,
                   epochs cut to 2, router 1, stage files every epoch,
                   maxdisp 192, 480x960 eval pad) with the learn phase's
                   stage gates, both train sets streamed natively,
                   result.json finite and zero forgetting; the same run
                   killed in task 1's fine-tune after epoch 0's stage
                   file, then --resume: no search again, the fine-tune
                   re-entering at epoch 1, row 0 read from the checkpoint
                   bit for bit, zero forgetting; --eval-only of the
                   committed checkpoint, routed, on 4 KITTI-size
                   (375x1242) and 2 wide (1024x2048, resized to 512x1024)
                   frames padded to 576x1248, at maxdisp 192 and 190 (C's
                   general instance): A, B and C only, one frame of each
                   list through the kernels within SERVE_ATOL of the plain
                   path, and every kernel call of those frames against its
                   plain version; and with --bf16 at maxdisp 192: the
                   bf16 instances of A and B, and C, only;
 11. selfsup       the self-supervised variant, default path: (a) the
                   committed logs/canonical_selfsup_r5 restored, one
                   photometric step of task 2's fine-tune stage (batch 3,
                   192x384, maxdisp 192) through the kernels against the
                   same step with the plain versions (recorded in phase 4;
                   its kernel calls are checked in phase 5 as "at":
                   "selfsup"), its launches (A, B, C, D and G, E and F by
                   the trainable sites), ms/step, pairs/s and peak memory;
                   (b) SelfSupContinualDriver.run over the learn phase's
                   two scenes with a synthetic pretrain set and colour-
                   transfer proxy pairs (32 of 192x384 each), the canonical
                   hyperparameters with epochs cut to 2 (router 1): each
                   stage (cell search, pretrain, op search, photometric
                   fine-tune, evaluations, router) timed and gated as in
                   the learn phase (pretrain as a fine-tune), every logged
                   value finite, matrix[1, 0] vs matrix[0, 0]
                   (ZERO_FORGET_RTOL), the reloaded checkpoint reproducing
                   row 1;
 12. depth         the monocular-depth variant, which runs no hand-written
                   kernel (every launch count must stay 0): (a) the
                   committed logs/canonical_depth_r3b and its router on the
                   card, each task path on 4 styled SyntheticDepthDataset
                   frames of 480x960 (depth metrics, ms/frame), one frame a
                   path against the CPU (DEPTH_ATOL), the 16 frames routed
                   on the card and the CPU (ids equal); a legacy reference
                   checkpoint (torch's non-zip format, the reference's
                   keys, OIHW weights, dormant BatchNorms) written from
                   its task-0 tensors and imported by
                   compat.torch_import onto the card and the CPU, task
                   0's metrics on 4 frames card vs CPU (DEPTH_ATOL); (b)
                   DepthContinualDriver.run over two styled depth scenes
                   (384x768 crops; batches 16 / 12 / 8 for cell search, op
                   search and fine-tune; epochs cut to 2, router 1), staged
                   and gated as in (b) of selfsup, zero forgetting in all
                   ten metrics, the reloaded checkpoint reproducing row 1;
                   (c) cli --variant depth --eval-only of the committed
                   checkpoint;
 13. repro         reproducible training: every train builder (make_train_
                   step on both paths in float32 and bf16, the supernet's,
                   the stereo and depth op search's, the selfsup, depth and
                   depth supernet steps, the router's Adam step) takes a
                   step twice from one state, REPRO_PAIRS times; first
                   under the parent's switches (full_fp32 in place of
                   models.stereo.reproducible: cuDNN free to pick its
                   algorithms), printing how many pairs differ, which
                   leaves, the first gradient in the backward's order that
                   differs, the ops torch.use_deterministic_algorithms(
                   True, warn_only=True) names, and each 2D conv whose
                   backward, replayed from its inputs and output gradient,
                   differs twice running (with the cuDNN kernels of one
                   replay in each mode); then as the port takes it, every
                   leaf equal under torch.equal (hard); the scope's cost on
                   a task-0 step (wall, CUDA events, profiled busy time
                   and the kernels that moved) and a supernet step (wall,
                   CUDA events); a task-0 step at maxdisp 190 (D = 63:
                   kernels C's and G's general instance) through the
                   kernels against plain (STEP_RTOL, STATS_RTOL), C and G
                   launched, their calls against plain and twice against
                   themselves; a 2-task ContinualDriver.run on synthetic
                   192x384 scenes on the card killed in task 1's fine-tune
                   after epoch 1's stage file and resumed, its whole
                   forgetting matrix and every leaf of the network and the
                   router equal to the uninterrupted run's (hard);
 14. report        one JSON line of the route phase ("route": its figures
                   and the card's name and power limit), one of the learn
                   phase ("learn"), one of the cli phase ("cli"), one of
                   the selfsup phase ("selfsup"), one of the depth phase
                   ("depth"), one of the dp phase and the float32 probe
                   ("dp"), one of the sp phase ("sp"), one of the scenes
                   phase ("scenes"), one of the bf16 phase ("bf16"), one
                   of the repro phase ("repro"), one of kernels (launches:
                   the serve, route, train, dp, sp, learn, scenes, cli,
                   selfsup and repro runs; a bf16 instance's: the bf16
                   phase, the cli's --bf16 evaluation and the repro
                   phase's bf16 steps), the card's name and
                   power limit, and as the last line {"ok": true,
                   "device": {...}}.

--small-only runs phases 1, 2 and 5 at the small shapes alone (a quick
build-and-check) and prints no report; --repro-only runs phases 1, 2 and
13 and prints no report.

Float32 throughout but the bf16 runs: TF32 is off for cuDNN and matmuls; kernel A's tensor-core
products are 3xTF32, which keeps float32 accuracy (its lines also carry
bound_tf32_ms, the bound of those products at the TF32 peak, beside
bound_ms; so do kernel B's, which runs A's engine). bound_ms takes the
float32 peak for float32 activations and the bf16 tensor-core peak for
bf16 ones (flop_s). Kernel A's,
B's, D's, E's, F's, H's and I's lines carry their plan: A's tile, splits
and blocks per launch; B's and H's the same, with A's plan for the call
beside it; D's and F's blocks, tile, row groups, planes per block, channel
chunks and workspace (F's also the share of its blocks' plane steps that
run, and D's plan for the materialized volume); E's chunks, blocks and
workspace; I's tile, runs of output planes, taps a table row, staged rows
x columns and shared memory; C's its instance (D of the periodic one, or
0 for the general one) and blocks, G's its instance, strips, warps,
blocks of its two passes and workspace; J's and K's their grid, block,
staged bytes, planes, columns and pieces (J) or runs (K) a row, copy
width, splits and column splits, as the library reports them. D's report entry lists its shapes in a step of task 0's stage.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

from rag_tpu_torch.continual.driver import (  # noqa: E402
    ContinualDriver,
    ExperimentConfig,
    TrainConfig,
)
from rag_tpu_torch.continual.depth_driver import (  # noqa: E402
    DepthContinualDriver,
    SyntheticDepthDataset,
)
from rag_tpu_torch.continual.inference import RoutedInference  # noqa: E402
from rag_tpu_torch.continual.self_supervised import (  # noqa: E402
    SelfSupConfig,
    SelfSupContinualDriver,
)
from rag_tpu_torch.continual.state import (  # noqa: E402
    load_checkpoint,
    load_router,
)
from rag_tpu_torch.data.synthetic import (  # noqa: E402
    WEATHER_STYLES,
    DeviceCache,
    SyntheticStereoDataset,
)
from rag_tpu_torch import cli  # noqa: E402
from rag_tpu_torch.compat import torch_import  # noqa: E402
from rag_tpu_torch.data.manifests import (  # noqa: E402
    DISP_DIR,
    LEFT_DIR,
    RIGHT_DIR,
    SCENES,
)
from rag_tpu_torch.data.stereo_dataset import (  # noqa: E402
    StereoDataset,
    split_half,
)
from rag_tpu_torch.metrics.depth import DEPTH_METRIC_NAMES  # noqa: E402
from rag_tpu_torch.metrics.meters import AverageMeterDict  # noqa: E402
from rag_tpu_torch.metrics.stereo import stereo_metrics  # noqa: E402
from rag_tpu_torch.models.depth import depth_forward  # noqa: E402
from rag_tpu_torch.models import router as router_mod  # noqa: E402
from rag_tpu_torch.models.stereo import (  # noqa: E402
    SITE_NAMES,
    disparity_rows,
    full_fp32,
    stereo_forward,
)
from rag_tpu_torch.models.growable import GrowableDepthNet  # noqa: E402
from rag_tpu_torch.models.supernet import (  # noqa: E402
    NUM_EDGES,
    init_depth_supernet,
    init_supernet,
)
from rag_tpu_torch.models.router import (  # noqa: E402
    SceneRouter,
    make_router_train_step,
    router_logits,
)
from rag_tpu_torch.ops import conv3d as conv3d_mod  # noqa: E402
from rag_tpu_torch.ops import convbr as convbr_mod  # noqa: E402
from rag_tpu_torch.ops.convbr import ConvBRSpec  # noqa: E402
from rag_tpu_torch.ops import cuda_lib  # noqa: E402
from rag_tpu_torch.ops import cvstem as cvstem_mod  # noqa: E402
from rag_tpu_torch.ops import disparity as disparity_mod  # noqa: E402
from rag_tpu_torch.ops import resize as resize_mod  # noqa: E402
from rag_tpu_torch.ops import shear as shear_mod  # noqa: E402
from rag_tpu_torch.ops.cost_volume import cost_volume_cf  # noqa: E402
from rag_tpu_torch.ops.fused_stem import cost_stem_z  # noqa: E402
from rag_tpu_torch.ops.precision import Precision  # noqa: E402
from rag_tpu_torch.ops.resize import _interp_matrix_np  # noqa: E402
from rag_tpu_torch.ops.variants import KernelVariants  # noqa: E402
from rag_tpu_torch.parallel.axis import ALL_REDUCES, all_sum_if  # noqa: E402
from rag_tpu_torch.parallel.halo import HALO  # noqa: E402
from rag_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from rag_tpu_torch.parallel.multihost import (  # noqa: E402
    initialize_multihost,
    local_address,
)
from rag_tpu_torch.parallel.scaling import measure_scaling  # noqa: E402
from rag_tpu_torch.parallel.sharded import (  # noqa: E402
    make_sharded_eval_step,
    make_sharded_train_step,
)
from rag_tpu_torch.search import growth as growth_mod  # noqa: E402
from rag_tpu_torch.search.genotype import (  # noqa: E402
    default_genotype,
    parse_genotype,
)
from rag_tpu_torch.search.growth import OpSearchConfig  # noqa: E402
from rag_tpu_torch.search.mdenas import (  # noqa: E402
    CellSearch,
    CellSearchConfig,
    make_depth_supernet_train_step,
    make_supernet_train_step,
)
from rag_tpu_torch.search.scene_parallel import (  # noqa: E402
    SceneParallelCellSearch,
)
from rag_tpu_torch.train import trainer as trainer_mod  # noqa: E402
from rag_tpu_torch.train.trainer import (  # noqa: E402
    clone_tree,
    cosine_lr,
    make_depth_eval_step,
    make_depth_train_step,
    make_eval_step,
    make_optimizer,
    make_selfsup_train_step,
    make_train_step,
)
from rag_tpu_torch.utils.profiling import trace  # noqa: E402
from rag_tpu_torch.utils.timing import cuda_ms, graph_ms  # noqa: E402

ROOT = Path(__file__).resolve().parent
CKPT = ROOT / "logs" / "canonical_learn_r4"
H, W, MAXDISP = 480, 960, 192
TRUE_DISP = 24                 # the synthetic pair is one fronto-parallel plane
REQUESTS = 3                   # per task path; the first is reported apart
REPS = 10                      # timed launches per kernel at main-path shapes
TRAIN_B, TRAIN_H, TRAIN_W = 4, 192, 384  # the reference's training crops
TRAIN_STEPS = 3                # per configuration; the first is reported apart
TRAIN_EPOCHS = 10              # cosine schedule length; step i takes epoch i's lr
LR, WD = 0.001, 0.003
STEM_C = 12                    # feature channels into the matching stem
PATHS = {"default": KernelVariants(),
         "variants": KernelVariants(conv3d_dblock=True, resize_kernel=True,
                                    shear_stem=True)}
TURNS = ("default", "variants", "variants", "default")  # serve, route, train
# the route phase: the canonical run's four styled test scenes (scene t
# styled WEATHER_STYLES[t], seed 30 + t, disparity up to 64 px;
# rag_tpu/cli.py:260-267) and its router training (rag_tpu's driver
# defaults, continual/driver.py:61-62, on the train sets' seeds 10 + t)
RESULT = ROOT / "logs" / "drivingstereo_rag_0_canonical_learn_r4" / "result.json"
SCENE_FRAMES, SCENE_DISP = 16, 64.0
ROUTE_REQUESTS = 3             # per scene, routed and with the task given
ROUTER_TRAIN_PAIRS, ROUTER_TRAIN_H, ROUTER_TRAIN_W = 32, 192, 384
ROUTER_EPOCHS, ROUTER_BATCH = 3, 8

# the learn phase: the port's continual driver (rag_tpu/cli.py:250-267's
# styled synthetic scenes, run_rag_tpu.sh's hyperparameters) at full width
# and the reference geometry, with epochs and scenes cut
LEARN_TASKS = 2                 # scenes, styled WEATHER_STYLES[0] and [1] (was 4)
LEARN_PAIRS = (32, 8, 8)        # train, valid, test pairs a scene
LEARN_TRAIN_HW, LEARN_TEST_HW = (192, 384), (480, 960)
LEARN_SCENE_DISP = 64.0         # min(64, maxdisp / 3)
LEARN_CFG = ExperimentConfig(
    cell=CellSearchConfig(epochs=2, batch=8, lr=0.002, lr_a=0.01),
    op=OpSearchConfig(epochs=2, batch=6, lr=0.001, lr_a=0.01, o_size=10),
    train=TrainConfig(epochs=2, batch=4, lr=0.001, weight_decay=0.003),
    num_tasks=LEARN_TASKS, seed=0, maxdisp=MAXDISP, use_router=True,
    router_epochs=1, router_batch=8)
LEARN_CUTS = ("scenes 4 -> 2", "cell-search epochs 100 -> 2",
              "op-search epochs 100 -> 2", "fine-tune epochs 400 -> 2",
              "router epochs 3 -> 1",
              "pairs a scene: 32 train, 8 valid, 8 test")
KA, KB, KC, KD, KE, KF, KG = (
    "conv3d_brc_cf", "cvstem_brc", "fused_soft_argmin", "conv3d_dw_cf",
    "cvstem_dxy", "cvstem_dw", "soft_argmin_bwd")
FEATURE_SITES = frozenset(s for s in SITE_NAMES if "2d" in s)
ZERO_FORGET_RTOL = 1e-6   # matrix[1, 0] vs matrix[0, 0] where not bit-equal
ROUNDTRIP_RTOL = 1e-6     # the reloaded checkpoint's evaluation vs the matrix

# the cli phase: python -m rag_tpu_torch.cli on files it writes, a fake
# DrivingStereo "different weathers" tree at the half-size geometry, with
# run_rag_tpu.sh's hyperparameters and the epochs cut as in the learn phase
CLI_SCENES = ("cloudy", "foggy")   # learned; rainy and sunny link to them
CLI_FRAMES = (24, 8)               # train, test frames a scene
CLI_HW = (400, 881)                # DrivingStereo half-size frames
CLI_MAX_DISP = 64.0                # the frames' disparity planes, at most
CLI_HYPER = ["--c_epochs", "2", "--c_batch", "8", "--c_lr", "0.002",
             "--c_lr_a", "0.01", "--o_epochs", "2", "--o_batch", "6",
             "--o_lr", "0.001", "--o_lr_a", "0.01", "--o_size", "10",
             "--epochs", "2", "--batch", "4", "--lr", "0.001",
             "--lamb", "0.003", "--router-epochs", "1"]
CLI_CUTS = ("scenes 4 -> 2 (cloudy, foggy)", "frames a scene 400 + 100 -> 24 + 8",
            "cell-search epochs 100 -> 2", "op-search epochs 100 -> 2",
            "fine-tune epochs 400 -> 2", "router epochs 3 -> 1")
CLI_KILL_AT = "[train t1] epoch 1 "   # task 1's fine-tune, after epoch 0's file
# --eval-only lists: (frames, height, width, largest disparity)
CLI_EVAL = {"kitti": (4, 375, 1242, 64.0), "wide": (2, 1024, 2048, 128.0)}
CLI_EVAL_PAD = (576, 1248)
PIPE_EPOCHS = 3                    # host-pipeline rate: epochs of 24 pairs

# the selfsup phase: task 2's fine-tune stage of the committed
# self-supervised run (run_rag_tpu_self.sh: batch 3, 192x384, maxdisp 192),
# then the self-supervised driver on the learn phase's scenes with the
# synthetic pretrain set (seed 777) and proxy pairs (seed 888, colour-
# matched per scene), disparity up to 0.6 maxdisp, run_rag_tpu_self.sh's
# hyperparameters with epochs cut to 2 (router 1)
SELF_CKPT = ROOT / "logs" / "canonical_selfsup_r5"
SELF_B = 3
SELF_PRETRAIN_PAIRS, SELF_PROXY_PAIRS = 32, 32
SELF_CFG = SelfSupConfig(
    cell=CellSearchConfig(epochs=2, batch=8, lr=0.002, lr_a=0.01),
    op=OpSearchConfig(epochs=2, batch=6, lr=0.001, lr_a=0.01, o_size=10),
    train=TrainConfig(epochs=2, batch=SELF_B, lr=0.001, weight_decay=0.003),
    num_tasks=LEARN_TASKS, seed=0, maxdisp=MAXDISP, use_router=True,
    router_epochs=1, router_batch=8, pretrain_epochs=2, pretrain_batch=8)
SELF_CUTS = ("scenes 4 -> 2", "cell-search epochs 100 -> 2",
             "op-search epochs 100 -> 2", "fine-tune epochs 300 -> 2",
             "pretrain epochs 9 -> 2", "router epochs 3 -> 1",
             "pairs a scene: 32 train, 8 valid, 8 test",
             "pretrain and proxy sets 64 -> 32 pairs")
# the depth phase: the committed 4-task depth run and its router, then the
# depth driver on two styled depth scenes at the depth variant's 384x768
# crops (run_rag_tpu_depth.sh: batches 16 / 12 / 8), epochs cut to 2
DEPTH_CKPT = ROOT / "logs" / "canonical_depth_r3b"
DEPTH_FRAMES = 4                 # test frames a scene, 480x960
DEPTH_TRAIN_HW = (384, 768)
DEPTH_PAIRS = (32, 8, 8)         # train, valid, test (480x960) a scene
DEPTH_CFG = ExperimentConfig(
    cell=CellSearchConfig(epochs=2, batch=16, lr=0.002, lr_a=0.01),
    op=OpSearchConfig(epochs=2, batch=12, lr=0.001, lr_a=0.01, o_size=10),
    train=TrainConfig(epochs=2, batch=8, lr=0.001, weight_decay=0.003),
    num_tasks=LEARN_TASKS, seed=0, use_router=True, router_epochs=1,
    router_batch=8)
DEPTH_CUTS = ("scenes 4 -> 2", "cell-search epochs 100 -> 2",
              "op-search epochs 100 -> 2", "fine-tune epochs 400 -> 2",
              "router epochs 3 -> 1",
              "pairs a scene: 32 train, 8 valid, 8 test")
DEPTH_ATOL = 1e-2  # m, a restored path's 480x960 frame, card vs CPU float32:
                   # ~25 2D conv layers summed in another order, then the
                   # sigmoid's x80

# H100 SXM data-sheet peaks (dense, no sparsity) at the 700 W limit
PEAK_FP32_FLOPS = 67e12        # float32 outside the tensor cores
PEAK_TF32_FLOPS = 495e12       # TF32 on the tensor cores
PEAK_BF16_FLOPS = 989e12       # bf16 on the tensor cores
PEAK_HBM_BYTES = 3.35e12

# Tolerances, with their reasons:
CONV_RTOL = 1e-5   # of max |plain|: float32 sums of <= 27*48 products in
                   # another order; a wrong tap or channel is O(1) off
DISP_ATOL = 1e-3   # px, kernel C alone: float32 softmin over 192 levels
BWD_RTOL = 1e-4    # kernels D-F: of the largest sum of the products'
                   # magnitudes (the plain version on |inputs|), the scale of
                   # float32 error in sums of up to 2M (D, F) or 64 planes x
                   # 27 taps x 12 (E) terms taken in another order, where
                   # real gradients cancel; G: of max |plain|. A wrong tap or
                   # mask is O(1) off
STEP_RTOL = 1e-2   # a train step, kernels vs plain: relative L2 of dp/lr over
                   # all trainable leaves; float32 sums in another order
                   # through ~25 layers, where a ReLU input within float32
                   # noise of zero takes the other branch (ROADMAP Queue 3)
STATS_RTOL = 1e-3  # of max(1, |stat|), new BN running statistics of that step
# all-reduces of one data-parallel step of task 0's stage (BN statistics
# forward and backward, the loss's sums forward and backward, the metrics,
# the flattened gradients), as tests/test_torch_dp.py counts them at world 2
DP_ALL_REDUCES = 130
DP_PAIRS = 10  # steps without a mesh and dp steps, interleaved and timed
SCENES_P_ATOL = 1e-6  # the scene-parallel search's p vs the learn phase's
                   # sequential searches': the same float64 host updates
                   # from the same qualities give the same bits, and a
                   # quality that moved in float32 moves p by ~lr_a
FP32_PROBE_RTOL = 1e-4  # a train step with both TF32 switches on vs off:
                   # relative L2 of dp/lr. Sound (the backward in float32)
                   # the two read at most 1.44e-5 (cuDNN's run-to-run
                   # order); a backward in TF32 reads 4.5e-4 to 1.35e-3, and
                   # must read above it, so the gate is shown to catch it
ROUTER_STEP_RTOL = 1e-4  # the router's first Adam step, card vs CPU: relative
                   # L2 of the update, mu and nu; float32 convs and
                   # reductions summed in another order (~1e-6)
SERVE_ATOL = 1e-2  # px, whole request: ~25 float32 layers summed in another
                   # order, amplified by the softmin; 1% of the 1-px Thres1
BF16_RTOL = 2.0 ** -7  # a bf16 output, kernel vs plain: one bf16 ulp of the
                   # largest |value| (8 significant bits), added to the
                   # float32 tolerance: the same float32 sums in another
                   # order, each rounded once to bf16
BF16_MEAN_PX, BF16_ABS_PX = 1.0, 5.0  # a bf16 request vs the float32 one:
                   # |mean difference| and mean |difference| of the
                   # disparity (tests/test_bf16.py's bounds)
BF16_LOSS_RTOL = 0.05  # a bf16 train step's loss vs the float32 step's
                   # (tests/test_bf16.py's bound)
BF16 = Precision(torch.bfloat16)


def log(msg: str) -> None:
    print(msg, flush=True)


def cfg_dict(cfg) -> dict:
    """A config dataclass as JSON-ready values (its Precision's dtype as
    its name)."""
    return json.loads(json.dumps(dataclasses.asdict(cfg), default=str))


def nvidia_smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


# -- bounds: the least time the card could take for one call ---------------

def _taps(n: int) -> int:
    """(output, tap) pairs of a 3-tap zero-padded axis that read inside."""
    return 3 * n - 2 if n > 1 else 1


def flop_s(eb: int, f32_operand: bool) -> float:
    """Seconds a flop of a sum of products takes at the card's peak for
    its operands. Float32 activations (eb 4): the float32 peak. bf16
    activations (eb 2) go to the bf16 tensor cores, whose products are
    exact in their float32 accumulator: one product a multiply-add where
    the other operand is bf16 too, three where it is a float32 weight
    (split into three bf16 pieces of 8 significant bits, float32's 24)."""
    if eb == 4:
        return 1.0 / PEAK_FP32_FLOPS
    return (3.0 if f32_operand else 1.0) / PEAK_BF16_FLOPS


def _bound(flops: float, nbytes: float, per_flop=1.0 / PEAK_FP32_FLOPS):
    t_ops = flops * per_flop * 1e3
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def tf32_bound(flops: float, nbytes: float, eb: int) -> float:
    """Kernel A's engine (A, B, H) on the tensor cores: the TF32 products
    it needs at the TF32 peak, three a multiply-add for float32
    activations (3xTF32) and two for bf16 ones (x exact in TF32, so its
    low part's product is zero), or the bytes' time where that is
    longer."""
    products = 3 if eb == 4 else 2
    return max(products * flops / PEAK_TF32_FLOPS,
               nbytes / PEAK_HBM_BYTES) * 1e3


def conv_bound(x_shape, cout, tf32=False, eb=4):
    """Multiply-adds that read an in-range voxel (padding zeros excluded);
    bytes: input, weights, affine read once, output written once. With
    tf32: the bound of kernel A's TF32 products (tf32_bound). eb: bytes
    an activation element (2 for bf16); weights are float32."""
    b, d, cin, h, w = x_shape
    flops = 2.0 * b * _taps(d) * _taps(h) * _taps(w) * cin * cout
    nbytes = (eb * b * d * h * w * (cin + cout)
              + 4.0 * (27 * cin * cout + 2 * cout))
    if tf32:
        return tf32_bound(flops, nbytes, eb)
    return _bound(flops, nbytes, flop_s(eb, True))


def _stem_products(nd, w, dv_needed=False):
    """(plane, column, kd, kw) combinations of the stem's conv whose product
    is not structurally zero. Forward and dW: the volume voxel read,
    (d+kd-1, j+kw-1), lies inside the planes and right of the diagonal.
    dX/dY (dv_needed): the conv of dz lands on an output (d, j) the
    volume's adjoint keeps (j >= d) and reads dz inside the planes."""
    d = np.arange(nd)[:, None, None, None]
    dd = np.arange(3)[None, :, None, None]
    j = np.arange(w)[None, None, :, None]
    kw = np.arange(3)[None, None, None, :]
    dv, jv = d + dd - 1, j + kw - 1
    inside = (dv >= 0) & (dv < nd) & (jv >= 0) & (jv < w)
    inside &= (j >= d) if dv_needed else (jv >= dv)
    return int(inside.sum())


def cvstem_bound(x_shape, nd, cout, tf32=False, eb=4):
    """Multiply-adds that read a voxel of the cost volume that is not a
    structural zero (outside the planes, left of the diagonal, or padding);
    bytes: the two feature maps, weights, affine in, the output out. With
    tf32: the bound of kernel A's TF32 products (tf32_bound). eb: bytes
    an activation element."""
    b, c, h, w = x_shape
    flops = 2.0 * b * _stem_products(nd, w) * _taps(h) * 2 * c * cout
    nbytes = (eb * (2 * b * c * h * w + b * nd * cout * h * w)
              + 4.0 * (27 * 2 * c * cout + 2 * cout))
    if tf32:
        return tf32_bound(flops, nbytes, eb)
    return _bound(flops, nbytes, flop_s(eb, True))


def disp_bound(x_shape, maxdisp, scale):
    """Per output pixel: a bilinear blend of each of the D cost levels
    (9 flops) and, per disparity level, the D-axis lerp (3), the running
    max (1), exp (1), and the two sums (3). Bytes: cost in, disparity out."""
    b, d, h, w = x_shape
    pixels = b * h * scale * w * scale
    flops = pixels * (9.0 * d + 8.0 * maxdisp)
    nbytes = 4.0 * (b * d * h * w + pixels)
    return _bound(flops, nbytes)


def dw_bound(x_shape, cout, eb=4):
    """Kernel D: the forward's multiply-adds that read an in-range voxel;
    bytes: x and dz in (eb bytes an element), dW out."""
    b, d, cin, h, w = x_shape
    flops = 2.0 * b * _taps(d) * _taps(h) * _taps(w) * cin * cout
    nbytes = eb * b * d * h * w * (cin + cout) + 4.0 * 27 * cin * cout
    return _bound(flops, nbytes, flop_s(eb, False))


def cvstem_dxy_bound(dz_shape, c2, nd, eb=4):
    """Kernel E: for every volume voxel the adjoint keeps, the in-range
    products of the dx conv over 27 taps and Cout; bytes: dz and weights
    in, dX and dY out (dz, dX, dY eb bytes an element)."""
    b, _, cout, h, w = dz_shape
    flops = 2.0 * b * _stem_products(nd, w, dv_needed=True) * _taps(h) \
        * c2 * cout
    nbytes = (eb * (b * nd * cout * h * w + b * c2 * h * w)
              + 4.0 * 27 * c2 * cout)
    return _bound(flops, nbytes, flop_s(eb, True))


def cvstem_dw_bound(x_shape, dz_shape, nd, eb=4):
    """Kernel F: the forward's products (the same (voxel, tap) pairs);
    bytes: X, Y and dz in (eb bytes an element), dW out."""
    b, c, h, w = x_shape
    cout = dz_shape[2]
    flops = 2.0 * b * _stem_products(nd, w) * _taps(h) * 2 * c * cout
    nbytes = (eb * (2 * b * c * h * w + b * nd * cout * h * w)
              + 4.0 * 27 * 2 * c * cout)
    return _bound(flops, nbytes, flop_s(eb, False))


def disp_bwd_bound(x_shape, maxdisp, scale):
    """Kernel G: per output pixel, kernel C's work (9 per cost level, 8
    per disparity level) plus the third walk over the levels (lerp 3, exp
    1, p 1, dy 4, the D fold into two taps 4); per input voxel, the gather
    over its inverse H and W taps (2*KW + 2 per H tap). Bytes: x and g in,
    dx out."""
    b, d, h, w = x_shape
    kh, kw = (int(np.count_nonzero(_interp_matrix_np(n, n * scale, False),
                                   axis=0).max()) for n in (h, w))
    pixels = b * h * scale * w * scale
    flops = (pixels * (9.0 * d + 21.0 * maxdisp)
             + b * d * h * w * kh * (2.0 * kw + 2.0))
    nbytes = 4.0 * (2 * b * d * h * w + pixels)
    return _bound(flops, nbytes)


def resize_bound(x_shape, d2, h2, w2, align_corners=True, transposed=False,
                 eb=4):
    """Kernel I: the multiply-adds of the separable form (each axis that
    changes, one per nonzero tap of its table, over the volume at that
    stage), float32 (the bf16 instance widens and sums in float32); bytes:
    x in, the output out, eb bytes an element."""
    b, d, c, h, w = x_shape
    nnz = []
    for n, n2 in ((d, d2), (h, h2), (w, w2)):
        if n == n2:
            nnz.append(0)
            continue
        _, wts = resize_mod._taps_np(*((n2, n) if transposed else (n, n2)),
                                     align_corners, transposed)
        nnz.append(int(np.count_nonzero(wts)))
    flops = 2.0 * (nnz[0] * b * c * h * w + nnz[1] * b * d2 * c * w
                   + nnz[2] * b * d2 * c * h2)
    nbytes = float(eb) * (b * d * c * h * w + b * d2 * c * h2 * w2)
    return _bound(flops, nbytes)


def _shear_terms(nd, w):
    """(plane, column, term) adds of the shear assembly that its masks
    keep: the px term where the gate and j >= s hold, the py term where
    also j <= W - dw."""
    d = np.arange(nd)[:, None]
    j = np.arange(w)[None, :]
    n = 0
    for dd, dw in shear_mod.T9:
        s = d + dd - dw
        xm = (j >= s) & (d + dd - 1 >= 0) & (d + dd - 1 <= nd - 1)
        n += int(xm.sum()) + int((xm & (j <= w - dw)).sum())
    return n


def shear_bound(px_shape, nd, relu=False, eb=4):
    """Kernel J: the kept adds plus the affine (2) and ReLU (1) per output;
    bytes: the two tap-map stacks and the affine in, the output out (maps
    and output eb bytes an element)."""
    b, _, co, h, w = px_shape
    flops = b * co * h * (_shear_terms(nd, w) + (3.0 if relu else 2.0) * nd * w)
    nbytes = (eb * (2 * b * 9 * co * h * w + b * nd * co * h * w)
              + 4.0 * 2 * co)
    return _bound(flops, nbytes)


def shear_adj_bound(dz_shape, nd, eb=4):
    """Kernel K: the same kept adds, taken back; bytes: dz in (eb bytes an
    element), the two float32 tap-map gradients out."""
    b, _, co, h, w = dz_shape
    flops = float(b * co * h * _shear_terms(nd, w))
    nbytes = eb * b * nd * co * h * w + 4.0 * 2 * b * 9 * co * h * w
    return _bound(flops, nbytes)


# -- the eleven kernels: wrapper, plain version, yardstick, bound -----------

def _ncdhw(v):
    return v.permute(0, 2, 1, 3, 4).contiguous()


def _conv_library(x, w, scale, bias, relu):
    """cuDNN F.conv3d on NCDHW with the affine folded into weights and
    bias, then ReLU (the layout change is made once, outside the timing)."""
    x_n = _ncdhw(x)
    w_n = (w * scale).permute(4, 3, 0, 1, 2).contiguous().to(x.dtype)
    bias = bias.to(x.dtype)

    def run():
        y = F.conv3d(x_n, w_n, bias, padding=1)
        return torch.relu_(y) if relu else y
    return run


def _cvstem_library(x_cf, y_cf, w3, scale, bias, nd, relu):
    """The materialized cost volume, then cuDNN F.conv3d as above."""
    x = x_cf.permute(0, 2, 3, 1).contiguous()
    y = y_cf.permute(0, 2, 3, 1).contiguous()
    w_n = (w3 * scale).permute(4, 3, 0, 1, 2).contiguous().to(x.dtype)
    bias = bias.to(x.dtype)

    def run():
        vol = cost_volume_cf(x, y, nd).permute(0, 2, 1, 3, 4)
        out = F.conv3d(vol, w_n, bias, padding=1)
        return torch.relu_(out) if relu else out
    return run


def _dw_library(x, dz):
    """cuDNN's weight gradient (conv3d_weight) on NCDHW."""
    x_n, dz_n = _ncdhw(x), _ncdhw(dz)
    shape = (dz.shape[2], x.shape[2], 3, 3, 3)
    return lambda: torch.nn.grad.conv3d_weight(x_n, shape, dz_n, padding=1)


def _dxy_library(dz, w3, nd):
    """cuDNN's input gradient (conv3d_input) of the materialized volume,
    then the volume's adjoint: the masked sum over d for dX, the shifted
    sum for dY."""
    b, _, _, h, w = dz.shape
    c2 = w3.shape[3]
    c = c2 // 2
    dz_n = _ncdhw(dz)
    w_n = w3.permute(4, 3, 0, 1, 2).contiguous().to(dz.dtype)
    j = torch.arange(w, device=dz.device)
    mask = (j[None, :] >= torch.arange(nd, device=dz.device)[:, None]).to(
        dz.dtype)

    def run():
        dv = torch.nn.grad.conv3d_input((b, c2, nd, h, w), w_n, dz_n,
                                        padding=1)
        dx = (dv[:, :c] * mask[None, None, :, None, :]).sum(2)
        dy = torch.zeros_like(dx)
        for d in range(min(nd, w)):
            dy[..., :w - d] += dv[:, c:, d, :, d:]
        return dx, dy
    return run


def _cvstem_dw_library(x_cf, y_cf, dz, nd):
    """The materialized cost volume, then cuDNN's conv3d_weight."""
    x = x_cf.permute(0, 2, 3, 1).contiguous()
    y = y_cf.permute(0, 2, 3, 1).contiguous()
    dz_n = _ncdhw(dz)
    shape = (dz.shape[2], 2 * x_cf.shape[1], 3, 3, 3)

    def run():
        vol = cost_volume_cf(x, y, nd).permute(0, 2, 1, 3, 4)
        return torch.nn.grad.conv3d_weight(vol, shape, dz_n, padding=1)
    return run


def _resize_library(x, d2, h2, w2, align_corners=True, transposed=False):
    """One call of F.interpolate(mode="trilinear") on the volume permuted
    to NCDHW (made once, outside the timing); for the adjoint, one call of
    its backward, aten's upsample_trilinear3d_backward."""
    b, d, c, h, w = x.shape
    x_n = _ncdhw(x)
    if not transposed:
        return lambda: F.interpolate(x_n, size=(d2, h2, w2), mode="trilinear",
                                     align_corners=align_corners)
    return lambda: torch.ops.aten.upsample_trilinear3d_backward(
        x_n, [d, h, w], [b, c, d2, h2, w2], align_corners)


def _stem_inputs(b, h, w, co, dev, grad=False):
    """Random features and stem weights at the shapes the stem is given."""
    def t(*shape):
        return torch.randn(*shape, device=dev).requires_grad_(grad)
    return t(b, STEM_C, h, w), t(b, STEM_C, h, w), t(3, 3, 3, 2 * STEM_C, co)


def _dblock_beside(x, w, scale, bias, relu):
    """Kernel A (its own plan) at kernel H's arguments."""
    return {"kernel_a_ms":
            lambda: conv3d_mod.conv3d_affine_cf(x, w, scale, bias, relu)}


def _dblock_plan(x, w, scale, bias, relu):
    """Kernel H's plan (kernel A's engine, db = 4) and kernel A's plan for
    the same call beside it."""
    def fields(p):
        return {"blocks": p.blocks, "tile": f"{p.th}x{p.tw}", "mt": p.mt,
                "nt": p.nt, "n_split": p.n_split, "cc": p.cc, "db": p.db}
    p = conv3d_mod.conv_plan_dblock(*x.shape, w.shape[4])
    return {**fields(p), "smem_bytes": p.smem_for(x.element_size()),
            "kernel_a_plan": fields(conv3d_mod.conv_plan(*x.shape,
                                                         w.shape[4]))}


def _resize_beside(x, d2, h2, w2, align_corners=True, transposed=False):
    """Kernel I through its C entry with the plan, tables and output made
    once (the wrapper's host work left out)."""
    plan, itab, ftab = resize_mod.resize_setup(
        tuple(x.shape), d2, h2, w2, align_corners, transposed, x.device)
    out = torch.empty((x.shape[0], d2, x.shape[2], h2, w2), device=x.device)
    return {"entry_ms": lambda: resize_mod.launch_resize(x, itab, ftab, out,
                                                         plan)}


def _resize_piece(x):
    """Elements of kernel I's staged pieces for x (its instance's rule)."""
    return resize_mod.resize_piece(x.shape[-1], x.data_ptr(),
                                   x.element_size())


def _resize_plan(x, d2, h2, w2, align_corners=True, transposed=False):
    """Kernel I's plan for the call (the float32 plan for either dtype):
    tile, output planes per block, taps a table row, blocks, staged rows
    and elements a row, the elements a staged piece, shared memory for x's
    dtype."""
    b, d, c, h, w = x.shape
    p = resize_mod.resize_plan(b, d, c, h, w, d2, h2, w2, align_corners,
                               transposed)
    piece = _resize_piece(x)
    return {"blocks": p.blocks, "tile": f"{p.th}x{p.tw}", "run": p.run,
            "n_runs": p.n_runs, "k": p.k,
            "staged": f"{p.rows}x{p.pitch_for(piece)}", "piece": piece,
            "smem_bytes": p.smem_for(x.element_size(), piece)}


def _conv_beside(x, w, scale, bias, relu):
    """Kernel A with one output plane per block, and with its 4-byte copy
    path (x copied to an address 4 bytes past a 16-byte boundary)."""
    plan = conv3d_mod.conv_plan(*x.shape, w.shape[4])
    one = plan._replace(db=1, blocks=plan.blocks // -(-x.shape[1] // plan.db)
                        * x.shape[1])
    x4 = torch.empty(x.numel() + 1, device=x.device)[1:].view_as(x)
    x4.copy_(x)
    return {"db1_ms": lambda: conv3d_mod.launch_conv(x, w, scale, bias, relu,
                                                     one),
            "copy4_ms": lambda: conv3d_mod.launch_conv(x4, w, scale, bias,
                                                       relu, plan)}


def _dxy_beside(dz, w3, nd):
    """Kernel E at chunks of 4 and 8 planes beside its plan's."""
    b, d, cout, h, w = dz.shape
    plan = cvstem_mod.dxy_plan(b, d, cout, w3.shape[3] // 2, h, w)
    runs = {}
    for chunk in (4, 8):
        n = -(-d // chunk)
        p = plan._replace(chunk=chunk, n_chunks=n,
                          blocks=plan.blocks // plan.n_chunks * n,
                          workspace=plan.workspace // plan.n_chunks * n)
        runs[f"chunk{chunk}_ms"] = (lambda p=p:
                                    cvstem_mod.launch_dxy(dz, w3, p))
    return runs


def _conv_plan(x, w, scale, bias, relu):
    """Kernel A's plan for the call: its tile, splits, planes per block and
    blocks, and the bound of its TF32 products beside bound_ms."""
    p = conv3d_mod.conv_plan(*x.shape, w.shape[4])
    return {"blocks": p.blocks, "tile": f"{p.th}x{p.tw}", "mt": p.mt,
            "nt": p.nt, "n_split": p.n_split, "cc": p.cc, "db": p.db,
            "smem_bytes": p.smem_for(x.element_size()),
            "bound_tf32_ms": conv_bound(x.shape, w.shape[4], True,
                                        eb=x.element_size())}


def _dw_beside(x, dz):
    """Kernel D's two passes timed apart: the blocks' partials alone, the
    fixed-order sum alone (over a workspace the first pass filled). Other
    blockings are timed by scripts/torch_dw_sweep.py."""
    plan = conv3d_mod.dw_plan(*x.shape, dz.shape[2])
    return {"partial_ms": lambda: conv3d_mod.launch_dw_plan(x, dz, plan, 1),
            "sum_ms": lambda: conv3d_mod.launch_dw_plan(x, dz, plan, 2)}


def _cvstem_beside(x_cf, y_cf, w3, scale, bias, nd, relu=True):
    """Kernel A on the materialized cost volume (made once, outside the
    timing): the same engine with the volume's bytes; and the shear-
    collapsed stem in plain PyTorch, ops.fused_stem.cost_stem_z (rag_tpu's
    RAG_TPU_FUSED_STEM path, pre-affine), at the same features."""
    vol = cvstem_mod._volume(x_cf, y_cf, nd).contiguous()
    return {"kernel_a_on_volume_ms": lambda: conv3d_mod.conv3d_affine_cf(
        vol, w3, scale, bias, relu),
            "fused_stem_ms": lambda: cost_stem_z(x_cf, y_cf, w3, nd)}


def _cvstem_plan(x_cf, y_cf, w3, scale, bias, nd, relu=True):
    """Kernel B's plan (kernel A's engine on the cost volume), kernel A's
    plan for the materialized volume beside it, and the bound of its TF32
    products."""
    b, c, h, w = x_cf.shape
    p = cvstem_mod.cvstem_plan(b, nd, c, h, w, w3.shape[4])
    a = conv3d_mod.conv_plan(b, nd, 2 * c, h, w, w3.shape[4])
    return {"blocks": p.blocks, "tile": f"{p.th}x{p.tw}", "mt": p.mt,
            "nt": p.nt, "n_split": p.n_split, "cc": p.cc, "db": p.db,
            "smem_bytes": p.smem_for(x_cf.element_size()),
            "kernel_a_plan": f"{a.mt},{a.nt},{a.db} {a.th}x{a.tw}",
            "bound_tf32_ms": cvstem_bound(x_cf.shape, nd, w3.shape[4], True,
                                          eb=x_cf.element_size())}


def _cvstem_dw_beside(x_cf, y_cf, dz, nd):
    """Kernel D on the materialized cost volume: alone (the volume made
    once, outside the timing) and with the volume's build, as the plain
    path would run it; kernel F's two passes apart."""
    vol = cvstem_mod._volume(x_cf, y_cf, nd).contiguous()
    b, c, h, w = x_cf.shape
    plan = cvstem_mod.cvstem_dw_plan(b, nd, c, h, w, dz.shape[2])
    return {"kernel_d_on_volume_ms": lambda: conv3d_mod.conv3d_dw_cf(vol, dz),
            "volume_and_kernel_d_ms": lambda: conv3d_mod.conv3d_dw_cf(
                cvstem_mod._volume(x_cf, y_cf, nd).contiguous(), dz),
            "partial_ms": lambda: cvstem_mod.launch_cvstem_dw(x_cf, y_cf, dz,
                                                              plan, 1),
            "sum_ms": lambda: cvstem_mod.launch_cvstem_dw(x_cf, y_cf, dz,
                                                          plan, 2)}


def _cvstem_dw_plan(x_cf, y_cf, dz, nd):
    """Kernel F's plan (kernel D's engine on the cost volume), the share of
    its blocks' plane steps that run, and kernel D's plan for the
    materialized volume beside it."""
    b, c, h, w = x_cf.shape
    p = cvstem_mod.cvstem_dw_plan(b, nd, c, h, w, dz.shape[2])
    d = conv3d_mod.dw_plan(b, nd, 2 * c, h, w, dz.shape[2])
    return {**_dw_fields(p, x_cf.element_size()),
            "live_share": cvstem_mod.cvstem_live_share(p, nd, w),
            "kernel_d_plan": f"{d.th}x{d.tw} db {d.db} co_t {d.co_t} kh_t "
                             f"{d.kh_t}"}


def _dw_fields(p, eb):
    return {"blocks": p.blocks, "threads": p.threads,
            "tile": f"{p.th}x{p.tw}", "groups": p.groups, "db": p.db,
            "ci": p.ci, "n_ci": p.n_ci, "co_t": p.co_t, "n_co": p.n_co,
            "kh_t": p.kh_t, "workspace_bytes": 4 * p.workspace,
            "smem_bytes": p.smem_for(eb)}


def _dw_plan(x, dz):
    """Kernel D's plan for the call: blocks, tile (band of rows x columns),
    row groups, output planes per block, input- and output-channel chunks,
    workspace."""
    return _dw_fields(conv3d_mod.dw_plan(*x.shape, dz.shape[2]),
                      x.element_size())


def _dxy_plan(dz, w3, nd):
    """Kernel E's plan for the call: chunks of planes, blocks, workspace,
    shared memory, and the elements a copy of its staging moves (1: a
    float32 element; bf16: 8 or 4, a piece, or 0, element by element)."""
    b, d, cout, h, w = dz.shape
    p = cvstem_mod.dxy_plan(b, d, cout, w3.shape[3] // 2, h, w)
    return {"n_chunks": p.n_chunks, "chunk": p.chunk, "blocks": p.blocks,
            "workspace_bytes": 4 * p.workspace,
            "smem_bytes": p.smem_for(dz.element_size()),
            "piece": cvstem_mod.dxy_piece(dz)}


def _dxy_bf16_beside(dz, w3, nd):
    """Kernel E's bf16 instance with 8-byte pieces of four (dz copied to
    an address 8 bytes past a 16-byte boundary), beside its 16-byte
    pieces of eight."""
    dz8 = torch.empty(dz.numel() + 4, device=dz.device,
                      dtype=dz.dtype)[4:].view_as(dz)
    dz8.copy_(dz)
    return {"piece4_ms": lambda: cvstem_mod.cvstem_dxy(dz8, w3, nd)}


def _head_plan(x, maxdisp, scale=3):
    """Kernel C's instance (D of the periodic one, 0 = general) and
    blocks."""
    p = disparity_mod.head_plan(*x.shape, maxdisp, scale)
    return {"instance": p.instance, "blocks": p.blocks}


def _head_bwd_plan(x, g, maxdisp, scale=3):
    """Kernel G's instance, strips a row, warps a block, blocks of its two
    passes and workspace."""
    p = disparity_mod.head_bwd_plan(*x.shape, maxdisp)
    return {"instance": p.instance, "strip": p.strip, "strips": p.strips,
            "warps": p.warps, "fold_blocks": p.fold_blocks,
            "gather_blocks": p.gather_blocks,
            "workspace_bytes": 4 * p.workspace}


def _head_bwd_beside(x, g, maxdisp, scale=3):
    """Kernel G's two passes timed apart, as CUDA-graph replays (the H fold
    alone takes less than the wrapper's host time): the D and W folds into
    the workspace alone, the H fold alone (over a workspace left
    unwritten)."""
    plan = disparity_mod.head_bwd_plan(*x.shape, maxdisp)
    return {"fold_ms": lambda: disparity_mod.launch_head_bwd(x, g, maxdisp,
                                                             plan, 1),
            "gather_ms": lambda: disparity_mod.launch_head_bwd(x, g, maxdisp,
                                                               plan, 2)}


def _shear_fields(p):
    return {"grid": p.blocks, "block": p.threads, "staged_bytes": p.smem,
            "planes": p.planes, "cols": p.cols, "runs": p.runs,
            "copy_bytes": p.copy_bytes, "splits": p.splits,
            "col_splits": p.col_splits}


def _shear_plan(px, py, scale, bias, nd, relu=False):
    """Kernel J's launch for the maps' dtype: blocks (a row each), threads
    (a task each: a run of planes down a group of columns), shared memory
    (a piece's staged tap-map rows, P and R), planes and columns a piece,
    pieces a row, bytes a copy; it must equal ops/shear.py::fwd_plan."""
    b, _, co, h, w = px.shape
    p = shear_mod.shear_plan(False, b, nd, co, h, w, px.element_size())
    if p != shear_mod.fwd_plan(b, nd, co, h, w, px.element_size()):
        raise SystemExit(f"chip_smoke: kernel J's launch {p} differs from "
                         "ops/shear.py::fwd_plan")
    return _shear_fields(p)


def _shear_adj_plan(dz, nd):
    """Kernel K's launch for dz's dtype: blocks (row, split), threads
    (walkers), shared memory (the staged run of dz), planes a run, the
    slab's row pitch, runs a row, bytes a copy, splits a row and the column
    blocks among them; it must equal ops/shear.py::adj_plan."""
    b, _, co, h, w = dz.shape
    p = shear_mod.shear_plan(True, b, nd, co, h, w, dz.element_size())
    if p != shear_mod.adj_plan(b, nd, co, h, w, dz.element_size()):
        raise SystemExit(f"chip_smoke: kernel K's launch {p} differs from "
                         "ops/shear.py::adj_plan")
    return _shear_fields(p)


def _shear_beside(px, py, scale, bias, nd, relu=False):
    """The whole shear stem (tap maps + J) against kernel B, on random
    features of the same shapes (they set the work, not the values)."""
    b, _, co, h, w = px.shape
    x, y, w3 = _stem_inputs(b, h, w, co, px.device)
    return {"stem_ms": lambda: shear_mod.shear_stem_brc(x, y, w3, scale,
                                                        bias, nd, relu),
            "kernel_b_ms": lambda: cvstem_mod.cvstem_affine(
                x, y, w3, scale, bias, nd, relu)}


def _shear_adj_beside(dz, nd):
    """The shear stem's whole backward (K, then autograd through the
    tap-map convs to dX, dY, dW) against kernels E + F, on random features
    of the same shapes."""
    b, _, co, h, w = dz.shape
    x, y, w3 = _stem_inputs(b, h, w, co, dz.device, grad=True)
    z = shear_mod.shear_stem_z(x, y, w3, nd)
    xd, yd, wd = x.detach(), y.detach(), w3.detach()
    return {"stem_bwd_ms": lambda: torch.autograd.grad(
                z, (x, y, w3), dz, retain_graph=True),
            "kernel_ef_ms": lambda: (cvstem_mod.cvstem_dxy(dz, wd, nd),
                                     cvstem_mod.cvstem_dw(xd, yd, dz, nd))}


# name -> the module and attribute where the main path looks the kernel's
# wrapper up (record puts the plain version there), the plain version, the
# TPU kernel it replaces, and how to sign, bound and yardstick one call;
# "path": the path it reports from, "serving": whether that path serves
# through it (else it runs in training only); "beside": other calls timed
# at its arguments and printed beside it ("beside_graph": as replays of a
# CUDA graph, free of the host's launch time).
KERNELS = {
    "conv3d_brc_cf": dict(
        site=(conv3d_mod, "conv3d_affine_cf"),
        plain=conv3d_mod.conv3d_brc_cf_plain,
        source="rag_tpu_torch/csrc/conv3d.cu",
        replaces="rag_tpu/ops/pallas_conv3d.py:257",
        sig=lambda x, w, scale, bias, relu: (tuple(x.shape), w.shape[4], relu),
        bound=lambda x, w, scale, bias, relu: conv_bound(
            x.shape, w.shape[4], eb=x.element_size()),
        library=_conv_library, beside=_conv_beside, plan=_conv_plan,
        vec=lambda x, *a: conv3d_mod.stages_in_pieces(x),
        tol="conv", path="default", serving=True),
    "cvstem_brc": dict(
        site=(cvstem_mod, "cvstem_affine"),
        plain=cvstem_mod.cvstem_brc_plain,
        source="rag_tpu_torch/csrc/cvstem.cu",
        replaces="rag_tpu/ops/pallas_cvstem.py:257",
        sig=lambda x, y, w3, scale, bias, nd, relu=True:
            (tuple(x.shape), w3.shape[4], nd, relu),
        bound=lambda x, y, w3, scale, bias, nd, relu=True:
            cvstem_bound(x.shape, nd, w3.shape[4], eb=x.element_size()),
        library=_cvstem_library, beside=_cvstem_beside, plan=_cvstem_plan,
        vec=lambda x, y, *a, **kw: conv3d_mod.stages_in_pieces(x, y),
        tol="conv", path="default", serving=True),
    "fused_soft_argmin": dict(
        site=(disparity_mod, "soft_argmin_fwd"),
        plain=disparity_mod.soft_argmin_disparity,
        source="rag_tpu_torch/csrc/disp_head.cu",
        replaces="rag_tpu/ops/pallas_kernels.py:163",
        sig=lambda x, maxdisp, scale=3: (tuple(x.shape), maxdisp, scale),
        bound=lambda x, maxdisp, scale=3: disp_bound(x.shape, maxdisp, scale),
        library=None, plan=_head_plan, tol="disp", path="default",
        serving=True),
    "conv3d_dw_cf": dict(
        site=(conv3d_mod, "conv3d_dw_cf"),
        plain=conv3d_mod.conv3d_dw_cf_plain,
        source="rag_tpu_torch/csrc/conv3d_dw.cu",
        replaces="rag_tpu/ops/pallas_conv3d.py:561",
        sig=lambda x, dz: (tuple(x.shape), dz.shape[2]),
        bound=lambda x, dz: dw_bound(x.shape, dz.shape[2],
                                     eb=x.element_size()),
        magnitude=lambda x, dz: (x.abs(), dz.abs()),
        library=_dw_library, beside=_dw_beside, plan=_dw_plan, tol="bwd",
        vec=lambda x, dz: conv3d_mod.stages_in_pieces(
            x, dz, n=conv3d_mod.dw_piece(x.element_size())),
        path="default", serving=False, per_shape=True),
    "cvstem_dxy": dict(
        site=(cvstem_mod, "cvstem_dxy"),
        plain=cvstem_mod.cvstem_dxy_plain,
        source="rag_tpu_torch/csrc/cvstem_dxy.cu",
        replaces="rag_tpu/ops/pallas_cvstem.py:384",
        sig=lambda dz, w3, nd: (tuple(dz.shape), w3.shape[3], nd),
        bound=lambda dz, w3, nd: cvstem_dxy_bound(dz.shape, w3.shape[3], nd,
                                                  eb=dz.element_size()),
        magnitude=lambda dz, w3, nd: (dz.abs(), w3.abs(), nd),
        library=_dxy_library, beside=_dxy_beside, plan=_dxy_plan, tol="bwd",
        vec=lambda dz, w3, nd: cvstem_mod.dxy_piece(dz) > 1,
        path="default", serving=False),
    "cvstem_dw": dict(
        site=(cvstem_mod, "cvstem_dw"),
        plain=cvstem_mod.cvstem_dw_plain,
        source="rag_tpu_torch/csrc/cvstem_bwd.cu",
        replaces="rag_tpu/ops/pallas_cvstem.py:476",
        sig=lambda x, y, dz, nd: (tuple(x.shape), dz.shape[2], nd),
        bound=lambda x, y, dz, nd: cvstem_dw_bound(x.shape, dz.shape, nd,
                                                   eb=x.element_size()),
        magnitude=lambda x, y, dz, nd: (x.abs(), y.abs(), dz.abs(), nd),
        library=_cvstem_dw_library, beside=_cvstem_dw_beside,
        plan=_cvstem_dw_plan, tol="bwd", path="default", serving=False,
        vec=lambda x, y, dz, nd: conv3d_mod.stages_in_pieces(
            x, y, dz, n=conv3d_mod.dw_piece(x.element_size()))),
    "soft_argmin_bwd": dict(
        site=(disparity_mod, "soft_argmin_bwd"),
        plain=disparity_mod.soft_argmin_bwd_plain,
        source="rag_tpu_torch/csrc/disp_head.cu",
        replaces="rag_tpu/ops/pallas_kernels.py:295",
        sig=lambda x, g, maxdisp, scale=3: (tuple(x.shape), maxdisp, scale),
        bound=lambda x, g, maxdisp, scale=3:
            disp_bwd_bound(x.shape, maxdisp, scale),
        library=None, beside=_head_bwd_beside, beside_graph=True,
        plan=_head_bwd_plan, tol="bwd", path="default", serving=False),
    "conv3d_dblock_cf": dict(
        site=(conv3d_mod, "conv3d_dblock_cf"),
        plain=conv3d_mod.conv3d_brc_cf_plain,
        source="rag_tpu_torch/csrc/conv3d.cu",
        replaces="rag_tpu/ops/pallas_conv3d.py:314",
        sig=lambda x, w, scale, bias, relu: (tuple(x.shape), w.shape[4], relu),
        bound=lambda x, w, scale, bias, relu: conv_bound(
            x.shape, w.shape[4], eb=x.element_size()),
        library=_conv_library, beside=_dblock_beside, plan=_dblock_plan,
        vec=lambda x, *a: conv3d_mod.stages_in_pieces(x),
        tol="conv", path="variants", serving=True),
    "resize_taps_cf": dict(
        site=(resize_mod, "resize_taps_cf"),
        plain=resize_mod.resize_taps_plain,
        source="rag_tpu_torch/csrc/resize_taps.cu",
        replaces="rag_tpu/ops/pallas_resize.py:123",
        sig=lambda x, d2, h2, w2, align_corners=True, transposed=False:
            (tuple(x.shape), (d2, h2, w2), transposed),
        bound=lambda x, *a, **kw: resize_bound(x.shape, *a, **kw,
                                               eb=x.element_size()),
        library=_resize_library, beside=_resize_beside, plan=_resize_plan,
        vec=lambda x, *a, **kw: _resize_piece(x) > 1,
        tol="conv", path="variants", serving=True),
    "shear_forward": dict(
        site=(shear_mod, "shear_forward"),
        plain=shear_mod.shear_forward_plain,
        source="rag_tpu_torch/csrc/shear.cu",
        replaces="rag_tpu/ops/pallas_shear.py:120",
        sig=lambda px, py, scale, bias, nd, relu=False:
            (tuple(px.shape), nd, relu),
        bound=lambda px, py, scale, bias, nd, relu=False:
            shear_bound(px.shape, nd, relu, eb=px.element_size()),
        library=None, beside=_shear_beside, plan=_shear_plan, tol="conv",
        vec=lambda px, py, *a, **kw: conv3d_mod.stages_in_pieces(px, py),
        path="variants", serving=True),
    "shear_adjoint": dict(
        site=(shear_mod, "shear_adjoint"),
        plain=shear_mod.shear_adjoint_plain,
        source="rag_tpu_torch/csrc/shear.cu",
        replaces="rag_tpu/ops/pallas_shear.py:173",
        sig=lambda dz, nd: (tuple(dz.shape), nd),
        bound=lambda dz, nd: shear_adj_bound(dz.shape, nd,
                                             eb=dz.element_size()),
        magnitude=lambda dz, nd: (dz.abs(), nd),
        library=None, beside=_shear_adj_beside, plan=_shear_adj_plan,
        vec=lambda dz, nd: shear_mod.adj_piece(
            dz.shape[-1], dz.data_ptr(), dz.element_size()) > 1,
        tol="bwd", path="variants", serving=False),
}
for _k in KERNELS.values():
    _k["wrapper"] = getattr(*_k["site"])

# The bf16 instances (bf16 at rest, rag_tpu_torch/ops/precision.py): the
# same wrappers and plain versions on bf16 activations, counted on the
# wrapper's launches_bf16. name -> (positions of the activation arguments,
# the rest float32; whether the output is bf16: D's, F's and K's are
# float32). Each is timed beside its float32 instance on the upcast
# arguments ("f32_ms"). Every one runs the float32 instance's sums on the
# widened values at its plan (plans take shapes only), so its output
# equals the float32 instance's on the upcast arguments, rounded to bf16
# (A, H, B, E, I, J), or outright (D's and F's float32 dW, K's float32
# maps), under torch.equal ("f32_equal"); and at every main-path shape it
# stages with cp.async in pieces ("vec": of four elements in A's engine
# and J, of 16 bytes in D's, of 16 or 8 bytes in E, I and K).
BF16_OF = {"conv3d_brc_cf": ((0,), True), "conv3d_dblock_cf": ((0,), True),
           "cvstem_brc": ((0, 1), True), "conv3d_dw_cf": ((0, 1), False),
           "cvstem_dxy": ((0,), True), "cvstem_dw": ((0, 1, 2), False),
           "resize_taps_cf": ((0,), True), "shear_forward": ((0, 1), True),
           "shear_adjoint": ((0,), False)}


def bf16_name(name: str) -> str:
    return f"{name}[bf16]"


def cast_acts(name, args, dtype):
    """The arguments of kernel ``name`` with its activations in dtype."""
    acts = BF16_OF[name][0]
    return tuple(a.to(dtype) if i in acts else a for i, a in enumerate(args))


# calls timed beside a bf16 instance besides its float32 instance
BF16_BESIDE = {"cvstem_dxy": _dxy_bf16_beside}


def _f32_beside(name):
    wrapper = KERNELS[name]["wrapper"]

    def beside(*args, **kw):
        a32 = cast_acts(name, args, torch.float32)
        extra = BF16_BESIDE[name](*args, **kw) if name in BF16_BESIDE else {}
        return {"f32_ms": lambda: wrapper(*a32, **kw), **extra}
    return beside


BF16_KERNELS = {
    bf16_name(n): {**{k: v for k, v in KERNELS[n].items()
                      if k not in ("beside", "beside_graph", "max_err")},
                   "base": n, "count": "launches_bf16", "bf16_out": out,
                   "beside": _f32_beside(n)}
    for n, (_, out) in BF16_OF.items()}
ALL_KERNELS = {**KERNELS, **BF16_KERNELS}


def launch_count(name: str) -> int:
    k = ALL_KERNELS[name]
    return getattr(k["wrapper"], k.get("count", "launches"))


def zero_launches() -> None:
    """Every launch count, each instance's, set to 0."""
    for k in ALL_KERNELS.values():
        setattr(k["wrapper"], k.get("count", "launches"), 0)


def read_launches() -> dict:
    """Each kernel instance's launch count."""
    return {n: launch_count(n) for n in ALL_KERNELS}

# the kernels each path must run, serving and training (F only where
# stem_3d0 trains); every other kernel must not run on that path
SERVE_KERNELS = {
    "default": ("conv3d_brc_cf", "cvstem_brc", "fused_soft_argmin"),
    "variants": ("conv3d_dblock_cf", "resize_taps_cf", "shear_forward",
                 "fused_soft_argmin")}
TRAIN_KERNELS = {
    "default": SERVE_KERNELS["default"] + (
        "conv3d_dw_cf", "cvstem_dxy", "cvstem_dw", "soft_argmin_bwd"),
    "variants": SERVE_KERNELS["variants"] + (
        "shear_adjoint", "conv3d_dw_cf", "soft_argmin_bwd")}
# under Precision(torch.bfloat16): every kernel that takes bf16 runs its
# bf16 instance; the head (C, G) stays float32
SERVE_BF16 = {p: tuple(bf16_name(k) if k in BF16_OF else k
                       for k in SERVE_KERNELS[p]) for p in PATHS}
TRAIN_BF16 = {p: tuple(bf16_name(k) if k in BF16_OF else k
                       for k in TRAIN_KERNELS[p]) for p in PATHS}


def small_cases(dev, rng):
    """A few small shapes per kernel: Cout 1 with W not a multiple of 8,
    merged Cout 48, D not a multiple of kernel H's 4 planes, a D == W cost
    volume, num_disp past W, W = 13; for kernels B and F at C = 12 (one
    half of the volume a channel chunk) D past W with W % 4 != 0 (4-byte
    copies) and with W % 4 == 0 (16-byte copies; Y's rows at planes
    p % 4 != 0 and the diagonal's pieces in 4-byte ones, up to the right
    edge of a ragged last tile), a 4-tap and a 3-tap adjoint resize
    table, a 4x downsample (kernel I skips the planes and rows it does not
    read) and its adjoint, batch 2 for every kernel; for kernel A's plans
    W = 80 (a 16-wide tile), Cout 12 and 36 (N padded to 16 and 48) and
    Cin 12 and 36 (K padded per stage, three stages per plane at 36); for
    kernel E's, D not a multiple of its chunk (2 planes at small shapes, 16
    at the last, train-sized case) and W past one 64-wide tile."""
    def t(*shape, s=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * s)
                                .astype(np.float32)).to(dev)

    def aff(c):
        return t(c, s=0.3) + 1.0, t(c, s=0.1)

    cases = []
    for b, d, cin, h, w, cout, relu in [(1, 4, 12, 16, 24, 12, True),
                                        (1, 3, 12, 8, 13, 1, False),
                                        (2, 3, 16, 9, 70, 48, True),
                                        (1, 7, 12, 12, 40, 16, True),
                                        (1, 1, 4, 8, 8, 4, False),
                                        (1, 3, 12, 10, 80, 36, True),
                                        (2, 2, 36, 9, 80, 12, False),
                                        (1, 5, 36, 20, 33, 36, True)]:
        args = (t(b, d, cin, h, w), t(3, 3, 3, cin, cout, s=0.2),
                *aff(cout), relu)
        cases.append(("conv3d_brc_cf", args))
        cases.append(("conv3d_dblock_cf", args))
        cases.append(("conv3d_dw_cf", (t(b, d, cin, h, w),
                                       t(b, d, cout, h, w))))
    # kernel D alone: Cin 4 -> 4 at W = 13 (4-byte copies), 8 -> 8 at
    # W = 16, and a shape big enough for a main-path plan (row groups, runs
    # of planes, at least 264 blocks)
    for b, d, cin, h, w, cout in [(1, 3, 4, 10, 13, 4), (2, 3, 8, 9, 16, 8),
                                  (2, 9, 4, 32, 64, 4)]:
        cases.append(("conv3d_dw_cf", (t(b, d, cin, h, w),
                                       t(b, d, cout, h, w))))
    for b, c, h, w, nd, cout in [(1, 12, 8, 20, 6, 12), (1, 2, 8, 8, 8, 3),
                                 (2, 3, 6, 11, 5, 4), (1, 2, 5, 6, 9, 3),
                                 (1, 3, 8, 13, 13, 12),
                                 (2, 12, 9, 130, 11, 12),
                                 (1, 12, 7, 21, 24, 12),
                                 (2, 12, 10, 68, 72, 12)]:
        x, y, w3 = t(b, c, h, w), t(b, c, h, w), t(3, 3, 3, 2 * c, cout, s=0.2)
        dz = t(b, nd, cout, h, w)
        cases.append(("cvstem_brc", (x, y, w3, *aff(cout), nd, True)))
        cases.append(("cvstem_dxy", (dz, w3, nd)))
        cases.append(("cvstem_dw", (x, y, dz, nd)))
        px, py = shear_mod.tap_maps(x, y, w3)
        cases.append(("shear_forward", (px.contiguous(), py.contiguous(),
                                        *aff(cout), nd, True)))
        cases.append(("shear_adjoint", (dz, nd)))
    # kernel E at the train shape with D = 60: chunks of 16, the last of 12
    cases.append(("cvstem_dxy", (t(4, 60, 12, 64, 128),
                                 t(3, 3, 3, 2 * STEM_C, 12, s=0.2), 60)))
    # kernel E's bf16 instance at W not a multiple of its 16-byte piece:
    # W = 100 (8-byte pieces of four, two W tiles), W = 75 (element by
    # element), and W = 64 with dz 8 bytes past a 16-byte boundary (8-byte
    # pieces)
    for b, nd, h, w, off in [(1, 7, 9, 100, 0), (2, 5, 10, 75, 0),
                             (1, 6, 8, 64, 4)]:
        dz = t(b, nd, 12, h, w).to(torch.bfloat16)
        if off:
            dz = torch.empty(dz.numel() + off, device=dev,
                             dtype=dz.dtype)[off:].view_as(dz).copy_(dz)
        cases.append((bf16_name("cvstem_dxy"),
                      (dz, t(3, 3, 3, 2 * STEM_C, 12, s=0.2), nd)))
    for shape, target, tr in [((1, 6, 5, 16, 24), (3, 8, 12), False),
                              ((2, 6, 5, 16, 24), (12, 32, 48), False),
                              ((1, 6, 3, 11, 13), (4, 6, 7), False),
                              ((1, 6, 5, 16, 24), (6, 16, 11), False),
                              ((2, 12, 5, 32, 48), (6, 16, 24), True),
                              ((1, 11, 3, 11, 11), (6, 6, 6), True),
                              ((1, 3, 4, 8, 12), (6, 16, 24), True),
                              ((1, 16, 2, 20, 40), (4, 5, 10), False),
                              ((1, 4, 2, 5, 10), (16, 20, 40), True)]:
        cases.append(("resize_taps_cf", (t(*shape), *target, True, tr)))
    # the bf16 instances of I and K with x or dz 8 bytes past a 16-byte
    # boundary (8-byte pieces of four), and I where a W tile's span starts
    # four columns into its 16-byte piece (a 2x upsample of W = 40)
    def off8(v):
        return torch.empty(v.numel() + 4, device=dev,
                           dtype=v.dtype)[4:].view_as(v).copy_(v)

    for shape, target, tr, off in [((1, 6, 5, 16, 24), (3, 8, 12), False, 1),
                                   ((2, 12, 5, 32, 48), (6, 16, 24), True, 1),
                                   ((1, 8, 3, 20, 40), (16, 40, 80), False,
                                    0)]:
        x = t(*shape).to(torch.bfloat16)
        cases.append((bf16_name("resize_taps_cf"),
                      (off8(x) if off else x, *target, True, tr)))
    cases.append((bf16_name("shear_adjoint"),
                  (off8(t(2, 9, 3, 5, 64).to(torch.bfloat16)), 9)))
    # the head: the periodic instance at D = 8, W = 10; the general one
    # at D = 4 (no instance) and at maxdisp not a multiple of D
    for b, d, h, w, md in [(1, 8, 16, 10, 24), (2, 4, 5, 43, 12),
                           (1, 8, 16, 10, 26)]:
        x = t(b, d, h, w, s=3.0)
        cases.append(("fused_soft_argmin", (x, md, 3)))
        cases.append(("soft_argmin_bwd", (x, t(b, 3 * h, 3 * w), md, 3)))
    return cases


def exact_cases(dev, rng):
    """Kernels J and K on integer-valued inputs, where every order of
    summation is exact and kernel and plain version must agree bit for bit
    (their bf16 instances too: integers in [-3, 4) are exact in bf16; J's
    output is rounded as the plain version's; K's bf16 instance stages in
    16-byte pieces at W = 24 and 520, the diagonal blocks' windows widened
    to pieces of eight, in 8-byte ones at W = 12 and 2100):
    D = 2 (every plane a first or last one) at odd W, the diagonal band,
    the first and last planes and the interior at odd W (4-byte copies)
    and at W % 4 == 0 (16-byte copies and stores), ReLU on and off; D = 1;
    rows wider than one block of K's walkers (K's column and diagonal
    blocks, with runs of planes: W = 520, 2100, 3001) and than one piece of
    J (column tiles: W = 2100, 3001; plane chunks: D = 70); W = 60001, past
    where a whole staged row (J) or plane (K) would fit shared memory."""
    def ints(*shape, lo=-3, hi=4):
        return torch.from_numpy(rng.integers(lo, hi, shape)
                                .astype(np.float32)).to(dev)

    cases = []
    for b, co, h, w, nd, relu in [(2, 3, 5, 13, 2, False),
                                  (1, 4, 6, 21, 9, True),
                                  (1, 4, 5, 24, 7, False),
                                  (1, 3, 4, 12, 1, True),
                                  (1, 2, 2, 520, 40, False),
                                  (1, 1, 2, 2100, 70, True),
                                  (1, 1, 1, 3001, 5, False),
                                  (1, 1, 1, 60001, 3, True)]:
        scale = torch.arange(1, co + 1, dtype=torch.float32, device=dev)
        bias = torch.full((co,), -3.0, device=dev)
        cases.append(("shear_forward", (ints(b, 9, co, h, w),
                                        ints(b, 9, co, h, w), scale, bias,
                                        nd, relu)))
        cases.append(("shear_adjoint", (ints(b, nd, co, h, w), nd)))
    cases += [(bf16_name(n), cast_acts(n, args, torch.bfloat16))
              for n, args in list(cases)]
    return cases


# -- phases ------------------------------------------------------------------

def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (this script never "
                         "falls back to the CPU)")
    smi = nvidia_smi_line()
    log(f"[device] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}"
        f" | nvidia-smi: {smi} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | python {sys.version.split()[0]}")
    return smi


def phase_build() -> None:
    t0 = time.perf_counter()
    path = cuda_lib.build()
    cuda_lib.lib()
    log(f"[build] {path.relative_to(ROOT)} in {time.perf_counter() - t0:.1f} s")
    for line in (path.parent / "ptxas.log").read_text().splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            log(f"[build]   {line.strip()}")


def stereo_pair(rng, h, w, disp):
    """A random smooth texture seen by two cameras: right(x) = left(x + d)
    (disparity d everywhere the left pixel has a match)."""
    coarse = rng.standard_normal((h // 4 + 1, (w + disp) // 4 + 2, 3))
    tex = np.repeat(np.repeat(coarse, 4, 0), 4, 1)[:h, :w + disp]
    tex = (tex + 0.3 * rng.standard_normal(tex.shape)).astype(np.float32)
    return tex[None, :, :w].copy(), tex[None, :, disp:disp + w].copy()


@contextlib.contextmanager
def recording(calls, args_of):
    """Every kernel wrapper replaced by its plain version where the main
    path looks it up; each call's (name, signature) is appended to calls
    and the first real arguments of each signature kept in args_of."""
    def recorder(name):
        def run(*args, **kw):
            sig = KERNELS[name]["sig"](*args, **kw)
            key = (bf16_name(name) if name in BF16_OF
                   and args[0].dtype == torch.bfloat16 else name)
            calls.append((key, sig))
            if (key, sig) not in args_of:
                args_of[(key, sig)] = (
                    tuple(a.detach().clone() if isinstance(a, torch.Tensor)
                          else a for a in args), dict(kw))
            return KERNELS[name]["plain"](*args, **kw)
        return run

    launches0 = read_launches()
    try:
        for n, k in KERNELS.items():
            setattr(*k["site"], recorder(n))
        yield
    finally:
        for k in KERNELS.values():
            setattr(*k["site"], k["wrapper"])
    launched = {n: c - launches0[n] for n, c in read_launches().items()}
    if any(launched.values()):
        raise SystemExit(f"chip_smoke: the plain path launched {launched}")


def count_calls(calls):
    return {k: sum(1 for n, _ in calls if n == k) for k in ALL_KERNELS}


def check_called(what, counts, expected, optional=()):
    """Every expected kernel called (those in optional may not be), and no
    other kernel."""
    bad = [f"no call to {k}" for k in expected
           if counts[k] < 1 and k not in optional]
    bad += [f"{c} calls to {k}" for k, c in counts.items()
            if c and k not in expected]
    if bad:
        raise SystemExit(f"chip_smoke: {what}: " + "; ".join(bad))


def phase_record(ri, requests, args_of, path):
    """The first request of each task path through RoutedInference.predict
    on one path (ri carries its variants) with each kernel's plain version
    in its wrapper's place. Returns the plain disparities and every kernel
    call per task (name, signature)."""
    calls, plain = {}, {}
    for t, reqs in requests.items():
        calls[t] = []
        with recording(calls[t], args_of):
            plain[t] = ri.predict(*reqs[0], task=t)
        n_calls = count_calls(calls[t])
        log(f"[record] {path} task {t}: plain disparity in "
            f"[{plain[t].min():.2f}, {plain[t].max():.2f}], kernel calls "
            f"{n_calls}")
        # a call site the main path no longer reads would leave the kernel
        # unchecked and the "plain" reference running kernels
        check_called(f"{path} task {t}", n_calls, SERVE_KERNELS[path])
    return plain, calls


def leaves(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from leaves(tree[k], f"{prefix}{k}/")
        else:
            yield prefix + k, tree[k]


def train_configs(dev):
    """The two training configurations on a fresh copy of the committed
    checkpoint: task 3's fine-tune stage (BN-train = trainable = the 13
    units task 3 trains) and task 0's stage (every site, BN in train
    mode). name -> (specs, params, stats, sites)."""
    net, _ = load_checkpoint(str(CKPT), 3, device=dev)
    out = {}
    for t in (3, 0):
        specs, params, stats = net.path(net.archis[t])
        out[f"task{t}"] = (specs, params, stats, net.trainable_sites(t))
    return out


def train_batch(dev):
    """Batch 4 of seeded synthetic 192x384 pairs, each one fronto-parallel
    plane at its own disparity, with that ground truth (0 = no match)."""
    rng = np.random.default_rng(1)
    lefts, rights, gts = [], [], []
    for i in range(TRAIN_B):
        disp = 8 + 16 * i
        left, right = stereo_pair(rng, TRAIN_H, TRAIN_W, disp)
        gt = np.full((1, TRAIN_H, TRAIN_W), float(disp), np.float32)
        gt[..., :disp] = 0.0
        lefts.append(left), rights.append(right), gts.append(gt)
    return tuple(torch.from_numpy(np.concatenate(a)).to(dev)
                 for a in (lefts, rights, gts))


def train_step(cfg, params, stats, opt_state, lr, batch, path,
               precision=Precision()):
    specs, _, _, sites = cfg
    step = make_train_step(specs, sites, make_optimizer(WD), maxdisp=MAXDISP,
                           variants=PATHS[path], precision=precision)
    return step(params, stats, opt_state, lr, *batch)


def phase_record_train(dev, args_of, path):
    """One step of each training configuration on one path with the plain
    versions in the wrappers' places. Returns every kernel call per
    configuration and the plain step's dp/lr and new statistics."""
    calls, plain = {}, {}
    batch = train_batch(dev)
    lr = cosine_lr(LR, TRAIN_EPOCHS, 0)
    for name, cfg in train_configs(dev).items():
        _, params, stats, sites = cfg
        before = {k: v.clone() for k, v in leaves(params)}
        calls[name] = []
        t0 = time.perf_counter()
        with recording(calls[name], args_of):
            params, new_stats, _, sc = train_step(
                cfg, params, stats, make_optimizer(WD).init(params), lr, batch,
                path)
        torch.cuda.synchronize()
        plain[name] = (
            {k: (v - before[k]) / lr for k, v in leaves(params)
             if k.split("/")[0] in sites},
            dict(leaves(new_stats)))
        n_calls = count_calls(calls[name])
        log(f"[record-train] {path} {name} ({len(sites)} trainable sites): "
            f"plain step {(time.perf_counter() - t0) * 1e3:.0f} ms, loss "
            f"{float(sc['loss']):.4f}, kernel calls {n_calls}")
        check_called(f"{path} {name}", n_calls, TRAIN_KERNELS[path],
                     () if "stem_3d0" in sites else ("cvstem_dw",))
    return plain, calls


def _max_err(out, ref):
    outs = out if isinstance(out, tuple) else (out,)
    refs = ref if isinstance(ref, tuple) else (ref,)
    err = max(float((o.float() - r.float()).abs().max())
              for o, r in zip(outs, refs))
    return err, max(float(r.float().abs().max()) for r in refs)


def check_kernel(name, args, kw, reps, beside, exact=False):
    """Kernel vs plain on one set of arguments (with exact: bit for bit);
    times of kernel, plain, library and (with beside) the calls timed
    beside it. Returns a result dict (no assertion here). A bf16 instance
    whose output is bf16 is held to one bf16 ulp of its largest value
    beyond its float32 instance's tolerance; every bf16 instance also to
    its float32 instance on the upcast arguments, rounded to bf16, under
    torch.equal (f32_equal)."""
    k = ALL_KERNELS[name]
    with torch.inference_mode():
        out = k["wrapper"](*args, **kw)
        f32_equal = None
        if "base" in k:
            out32 = KERNELS[k["base"]]["wrapper"](
                *cast_acts(k["base"], args, torch.float32), **kw)
            f32_equal = all(torch.equal(o, o32.to(o.dtype)) for o, o32 in zip(
                out if isinstance(out, tuple) else (out,),
                out32 if isinstance(out32, tuple) else (out32,)))
            del out32
        ref = k["plain"](*args, **kw)
        # every kernel sums in a fixed order: the same bits twice
        again = k["wrapper"](*args, **kw)
        same = all(torch.equal(o, a) for o, a in zip(
            out if isinstance(out, tuple) else (out,),
            again if isinstance(again, tuple) else (again,)))
        del again
        torch.cuda.synchronize()
        err, ref_max = _max_err(out, ref)
        out_max = ref_max
        del out, ref
        if k["tol"] == "bwd" and "magnitude" in k:
            mags = k["plain"](*k["magnitude"](*args), **kw)
            ref_max = _max_err(mags, mags)[1]
            del mags
        tol = 0.0 if exact else {"conv": CONV_RTOL * max(1.0, ref_max),
                                 "disp": DISP_ATOL,
                                 "bwd": BWD_RTOL * ref_max}[k["tol"]]
        if k.get("bf16_out") and not exact:
            tol += BF16_RTOL * out_max
        ms = cuda_ms(lambda: k["wrapper"](*args, **kw), reps)
        plain_ms = cuda_ms(lambda: k["plain"](*args, **kw), max(1, reps // 2))
        lib_ms = (cuda_ms(k["library"](*args, **kw), reps)
                  if k["library"] is not None else None)
    extra = {}
    if beside and "beside" in k:
        # outside inference mode: the shear stem's backward is autograd's
        timer = graph_ms if k.get("beside_graph") else cuda_ms
        extra = {f: timer(fn, reps)
                 for f, fn in k["beside"](*args, **kw).items()}
    bound_ms, bound_by = k["bound"](*args, **kw)
    plan = k["plan"](*args, **kw) if "plan" in k else {}
    return dict(err=err, tol=tol,
                ok=bool(err <= tol) and same and f32_equal is not False,
                same=same, f32_equal=f32_equal,
                vec=k["vec"](*args, **kw) if "vec" in k else None, ms=ms,
                plain_ms=plain_ms, lib_ms=lib_ms, bound_ms=bound_ms,
                bound_ops_ms=bound_ms if bound_by == "operations" else 0.0,
                bound_by=bound_by, beside=extra, plan=plan)


def check_weight_pass(dev, rng):
    """Kernel A's first pass (the weights' TF32 split, in mma fragment
    order) against its plain version, bit for bit: K padded per stage (Cin
    12, 36), N padded (Cout 1, 12, 36), a Cout split, 16 channels a stage,
    and kernel B's plan at the eval geometry (two stages of 12 a plane)."""
    plans = [((cin, cout), conv3d_mod.conv_plan(b, d, cin, h, w, cout))
             for cin, cout, b, d, h, w in [
                 (12, 12, 1, 64, 160, 320), (12, 1, 1, 64, 160, 320),
                 (36, 36, 1, 3, 10, 80), (16, 48, 1, 16, 40, 80),
                 (48, 16, 4, 16, 16, 32), (4, 8, 1, 64, 160, 320)]]
    # kernel B's at the eval geometry (the stem's 24 -> 12)
    plans.append(((2 * STEM_C, 12), cvstem_mod.cvstem_plan(
        1, MAXDISP // 3, STEM_C, H // 3, W // 3, 12)))
    for (cin, cout), plan in plans:
        wt = torch.from_numpy(rng.standard_normal((3, 3, 3, cin, cout))
                              .astype(np.float32)).to(dev)
        got = conv3d_mod.pack_weights_cuda(wt, plan)
        want = conv3d_mod.pack_weights_tf32(wt, plan)
        if not torch.equal(got, want):
            raise SystemExit(f"chip_smoke: kernel A's weight pass differs "
                             f"from pack_weights_tf32 at Cin {cin} Cout "
                             f"{cout}")
    log("[kernels] kernel A's weight pass equals pack_weights_tf32 bit for "
        f"bit at {len(plans)} plans (kernel B's at the eval geometry)")


def phase_kernels(args_of, dev, extra_args=None):
    """Every kernel against its plain version: at the recorded main-path
    calls (timed, with the calls beside them), at the calls of the later
    phases' paths that the main path does not make (extra_args, {tag:
    recorded calls}: the learn phase's supernet step, the selfsup phase's
    photometric step; fewer timings, nothing beside), and at the small and
    exact cases."""
    results, failures = {}, []
    rng = np.random.default_rng(7)
    check_weight_pass(dev, rng)
    todo = [("main", name, sig, args, kw)
            for (name, sig), (args, kw) in args_of.items()]
    seen = set(args_of)
    for tag, extra in (extra_args or {}).items():
        for key, (args, kw) in extra.items():
            if key not in seen:
                seen.add(key)
                todo.append((tag, *key, args, kw))
    small = small_cases(dev, rng)
    # the bf16 instances at the same small shapes
    small += [(bf16_name(n), cast_acts(n, args, torch.bfloat16))
              for n, args in small if n in BF16_OF]
    todo += [(where, name, ALL_KERNELS[name]["sig"](*args), args, {})
             for where, cases in (("small", small),
                                  ("exact", exact_cases(dev, rng)))
             for name, args in cases]
    for where, name, sig, args, kw in todo:
        main = where == "main"
        r = check_kernel(name, args, kw, REPS if main else 5 if where in
                         ("small", "exact") else 3, main,
                         exact=where == "exact")
        if main:
            results[(name, sig)] = r
        line = {"kernel": name, "at": where, "sig": str(sig),
                "max_abs_err": r["err"], "tol": r["tol"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "library_ms": r["lib_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "repeat_bit_identical": r["same"], **r["beside"], **r["plan"]}
        if r["vec"] is not None:
            line["vec"] = r["vec"]
        if r["f32_equal"] is not None:
            line["f32_equal"] = r["f32_equal"]
        log(f"[kernels] {json.dumps(line)}")
        if not r["ok"]:
            failures.append(f"{name} {where} {sig}: max_abs_err {r['err']:.3g}"
                            f" (tolerance {r['tol']:.3g}), two launches "
                            f"bit-identical: {r['same']}, equal to the "
                            f"float32 instance: {r['f32_equal']}")
        if main and "base" in ALL_KERNELS[name] and not r["vec"]:
            failures.append(f"{name} {where} {sig}: a main-path bf16 call "
                            "not staged in pieces (vec false)")
        ALL_KERNELS[name].setdefault("max_err", 0.0)
        ALL_KERNELS[name]["max_err"] = max(ALL_KERNELS[name]["max_err"],
                                           r["err"])
    if failures:
        raise SystemExit("chip_smoke: kernels disagree with their plain "
                         "versions:\n  " + "\n  ".join(failures))
    return results


def check_disparity(what, d):
    if d.shape != (1, H, W) or not np.isfinite(d).all():
        return [f"{what}: shape {d.shape} or non-finite values"]
    if d.min() < 0 or d.max() > MAXDISP - 1:
        return [f"{what}: disparity outside [0, {MAXDISP - 1}]"]
    return []


def phase_serve(ri, requests, plain, path, default_outs=None):
    """REQUESTS requests per task path on one path, every launch count set
    to 0 first. The variant path's first disparity per task is also held
    against the default kernel path's (default_outs)."""
    for k in KERNELS.values():
        k["wrapper"].launches = 0
    outs, times = {}, {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for t, reqs in requests.items():
        outs[t], times[t] = [], []
        for left, right in reqs:
            t0 = time.perf_counter()
            disp = ri.predict(left, right, task=t)   # returns on the host
            times[t].append((time.perf_counter() - t0) * 1e3)
            outs[t].append(disp)
    launches = {n: k["wrapper"].launches for n, k in KERNELS.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"[serve] {path}: launches in the main-path run: {launches}; peak "
        f"device memory {peak_gb:.2f} GB")

    failures = [f"{n} never launched" for n in SERVE_KERNELS[path]
                if launches[n] <= 0]
    failures += [f"{n} launched while serving" for n, c in launches.items()
                 if n not in SERVE_KERNELS[path] and c != 0]
    per_task = {}
    for t in requests:
        for i, d in enumerate(outs[t]):
            failures += check_disparity(f"{path} task {t} request {i}", d)
        diff = float(np.abs(outs[t][0] - plain[t]).max())
        if not diff <= SERVE_ATOL:
            failures.append(f"{path} task {t}: kernel path vs plain path "
                            f"{diff:.3g} px > {SERVE_ATOL}")
        vs_default = None
        if default_outs is not None:
            vs_default = float(np.abs(outs[t][0] - default_outs[t][0]).max())
            if not vs_default <= SERVE_ATOL:
                failures.append(f"{path} task {t}: vs the default kernel "
                                f"path {vs_default:.3g} px > {SERVE_ATOL}")
        gt = torch.full((1, H, W), float(TRUE_DISP))
        gt[..., :TRUE_DISP] = 0.0
        m = stereo_metrics(torch.from_numpy(outs[t][0]), gt,
                           (gt > 0) & (gt < MAXDISP))
        steady = times[t][1:] or times[t]
        per_task[t] = dict(first_ms=times[t][0],
                           ms_per_request=float(np.mean(steady)),
                           vs_plain_max_px=diff, vs_default_max_px=vs_default,
                           epe_vs_plane=float(m["EPE"]), d1=float(m["D1"]),
                           peak_gb=peak_gb)
        log(f"[serve] {path} task {t}: {json.dumps(per_task[t])}")
    if failures:
        raise SystemExit("chip_smoke: serve failed:\n  " + "\n  ".join(failures))
    return launches, per_task, outs


def router_bound(params, b, h, w):
    """Least device time of router_logits on (b, h, w, 3) frames: its conv
    products at the float32 peak, or its frames and weights read once."""
    flops, hh, ww = 0, h, w
    for name in ("c0", "c1", "c2"):
        hh, ww = -(-hh // 2), -(-ww // 2)
        kh, kw, cin, cout = params[name].shape
        flops += 2 * b * hh * ww * cout * cin * kh * kw
    nbytes = 4 * (b * h * w * 3 + sum(v.numel() for v in params.values()))
    return _bound(flops, nbytes)


def route_scenes(dev, cache):
    """The canonical run's four styled 480x960 test scenes on the card."""
    return [SyntheticStereoDataset(SCENE_FRAMES, H, W, seed=30 + t,
                                   max_disp=SCENE_DISP,
                                   style=WEATHER_STYLES[t], device=dev,
                                   cache=cache)
            for t in range(len(WEATHER_STYLES))]


def phase_route_setup(dev, cache):
    """Load the committed router onto the card (and onto the CPU), build
    the test scenes on the card, route every left frame on the card and
    again on the CPU in float32: the ids must be equal frame by frame.
    Returns the router, the scenes, the ids per scene and a summary."""
    t0 = time.perf_counter()
    router = load_router(str(CKPT), device=dev)
    router_cpu = load_router(str(CKPT), device="cpu")
    if (router is None or router.num_tasks != 4
            or router.input_key != "left"):
        raise SystemExit(f"chip_smoke: route: {CKPT.relative_to(ROOT)}/"
                         "router.npz missing or not a 4-task router on "
                         "'left' frames")
    scenes = route_scenes(dev, cache)
    ids, failures = [], []
    for t, ds in enumerate(scenes):
        left = next(ds.batches(len(ds), False))["left"]
        if left.device.type != router.device.type:
            raise SystemExit(f"chip_smoke: route: the test scenes are on "
                             f"{left.device}, not on {router.device}")
        ids.append(router.predict(left))
        on_cpu = router_cpu.predict(ds._samples()["left"])
        if not np.array_equal(ids[t], on_cpu):
            failures.append(f"scene {t}: card routes {ids[t].tolist()}, CPU "
                            f"{on_cpu.tolist()}")
    if failures:
        raise SystemExit("chip_smoke: route failed:\n  "
                         + "\n  ".join(failures))
    n = len(scenes)
    confusion = np.zeros((n, router.num_tasks), np.int64)
    for t, i in enumerate(ids):
        np.add.at(confusion[t], i, 1)
    ref = json.loads(RESULT.read_text())["router"]
    summary = dict(scene_accuracy=float(np.trace(confusion) / confusion.sum()),
                   confusion=confusion.tolist(),
                   confusion_result_json=ref["confusion"],
                   card_equals_cpu=True,
                   resident_gb=cache.nbytes / 1e9,
                   setup_s=time.perf_counter() - t0)
    log(f"[route] {CKPT.relative_to(ROOT)}/router.npz on the card; "
        f"{n} scenes x {SCENE_FRAMES} frames of {H}x{W} on the card "
        f"({summary['resident_gb']:.2f} GB); card and CPU route ids equal "
        f"on all {confusion.sum()} frames; scene accuracy "
        f"{summary['scene_accuracy']:.4f}; confusion {summary['confusion']} "
        f"(result.json {ref['confusion']}); {summary['setup_s']:.1f} s")
    return router, scenes, ids, summary


def phase_route(ri, scenes, ids, path):
    """Per path, every launch count set to 0 first: routed evaluation of
    each scene against evaluation on its own task path (equal metrics
    where every frame was routed to its own task), and ROUTE_REQUESTS
    routed requests per scene beside the same requests with the task
    given (equal disparity where the frame was routed right)."""
    for k in KERNELS.values():
        k["wrapper"].launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ref = json.loads(RESULT.read_text())["router"]["routed"]
    per_scene, failures = {}, []
    for t, ds in enumerate(scenes):
        right_scene = bool((ids[t] == t).all())
        routed = ri.evaluate(ds, task=None)
        oracle = ri.evaluate(ds, task=t)
        if right_scene and routed != oracle:
            failures.append(f"{path} scene {t}: routed {routed} != oracle "
                            f"{oracle}")
        host = ds._samples()
        times = {"routed": [], "fixed": []}
        for i in range(ROUTE_REQUESTS):
            left, right = host["left"][i:i + 1], host["right"][i:i + 1]
            order = (("routed", None), ("fixed", t))
            outs = {}
            for kind, task in (order if i % 2 == 0 else order[::-1]):
                t0 = time.perf_counter()
                outs[kind] = ri.predict(left, right, task=task)
                times[kind].append((time.perf_counter() - t0) * 1e3)
                failures += check_disparity(f"{path} scene {t} {kind} "
                                            f"request {i}", outs[kind])
            if ids[t][i] == t and not np.array_equal(outs["routed"],
                                                     outs["fixed"]):
                failures.append(f"{path} scene {t} request {i}: routed "
                                "disparity != the task's")
        per_scene[t] = dict(
            routed_right=right_scene, routed=routed, oracle=oracle,
            d1_vs_result_json=routed["D1"] - ref["D1"][t],
            epe_vs_result_json=routed["EPE"] - ref["EPE"][t],
            routed_ms_per_request=float(np.mean(times["routed"])),
            fixed_ms_per_request=float(np.mean(times["fixed"])))
        log(f"[route] {path} scene {t}: routed D1 {routed['D1']:.6f} EPE "
            f"{routed['EPE']:.6f} (result.json {ref['D1'][t]:.6f} / "
            f"{ref['EPE'][t]:.6f}, diff {per_scene[t]['d1_vs_result_json']:+.2e}"
            f" / {per_scene[t]['epe_vs_result_json']:+.2e}); routed == oracle "
            f"{routed == oracle}; ms/request routed "
            f"{per_scene[t]['routed_ms_per_request']:.2f}, task given "
            f"{per_scene[t]['fixed_ms_per_request']:.2f}")
    launches = {n: k["wrapper"].launches for n, k in KERNELS.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"[route] {path}: launches in the routed run: {launches}; peak "
        f"device memory {peak_gb:.2f} GB (with the resident scenes)")
    failures += [f"{path}: {n} never launched" for n in SERVE_KERNELS[path]
                 if launches[n] <= 0]
    failures += [f"{path}: {n} launched while serving"
                 for n, c in launches.items()
                 if n not in SERVE_KERNELS[path] and c != 0]
    if failures:
        raise SystemExit("chip_smoke: route failed:\n  "
                         + "\n  ".join(failures))
    return launches, dict(scenes=per_scene, peak_gb=peak_gb, routed_ms=float(
        np.mean([v["routed_ms_per_request"] for v in per_scene.values()])),
        fixed_ms=float(np.mean([v["fixed_ms_per_request"]
                                for v in per_scene.values()])))


def router_time(router, scenes):
    """The router alone on one 1x480x960 frame: its logits timed with CUDA
    events back to back (~20 launches, so the host's launch rate shows)
    and as replays of a CUDA graph (device time alone), the host time of
    a routing decision (logits, argmax and the ids' copy to the host), and
    its bound."""
    frame = next(scenes[0].batches(1, False))["left"]
    with torch.inference_mode():
        ms = cuda_ms(lambda: router_logits(router.params, frame), REPS * 2)
        graph = graph_ms(lambda: router_logits(router.params, frame),
                         REPS * 2)
        router.predict(frame)
        host = []
        for _ in range(REPS):
            t0 = time.perf_counter()
            router.predict(frame)
            host.append((time.perf_counter() - t0) * 1e3)
    bound, bound_by = router_bound(router.params, 1, H, W)
    out = dict(logits_ms=ms, logits_graph_ms=graph,
               route_host_ms=float(np.mean(host)),
               bound_ms=bound, bound_by=bound_by)
    log(f"[route] router alone, 1x{H}x{W}: {json.dumps(out)}")
    return out


def _rel_l2(a, b):
    num = sum(float(((x.double().cpu() - y.double()) ** 2).sum())
              for x, y in zip(a, b))
    den = sum(float((y.double() ** 2).sum()) for y in b)
    return (num / den) ** 0.5


def phase_router_train(dev, scenes):
    """A fresh router on the card: its first Adam step against the same
    step of the port on the CPU from the same state and batch, then
    ROUTER_EPOCHS epochs on four styled train scenes (losses finite and
    falling), and its accuracy on the test scenes (not gated: far fewer
    pairs and epochs than the canonical run)."""
    t0 = time.perf_counter()
    cache = DeviceCache()
    train = [SyntheticStereoDataset(ROUTER_TRAIN_PAIRS, ROUTER_TRAIN_H,
                                    ROUTER_TRAIN_W, seed=10 + t,
                                    max_disp=SCENE_DISP,
                                    style=WEATHER_STYLES[t], device=dev,
                                    cache=cache)
             for t in range(len(WEATHER_STYLES))]
    # the first step of train(): scene 0's first batch of epoch 0, label 0
    frames = next(train[0].batches(ROUTER_BATCH, True, seed=0))["left"]
    labels = torch.zeros(frames.shape[0], dtype=torch.int64)
    steps = {}
    for where, x, y in (("card", frames, labels.to(dev)),
                        ("cpu", frames.cpu(), labels)):
        r = SceneRouter(4, seed=0, device=x.device)
        before = r.params
        p, o, loss = make_router_train_step(r.optimizer)(
            r.params, r.opt_state, x, y)
        steps[where] = ([p[k] - before[k] for k in sorted(p)],
                        [o["mu"][k] for k in sorted(p)],
                        [o["nu"][k] for k in sorted(p)], float(loss),
                        int(o["count"]))
    step_err = {name: _rel_l2(steps["card"][i], steps["cpu"][i])
                for i, name in enumerate(("update", "mu", "nu"))}
    failures = [f"first step, {k} vs the CPU: {v:.3g} > {ROUTER_STEP_RTOL}"
                for k, v in step_err.items() if not v <= ROUTER_STEP_RTOL]
    if steps["card"][4] != steps["cpu"][4]:
        failures.append(f"first step: count {steps['card'][4]} != "
                        f"{steps['cpu'][4]}")

    router = SceneRouter(4, seed=0, device=dev)
    for ds in train:        # make and upload every set before the clock
        next(ds.batches(1, False))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    losses = router.train(train, epochs=ROUTER_EPOCHS, batch=ROUTER_BATCH,
                          log=log)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t1
    if (len(losses) != ROUTER_EPOCHS or not np.isfinite(losses).all()
            or not losses[-1] < losses[0]):
        failures.append(f"router losses {losses}: not finite and falling")
    if failures:
        raise SystemExit("chip_smoke: router training failed:\n  "
                         + "\n  ".join(failures))
    acc = router.accuracy(scenes)
    steps_run = int(router.opt_state["count"])
    out = dict(first_step_vs_cpu=step_err,
               first_loss_card=steps["card"][3], first_loss_cpu=steps["cpu"][3],
               losses=losses, steps=steps_run, train_s=train_s,
               ms_per_step=train_s * 1e3 / steps_run,
               test_accuracy=acc, wall_s=time.perf_counter() - t0)
    log(f"[route] router training on the card: {json.dumps(out)}")
    return out


# kinds of device kernel in a trace, matched in order on the lower-cased
# name (the port's A-K first; kernel_kind sorts B and F apart: they are the
# engines of A and D with the cost-volume policy). Kernel H is kernel A's
# engine: "A (H)" is A on the default path, H on the variant path, which
# runs no kernel A; it also holds B's weight pass. "D (F) sum" holds both
# sum passes
KINDS = (("conv3d_tf32x3_kernel", "A (H)"), ("conv3d_pack_kernel", "A (H)"),
         ("conv3d_dw_kernel", "D"),
         ("conv3d_dw_sum_kernel", "D (F) sum"),
         ("cvstem_dxy", "E"),
         ("soft_argmin_kernel", "C"), ("soft_argmin_fold_kernel", "G"),
         ("soft_argmin_gather_kernel", "G"), ("resize_taps_kernel", "I"),
         ("shear_fwd_kernel", "J"), ("shear_adj_kernel", "K"),
         ("gemm", "GEMM"), ("reduce_kernel", "reductions"),
         ("elementwise", "elementwise"), ("cudnn", "cuDNN"),
         ("grad", "cuDNN"), ("conv", "cuDNN"), ("", "other"))


def kernel_kind(name: str) -> str:
    if "CostVolumeSrc" in name:
        return "F" if "conv3d_dw_kernel" in name else "B"
    low = name.lower()
    return next(kind for key, kind in KINDS if key in low)


def device_breakdown(trace: Path) -> dict:
    """ms of device time by kind in an exported chrome trace: each of the
    port's kernels (A and H also count their dx launches), GEMMs,
    reductions, elementwise, cuDNN, copies and the rest."""
    data = json.loads(trace.read_text())
    events = data["traceEvents"] if isinstance(data, dict) else data
    out = {}
    for e in events:
        cat = e.get("cat")
        if cat not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        kind = kernel_kind(e["name"]) if cat == "kernel" else "copies"
        out[kind] = out.get(kind, 0.0) + e.get("dur", 0) / 1e3
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def profile(fn, label: str, out_dir: Path) -> None:
    """torch.profiler over one call of fn (after one warm-up call): the
    kernel table and trace go to out_dir, the device busy share and the
    top device entries to the log."""
    fn()
    torch.cuda.synchronize()
    with trace(str(out_dir / f"trace_{label}")) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    # the attribute's name changed across PyTorch releases
    key = ("self_device_time_total"
           if hasattr(events[0], "self_device_time_total")
           else "self_cuda_time_total")
    # device-side entries only (kernels, copies): the host ops that launch
    # them carry the same time again
    dev_us = sum(getattr(e, key) for e in events
                 if e.device_type == torch.autograd.DeviceType.CUDA)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"profile_{label}.txt").write_text(
        events.table(sort_by=key, row_limit=60))
    trace_file = out_dir / f"trace_{label}" / "trace.json"
    n_dev = sum(e.count for e in events
                if e.device_type == torch.autograd.DeviceType.CUDA)
    log(f"[profile] {label}: wall {wall_ms:.2f} ms, device busy "
        f"{dev_us / 1e3:.2f} ms ({100 * dev_us / 1e3 / wall_ms:.1f}%), "
        f"{n_dev} device operations; ms by kind "
        + json.dumps({k: round(v, 3) for k, v in
                      device_breakdown(trace_file).items()}))
    for e in sorted(events, key=lambda e: -getattr(e, key))[:24]:
        log(f"[profile]   {getattr(e, key) / 1e3:9.3f} ms "
            f"x{e.count:<4d} {e.key[:90]}")


def phase_profile(ris, requests, dev, out_dir: Path) -> None:
    """Per path: one steady request of the last task path and one steady
    train step of task 0's stage under the profiler; then the learn
    phase's first supernet train step (default path)."""
    t = max(requests)
    left, right = requests[t][0]
    batch = train_batch(dev)
    for path, ri in ris.items():
        profile(lambda: ri.predict(left, right, task=t),
                f"serve_task{t}_{path}", out_dir)
        cfg = train_configs(dev)["task0"]
        state = [cfg[1], cfg[2], make_optimizer(WD).init(cfg[1])]

        def step():
            state[:3] = train_step(cfg, *state, LR, batch, path)[:3]
        profile(step, f"train_task0_{path}", out_dir)
    counts = {"trained": 0, "evaluated": 0}
    cs, lr, args = first_supernet_step(dev, learn_scenes(dev, counts)[0][0])
    profile(lambda: supernet_step(cs, lr, args), "supernet_step", out_dir)


def compare_step(name, delta, new_stats, plain):
    """The kernel step's dp/lr and statistics against the plain step's."""
    p_delta, p_stats = plain
    num = sum(float(((delta[k] - p_delta[k]) ** 2).sum()) for k in p_delta)
    den = sum(float((p_delta[k] ** 2).sum()) for k in p_delta)
    rel_l2 = (num / den) ** 0.5
    leaf = max(float((delta[k] - p_delta[k]).abs().max()
                     / p_delta[k].abs().max().clamp(min=1e-30))
               for k in p_delta)
    stats_err = max(float((new_stats[k] - v).abs().max()
                          / max(1.0, float(v.abs().max())))
                    for k, v in p_stats.items())
    log(f"[train] {name}: first step vs plain step: dp/lr relative L2 "
        f"{rel_l2:.3e} (tolerance {STEP_RTOL}), worst leaf max-relative "
        f"{leaf:.3e}; BN statistics {stats_err:.3e} (tolerance {STATS_RTOL})")
    failures = []
    if not rel_l2 <= STEP_RTOL:
        failures.append(f"{name}: dp/lr vs plain step {rel_l2:.3g}")
    if not stats_err <= STATS_RTOL:
        failures.append(f"{name}: statistics vs plain step {stats_err:.3g}")
    return dict(vs_plain_dp_rel_l2=rel_l2, vs_plain_worst_leaf=leaf,
                vs_plain_stats=stats_err), failures


def phase_train(dev, plain, path):
    """TRAIN_STEPS steps of each configuration on one path through
    make_train_step on a fresh copy of the checkpoint, every launch count
    set to 0 first."""
    for k in KERNELS.values():
        k["wrapper"].launches = 0
    batch = train_batch(dev)
    per_cfg, failures = {}, []
    for name, cfg in train_configs(dev).items():
        _, params, stats, sites = cfg
        opt_state = make_optimizer(WD).init(params)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times, losses = [], []
        for i in range(TRAIN_STEPS):
            lr = cosine_lr(LR, TRAIN_EPOCHS, i)
            before = ({k: v.clone() for k, v in leaves(params)} if i == 0
                      else None)
            t0 = time.perf_counter()
            params, stats, opt_state, sc = train_step(
                cfg, params, stats, opt_state, lr, batch, path)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(sc["loss"]))
            if i == 0:
                delta = {k: (v - before[k]) / lr for k, v in leaves(params)
                         if k.split("/")[0] in sites}
                cmp, bad = compare_step(f"{path} {name}", delta,
                                        dict(leaves(stats)), plain[name])
                failures += bad
                del before, delta
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        trained = [k for k, _ in leaves(params) if k.split("/")[0] in sites]
        finite = all(bool(torch.isfinite(v).all()) for k, v in leaves(params)
                     if k in trained)
        if not (finite and all(np.isfinite(losses))):
            failures.append(f"{path} {name}: non-finite loss {losses} or "
                            "leaves")
        steady = times[1:] or times
        ms = float(np.mean(steady))
        per_cfg[name] = dict(sites=len(sites), leaves_trained=len(trained),
                             first_ms=times[0], ms_per_step=ms,
                             pairs_per_s=TRAIN_B / (ms / 1e3),
                             peak_gb=peak_gb, loss=losses, **cmp)
        log(f"[train] {path} {name}: {json.dumps(per_cfg[name])}")
    launches = {n: k["wrapper"].launches for n, k in KERNELS.items()}
    log(f"[train] {path}: launches in the training run: {launches}")
    failures += [f"{path}: {n} never launched" for n in TRAIN_KERNELS[path]
                 if launches[n] <= 0]
    failures += [f"{path}: {n} launched" for n, c in launches.items()
                 if n not in TRAIN_KERNELS[path] and c != 0]
    if failures:
        raise SystemExit("chip_smoke: train failed:\n  " + "\n  ".join(failures))
    return launches, per_cfg


# -- bf16 at rest ------------------------------------------------------------

def phase_record_bf16(dev, args_of, requests, path):
    """One bf16 request (task 0's path) and one bf16 step of task 0's
    configuration on one path, with the plain versions in the wrappers'
    places: the shapes and arguments of the bf16 instances' calls (their
    keys carry "[bf16]"; the head's calls are float32). Returns the calls
    ({"request": ...}, {"task0": ...})."""
    net, _ = load_checkpoint(str(CKPT), 3, device=dev)
    ri = RoutedInference(net, maxdisp=MAXDISP, device=dev,
                         variants=PATHS[path], precision=BF16)
    req, step = [], []
    with recording(req, args_of):
        ri.predict(*requests[0][0], task=0)
    check_called(f"bf16 {path} request", count_calls(req), SERVE_BF16[path])
    cfg = train_configs(dev)["task0"]
    _, params, stats, _ = cfg
    with recording(step, args_of):
        train_step(cfg, params, stats, make_optimizer(WD).init(params),
                   cosine_lr(LR, TRAIN_EPOCHS, 0), train_batch(dev), path,
                   BF16)
    check_called(f"bf16 {path} task0 step", count_calls(step),
                 TRAIN_BF16[path])
    log(f"[record] bf16 {path}: request calls "
        f"{ {k: c for k, c in count_calls(req).items() if c} }, task 0 step "
        f"calls { {k: c for k, c in count_calls(step).items() if c} }")
    return {"request": req}, {"task0": step}


def serve_run(ri, requests):
    """REQUESTS requests per task path through ri, every launch count (both
    instances) set to 0 first: (disparities, ms/request past the first of
    each path, peak GB, launches)."""
    zero_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    outs, times = {}, []
    for t, reqs in requests.items():
        outs[t] = []
        for i, (left, right) in enumerate(reqs):
            t0 = time.perf_counter()
            outs[t].append(ri.predict(left, right, task=t))
            if i:
                times.append((time.perf_counter() - t0) * 1e3)
    return (outs, float(np.mean(times)),
            torch.cuda.max_memory_allocated() / 1e9, read_launches())


def train_run(dev, path, precision):
    """TRAIN_STEPS steps of task 0's configuration on a fresh copy of the
    checkpoint, every launch count set to 0 first: (losses, ms/step past
    the first, peak GB, launches, failures: non-finite or non-float32
    leaves of params, statistics or momentum)."""
    cfg = train_configs(dev)["task0"]
    _, params, stats, _ = cfg
    opt_state = make_optimizer(WD).init(params)
    batch = train_batch(dev)
    zero_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for i in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        params, stats, opt_state, sc = train_step(
            cfg, params, stats, opt_state, cosine_lr(LR, TRAIN_EPOCHS, i),
            batch, path, precision)
        torch.cuda.synchronize()
        if i:
            times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(sc["loss"]))
    bad = [f"{k} {v.dtype}" for tree in (params, stats, opt_state)
           for k, v in leaves(tree)
           if v.dtype != torch.float32 or not bool(torch.isfinite(v).all())]
    return (losses, float(np.mean(times)),
            torch.cuda.max_memory_allocated() / 1e9, read_launches(),
            bad)


def i_failures(seen, path, prec, what, n, units):
    """Kernel I's gate in the bf16 phase: a bf16 run launches I's bf16
    instance (and no float32 I) as often as the float32 run before it
    launched I. ``seen`` collects the launches a unit (request or step)
    per dtype."""
    name = "resize_taps_cf"
    count = n[bf16_name(name)] if prec == "bfloat16" else n[name]
    seen.setdefault(prec, []).append(count / units)
    if prec == "bfloat16" and count != units * seen["float32"][0]:
        return [f"bf16 phase {path} {what}: kernel I's bf16 instance "
                f"launched {count} times, the float32 turn "
                f"{units * seen['float32'][0]:g}"]
    return []


def phase_bf16(dev, net, requests):
    """bf16 at rest against float32, per path in turns (float32, bf16, bf16,
    float32): REQUESTS requests per task path through RoutedInference and
    TRAIN_STEPS steps of task 0's configuration through make_train_step,
    with precision=Precision(torch.bfloat16) or float32. Gates: each run
    launches its kernels' instances and no other (bf16: A, B, C serving
    and A-G training on the default path, H, I, J, C and H-K, C, D, G on
    the variant path); a bf16 run launches kernel I's bf16 instance as
    often as the float32 turn before it launches I; every disparity finite
    in [0, 191];
    each task path's bf16 disparity against the float32 one within
    tests/test_bf16.py's bounds; the bf16 first step's loss within
    BF16_LOSS_RTOL of the float32 one's; every leaf float32 and finite.
    Prints ms/request, ms/step and peak memory beside float32's. Returns
    (bf16 launches summed over the runs, report)."""
    t_phase = time.perf_counter()
    failures, report = [], {}
    launches = dict.fromkeys(BF16_KERNELS, 0)
    n_requests = sum(len(reqs) for reqs in requests.values())
    turns = ("float32", "bfloat16", "bfloat16", "float32")
    for p in PATHS:
        ris = {"float32": RoutedInference(net, maxdisp=MAXDISP, device=dev,
                                          variants=PATHS[p]),
               "bfloat16": RoutedInference(net, maxdisp=MAXDISP, device=dev,
                                           variants=PATHS[p],
                                           precision=BF16)}
        # kernel I's launches a request and a step, float32 and bf16
        i_launches = {"serve": {}, "train": {}}
        serve = {prec: [] for prec in ris}
        first = {}
        for prec in turns:
            outs, ms, gb, n = serve_run(ris[prec], requests)
            must = SERVE_BF16[p] if prec == "bfloat16" else SERVE_KERNELS[p]
            failures += launch_failures(f"bf16 phase {p} {prec} serving", n,
                                        must)
            failures += i_failures(i_launches["serve"], p, prec, "serving",
                                   n, n_requests)
            for t, ds in outs.items():
                for i, d in enumerate(ds):
                    failures += check_disparity(f"{p} {prec} task {t} "
                                                f"request {i}", d)
            first.setdefault(prec, {t: ds[0] for t, ds in outs.items()})
            serve[prec].append({"ms_per_request": ms, "peak_gb": gb})
            if prec == "bfloat16":
                for k in launches:
                    launches[k] += n[k]
        vs = {}
        for t in requests:
            a, b = first["float32"][t], first["bfloat16"][t]
            vs[t] = {"mean_diff_px": float(a.mean() - b.mean()),
                     "mean_abs_diff_px": float(np.abs(a - b).mean()),
                     "max_abs_diff_px": float(np.abs(a - b).max())}
            if not (abs(vs[t]["mean_diff_px"]) < BF16_MEAN_PX
                    and vs[t]["mean_abs_diff_px"] < BF16_ABS_PX):
                failures.append(f"bf16 {p} task {t}: disparity vs float32 "
                                f"{vs[t]} (bounds {BF16_MEAN_PX}, "
                                f"{BF16_ABS_PX} px)")
        train = {prec: [] for prec in ris}
        for prec in turns:
            losses, ms, gb, n, bad = train_run(
                dev, p, BF16 if prec == "bfloat16" else Precision())
            must = TRAIN_BF16[p] if prec == "bfloat16" else TRAIN_KERNELS[p]
            failures += launch_failures(f"bf16 phase {p} {prec} training", n,
                                        must)
            failures += i_failures(i_launches["train"], p, prec, "training",
                                   n, TRAIN_STEPS)
            failures += [f"bf16 {p} {prec} step: leaf {b}" for b in bad]
            if not all(np.isfinite(losses)):
                failures.append(f"bf16 {p} {prec}: losses {losses}")
            train[prec].append({"loss": losses, "ms_per_step": ms,
                                "pairs_per_s": TRAIN_B / (ms / 1e3),
                                "peak_gb": gb})
            if prec == "bfloat16":
                for k in launches:
                    launches[k] += n[k]
        l32, l16 = train["float32"][0]["loss"][0], train["bfloat16"][0]["loss"][0]
        rel = abs(l16 - l32) / max(abs(l32), 1e-12)
        if not rel <= BF16_LOSS_RTOL:
            failures.append(f"bf16 {p}: first-step loss {l16} vs float32 "
                            f"{l32} ({rel:.3g} relative > {BF16_LOSS_RTOL})")
        report[p] = {"serve": serve, "vs_float32": vs, "train": train,
                     "first_step_loss_rel": rel,
                     "kernel_i_launches": i_launches}
        log(f"[bf16] {p}: {json.dumps(report[p])}")
    report["launches"] = {k: c for k, c in launches.items() if c}
    report["wall_s"] = time.perf_counter() - t_phase
    log(f"[bf16] launches of the bf16 instances: "
        f"{json.dumps(report['launches'])}; phase wall time "
        f"{report['wall_s']:.1f} s")
    if failures:
        raise SystemExit("chip_smoke: bf16 failed:\n  " + "\n  ".join(failures))
    return launches, report


# -- the float32 probe and the dp phase --------------------------------------

def _tf32_flags():
    return (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)


def _set_tf32(on: bool) -> None:
    torch.backends.cudnn.allow_tf32 = on
    torch.backends.cuda.matmul.allow_tf32 = on


class Fp32Probe(torch.autograd.Function):
    """The identity, recording both TF32 switches when its backward runs."""
    seen = []

    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        Fp32Probe.seen.append(_tf32_flags())
        return g


@contextlib.contextmanager
def probed_first_conv():
    """The first 2D conv output that needs a gradient (the feature net's
    first conv) passes through Fp32Probe until the block ends."""
    conv = convbr_mod.conv2d_nhwc
    first = []

    def probed(x, w, spec):
        y = conv(x, w, spec)
        if not first and y.requires_grad:
            first.append(spec)
            y = Fp32Probe.apply(y)
        return y

    convbr_mod.conv2d_nhwc = probed
    try:
        yield first
    finally:
        convbr_mod.conv2d_nhwc = conv


def tree_rel_l2(a, b):
    """Relative L2 norm of a - b over the leaves of b (dicts of tensors)."""
    num = sum(float(((a[k].double() - v.double()) ** 2).sum())
              for k, v in b.items())
    den = sum(float((v.double() ** 2).sum()) for v in b.values())
    return (num / max(den, 1e-300)) ** 0.5


def fp32_cases(dev):
    """name -> a function taking one step of that train builder from one
    fixed state and returning its dp/lr by leaf: the builders whose
    backward the float32 scope must cover."""
    cfg = train_configs(dev)["task0"]
    batch = train_batch(dev)
    rng = np.random.default_rng(3)
    depth_gt = torch.from_numpy(rng.uniform(1, 10, (TRAIN_B, TRAIN_H, TRAIN_W))
                                .astype(np.float32)).to(dev)
    dnet = GrowableDepthNet.initial(default_genotype(), 0, dev)
    dspecs, dparams, dstats = dnet.path(dnet.archis[0])
    ops = [np.zeros(NUM_EDGES, np.int32), np.ones(NUM_EDGES, np.int32)]
    lr = cosine_lr(LR, TRAIN_EPOCHS, 0)

    def run(step, params, stats, *args):
        params = clone_tree(params)  # the step updates it in place
        before = dict(leaves(clone_tree(params)))
        opt_state = make_optimizer(WD).init(params)
        params = step(params, stats, opt_state, lr, *args)[0]
        return {k: (v - before[k]) / lr for k, v in leaves(params)}

    specs, params, stats, sites = cfg
    opt = make_optimizer(WD)
    stereo = lambda build, **kw: lambda: run(  # noqa: E731
        build(specs, sites, opt, maxdisp=MAXDISP, **kw), params, stats,
        *batch)
    sup = init_supernet(torch.Generator().manual_seed(0), dev)
    dsup = init_depth_supernet(torch.Generator().manual_seed(0), dev)
    op_stereo, _ = growth_mod.VARIANTS["stereo"][0](
        specs, sites, opt, MAXDISP, KernelVariants(), None)
    op_depth, _ = growth_mod.VARIANTS["depth"][0](
        dspecs, dnet.trainable_sites(0), opt, MAXDISP, KernelVariants(), None)
    return {
        "make_train_step": stereo(make_train_step),
        "make_selfsup_train_step": stereo(make_selfsup_train_step),
        "make_depth_train_step": lambda: run(
            make_depth_train_step(dspecs, dnet.trainable_sites(0), opt),
            dparams, dstats, batch[0], depth_gt),
        "supernet_train_step": lambda: run(
            make_supernet_train_step(opt, MAXDISP), *sup, *batch, *ops),
        "depth_supernet_train_step": lambda: run(
            make_depth_supernet_train_step(opt), *dsup, batch[0], depth_gt,
            *ops),
        "op_search_step": lambda: run(op_stereo, params, stats, *batch),
        "depth_op_search_step": lambda: run(op_depth, dparams, dstats,
                                            batch[0], depth_gt),
    }


# (B, H, W, Cin, Cout) of 3x3 convs of the feature net at a task-0 step
# (the stacked left+right batch): the first stem, the stride-3 stem's
# output width, and a cell's 1/2-scale conv; and the depth net's widest
TF32_CONVS = ((8, 192, 384, 3, 6), (8, 64, 128, 12, 12),
              (8, 32, 64, 12, 12), (4, 16, 32, 48, 48))


def tf32_conv_gap(dev):
    """One ops.convbr.conv2d_nhwc forward and backward per TF32_CONVS shape
    with both switches on against the same with both off: relative L2 of
    the output, dx and dW. Whether cuDNN's TF32 changes these convs' bits
    on this card at all."""
    rng = np.random.default_rng(4)
    out = []
    for b, h, w, cin, cout in TF32_CONVS:
        spec = ConvBRSpec(2, cin, cout, 3)
        x = torch.from_numpy(rng.standard_normal((b, h, w, cin))
                             .astype(np.float32)).to(dev)
        wt = torch.from_numpy(rng.standard_normal((3, 3, cin, cout))
                              .astype(np.float32)).to(dev)
        g = torch.from_numpy(rng.standard_normal((b, h, w, cout))
                             .astype(np.float32)).to(dev)
        res = {}
        for on in (False, True):
            _set_tf32(on)
            try:
                xr, wr = x.clone().requires_grad_(), wt.clone().requires_grad_()
                y = convbr_mod.conv2d_nhwc(xr, wr, spec)
                dx, dw = torch.autograd.grad(y, (xr, wr), g)
                torch.cuda.synchronize()
            finally:
                _set_tf32(False)
            res[on] = {"y": y.detach(), "dx": dx, "dw": dw}
        gap = {k: tree_rel_l2({0: res[True][k]}, {0: res[False][k]})
               for k in ("y", "dx", "dw")}
        out.append({"shape": [b, h, w, cin, cout], **gap})
        log(f"[train] TF32 on vs off, one conv {b}x{h}x{w}, {cin}->{cout}: "
            f"relative L2 y {gap['y']:.3e}, dx {gap['dx']:.3e}, "
            f"dW {gap['dw']:.3e}")
    return out


def phase_fp32_probe(dev):
    """Each train builder's step with both TF32 switches on, as a CLI user
    has them: the probe on the feature net's first conv must see both off
    while its backward runs, and both on again after the step. The step
    is set against the same step with the switches off (relative L2 of
    dp/lr), and against a step whose backward runs outside the float32
    scope, as every builder's did before the scope covered it."""
    report, failures = {}, []
    for name, case in fp32_cases(dev).items():
        runs = {}
        for mode in ("off", "on", "tf32_backward"):
            _set_tf32(mode != "off")
            Fp32Probe.seen.clear()
            saved = trainer_mod.reproducible
            if mode == "tf32_backward":
                trainer_mod.reproducible = contextlib.nullcontext
            try:
                with probed_first_conv() as first:
                    runs[mode] = case()
                torch.cuda.synchronize()
                after = _tf32_flags()
            finally:
                trainer_mod.reproducible = saved
                _set_tf32(False)
            seen = list(Fp32Probe.seen)
            want = [(True, True)] if mode == "tf32_backward" \
                else [(False, False)]
            if not first or seen != want:
                failures.append(f"{name} switches {mode}: the probe saw "
                                f"{seen} during the backward")
            if mode == "on" and after != (True, True):
                failures.append(f"{name}: switches not restored: {after}")
        rel = {m: tree_rel_l2(runs[m], runs["off"])
               for m in ("on", "tf32_backward")}
        report[name] = {"backward_switches": "off",
                        "on_vs_off_rel_l2": rel["on"],
                        "tf32_backward_vs_off_rel_l2": rel["tf32_backward"]}
        log(f"[train] float32 probe {name}: switches on -> backward ran with "
            f"both off, restored after; dp/lr vs switches off: relative L2 "
            f"{rel['on']:.3e}; a backward in TF32 would be {rel['tf32_backward']:.3e} "
            "from it")
        if not rel["on"] <= FP32_PROBE_RTOL:
            failures.append(f"{name}: switches on vs off {rel['on']:.3g} > "
                            f"{FP32_PROBE_RTOL}")
        if not rel["tf32_backward"] > FP32_PROBE_RTOL:
            failures.append(f"{name}: a backward in TF32 reads "
                            f"{rel['tf32_backward']:.3g} <= {FP32_PROBE_RTOL}: "
                            "the gate would not catch it")
    report["one_conv_tf32_on_vs_off"] = tf32_conv_gap(dev)
    if failures:
        raise SystemExit("chip_smoke: float32 probe failed:\n  "
                         + "\n  ".join(failures))
    return report


# -- reproducible training ---------------------------------------------------

REPRO_PAIRS = 3          # step pairs from one state, per train builder and mode
REPRO_REPS = 5           # timed steps a mode, in turns: the scope's cost
REPRO_MAXDISP = 190      # D = 63: kernels C's and G's general instance
REPRO_SCENE = (16, 8, 4)  # train, valid, test pairs a scene, all 192x384
REPRO_CFG = ExperimentConfig(
    cell=CellSearchConfig(epochs=2, batch=4, lr=0.002, lr_a=0.01),
    op=OpSearchConfig(epochs=2, batch=4, lr=0.001, lr_a=0.01, o_size=10),
    train=TrainConfig(epochs=3, batch=4, lr=0.001, weight_decay=0.003),
    num_tasks=2, seed=0, maxdisp=MAXDISP, use_router=True, router_epochs=1,
    router_batch=4)
REPRO_KILL_AT = "[train t1] epoch 2 "  # task 1's fine-tune, after epoch 1's file


def switches():
    """(cudnn.deterministic, cudnn.benchmark, both TF32 switches)."""
    return (torch.backends.cudnn.deterministic,
            torch.backends.cudnn.benchmark, *_tf32_flags())


@contextlib.contextmanager
def parent_switches():
    """The train steps as the parent tree took them: in float32, with
    cuDNN free to pick any algorithm (full_fp32 in reproducible's place)."""
    saved = trainer_mod.reproducible, router_mod.reproducible
    trainer_mod.reproducible = router_mod.reproducible = full_fp32
    try:
        yield
    finally:
        trainer_mod.reproducible, router_mod.reproducible = saved


def flat_leaves(**trees):
    """{'name/site/leaf': tensor} over named trees of nested dicts."""
    return {f"{name}/{k}": v for name, tree in trees.items()
            for k, v in leaves(tree)}


def repro_cases(dev):
    """name -> a function taking one step of that train builder from one
    fixed state and batch and returning every leaf the step leaves:
    params, BatchNorm statistics and optimizer state. The stereo builders
    on task 0's stage of the committed checkpoint (batch 4, 192x384,
    maxdisp 192), make_train_step on each path in float32 and bf16; the
    depth net's task 0, the two supernets, the op searches' steps (every
    BatchNorm frozen) and the router's Adam step."""
    specs, params, stats, sites = train_configs(dev)["task0"]
    batch = train_batch(dev)
    rng = np.random.default_rng(3)
    depth_gt = torch.from_numpy(rng.uniform(1, 10, (TRAIN_B, TRAIN_H, TRAIN_W))
                                .astype(np.float32)).to(dev)
    dnet = GrowableDepthNet.initial(default_genotype(), 0, dev)
    dspecs, dparams, dstats = dnet.path(dnet.archis[0])
    dsites = dnet.trainable_sites(0)
    ops = [np.zeros(NUM_EDGES, np.int32), np.ones(NUM_EDGES, np.int32)]
    sup = init_supernet(torch.Generator().manual_seed(0), dev)
    dsup = init_depth_supernet(torch.Generator().manual_seed(0), dev)
    lr = cosine_lr(LR, TRAIN_EPOCHS, 0)
    opt = make_optimizer(WD)

    def run(step, params, stats, *args):
        params = clone_tree(params)  # the step updates it in place
        p, st, o, _ = step(params, stats, opt.init(params), lr, *args)
        return flat_leaves(params=p, stats=st, momentum=o)

    cases = {}
    for path, variants in PATHS.items():
        for dtype, prec in (("float32", Precision()),
                            ("bf16", Precision(torch.bfloat16))):
            step = make_train_step(specs, sites, opt, maxdisp=MAXDISP,
                                   variants=variants, precision=prec)
            cases[f"make_train_step {path} {dtype}"] = (
                lambda step=step: run(step, params, stats, *batch))
    supernet = make_supernet_train_step(opt, MAXDISP)
    op_stereo, _ = growth_mod.VARIANTS["stereo"][0](
        specs, sites, opt, MAXDISP, KernelVariants(), None)
    op_depth, _ = growth_mod.VARIANTS["depth"][0](
        dspecs, dsites, opt, MAXDISP, KernelVariants(), None)
    selfsup = make_selfsup_train_step(specs, sites, opt, maxdisp=MAXDISP)
    depth = make_depth_train_step(dspecs, dsites, opt)
    dsupernet = make_depth_supernet_train_step(opt)
    router = SceneRouter(4, seed=0, device=dev)
    router_step = make_router_train_step(router.optimizer)
    labels = torch.arange(TRAIN_B, device=dev) % 4
    cases.update({
        "make_supernet_train_step": lambda: run(supernet, *sup, *batch, *ops),
        "op search _stereo_steps": lambda: run(op_stereo, params, stats,
                                               *batch),
        "op search _depth_steps": lambda: run(op_depth, dparams, dstats,
                                              batch[0], depth_gt),
        "make_selfsup_train_step": lambda: run(selfsup, params, stats,
                                               *batch),
        "make_depth_train_step": lambda: run(depth, dparams, dstats,
                                             batch[0], depth_gt),
        "make_depth_supernet_train_step": lambda: run(
            dsupernet, *dsup, batch[0], depth_gt, *ops),
        "router Adam step": lambda: flat_leaves(**dict(zip(
            ("params", "adam"), router_step(router.params, router.opt_state,
                                            batch[0], labels)[:2]))),
    })
    return cases


def step_diff(a, b):
    """The leaves of two step results whose bits differ, and the largest
    difference among them."""
    bad = [k for k in a if not torch.equal(a[k], b[k])]
    worst = max((float((a[k].double() - b[k].double()).abs().max())
                 for k in bad), default=0.0)
    return bad, worst


@contextlib.contextmanager
def grads_in_order(out):
    """Every train step's gradients, appended to out as (leaf, gradient)
    in the order its backward produces them."""
    orig = trainer_mod.differentiable

    def keep(params, sites):
        handles, p = orig(params, sites)
        for path, h in handles.items():
            h.register_hook(lambda g, path=path: out.append(
                (path, g.detach().clone())))
        return handles, p

    trainer_mod.differentiable = keep
    try:
        yield
    finally:
        trainer_mod.differentiable = orig


class ConvTap(torch.autograd.Function):
    """The identity on a 2D conv's output; its backward keeps the output's
    gradient in the conv's record."""

    @staticmethod
    def forward(ctx, y, rec):
        ctx.rec = rec
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        ctx.rec["g"] = g.detach().clone()
        return g, None


@contextlib.contextmanager
def tapped_convs(recs):
    """Every F.conv2d without bias whose output needs a gradient (the
    feature nets', the depth net's and the router's) appends its inputs,
    layout kept, and after the backward its output's gradient to recs."""
    conv = F.conv2d

    def tapped(x, w, bias=None, stride=1, padding=0, *a, **kw):
        y = conv(x, w, bias, stride, padding, *a, **kw)
        if y.requires_grad and bias is None and not a and not kw:
            rec = {"x": x.detach(), "w": w.detach(), "dx": x.requires_grad,
                   "stride": stride, "padding": padding}
            recs.append(rec)
            y = ConvTap.apply(y, rec)
        return y

    F.conv2d = tapped
    try:
        yield
    finally:
        F.conv2d = conv


def conv_backward(rec, deterministic):
    """dX (where the step took it) and dW of one tapped conv from its
    inputs and output gradient, in float32, with cuDNN's deterministic
    switch as given."""
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = deterministic
    try:
        with full_fp32(), torch.enable_grad():
            x = rec["x"].clone().requires_grad_(rec["dx"])
            w = rec["w"].clone().requires_grad_()
            y = F.conv2d(x, w, None, rec["stride"], rec["padding"])
            return torch.autograd.grad(y, (x, w) if rec["dx"] else (w,),
                                       rec["g"])
    finally:
        torch.backends.cudnn.deterministic = saved


def device_kernels(fn):
    """{device kernel name: ms} of one call of fn under torch.profiler."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    key = ("self_device_time_total"
           if hasattr(events[0], "self_device_time_total")
           else "self_cuda_time_total")
    return {e.key: getattr(e, key) / 1e3 for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA}


def conv_suspects(case, profiled):
    """The 2D convs of one step (parent switches) whose backward, replayed
    twice from the same inputs and output gradient, gives other bits; for
    each, the two replays with cuDNN's deterministic switch on, and for
    the first of a shape not in ``profiled`` (added to it) the device
    kernels of one replay in each mode (the algorithms cuDNN picked)."""
    recs = []
    with tapped_convs(recs):
        case()
    out = []
    for rec in recs:
        if "g" not in rec:
            continue
        runs = [conv_backward(rec, False) for _ in range(2)]
        differ = [n for n, a, b in zip(("dX", "dW") if rec["dx"] else
                                       ("dW",), *runs) if not torch.equal(a, b)]
        if not differ:
            continue
        fixed = [conv_backward(rec, True) for _ in range(2)]
        entry = {"x": list(rec["x"].shape), "x_dtype": str(rec["x"].dtype),
                 "w": list(rec["w"].shape), "stride": rec["stride"],
                 "padding": rec["padding"], "differ": differ,
                 "deterministic_equal": all(
                     torch.equal(a, b) for a, b in zip(*fixed))}
        key = (entry["x"], entry["x_dtype"], entry["w"], entry["stride"])
        if not out and str(key) not in profiled:
            profiled.add(str(key))
            entry["kernels"] = {
                m: sorted(device_kernels(lambda d=d: conv_backward(rec, d)))
                for m, d in (("parent", False), ("deterministic", True))}
        out.append(entry)
    return out, len(recs)


def warned_ops(case):
    """The ops of one step that warn under torch.use_deterministic_
    algorithms(True, warn_only=True): each message's head (cuDNN is
    deterministic in that mode and never warns)."""
    det = getattr(torch.utils, "deterministic", None)
    fill = getattr(det, "fill_uninitialized_memory", None)
    if fill is not None:
        det.fill_uninitialized_memory = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            case()
            torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
        if fill is not None:
            det.fill_uninitialized_memory = fill
    heads = set()
    for w in caught:
        msg = str(w.message)
        if "CuBLAS" in msg:
            heads.add("cuBLAS (CUBLAS_WORKSPACE_CONFIG unset)")
        elif "deterministic" in msg:
            heads.add(msg.split(" does not have")[0][:120])
    return sorted(heads)


def repro_parent(name, case, profiled):
    """REPRO_PAIRS step pairs of one builder under the parent's switches:
    how many pairs differ, which leaves, the first gradient (in the
    backward's order) that differs, the ops that warn in deterministic
    mode and, where a pair differed, the conv replays."""
    t0 = time.perf_counter()
    unequal, bad_leaves, worst, first_grad = 0, set(), 0.0, None
    with parent_switches():
        for _ in range(REPRO_PAIRS):
            ga, gb = [], []
            with grads_in_order(ga):
                a = case()
            with grads_in_order(gb):
                b = case()
            bad, w = step_diff(a, b)
            if bad:
                unequal += 1
                bad_leaves.update(bad)
                worst = max(worst, w)
                if first_grad is None:
                    first_grad = next((k for (k, g), (_, h) in zip(ga, gb)
                                       if not torch.equal(g, h)), None)
            n_leaves = len(a)
            del a, b, ga, gb
        ops = warned_ops(case)
        convs, n_convs = (conv_suspects(case, profiled) if unequal
                          else ([], None))
    out = dict(pairs=REPRO_PAIRS, unequal_pairs=unequal, leaves=n_leaves,
               differing_leaves=len(bad_leaves),
               first_differing_leaves=sorted(bad_leaves)[:6],
               max_abs_diff=worst, first_differing_grad=first_grad,
               warn_only_ops=ops, convs_tapped=n_convs,
               conv_backward_differs=convs, s=time.perf_counter() - t0)
    log(f"[repro] {name}, parent's switches: {json.dumps(out)}")
    return out


def repro_scope(name, case):
    """REPRO_PAIRS step pairs of one builder as the port takes them: every
    leaf must be equal under torch.equal, and the caller's switches as
    they were after the steps."""
    t0 = time.perf_counter()
    before, failures, unequal = switches(), [], 0
    for i in range(REPRO_PAIRS):
        a, b = case(), case()
        bad, worst = step_diff(a, b)
        if bad:
            unequal += 1
            failures.append(f"{name} pair {i}: {len(bad)} of {len(a)} leaves "
                            f"differ (first {bad[0]}, max |diff| {worst:.3g})")
        n_leaves = len(a)
        del a, b
    if switches() != before:
        failures.append(f"{name}: switches {switches()} after the steps, "
                        f"{before} before")
    out = dict(pairs=REPRO_PAIRS, unequal_pairs=unequal, leaves=n_leaves,
               all_equal=unequal == 0, s=time.perf_counter() - t0)
    log(f"[repro] {name}, reproducible(): {json.dumps(out)}")
    return out, failures


def scope_cost(name, case, profiled=False):
    """One builder's step with the scope and with the parent's switches:
    REPRO_REPS steps a mode in turns on the host clock (synchronized), the
    device time of REPRO_REPS steps back to back (CUDA events,
    utils.timing.cuda_ms) and, where profiled, the device kernels of one
    step in each mode under the profiler (busy ms, and the kernels whose
    time moved most)."""
    modes = {"scope": contextlib.nullcontext, "parent": parent_switches}
    wall = {m: [] for m in modes}
    for i in range(REPRO_REPS):
        for m in (("scope", "parent") if i % 2 == 0 else ("parent", "scope")):
            with modes[m]():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                case()
                torch.cuda.synchronize()
                wall[m].append((time.perf_counter() - t0) * 1e3)
    out, kernels = {}, {}
    for m, ctx in modes.items():
        with ctx():
            out[m] = dict(wall_ms=wall[m],
                          wall_ms_median=float(np.median(wall[m])),
                          device_ms=cuda_ms(case, REPRO_REPS, warmup=0))
            if profiled:
                kernels[m] = device_kernels(case)
                out[m]["busy_ms"] = sum(kernels[m].values())
    out["device_cost"] = (out["scope"]["device_ms"]
                          / out["parent"]["device_ms"] - 1)
    if profiled:
        moved = {k: kernels["scope"].get(k, 0.0)
                 - kernels["parent"].get(k, 0.0)
                 for k in set(kernels["scope"]) | set(kernels["parent"])}
        out["kernels_moved_ms"] = {k[:100]: v for k, v in sorted(
            moved.items(), key=lambda kv: -abs(kv[1]))[:6] if v}
        out["busy_cost"] = (out["scope"]["busy_ms"]
                            / out["parent"]["busy_ms"] - 1)
    log(f"[repro] cost of reproducible(), {name}: {json.dumps(out)}")
    return out


def repro_maxdisp(dev):
    """One task-0 step at maxdisp REPRO_MAXDISP (D = 63: kernels C and G
    take their general instance) through the kernels against the same
    step with the plain versions (STEP_RTOL, STATS_RTOL), C's and G's
    launches in it, and each of their calls there against its plain
    version and twice against itself."""
    specs, params, stats, sites = train_configs(dev)["task0"]
    batch = train_batch(dev)
    lr = cosine_lr(LR, TRAIN_EPOCHS, 0)
    opt = make_optimizer(WD)
    step = make_train_step(specs, sites, opt, maxdisp=REPRO_MAXDISP)
    d = REPRO_MAXDISP // 3

    def one():
        before = dict(leaves(params))
        p = clone_tree(params)  # the step updates it in place
        p, st, _, _ = step(p, stats, opt.init(p), lr, *batch)
        return ({k: (v - before[k]) / lr for k, v in leaves(p)
                 if k.split("/")[0] in sites}, dict(leaves(st)))

    calls, args_of = [], {}
    with recording(calls, args_of):
        plain = one()
    zero_launches()
    delta, new_stats = one()
    torch.cuda.synchronize()
    n = read_launches()
    cmp, failures = compare_step(f"maxdisp {REPRO_MAXDISP} task0", delta,
                                 new_stats, plain)
    instance = disparity_mod.head_instance(d, REPRO_MAXDISP)
    if instance != 0:
        failures.append(f"maxdisp {REPRO_MAXDISP}: instance {instance}, not "
                        "the general one")
    failures += [f"maxdisp {REPRO_MAXDISP}: {k} never launched"
                 for k in (KC, KG) if n[k] < 1]
    kernels = []
    for (name, sig), (args, kw) in args_of.items():
        if name not in (KC, KG):
            continue
        r = check_kernel(name, args, kw, 5, False)
        line = {"kernel": name, "at": f"train maxdisp {REPRO_MAXDISP}",
                "sig": str(sig), "max_abs_err": r["err"], "tol": r["tol"],
                "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "repeat_bit_identical": r["same"], **r["plan"]}
        log(f"[kernels] {json.dumps(line)}")
        kernels.append(line)
        if not r["ok"]:
            failures.append(f"maxdisp {REPRO_MAXDISP}: {name} {sig} "
                            f"max_abs_err {r['err']:.3g} (tolerance "
                            f"{r['tol']:.3g}), bit-identical twice: "
                            f"{r['same']}")
    out = dict(maxdisp=REPRO_MAXDISP, d=d, instance=instance,
               general_launches={k: n[k] for k in (KC, KG)},
               launches={k: c for k, c in n.items() if c}, **cmp,
               kernels=kernels)
    log(f"[repro] maxdisp {REPRO_MAXDISP}: {json.dumps(out)}")
    return out, failures


def net_leaves(drv):
    """Every leaf of a driver's network (units' and heads' params and
    statistics) and of its router's state, by name."""
    out = {}
    for kind in ("units", "heads"):
        for name, units in getattr(drv.net, kind).items():
            for i, u in enumerate(units):
                out.update(flat_leaves(**{
                    f"{kind}/{name}/{i}/params": u.params,
                    f"{kind}/{name}/{i}/stats": u.stats}))
    if drv.router is not None:
        out.update({f"router/{k}": torch.from_numpy(np.asarray(v))
                    for k, v in drv.router.state_arrays().items()})
    return out


def repro_resume(dev):
    """A 2-task ContinualDriver.run on synthetic scenes held on the card
    (REPRO_SCENE pairs of 192x384 a scene, REPRO_CFG: batch 4, stage
    files every epoch, the router), killed in task 1's fine-tune right
    after epoch 1's stage file (an exception from its log callback), then
    run(resume=True): the whole forgetting matrix and every leaf of the
    network and the router must equal the uninterrupted run's bit for
    bit."""
    cache = DeviceCache()
    scenes = tuple(
        [SyntheticStereoDataset(n, TRAIN_H, TRAIN_W, seed=seed + t,
                                max_disp=LEARN_SCENE_DISP,
                                style=WEATHER_STYLES[t], device=dev,
                                cache=cache) for t in range(2)]
        for n, seed in zip(REPRO_SCENE, (10, 20, 30)))

    def run(ckpt, kill_at=None, resume=False):
        lines = []

        def log_line(msg):
            lines.append(str(msg))
            if kill_at is not None and str(msg).startswith(kill_at):
                raise Killed(msg)

        drv = ContinualDriver(REPRO_CFG, log=log_line,
                              checkpoint_dir=str(ckpt), device=dev)
        drv.stage_checkpoint_every = 1
        t0 = time.perf_counter()
        try:
            matrix = drv.run(*scenes, resume=resume)
        except Killed:
            matrix = None
        torch.cuda.synchronize()
        return drv, matrix, lines, time.perf_counter() - t0

    failures = []
    with tempfile.TemporaryDirectory() as tmp:
        whole, m_whole, _, s_whole = run(Path(tmp) / "whole")
        ckpt = Path(tmp) / "killed"
        _, m_killed, _, s_killed = run(ckpt, kill_at=REPRO_KILL_AT)
        stage = ckpt / "finetune_t1.npz"
        epoch = int(np.load(stage)["epoch"]) if stage.exists() else None
        if m_killed is not None or epoch != 1:
            failures.append(f"resume: the run was not killed after epoch 1's "
                            f"stage file (finished {m_killed is not None}, "
                            f"stage file epoch {epoch})")
        resumed, m_resumed, lines, s_resumed = run(ckpt, resume=True)
    if not any("resumed at epoch" in m for m in lines):
        failures.append("resume: the fine-tune did not re-enter from its "
                        "stage file")
    bad_metrics = [k for k in m_whole.m
                   if not np.array_equal(m_resumed.m[k], m_whole.m[k],
                                         equal_nan=True)]
    a, b = net_leaves(resumed), net_leaves(whole)
    bad = sorted(set(a) ^ set(b)) + [k for k in b if k in a
                                     and not torch.equal(a[k], b[k])]
    if resumed.net.archis != whole.net.archis:
        bad.append("archis")
    if resumed.net.genotypes != whole.net.genotypes:
        bad.append("genotypes")
    if bad_metrics or bad:
        failures.append(f"resume: metrics {bad_metrics} and {len(bad)} "
                        f"leaves (first {bad[:4]}) differ from the "
                        "uninterrupted run")
    out = dict(tasks=2, pairs_per_scene=list(REPRO_SCENE),
               hw=[TRAIN_H, TRAIN_W], kill_at=REPRO_KILL_AT,
               stage_file_epoch=epoch, leaves=len(b),
               metrics=sorted(m_whole.m), matrix_equal=not bad_metrics,
               leaves_equal=not bad,
               matrix={k: m_whole.m[k].tolist() for k in ("D1", "EPE")},
               seconds={"uninterrupted": s_whole, "killed": s_killed,
                        "resumed": s_resumed})
    log(f"[repro] kill and resume on the card: {json.dumps(out)}")
    return out, failures


def phase_repro(dev):
    """Reproducible training: every train builder's step twice from one
    state, REPRO_PAIRS times, first under the parent's switches (what
    differs, and the op behind it), then as the port takes it (every leaf
    equal: hard); the scope's cost on a task-0 step and a supernet step;
    a task-0 step at maxdisp REPRO_MAXDISP through the kernels against
    plain (kernels C's and G's general instance); a killed and resumed
    2-task continual run against the uninterrupted one (bit for bit).
    Every launch count is set to 0 first; returns them with the report."""
    t0 = time.perf_counter()
    cases = repro_cases(dev)
    builders, failures, profiled = {}, [], set()
    zero_launches()
    for name, case in cases.items():
        parent = repro_parent(name, case, profiled)
        scope, bad = repro_scope(name, case)
        failures += bad
        builders[name] = {"parent": parent, "scope": scope}
    t1 = time.perf_counter()
    cost = {name: scope_cost(name, cases[name], profiled)
            for name, profiled in (("make_train_step default float32", True),
                                   ("make_supernet_train_step", False))}
    cost["s"] = time.perf_counter() - t1
    n = read_launches()
    del cases
    torch.cuda.empty_cache()
    maxdisp, bad = repro_maxdisp(dev)
    failures += bad
    torch.cuda.empty_cache()
    zero_launches()
    resume, bad = repro_resume(dev)
    failures += bad
    n = {k: c + maxdisp["launches"].get(k, 0) + launch_count(k)
         for k, c in n.items()}
    report = dict(builders=builders, cost=cost, maxdisp=maxdisp,
                  resume=resume, wall_s=time.perf_counter() - t0)
    differed = [k for k, b in builders.items()
                if b["parent"]["unequal_pairs"]]
    log(f"[repro] unequal bits in {REPRO_PAIRS} pairs: under the parent's "
        f"switches {len(differed)} of {len(builders)} builders "
        f"({differed}); with reproducible() "
        f"{sum(b['scope']['unequal_pairs'] > 0 for b in builders.values())};"
        f" wall time {report['wall_s']:.1f} s")
    if failures:
        raise SystemExit("chip_smoke: reproducible training failed:\n  "
                         + "\n  ".join(failures))
    return n, report


def phase_dp(dev, plain, train_turns, smi, profile_dir=None):
    """The data-parallel step on a world of one: one NCCL process group
    on the card, task 0's training configuration through
    make_train_step(mesh=make_mesh(1)) for TRAIN_STEPS steps with every
    launch count set to 0 first; measure_scaling's world-1 row. With
    profile_dir, one more dp step under the profiler (after the counts
    are read)."""
    t_phase = time.perf_counter()
    initialize_multihost(local_address(), 1, 0, device=dev)
    try:
        mesh = make_mesh(1)
        specs, params, stats, sites = train_configs(dev)["task0"]
        batch = train_batch(dev)
        lr0 = cosine_lr(LR, TRAIN_EPOCHS, 0)
        # the same first step without a mesh, through the kernels
        ref_params = clone_tree(params)
        before = dict(leaves(params))
        make_train_step(specs, sites, make_optimizer(WD), maxdisp=MAXDISP)(
            ref_params, stats, make_optimizer(WD).init(ref_params), lr0,
            *batch)
        ref_delta = {k: (v - before[k]) / lr0 for k, v in leaves(ref_params)
                     if k.split("/")[0] in sites}
        del ref_params
        step = make_train_step(specs, sites, make_optimizer(WD),
                               maxdisp=MAXDISP, mesh=mesh)
        opt_state = make_optimizer(WD).init(params)
        zero_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times, losses, reduces, failures = [], [], [], []
        for i in range(TRAIN_STEPS):
            lr = cosine_lr(LR, TRAIN_EPOCHS, i)
            before = dict(leaves(params)) if i == 0 else None
            if before is not None:
                before = {k: v.clone() for k, v in before.items()}
            ALL_REDUCES.count = 0
            t0 = time.perf_counter()
            params, stats, opt_state, sc = step(params, stats, opt_state, lr,
                                                *batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            reduces.append(ALL_REDUCES.count)
            losses.append(float(sc["loss"]))
            if i == 0:
                delta = {k: (v - before[k]) / lr for k, v in leaves(params)
                         if k.split("/")[0] in sites}
                cmp, bad = compare_step("dp world 1 task0", delta,
                                        dict(leaves(stats)), plain["task0"])
                failures += bad
                vs_kernel = tree_rel_l2(delta, ref_delta)
                del before, delta
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        launches = read_launches()
        failures += launch_failures("dp", launches, TRAIN_KERNELS["default"])
        if any(n != DP_ALL_REDUCES for n in reduces):
            failures.append(f"dp: all-reduces per step {reduces}, the CPU "
                            f"test's world 2 issues {DP_ALL_REDUCES}")
        if not all(np.isfinite(losses)):
            failures.append(f"dp: non-finite loss {losses}")
        steady = times[1:] or times
        ms = float(np.mean(steady))
        non_dp = [t["task0"] for t in train_turns]
        report = dict(
            world=1, backend=dist.get_backend(), config="task0",
            batch=TRAIN_B, hw=[TRAIN_H, TRAIN_W], maxdisp=MAXDISP,
            first_ms=times[0], ms_per_step=ms,
            pairs_per_s=TRAIN_B / (ms / 1e3), peak_gb=peak_gb, loss=losses,
            all_reduces_per_step=reduces, vs_non_dp_kernel_step_rel_l2=vs_kernel,
            non_dp_ms_per_step=[t["ms_per_step"] for t in non_dp],
            non_dp_pairs_per_s=[t["pairs_per_s"] for t in non_dp], **cmp,
            launches=launches)
        log(f"[dp] world 1 ({report['backend']}), task0: {ms:.2f} ms/step, "
            f"{report['pairs_per_s']:.2f} pairs/s (without a mesh, train "
            f"phase default turns: "
            + ", ".join(f"{t:.2f}" for t in report["non_dp_ms_per_step"])
            + f" ms/step); {reduces} all-reduces a step; dp/lr vs the "
            f"step without a mesh: relative L2 {vs_kernel:.3e}; launches "
            f"{launches}")
        if failures:
            raise SystemExit("chip_smoke: dp failed:\n  "
                             + "\n  ".join(failures))
        # the step without a mesh and the dp step, interleaved (each pair
        # in alternating order) from states of their own
        plain_step = make_train_step(specs, sites, make_optimizer(WD),
                                     maxdisp=MAXDISP)
        pp = clone_tree(params)
        runs = {"no_mesh": (plain_step, [pp, stats,
                                         make_optimizer(WD).init(pp)]),
                "dp": (step, [clone_tree(params), stats,
                              clone_tree(opt_state)])}
        paired = {k: [] for k in runs}
        for i in range(DP_PAIRS):
            for k in (("no_mesh", "dp") if i % 2 == 0 else ("dp", "no_mesh")):
                fn, st = runs[k]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                st[:3] = fn(*st, lr0, *batch)[:3]
                torch.cuda.synchronize()
                paired[k].append((time.perf_counter() - t0) * 1e3)
        del runs, pp
        report["interleaved"] = {
            "pairs": DP_PAIRS, **{f"{k}_ms": v for k, v in paired.items()},
            **{f"{k}_mean_ms": float(np.mean(v)) for k, v in paired.items()},
            **{f"{k}_median_ms": float(np.median(v))
               for k, v in paired.items()}}
        gaps = np.subtract(paired["dp"], paired["no_mesh"])
        report["interleaved"]["dp_minus_no_mesh_median_ms"] = float(
            np.median(gaps))
        log(f"[dp] {DP_PAIRS} steps without a mesh and {DP_PAIRS} dp steps, "
            f"interleaved: median {np.median(paired['no_mesh']):.2f} / "
            f"{np.median(paired['dp']):.2f} ms, mean "
            f"{np.mean(paired['no_mesh']):.2f} / {np.mean(paired['dp']):.2f} "
            f"ms; median of the pairs' gaps {np.median(gaps):.2f} ms")
        if profile_dir is not None:
            state = [params, stats, opt_state]

            def dp_step():
                state[:3] = step(*state, LR, *batch)[:3]
            profile(dp_step, "dp_task0_default", profile_dir)
        # the host cost of one of the step's small collectives: a
        # stacked pair of statistics summed over the world, back to back
        pair = torch.zeros(2, 64, device=dev)
        all_sum_if(pair, mesh.group)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(DP_ALL_REDUCES):
            all_sum_if(pair, mesh.group)
        torch.cuda.synchronize()
        report["all_reduces_ms"] = (time.perf_counter() - t0) * 1e3
        log(f"[dp] {DP_ALL_REDUCES} all-reduces of 2x64 floats back to back: "
            f"{report['all_reduces_ms']:.2f} ms on the host clock")
        rows = measure_scaling(worlds=(1,), batch_per_rank=TRAIN_B,
                               hw=(TRAIN_H, TRAIN_W), steps=5, warmup=2,
                               maxdisp=MAXDISP)
        report["scaling"] = rows
        report["scaling_note"] = ("one visible device: a world of one, no "
                                  "scaling claimed")
        log(f"[dp] measure_scaling (default genotype, fresh net, batch "
            f"{TRAIN_B} a rank, {TRAIN_H}x{TRAIN_W}): {json.dumps(rows)}")
    finally:
        dist.destroy_process_group()
    report["device"] = smi
    report["wall_s"] = time.perf_counter() - t_phase
    return launches, report


# -- the learn phase ---------------------------------------------------------

class Counted:
    """A dataset that counts the pairs its shuffled (training) batches and
    its ordered (evaluation) batches yield, into ``counts``."""

    def __init__(self, ds, counts):
        self.ds, self.counts = ds, counts

    def __len__(self):
        return len(self.ds)

    def batches(self, batch_size, shuffle=True, seed=0, *a, **kw):
        key = "trained" if shuffle else "evaluated"
        for b in self.ds.batches(batch_size, shuffle, seed, *a, **kw):
            self.counts[key] += int(b["left" if "left" in b
                                      else "image"].shape[0])
            yield b


def learn_scenes(dev, counts):
    """Per task t: train (32 pairs 192x384, seed 10 + t), valid (8, seed
    20 + t) and test (8 frames 480x960, seed 30 + t), styled
    WEATHER_STYLES[t], disparity up to 64 px, on the card."""
    cache = DeviceCache()
    (hh, ww), (eh, ew) = LEARN_TRAIN_HW, LEARN_TEST_HW
    mk = lambda n, h, w, seed, t: Counted(SyntheticStereoDataset(
        n, h, w, seed=seed, max_disp=LEARN_SCENE_DISP,
        style=WEATHER_STYLES[t], device=dev, cache=cache), counts)
    n_tr, n_va, n_te = LEARN_PAIRS
    return ([mk(n_tr, hh, ww, 10 + t, t) for t in range(LEARN_TASKS)],
            [mk(n_va, hh, ww, 20 + t, t) for t in range(LEARN_TASKS)],
            [mk(n_te, eh, ew, 30 + t, t) for t in range(LEARN_TASKS)])


def first_supernet_step(dev, train0):
    """Task 0's cell search as the driver builds it, and the arguments of
    its first train step: the first batch of its weight-training half and
    the ops it samples first (CellSearch.search's streams)."""
    cfg = dataclasses.replace(LEARN_CFG.cell, maxdisp=MAXDISP)  # seed + 0
    cs = CellSearch(cfg, log=None, device=dev)
    rng = np.random.default_rng(cfg.seed)
    train_idx, _ = split_half(len(train0), seed=cfg.seed)
    ops = [np.array([rng.choice(cfg.num_ops, p=cs.p[k][e])
                     for e in range(NUM_EDGES)], np.int32)
           for k in ("normal", "reduce")]
    b = next(train0.ds.batches(cfg.batch, True, seed=0, indices=train_idx))
    lr = cosine_lr(cfg.lr, cfg.epochs, 0, cfg.lr_min)
    return cs, lr, (b["left"], b["right"], b["disparity"], *ops)


def supernet_step(cs, lr, args):
    """One step from a copy of cs's state: (dp/lr by leaf, new stats by
    leaf, loss)."""
    params = clone_tree(cs.params)
    params, new_stats, _, sc = cs._train_step(
        params, cs.stats, cs.optimizer.init(params), lr, *args)
    before = dict(leaves(cs.params))
    return ({k: (v - before[k]) / lr for k, v in leaves(params)},
            dict(leaves(new_stats)), float(sc["loss"]))


def phase_record_learn(dev, args_of):
    """The first supernet train step with the plain versions in the
    wrappers' places. Returns its dp/lr and statistics."""
    counts = {"trained": 0, "evaluated": 0}
    train, _, _ = learn_scenes(dev, counts)
    cs, lr, args = first_supernet_step(dev, train[0])
    calls = []
    t0 = time.perf_counter()
    with recording(calls, args_of):
        delta, stats, loss = supernet_step(cs, lr, args)
    torch.cuda.synchronize()
    n_calls = count_calls(calls)
    log(f"[record-learn] first supernet train step (batch "
        f"{LEARN_CFG.cell.batch}, {LEARN_TRAIN_HW[0]}x{LEARN_TRAIN_HW[1]}, "
        f"ops {args[3].tolist()} / {args[4].tolist()}): plain "
        f"{(time.perf_counter() - t0) * 1e3:.0f} ms, loss {loss:.4f}, "
        f"kernel calls {n_calls}")
    check_called("supernet step", n_calls, (KA, KD))
    return delta, stats




def launch_failures(what, n, must):
    """The launch gate of one run: each kernel in must launched, no other."""
    bad = [f"{what}: {k} never launched" for k in must if n[k] <= 0]
    return bad + [f"{what}: {k} launched {c} times" for k, c in n.items()
                  if c and k not in must]


def record_ops(cs):
    """Wrap a cell search's train step to keep each step's sampled
    (normal, reduce) ops as lists; returns the list they go to."""
    out, step = [], cs._train_step

    def run(*a):
        out.append([np.asarray(a[-2]).tolist(), np.asarray(a[-1]).tolist()])
        return step(*a)

    cs._train_step = run
    return out


class StagedDriver(ContinualDriver):
    """The port's ContinualDriver with each stage timed on synchronized
    host clocks, its peak memory and launches read, and the trainable
    sites of every step it builds kept. Mixed before a variant's driver
    (class X(StagedDriver, SelfSupContinualDriver)) it stages that one;
    ``tag`` prefixes its lines. Launches between stages add up in
    ``outside`` (set every count to 0 before run, then call
    read_outside)."""

    tag = "learn"

    def __init__(self, *a, counts, **kw):
        super().__init__(*a, **kw)
        self.counts = counts
        self.stages, self.cell_searches, self.op_p = [], [], {}
        self.cell_ops = []
        self._trainable = None
        self.outside = dict.fromkeys(ALL_KERNELS, 0)

    def read_outside(self):
        """The launches of the last run outside its stages."""
        for n, c in read_launches().items():
            self.outside[n] += c
        zero_launches()
        return dict(self.outside)

    @contextlib.contextmanager
    def _stage(self, name, t, trainable=None):
        self.read_outside()
        self.counts.update(trained=0, evaluated=0)
        self._trainable = [] if trainable is None else [trainable]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        yield
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        rec = {"stage": name, "task": t, "s": sec,
               "trained_pairs": self.counts["trained"],
               "evaluated_pairs": self.counts["evaluated"],
               "pairs_per_s": (self.counts["trained"]
                               or self.counts["evaluated"]) / sec,
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
               "launches": read_launches(),
               "stem_trains": any("stem_3d0" in s for s in self._trainable),
               "features_train": any(s & FEATURE_SITES
                                     for s in self._trainable)}
        self.stages.append(rec)
        zero_launches()
        log(f"[{self.tag}] t{t} {name}: {sec:.2f} s, {rec['trained_pairs']} "
            f"pairs trained, {rec['evaluated_pairs']} evaluated, "
            f"{rec['pairs_per_s']:.2f} pairs/s, peak {rec['peak_gb']:.2f} "
            f"GB, launches {json.dumps({n: c for n, c in rec['launches'].items() if c})}"
            f", stem_3d0 trains: {rec['stem_trains']}, a feature site "
            f"trains: {rec['features_train']}")

    def _cell_search(self, t):
        cs = super()._cell_search(t)
        self.cell_searches.append(cs)
        self.cell_ops.append(record_ops(cs))
        return cs

    def search_cell(self, t, train_data):
        with self._stage("cell", t):
            return super().search_cell(t, train_data)

    def _op_search(self):
        search = super()._op_search()
        steps_for, run = search._steps_for, search.search

        def staged_steps_for(arch, trainable):
            self._trainable.append(trainable)
            return steps_for(arch, trainable)

        def staged_search(t, data, writer=None, **kw):
            with self._stage("op", t):
                run(t, data, writer=writer, **kw)
            self.op_p[t] = [p.copy() for p in self.net.p]

        search._steps_for, search.search = staged_steps_for, staged_search
        return search

    def fine_tune(self, t, train_data, valid_data):
        with self._stage("train", t, self.net.trainable_sites(t)):
            super().fine_tune(t, train_data, valid_data)
        log(f"[{self.tag}] after task {t}: genotype {self.net.genotypes[t]}, "
            f"archis[{t}] {self.net.archis[t]}, size "
            f"{self.net.size_m():.6f} M params")

    def evaluate(self, u, test_data, batch=1):
        with self._stage(f"eval u{u}", len(self.net.archis) - 1):
            return super().evaluate(u, test_data, batch)

    def train_router(self, t, train_datasets, test_datasets):
        with self._stage("router", t):
            super().train_router(t, train_datasets, test_datasets)

    def _routed_eval(self, u, test_data, confusion):
        with self._stage(f"routed eval u{u}", len(self.net.archis) - 1):
            return super()._routed_eval(u, test_data, confusion)


class Scalars:
    """A MetricWriter that keeps every scalar for the finiteness gate."""

    def __init__(self):
        self.values = []

    def scalars(self, tag, values, step=0):
        self.values += [(tag, k, float(v)) for k, v in values.items()]

    def text(self, tag, value, step=0):
        pass


def stage_failures(rec, depth=False):
    """The launch gate of one stage: which kernels it must run (E only
    where a feature-net site trains, F only where stem_3d0 does; the
    selfsup pretrain as a fine-tune; the depth path none) and that no
    other kernel ran."""
    name, n = rec["stage"], rec["launches"]
    if depth or name == "router":
        must = ()
    elif name == "cell":
        must = (KA, KD)
    elif name in ("op", "train", "pretrain"):
        must = (KA, KB, KC, KD, KG) + ((KE,) if rec["features_train"] else ()) \
            + ((KF,) if rec["stem_trains"] else ())
    else:
        must = (KA, KB, KC)
    return launch_failures(f"learn t{rec['task']} {name}", n, must)


def phase_learn(dev, plain_step, smi):
    """Two tasks of ContinualDriver.run on the card (default path) and the
    five gates: stage launches, the first supernet step vs plain, search
    state and growth, zero forgetting, the checkpoint round trip."""
    t_phase = time.perf_counter()
    log(f"[learn] configuration: {json.dumps(cfg_dict(LEARN_CFG))}")
    log(f"[learn] cut from the canonical run: {'; '.join(LEARN_CUTS)}; "
        f"widths and crops unchanged")
    counts = {"trained": 0, "evaluated": 0}
    train, valid, test = learn_scenes(dev, counts)
    failures = []

    # gate 2: the first supernet step through the kernels vs the plain one
    cs, lr, args = first_supernet_step(dev, train[0])
    delta, stats, loss = supernet_step(cs, lr, args)
    cmp, bad = compare_step("learn supernet step", delta, stats, plain_step)
    failures += bad
    step_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        supernet_step(cs, lr, args)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    log(f"[learn] supernet train step (batch {LEARN_CFG.cell.batch}): "
        f"{', '.join(f'{m:.1f}' for m in step_ms)} ms (host clock, "
        f"synchronized), loss {loss:.4f}")
    del cs, delta, stats

    writer = Scalars()
    with tempfile.TemporaryDirectory() as ckpt:
        drv = StagedDriver(LEARN_CFG, writer=writer, log=log,
                           checkpoint_dir=ckpt, device=dev, counts=counts)
        t0 = time.perf_counter()
        matrix = drv.run(train, valid, test)
        run_s = time.perf_counter() - t0
        for rec in drv.stages:
            failures += stage_failures(rec)
        net = drv.net

        # gate 3: search state and growth
        for t, search in enumerate(drv.cell_searches):
            for k, p in search.p.items():
                if not np.all(np.abs(p.sum(axis=1) - 1.0) <= 1e-12):
                    failures.append(f"cell search t{t}: p[{k}] rows sum to "
                                    f"{p.sum(axis=1)}")
            geno = parse_genotype(search.p["normal"], search.p["reduce"])
            if geno != net.genotypes[t]:
                failures.append(f"task {t}: genotype {net.genotypes[t]} is "
                                f"not parse_genotype(p) = {geno}")
        for i, s in enumerate(SITE_NAMES):
            p = drv.op_p[1][i]
            idx = int(np.argmax(p))
            new = idx == len(p) - 1
            if abs(p.sum() - 1.0) > 1e-12:
                failures.append(f"op search: p[{s}] sums to {p.sum()}")
            if (net.archis[1][s] != idx or idx >= net.length(s)
                    or net.length(s) != len(p) - (0 if new else 1)
                    or net.units[s][idx].born_task != (1 if new else 0)
                    or net.model_to_train[s] != ([idx] if new else [])):
                failures.append(f"select: {s} p {p.tolist()} -> archis "
                                f"{net.archis[1][s]}, {net.length(s)} units,"
                                f" model_to_train {net.model_to_train[s]}")
        bad_vals = [(tag, k, v) for tag, k, v in writer.values
                    if not np.isfinite(v)]
        if bad_vals:
            failures.append(f"non-finite logged values {bad_vals[:5]}")

        # gate 4: zero forgetting
        forget = {}
        for k in matrix.metric_names:
            a, b = matrix.m[k][1, 0], matrix.m[k][0, 0]
            forget[k] = {"after_0": b, "after_1": a, "bit_equal": bool(a == b)}
            if not abs(a - b) <= ZERO_FORGET_RTOL * abs(b):
                failures.append(f"forgetting: {k} {b!r} -> {a!r}")
        log(f"[learn] zero forgetting, matrix[1, 0] vs matrix[0, 0]: "
            f"{json.dumps(forget)}")
        for k in ("D1", "EPE"):
            log(f"[learn] forgetting matrix {k}:\n{matrix.format(k, fmt='{:10.6f}')}")

        # gate 5: the checkpoint round trip on the card
        back, manifest = load_checkpoint(ckpt, LEARN_TASKS - 1, device=dev)
        roundtrip = {}
        ri = RoutedInference(back, maxdisp=MAXDISP, device=dev)
        for u in range(LEARN_TASKS):
            got = ri.evaluate(test[u], task=u)
            err = max(abs(got[k] - matrix.m[k][LEARN_TASKS - 1, u])
                      / max(abs(matrix.m[k][LEARN_TASKS - 1, u]), 1e-30)
                      for k in matrix.metric_names)
            roundtrip[u] = err
            if not err <= ROUNDTRIP_RTOL:
                failures.append(f"checkpoint round trip: task {u} differs "
                                f"by {err:.3g} relative")
        router = load_router(ckpt, device=dev)
        routed = RoutedInference(back, router=router, maxdisp=MAXDISP,
                                 device=dev)
        routed_d1 = [routed.evaluate(test[u])["D1"]
                     for u in range(LEARN_TASKS)]
        acc = router.accuracy([d.ds for d in test])
        log(f"[learn] checkpoint {manifest['extra']['stage']} of task "
            f"{manifest['task']} reloaded: worst relative difference per task"
            f" {roundtrip}; routed D1 {routed_d1}, router accuracy {acc:.4f}")
    report = {
        "device": smi, "config": cfg_dict(LEARN_CFG),
        "cuts": LEARN_CUTS, "run_s": run_s,
        "wall_s": time.perf_counter() - t_phase,
        "supernet_step_ms": step_ms, "supernet_step_vs_plain": cmp,
        "stages": drv.stages,
        "genotypes": [str(g) for g in net.genotypes], "archis": net.archis,
        "cell_search": [
            {"ops": ops, "p": {k: v.tolist() for k, v in cs.p.items()},
             "s": next(r["s"] for r in drv.stages
                       if r["stage"] == "cell" and r["task"] == t)}
            for t, (cs, ops) in enumerate(zip(drv.cell_searches,
                                              drv.cell_ops))],
        "model_to_train": net.model_to_train, "size_m": net.size_m(),
        "matrix": {k: matrix.m[k].tolist() for k in ("D1", "EPE")},
        "zero_forgetting": forget, "roundtrip_rel": roundtrip,
        "routed_D1": routed_d1, "router_accuracy": acc}
    log(f"[learn] phase wall time {report['wall_s']:.1f} s (driver run "
        f"{run_s:.1f} s)")
    if failures:
        raise SystemExit("chip_smoke: learn failed:\n  " + "\n  ".join(failures))
    launches = dict.fromkeys(ALL_KERNELS, 0)
    for rec in drv.stages:
        for k, c in rec["launches"].items():
            launches[k] += c
    return launches, report


# -- the sp phase: the spatial (model-axis) step on two ranks of one card --

SP_MESH = (1, 2)        # data x model: two gloo ranks sharing the one card
SP_TIMEOUT_S = 600      # both ranks, start to end
SP_EVAL_SEED = 5


def sp_eval_frame(dev):
    """One 480x960 frame for the eval step: the serve phase's plane at
    TRUE_DISP, its ground truth 0 where the left pixel has no match."""
    left, right = stereo_pair(np.random.default_rng(SP_EVAL_SEED), H, W,
                              TRUE_DISP)
    gt = np.full((1, H, W), float(TRUE_DISP), np.float32)
    gt[..., :TRUE_DISP] = 0.0
    return tuple(torch.from_numpy(a).to(dev) for a in (left, right, gt))


def _cpu(tree):
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_cpu(v) for v in tree)
    return tree.detach().cpu() if isinstance(tree, torch.Tensor) else tree


def phase_sp(dev, plain, train_turns, smi):
    """The spatial step on a world of two gloo ranks sharing the card
    (NCCL refuses two ranks on one device; gloo moves CUDA tensors in
    all_reduce and broadcast, all the model axis uses). This process
    takes task 0's unsharded kernel step (its dp/lr and its launches a
    step) and the unsharded 480x960 eval (disparity and scalars) as
    references, then starts both ranks (``--sp-rank``; sp_rank), which
    gate themselves; any rank's failure fails the run. Returns the ranks'
    launches summed and the report."""
    t_phase = time.perf_counter()
    specs, params, stats, sites = train_configs(dev)["task0"]
    batch = train_batch(dev)
    lr0 = cosine_lr(LR, TRAIN_EPOCHS, 0)
    ref = clone_tree(params)
    before = dict(leaves(params))
    zero_launches()
    make_train_step(specs, sites, make_optimizer(WD), maxdisp=MAXDISP)(
        ref, stats, make_optimizer(WD).init(ref), lr0, *batch)
    torch.cuda.synchronize()
    per_step = read_launches()
    kernel_delta = {k: (v - before[k]) / lr0 for k, v in leaves(ref)
                    if k.split("/")[0] in sites}
    frame = sp_eval_frame(dev)
    with torch.inference_mode():
        disp, _ = stereo_forward(specs, params, stats, frame[0], frame[1],
                                 maxdisp=MAXDISP)
        scalars = make_eval_step(specs, maxdisp=MAXDISP)(params, stats,
                                                        *frame)
    zero_launches()
    non_sp = [t["task0"] for t in train_turns]
    with tempfile.TemporaryDirectory() as d:
        torch.save({"plain": _cpu(plain["task0"]),
                    "kernel_delta": _cpu(kernel_delta),
                    "per_step": per_step, "eval_disp": disp.cpu(),
                    "eval_scalars": {k: float(v) for k, v in scalars.items()}},
                   os.path.join(d, "ref.pt"))
        del ref, kernel_delta, disp, params, stats, specs, batch, frame
        torch.cuda.empty_cache()
        addr = local_address()
        world = SP_MESH[0] * SP_MESH[1]
        procs = [subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--sp-rank",
             str(r), addr, d], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(world)]
        outs, failed = [], []
        deadline = time.monotonic() + SP_TIMEOUT_S
        try:
            for r, p in enumerate(procs):
                out, _ = p.communicate(
                    timeout=max(1.0, deadline - time.monotonic()))
                outs.append(out)
        except subprocess.TimeoutExpired:
            failed.append(f"sp: ranks still running after {SP_TIMEOUT_S} s")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, out in enumerate(outs):
            for line in out.splitlines():
                log(f"[sp r{r}] {line}")
        failed += [f"sp: rank {r} exited {p.returncode}"
                   for r, p in enumerate(procs) if p.returncode != 0]
        if failed:
            raise SystemExit("chip_smoke: sp failed:\n  " + "\n  ".join(failed))
        ranks = [json.loads(Path(d, f"rank{r}.json").read_text())
                 for r in range(world)]
    launches = {k: sum(rk["launches"][k] + rk["eval_launches"].get(k, 0)
                       for rk in ranks) for k in KERNELS}
    report = {
        "device": smi, "mesh": list(SP_MESH), "backend": "gloo",
        "note": "two ranks share one card over gloo: no scaling is measured",
        "config": "task0", "batch": TRAIN_B, "hw": [TRAIN_H, TRAIN_W],
        "maxdisp": MAXDISP,
        "non_sp_ms_per_step": [t["ms_per_step"] for t in non_sp],
        "unsharded_launches_per_step": {k: c for k, c in per_step.items()
                                        if c},
        "ranks": ranks, "wall_s": time.perf_counter() - t_phase}
    log(f"[sp] mesh {SP_MESH[0]}x{SP_MESH[1]} over gloo on one card, task0: "
        + "; ".join(f"rank {r['rank']} {r['ms_per_step']:.1f} ms/step, halo "
                    f"{r['halo_bytes_per_step'] / 1e6:.1f} MB + gather "
                    f"{r['gather_bytes_per_step'] / 1e6:.1f} MB a step, peak "
                    f"{r['peak_gb']:.2f} GB, eval {r['eval_ms']:.1f} ms"
                    for r in ranks)
        + " (without a mesh, train phase default turns: "
        + ", ".join(f"{t:.2f}" for t in report["non_sp_ms_per_step"])
        + f" ms/step); phase {report['wall_s']:.1f} s")
    return launches, report


def sp_rank(rank: int, addr: str, d: str) -> int:
    """One rank of the sp phase: join the gloo world on the card, take
    TRAIN_STEPS spatial steps of task 0's configuration (every launch count
    at 0 first) and one 480x960 eval step, gate them, write
    rank{rank}.json into d. Returns the exit code."""
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    cuda_lib.lib()
    world = SP_MESH[0] * SP_MESH[1]
    dist.init_process_group("gloo", init_method=addr, world_size=world,
                            rank=rank)
    failures = []
    try:
        mesh = make_mesh(*SP_MESH, device=dev)
        ref = torch.load(os.path.join(d, "ref.pt"))
        to_dev = lambda tree: {k: v.to(dev) for k, v in tree.items()}
        specs, params, stats, sites = train_configs(dev)["task0"]
        batch = train_batch(dev)
        step = make_sharded_train_step(mesh, specs, sites, make_optimizer(WD),
                                       maxdisp=MAXDISP)
        opt_state = make_optimizer(WD).init(params)
        zero_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times, losses, traffic = [], [], []
        for i in range(TRAIN_STEPS):
            lr = cosine_lr(LR, TRAIN_EPOCHS, i)
            before = ({k: v.clone() for k, v in leaves(params)} if i == 0
                      else None)
            HALO.reset()
            dist.barrier()
            t0 = time.perf_counter()
            params, stats, opt_state, sc = step(params, stats, opt_state, lr,
                                                *batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            traffic.append((HALO.halo_bytes, HALO.gather_bytes,
                            HALO.exchanges))
            losses.append(float(sc["loss"]))
            if i == 0:
                delta = {k: (v - before[k]) / lr for k, v in leaves(params)
                         if k.split("/")[0] in sites}
                p_delta, p_stats = ref["plain"]
                cmp, bad = compare_step(f"sp rank {rank} task0", delta,
                                        dict(leaves(stats)),
                                        (to_dev(p_delta), to_dev(p_stats)))
                failures += bad
                vs_kernel = tree_rel_l2(delta, to_dev(ref["kernel_delta"]))
                if not vs_kernel <= STEP_RTOL:
                    failures.append(f"sp rank {rank}: dp/lr vs the unsharded "
                                    f"kernel step {vs_kernel:.3g}")
                del before, delta
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        launches = read_launches()
        failures += launch_failures(f"sp rank {rank}", launches,
                                    TRAIN_KERNELS["default"])
        want = {k: TRAIN_STEPS * c for k, c in ref["per_step"].items()}
        if launches != want:
            failures.append(f"sp rank {rank}: launches {launches}, the "
                            f"unsharded steps' {want}")
        if not all(np.isfinite(losses)):
            failures.append(f"sp rank {rank}: non-finite loss {losses}")
        # the 480x960 eval step on a fresh copy of task 0's path
        specs, params, stats, _ = train_configs(dev)["task0"]
        frame = sp_eval_frame(dev)
        ev = make_sharded_eval_step(mesh, specs, maxdisp=MAXDISP)
        zero_launches()
        HALO.reset()
        dist.barrier()
        t0 = time.perf_counter()
        got = ev(params, stats, *frame)
        torch.cuda.synchronize()
        eval_ms = (time.perf_counter() - t0) * 1e3
        eval_traffic = (HALO.halo_bytes, HALO.gather_bytes)
        eval_launches = read_launches()
        failures += launch_failures(f"sp rank {rank} eval", eval_launches,
                                    SERVE_KERNELS["default"])
        with torch.inference_mode():
            disp, _ = stereo_forward(specs, params, stats, frame[0],
                                     frame[1], maxdisp=MAXDISP, mesh=mesh)
        r0, r1 = disparity_rows(H, mesh)
        disp_err = float((disp.cpu() - ref["eval_disp"][:, r0:r1]).abs().max())
        scal_err = {k: abs(float(got[k]) - ref["eval_scalars"][k])
                    for k in ("EPE", "loss")}
        if not (disp_err <= SERVE_ATOL and bool(torch.isfinite(disp).all())
                and max(scal_err.values()) <= SERVE_ATOL):
            failures.append(f"sp rank {rank} eval: disparity rows [{r0}, "
                            f"{r1}) {disp_err:.3g} px from the unsharded "
                            f"one, scalars {scal_err} (tolerance "
                            f"{SERVE_ATOL})")
        steady = times[1:] or times
        out = dict(rank=rank, m=mesh.m, rows=[r0, r1], first_ms=times[0],
                   ms_per_step=float(np.mean(steady)), step_ms=times,
                   pairs_per_s=TRAIN_B / (float(np.mean(steady)) / 1e3),
                   loss=losses, peak_gb=peak_gb,
                   halo_bytes_per_step=traffic[-1][0],
                   gather_bytes_per_step=traffic[-1][1],
                   exchanges_per_step=traffic[-1][2],
                   vs_unsharded_kernel_step_rel_l2=vs_kernel, **cmp,
                   launches=launches,
                   eval_ms=eval_ms, eval_halo_bytes=eval_traffic[0],
                   eval_gather_bytes=eval_traffic[1],
                   eval_launches={k: c for k, c in eval_launches.items()
                                  if c},
                   eval_disp_max_px=disp_err, eval_scalar_err=scal_err,
                   failures=failures)
        log(f"rank {rank} (rows [{r0}, {r1}) of the disparity): "
            f"{json.dumps({k: v for k, v in out.items() if k != 'launches'})}")
        Path(d, f"rank{rank}.json").write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()
    for f in failures:
        log(f"FAILED {f}")
    return 1 if failures else 0


# -- the scenes phase: every scene's cell search at once --------------------

def busy(fn, label, out_dir):
    """fn() under the profiler: (wall s, device busy s as the union of
    the device's kernel and copy intervals, the same summed over
    streams)."""
    torch.cuda.synchronize()
    with trace(str(out_dir / f"trace_{label}")):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    path = out_dir / f"trace_{label}" / "trace.json"
    data = json.loads(path.read_text())
    path.unlink()
    events = data["traceEvents"] if isinstance(data, dict) else data
    spans = sorted((e["ts"], e["ts"] + e.get("dur", 0)) for e in events
                   if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    union, end = 0.0, -np.inf
    for a, b in spans:
        if b > end:
            union += b - max(a, end)
            end = b
    return wall, union / 1e6, sum(b - a for a, b in spans) / 1e6


def phase_scenes(dev, learn, smi):
    """SceneParallelCellSearch over the learn phase's two scenes with its
    cell configuration (scene t seeded cell.seed + t, as the driver's
    sequential searches), every launch count at 0 first: each scene's
    sampled ops equal the learn phase's sequential search's exactly, p
    within SCENES_P_ATOL, the genotypes equal, kernels A and D only. Then
    its seconds beside the two sequential searches (CellSearch.search, one
    after the other), in turns after a warm-up, and each one's
    device-busy share under the profiler."""
    t_phase = time.perf_counter()
    counts = {"trained": 0, "evaluated": 0}
    train, _, _ = learn_scenes(dev, counts)
    cfg = dataclasses.replace(LEARN_CFG.cell, maxdisp=MAXDISP)
    seeds = [cfg.seed + t for t in range(LEARN_TASKS)]

    def parallel():
        sp = SceneParallelCellSearch(cfg, LEARN_TASKS, log=None,
                                     scene_seeds=seeds, device=dev)
        ops = [record_ops(cs) for cs in sp.searches]
        return sp, ops, sp.search(train)

    def sequential():
        return [CellSearch(dataclasses.replace(cfg, seed=seeds[t]), log=None,
                           device=dev).search(train[t], task=t)
                for t in range(LEARN_TASKS)]

    zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sp, ops, genos = parallel()
    par_s = time.perf_counter() - t0
    launches = read_launches()
    failures = launch_failures("scenes", launches, (KA, KD))
    p_err = []
    for t, seq in enumerate(learn["cell_search"]):
        if ops[t] != seq["ops"]:
            failures.append(f"scenes t{t}: sampled ops {ops[t]} differ from "
                            f"the learn phase's {seq['ops']}")
        p_err.append(max(float(np.abs(sp.p[k][t] - np.asarray(v)).max())
                         for k, v in seq["p"].items()))
        if not p_err[-1] <= SCENES_P_ATOL:
            failures.append(f"scenes t{t}: p {p_err[-1]:.3g} from the learn "
                            f"phase's")
        if str(genos[t]) != learn["genotypes"][t]:
            failures.append(f"scenes t{t}: genotype {genos[t]} is not the "
                            f"learn phase's {learn['genotypes'][t]}")
    del sp
    # times: the sequential pair once to warm up, then both in turns
    # (parallel, sequential, sequential, parallel), then each profiled
    seq_genos = sequential()
    if [str(g) for g in seq_genos] != [str(g) for g in genos]:
        failures.append(f"scenes: sequential rerun genotypes {seq_genos}")
    turns = {"parallel": [], "sequential": []}
    for k in ("parallel", "sequential", "sequential", "parallel"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (parallel if k == "parallel" else sequential)()
        torch.cuda.synchronize()
        turns[k].append(time.perf_counter() - t0)
    with tempfile.TemporaryDirectory() as d:
        prof = {"parallel": busy(parallel, "scenes_parallel", Path(d)),
                "sequential": busy(sequential, "scenes_sequential", Path(d))}
    zero_launches()
    report = {
        "device": smi, "scenes": LEARN_TASKS,
        "config": dataclasses.asdict(cfg), "scene_seeds": seeds,
        "streams": "one CUDA stream per scene, one card",
        "gated_parallel_s": par_s, "turns_s": turns,
        "learn_cell_stage_s": [c["s"] for c in learn["cell_search"]],
        "profiled": {k: {"wall_s": w, "busy_union_s": u, "busy_sum_s": su,
                         "busy_share": u / w, "overlap": su / max(u, 1e-12)}
                     for k, (w, u, su) in prof.items()},
        "ops_equal": not any("sampled ops" in f for f in failures),
        "p_max_abs_err": p_err, "genotypes": [str(g) for g in genos],
        "launches": {k: c for k, c in launches.items() if c},
        "wall_s": time.perf_counter() - t_phase}
    log(f"[scenes] {LEARN_TASKS} scenes' cell searches at once: "
        f"{par_s:.2f} s gated, in turns "
        + ", ".join(f"{x:.2f}" for x in turns["parallel"])
        + " s; the two sequential searches in turns "
        + ", ".join(f"{x:.2f}" for x in turns["sequential"])
        + " s (learn phase's cell stages "
        + " + ".join(f"{s:.2f}" for s in report["learn_cell_stage_s"])
        + " s); profiled: " + "; ".join(
            f"{k} wall {v['wall_s']:.2f} s, device busy {v['busy_union_s']:.2f}"
            f" s ({100 * v['busy_share']:.1f} %), summed over streams "
            f"{v['busy_sum_s']:.2f} s" for k, v in report["profiled"].items())
        + f"; p vs learn {p_err}; launches {report['launches']}")
    if failures:
        raise SystemExit("chip_smoke: scenes failed:\n  "
                         + "\n  ".join(failures))
    return launches, report


# -- the cli phase -----------------------------------------------------------

def synth_frame(rng, h, w, max_disp):
    """A smooth random texture seen by two cameras through a disparity
    plane d(y) = d0 + (d1 - d0) y / (h - 1), d0, d1 in [4, max_disp]:
    right(x) = left(x + d). Returns left and right as uint8 RGB and the
    disparity (0 where the left pixel has no match)."""
    d0, d1 = rng.uniform(4.0, max_disp, 2)
    d = d0 + (d1 - d0) * np.arange(h) / max(h - 1, 1)
    wide = w + int(np.ceil(max_disp)) + 2
    coarse = rng.standard_normal((h // 4 + 1, wide // 4 + 1, 3))
    tex = np.repeat(np.repeat(coarse, 4, 0), 4, 1)[:h, :wide]
    tex = tex + 0.3 * rng.standard_normal(tex.shape)
    x = np.arange(w)[None, :] + d[:, None]
    i = np.floor(x).astype(np.int64)
    f = (x - i)[..., None]
    rows = np.arange(h)[:, None]
    right = (1 - f) * tex[rows, i] + f * tex[rows, i + 1]
    to8 = lambda a: np.clip(128 + 40 * a, 0, 255).astype(np.uint8)
    disp = np.where(np.arange(w)[None, :] >= d[:, None], d[:, None], 0.0)
    return to8(tex[:, :w]), to8(right), disp


def write_frame(paths, rng, h, w, max_disp):
    """Left, right (RGB PNG) and disparity (16-bit PNG x 256) to paths."""
    from PIL import Image

    left, right, disp = synth_frame(rng, h, w, max_disp)
    for p, a in zip(paths, (left, right,
                            np.round(disp * 256).astype(np.uint16))):
        Image.fromarray(a).save(p, compress_level=1)


def write_drivingstereo(root: Path, rng):
    """CLI_SCENES with CLI_FRAMES frames each in the DrivingStereo layout
    (root/{scene}/{left,right,disparity}-...-half-size/<stem>.png); the
    other two scenes of SCENES link to them, so that the manifest builder
    finds all four."""
    n = sum(CLI_FRAMES)
    for scene in CLI_SCENES:
        dirs = [root / scene / d for d in (LEFT_DIR, RIGHT_DIR, DISP_DIR)]
        for d in dirs:
            d.mkdir(parents=True)
        for i in range(n):
            write_frame([d / f"{i:06d}.png" for d in dirs], rng, *CLI_HW,
                        CLI_MAX_DISP)
    for scene, twin in zip(SCENES[len(CLI_SCENES):], CLI_SCENES):
        os.symlink(root / twin, root / scene, target_is_directory=True)


def write_eval_list(root: Path, name, rng):
    """A 3-column list of CLI_EVAL[name]'s frames."""
    n, h, w, md = CLI_EVAL[name]
    root.mkdir(parents=True)
    lines = []
    for i in range(n):
        paths = [root / f"{k}{i}.png" for k in ("left", "right", "disp")]
        write_frame(paths, rng, h, w, md)
        lines.append(" ".join(map(str, paths)))
    lst = root.parent / f"{name}.txt"
    lst.write_text("\n".join(lines) + "\n")
    return str(lst)


class CliDriver(StagedDriver):
    """The StagedDriver that cli.main builds (driver_cls): it counts the
    pairs of the datasets main gives it and keeps them; the last one built
    is CliDriver.last."""

    last = None

    def __init__(self, *a, **kw):
        super().__init__(*a, counts={"trained": 0, "evaluated": 0}, **kw)
        self.datasets = None
        CliDriver.last = self

    def run(self, train, valid, test, resume=False):
        self.datasets = (train, valid, test)
        wrap = lambda group: [Counted(d, self.counts) for d in group]
        return super().run(wrap(train), wrap(valid), wrap(test), resume=resume)


class Killed(Exception):
    pass


def cli_argv(lists, out, ckpt, run_id):
    return ["--filenames-dir", lists, "--num-tasks", str(len(CLI_SCENES)),
            *CLI_HYPER, "--train-router", "--checkpoint-dir", ckpt,
            "--stage-checkpoint-every", "1", "--maxdisp", str(MAXDISP),
            "--eval-pad", str(H), str(W), "--train-crop", str(TRAIN_H),
            str(TRAIN_W), "--output", out, "--id", run_id]


def pipeline_rate(lst, native, dev):
    """Training pairs/s of one scene's host pipeline alone (decode, crop,
    normalize, batch of TRAIN_B, copy to the card), after one epoch of
    warm-up."""
    ds = StereoDataset(lst, True, crop=(TRAIN_W, TRAIN_H), native=native,
                       device=dev)
    n, t0 = 0, None
    for epoch in range(PIPE_EPOCHS + 1):
        if epoch == 1:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        for b in ds.batches(TRAIN_B, True, seed=epoch):
            n += int(b["left"].shape[0]) if epoch else 0
    torch.cuda.synchronize()
    return n / (time.perf_counter() - t0), ds.used_native


def result_failures(path, what):
    with open(path) as f:
        result = json.load(f)
    bad = []
    for k, v in result.items():
        vals = np.asarray(v, np.float64) if k != "router" else np.asarray(
            v["routed_D1"] + v["oracle_D1"])
        if k in ("D1", "EPE", "loss", "Thres1", "Thres2", "Thres3"):
            vals = vals[np.tril_indices(len(vals))]
        if not np.isfinite(vals).all():
            bad.append(f"{what}: result.json {k} not finite: {v}")
    return result, bad


def forgetting_failures(matrix, what):
    out = {}
    bad = []
    for k in matrix.metric_names:
        a, b = matrix.m[k][1, 0], matrix.m[k][0, 0]
        out[k] = {"after_0": b, "after_1": a, "bit_equal": bool(a == b)}
        if not abs(a - b) <= ZERO_FORGET_RTOL * abs(b):
            bad.append(f"{what}: forgetting {k} {b!r} -> {a!r}")
    return out, bad


def eval_only_check(dev, lists, maxdisp, failures):
    """cli --eval-only of the committed checkpoint, routed, over the kitti
    and wide lists at maxdisp; every launch count set to 0 first. Then one
    frame of each list through the kernels and through the plain versions
    (the router picks the path), and every kernel call of those frames
    against its plain version. Returns (launches, figures)."""
    for k in KERNELS.values():
        k["wrapper"].launches = 0
    t0 = time.perf_counter()
    res = cli.main(["--eval-only", "--checkpoint-dir", str(CKPT),
                    "--use-router", "--eval-lists", *lists.values(),
                    "--maxdisp", str(maxdisp)], device=dev)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    launches = {n: k["wrapper"].launches for n, k in KERNELS.items()}
    what = f"cli eval-only maxdisp {maxdisp}"
    failures += [f"{what}: {k} never launched" for k in (KA, KB, KC)
                 if launches[k] <= 0]
    failures += [f"{what}: {k} launched {c} times"
                 for k, c in launches.items() if c and k not in (KA, KB, KC)]
    by_list = {}
    for name, lst in lists.items():
        r = res[lst]
        by_list[name] = {"D1": r["D1"], "EPE": r["EPE"], "loss": r["loss"]}
        if not all(np.isfinite(v) for v in by_list[name].values()):
            failures.append(f"{what}: {name} metrics not finite {r}")
    net, _ = load_checkpoint(str(CKPT), device=dev)
    ri = RoutedInference(net, router=load_router(str(CKPT), device=dev),
                         maxdisp=maxdisp, device=dev)
    frames, args_of = {}, {}
    for name, lst in lists.items():
        ds = StereoDataset(lst, False, pad=(CLI_EVAL_PAD[1], CLI_EVAL_PAD[0]),
                           resize_wide=True, device=dev)
        b = next(ds.batches(1, False, drop_last=False))
        got = ri.predict(b["left"], b["right"])
        calls = []
        with recording(calls, args_of):
            ref = ri.predict(b["left"], b["right"])
        diff = float(np.abs(got - ref).max())
        frames[name] = {"shape": list(got.shape), "vs_plain_max_px": diff,
                        "task": int(ri.route(b["left"])[0]),
                        "kernel_calls": {k: c for k, c in
                                         count_calls(calls).items() if c}}
        if got.shape != (1, *CLI_EVAL_PAD) or not np.isfinite(got).all() \
                or not diff <= SERVE_ATOL:
            failures.append(f"{what}: {name} frame {got.shape}, kernels vs "
                            f"plain {diff:.3g} px (tolerance {SERVE_ATOL})")
    kernels = []
    for (name, sig), (args, kw) in args_of.items():
        r = check_kernel(name, args, kw, 3, False)
        line = {"kernel": name, "at": f"cli maxdisp {maxdisp}",
                "sig": str(sig), "max_abs_err": r["err"], "tol": r["tol"],
                "ms": r["ms"], "plain_ms": r["plain_ms"],
                "library_ms": r["lib_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "repeat_bit_identical": r["same"],
                **r["plan"]}
        log(f"[kernels] {json.dumps(line)}")
        kernels.append(line)
        ALL_KERNELS[name]["max_err"] = max(
            ALL_KERNELS[name].get("max_err", 0.0), r["err"])
        if not r["ok"]:
            failures.append(f"{what}: {name} {sig} max_abs_err {r['err']:.3g}"
                            f" (tolerance {r['tol']:.3g}), bit-identical "
                            f"twice: {r['same']}")
    out = {"s": sec, "lists": by_list, "frames": frames, "kernels": kernels,
           "launches": {k: c for k, c in launches.items() if c}}
    log(f"[cli] eval-only maxdisp {maxdisp}: {json.dumps(out)}")
    return launches, out


def phase_cli(dev, smi):
    """python -m rag_tpu_torch.cli's path on files: a DrivingStereo tree
    and its lists, a full 2-task run, the same run killed in task 1's
    fine-tune and resumed, and --eval-only of the committed checkpoint on
    KITTI-size and wide frames at maxdisp 192 and 190, and with --bf16 at
    maxdisp 192."""
    t_phase = time.perf_counter()
    failures, report = [], {"device": smi, "cuts": CLI_CUTS,
                            "hyperparameters": " ".join(CLI_HYPER)}
    launches = dict.fromkeys(ALL_KERNELS, 0)

    def add(counts):
        for k, c in counts.items():
            launches[k] += c

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        rng = np.random.default_rng(11)
        t0 = time.perf_counter()
        write_drivingstereo(tmp / "ds", rng)
        lists = tmp / "lists"
        subprocess.run([sys.executable, "-m", "rag_tpu_torch.data.manifests",
                        str(tmp / "ds"), str(lists), "--train",
                        str(CLI_FRAMES[0]), "--test", str(CLI_FRAMES[1]),
                        "--seed", "0"], check=True, cwd=ROOT, timeout=120)
        report["data_s"] = time.perf_counter() - t0
        log(f"[cli] DrivingStereo tree of {len(CLI_SCENES)} scenes x "
            f"{sum(CLI_FRAMES)} frames of {CLI_HW[0]}x{CLI_HW[1]} and its "
            f"lists in {report['data_s']:.1f} s; cut from the canonical run: "
            f"{'; '.join(CLI_CUTS)}")

        # the host pipeline alone, native loader against the Python readers
        train0 = str(lists / f"drivingstereo_{CLI_SCENES[0]}_train.txt")
        pipe = {}
        for native in (True, False):
            rate, used = pipeline_rate(train0, native, dev)
            pipe["native" if native else "python"] = rate
            if used != native:
                failures.append(f"cli pipeline: native={native} streamed "
                                f"natively: {used}")
        report["pipeline_pairs_per_s"] = pipe
        log(f"[cli] host pipeline, batch {TRAIN_B} of {TRAIN_H}x{TRAIN_W} "
            f"crops to the card: {json.dumps(pipe)} pairs/s")

        # the full run
        t0 = time.perf_counter()
        matrix = cli.main(cli_argv(str(lists), str(tmp / "out"),
                                   str(tmp / "ckpt"), "full"),
                          device=dev, driver_cls=CliDriver, log=log)
        drv = CliDriver.last
        full = {"s": time.perf_counter() - t0, "stages": drv.stages}
        for rec in drv.stages:
            failures += stage_failures(rec)
            add(rec["launches"])
        full["used_native"] = [ds.used_native for ds in drv.datasets[0]]
        if not all(full["used_native"]):
            failures.append(f"cli full run: train sets streamed natively "
                            f"{full['used_native']}")
        full["result"], bad = result_failures(
            tmp / "out" / "drivingstereo_rag_0_full" / "result.json", "full")
        failures += bad
        full["zero_forgetting"], bad = forgetting_failures(matrix, "cli full")
        failures += bad
        report["full"] = full
        log(f"[cli] full run {full['s']:.1f} s; forgetting "
            f"{json.dumps(full['zero_forgetting'])}")

        # killed in task 1's fine-tune, then --resume
        argv = cli_argv(str(lists), str(tmp / "out"), str(tmp / "ckpt2"),
                        "resumed")

        def killer(msg):
            log(msg)
            if str(msg).startswith(CLI_KILL_AT):
                raise Killed(msg)

        t0 = time.perf_counter()
        try:
            cli.main(argv, device=dev, driver_cls=CliDriver, log=killer)
            failures.append("cli kill: the run was never killed")
        except Killed:
            pass
        killed = {"s": time.perf_counter() - t0}
        for rec in CliDriver.last.stages:
            add(rec["launches"])
        ck = tmp / "ckpt2"
        with np.load(ck / "finetune_t1.npz") as f:
            killed["stage_file_epoch"] = int(f["epoch"])
        with open(ck / "manifest_task1.json") as f:
            extra = json.load(f)["extra"]
        killed["stage"] = extra["stage"]
        row0 = {k: v[0][0] for k, v in extra["matrix"].items()}
        if (killed["stage_file_epoch"], killed["stage"]) != (0, "selected"):
            failures.append(f"cli kill: stage file / checkpoint {killed}")
        lines = []

        def keep(msg):
            log(msg)
            lines.append(str(msg))

        t0 = time.perf_counter()
        matrix = cli.main(argv + ["--resume"], device=dev,
                          driver_cls=CliDriver, log=keep)
        drv = CliDriver.last
        resumed = {"s": time.perf_counter() - t0, "stages": drv.stages}
        for rec in drv.stages:
            failures += stage_failures(rec)
            add(rec["launches"])
        names = [(r["stage"], r["task"]) for r in drv.stages]
        if drv.cell_searches or any(n in ("cell", "op") for n, _ in names):
            failures.append(f"cli resume: a search ran again: {names}")
        if any(t == 0 for n, t in names if n.startswith("eval")):
            failures.append(f"cli resume: row 0 evaluated again: {names}")
        reentry = [ln for ln in lines if "[train t1] resumed at epoch" in ln]
        trained = [r["trained_pairs"] for r in drv.stages
                   if r["stage"] == "train"]
        resumed["reentry"] = reentry
        if reentry != ["[train t1] resumed at epoch 1"] or \
                trained != [CLI_FRAMES[0]]:
            failures.append(f"cli resume: fine-tune re-entry {reentry}, "
                            f"pairs trained {trained}")
        resumed["row0_bit_equal"] = {
            k: bool(matrix.m[k][0, 0] == row0[k]) for k in matrix.metric_names}
        if not all(resumed["row0_bit_equal"].values()):
            failures.append(f"cli resume: row 0 {resumed['row0_bit_equal']}")
        resumed["zero_forgetting"], bad = forgetting_failures(matrix,
                                                              "cli resumed")
        failures += bad
        _, bad = result_failures(
            tmp / "out" / "drivingstereo_rag_0_resumed" / "result.json",
            "resumed")
        failures += bad
        report["kill"], report["resumed"] = killed, resumed
        log(f"[cli] killed at '{CLI_KILL_AT.strip()}' after {killed['s']:.1f}"
            f" s ({killed}); resumed run {resumed['s']:.1f} s, stages "
            f"{names}, row 0 restored bit for bit "
            f"{resumed['row0_bit_equal']}, forgetting "
            f"{json.dumps(resumed['zero_forgetting'])}")

        # --eval-only of the committed checkpoint, maxdisp 192 and 190
        eval_lists = {name: write_eval_list(tmp / name, name, rng)
                      for name in CLI_EVAL}
        report["eval_only"] = {}
        for maxdisp in (MAXDISP, 190):
            n, report["eval_only"][maxdisp] = eval_only_check(
                dev, eval_lists, maxdisp, failures)
            add(n)
        # --bf16 --eval-only: the bf16 instances of A and B, and C
        zero_launches()
        t0 = time.perf_counter()
        res = cli.main(["--eval-only", "--bf16", "--checkpoint-dir",
                        str(CKPT), "--use-router", "--eval-lists",
                        *eval_lists.values(), "--maxdisp", str(MAXDISP)],
                       device=dev)
        torch.cuda.synchronize()
        n = read_launches()
        failures += launch_failures("cli --bf16 --eval-only", n,
                                    (bf16_name(KA), bf16_name(KB), KC))
        add(n)
        f32 = report["eval_only"][MAXDISP]["lists"]
        lists16 = {name: {k: res[lst][k] for k in ("D1", "EPE", "loss")}
                   for name, lst in eval_lists.items()}
        for name, m in lists16.items():
            if not all(np.isfinite(v) for v in m.values()):
                failures.append(f"cli --bf16 --eval-only: {name} {m}")
        report["eval_only_bf16"] = {
            "s": time.perf_counter() - t0, "lists": lists16,
            "epe_minus_float32": {name: lists16[name]["EPE"] - f32[name]["EPE"]
                                  for name in lists16},
            "launches": {k: c for k, c in n.items() if c}}
        log(f"[cli] --bf16 --eval-only maxdisp {MAXDISP}: "
            f"{json.dumps(report['eval_only_bf16'])}")
    report["launches"] = {k: c for k, c in launches.items() if c}
    report["wall_s"] = time.perf_counter() - t_phase
    log(f"[cli] phase wall time {report['wall_s']:.1f} s")
    if failures:
        raise SystemExit("chip_smoke: cli failed:\n  " + "\n  ".join(failures))
    return launches, report


# -- the selfsup phase -------------------------------------------------------

def self_batch(dev):
    """Batch 3 of styled synthetic 192x384 pairs of task 2's scene
    (WEATHER_STYLES[2], train seed 12, disparity up to 64 px), on the card."""
    ds = SyntheticStereoDataset(SELF_B, TRAIN_H, TRAIN_W, seed=12,
                                max_disp=LEARN_SCENE_DISP,
                                style=WEATHER_STYLES[2], device=dev,
                                cache=DeviceCache())
    b = next(ds.batches(SELF_B, True, seed=0))
    return b["left"], b["right"], b["disparity"]


def self_config(dev):
    """Task 2's fine-tune stage of the committed selfsup checkpoint, on a
    fresh copy: (specs, params, stats, trainable sites)."""
    net, _ = load_checkpoint(str(SELF_CKPT), 2, device=dev)
    specs, params, stats = net.path(net.archis[2])
    return specs, params, stats, net.trainable_sites(2)


def self_step(cfg, batch, lr):
    """One photometric step from a copy of cfg's params: (dp/lr by
    trainable leaf, new stats by leaf, loss, the updated params)."""
    specs, params, stats, sites = cfg
    before = dict(leaves(params))
    params = clone_tree(params)
    step = make_selfsup_train_step(specs, sites, make_optimizer(WD),
                                   maxdisp=MAXDISP)
    params, new_stats, _, sc = step(params, stats,
                                    make_optimizer(WD).init(params), lr,
                                    *batch)
    return ({k: (v - before[k]) / lr for k, v in leaves(params)
             if k.split("/")[0] in sites},
            dict(leaves(new_stats)), float(sc["loss"]), params)


def self_expected(sites):
    return (KA, KB, KC, KD, KG) + ((KE,) if sites & FEATURE_SITES else ()) \
        + ((KF,) if "stem_3d0" in sites else ())


def phase_record_selfsup(dev, args_of):
    """The photometric step of task 2's stage with the plain versions in
    the wrappers' places. Returns its dp/lr and statistics."""
    cfg = self_config(dev)
    calls = []
    t0 = time.perf_counter()
    with recording(calls, args_of):
        delta, stats, loss, _ = self_step(cfg, self_batch(dev),
                                          cosine_lr(LR, TRAIN_EPOCHS, 0))
    torch.cuda.synchronize()
    n_calls = count_calls(calls)
    log(f"[record-selfsup] photometric step of task 2's stage ({len(cfg[3])}"
        f" trainable sites, batch {SELF_B}, {TRAIN_H}x{TRAIN_W}): plain "
        f"{(time.perf_counter() - t0) * 1e3:.0f} ms, loss {loss:.4f}, kernel"
        f" calls {n_calls}")
    expected = self_expected(cfg[3])
    check_called("selfsup step", n_calls, expected)
    return delta, stats


class StagedSelfSup(StagedDriver, SelfSupContinualDriver):
    tag = "selfsup"

    def pretrain(self, t):
        with self._stage("pretrain", t, self.net.trainable_sites(t)):
            super().pretrain(t)


class StagedDepth(StagedDriver, DepthContinualDriver):
    tag = "depth"


def run_checks(drv, matrix, writer, what, depth=False):
    """The gates shared by the variant runs: stage launches and none
    between stages, every logged value finite, zero forgetting in every
    tracked metric. Returns (failures, forgetting, the stages' launches
    summed, the launches outside them)."""
    failures = []
    stages = dict.fromkeys(ALL_KERNELS, 0)
    for rec in drv.stages:
        failures += stage_failures(rec, depth)
        for n, c in rec["launches"].items():
            stages[n] += c
    outside = drv.read_outside()
    failures += launch_failures(f"{what} outside its stages", outside, ())
    bad_vals = [(tag, k, v) for tag, k, v in writer.values
                if not np.isfinite(v)]
    if bad_vals:
        failures.append(f"{what}: non-finite logged values {bad_vals[:5]}")
    forget, bad = forgetting_failures(matrix, what)
    log(f"[{what}] zero forgetting, matrix[1, 0] vs matrix[0, 0]: "
        f"{json.dumps(forget)}")
    return failures + bad, forget, stages, outside


def phase_selfsup(dev, plain_step, smi):
    """(a) the photometric step of the committed selfsup checkpoint's task
    2 through the kernels against the plain step, and its rate; (b)
    SelfSupContinualDriver.run over two styled scenes with the synthetic
    pretrain set and the colour-transfer proxy, each stage gated as the
    learn phase gates it, zero forgetting and the checkpoint round trip."""
    t_phase = time.perf_counter()
    failures = []
    cfg = self_config(dev)
    batch = self_batch(dev)
    lr = cosine_lr(LR, TRAIN_EPOCHS, 0)
    # launches by segment: each set to 0 just before it, read just after
    segments = {}
    zero_launches()
    delta, stats, loss, params = self_step(cfg, batch, lr)
    cmp, bad = compare_step("selfsup step", delta, stats, plain_step)
    failures += bad
    segments["step"] = read_launches()
    expected = self_expected(cfg[3])
    failures += launch_failures("selfsup step", segments["step"], expected)
    specs, _, st, sites = cfg
    step = make_selfsup_train_step(specs, sites, make_optimizer(WD),
                                   maxdisp=MAXDISP)
    opt_state = make_optimizer(WD).init(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    zero_launches()
    for i in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        params, st, opt_state, sc = step(params, st, opt_state, lr, *batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    segments["timed_steps"] = read_launches()
    failures += launch_failures("selfsup timed steps",
                                segments["timed_steps"], expected)
    ms = float(np.mean(times))
    step_report = dict(sites=len(sites), loss=loss, ms=times,
                       ms_per_step=ms, pairs_per_s=SELF_B / (ms / 1e3),
                       peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                       launches={n: c for n, c in segments["step"].items()
                                 if c}, **cmp)
    if not np.isfinite(float(sc["loss"])):
        failures.append("selfsup step: non-finite loss")
    log(f"[selfsup] photometric step, task 2's stage of "
        f"{SELF_CKPT.relative_to(ROOT)} (batch {SELF_B}, {TRAIN_H}x{TRAIN_W},"
        f" maxdisp {MAXDISP}): {json.dumps(step_report)}")

    counts = {"trained": 0, "evaluated": 0}
    train, valid, test = learn_scenes(dev, counts)
    (hh, ww), cache = LEARN_TRAIN_HW, DeviceCache()
    aux = [Counted(SyntheticStereoDataset(
        n, hh, ww, seed=seed, max_disp=MAXDISP * 0.6, device=dev,
        cache=cache), counts) for n, seed in ((SELF_PRETRAIN_PAIRS, 777),
                                             (SELF_PROXY_PAIRS, 888))]
    writer = Scalars()
    log(f"[selfsup] configuration: {json.dumps(cfg_dict(SELF_CFG))};"
        f" cut from the canonical run: {'; '.join(SELF_CUTS)}")
    with tempfile.TemporaryDirectory() as ckpt:
        drv = StagedSelfSup(SELF_CFG, pretrain_data=aux[0],
                            proxy_search_data=aux[1], writer=writer, log=log,
                            checkpoint_dir=ckpt, device=dev, counts=counts)
        zero_launches()
        t0 = time.perf_counter()
        matrix = drv.run(train, valid, test)
        run_s = time.perf_counter() - t0
        bad, forget, segments["stages"], segments["outside_stages"] = \
            run_checks(drv, matrix, writer, "selfsup")
        failures += bad
        names = [r["stage"] for r in drv.stages]
        for stage in ("cell", "pretrain", "op", "train", "router"):
            if stage not in names:
                failures.append(f"selfsup: no {stage} stage ran: {names}")
        zero_launches()
        back, manifest = load_checkpoint(ckpt, LEARN_TASKS - 1, device=dev)
        ri = RoutedInference(back, maxdisp=MAXDISP, device=dev)
        roundtrip = {}
        for u in range(LEARN_TASKS):
            got = ri.evaluate(test[u], task=u)
            err = max(abs(got[k] - matrix.m[k][LEARN_TASKS - 1, u])
                      / max(abs(matrix.m[k][LEARN_TASKS - 1, u]), 1e-30)
                      for k in matrix.metric_names)
            roundtrip[u] = err
            if not err <= ROUNDTRIP_RTOL:
                failures.append(f"selfsup checkpoint round trip: task {u} "
                                f"differs by {err:.3g} relative")
        torch.cuda.synchronize()
        segments["roundtrip"] = read_launches()
        failures += launch_failures("selfsup round trip",
                                    segments["roundtrip"], (KA, KB, KC))
        log(f"[selfsup] checkpoint {manifest['extra']['stage']} of task "
            f"{manifest['task']} reloaded: worst relative difference per task"
            f" {roundtrip}")
    launches = {n: sum(seg[n] for seg in segments.values()) for n in KERNELS}
    log(f"[selfsup] launches by segment: " + json.dumps(
        {part: {k: c for k, c in n.items() if c} for part, n in segments.items()}))
    report = {"device": smi, "step": step_report,
              "config": cfg_dict(SELF_CFG), "cuts": SELF_CUTS,
              "run_s": run_s, "stages": drv.stages,
              "genotypes": [str(g) for g in drv.net.genotypes],
              "archis": drv.net.archis,
              "matrix": {k: matrix.m[k].tolist() for k in ("D1", "EPE")},
              "zero_forgetting": forget, "roundtrip_rel": roundtrip,
              "launches": {k: c for k, c in launches.items() if c},
              "launches_by_segment": segments,
              "wall_s": time.perf_counter() - t_phase}
    log(f"[selfsup] phase wall time {report['wall_s']:.1f} s (driver run "
        f"{run_s:.1f} s)")
    if failures:
        raise SystemExit("chip_smoke: selfsup failed:\n  "
                         + "\n  ".join(failures))
    return launches, report


# -- the depth phase ---------------------------------------------------------

def depth_scene(dev, t, n, h, w, cache, seed):
    return SyntheticDepthDataset(n, h, w, seed=seed + t,
                                 style=WEATHER_STYLES[t % len(WEATHER_STYLES)],
                                 device=dev, cache=cache)


def depth_restored(dev, failures):
    """(a) The committed depth checkpoint and router on the card: each task
    path on its scene's frames at 480x960 (depth metrics, ms/frame), one
    frame a path against the CPU, and the frames routed on the card and
    on the CPU."""
    net, manifest = load_checkpoint(str(DEPTH_CKPT), device=dev)
    cpu_net, _ = load_checkpoint(str(DEPTH_CKPT), device="cpu")
    router = load_router(str(DEPTH_CKPT), device=dev)
    cpu_router = load_router(str(DEPTH_CKPT), device="cpu")
    cache = DeviceCache()
    paths, frames = {}, []
    for t in range(len(net.archis)):
        scene = depth_scene(dev, t, DEPTH_FRAMES, H, W, cache, 30)
        specs, params, stats = net.path(net.archis[t])
        step = make_depth_eval_step(specs)
        batches = list(scene.batches(1, False, drop_last=False))
        step(params, stats, batches[0]["image"], batches[0]["depth"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = [step(params, stats, b["image"], b["depth"]) for b in batches]
        m = AverageMeterDict().update_batched(outs).mean()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / len(batches)
        image = batches[0]["image"]
        with torch.inference_mode():
            got, _ = depth_forward(specs, params, stats, image)
            cspecs, cparams, cstats = cpu_net.path(cpu_net.archis[t])
            ref, _ = depth_forward(cspecs, cparams, cstats, image.cpu())
        got = got.cpu()
        diff = float((got - ref).abs().max())
        paths[t] = {"metrics": m, "ms_per_frame": ms,
                    "frames_per_s": 1e3 / ms, "vs_cpu_max_m": diff,
                    "depth_range": [float(got.min()), float(got.max())]}
        if not (torch.isfinite(got).all() and diff <= DEPTH_ATOL
                and all(np.isfinite(v) for v in m.values())):
            failures.append(f"depth path {t}: vs CPU {diff:.3g} m "
                            f"(tolerance {DEPTH_ATOL}) or non-finite {m}")
        frames.append(torch.cat([b["image"] for b in batches]))
        log(f"[depth] restored task path {t}: {json.dumps(paths[t])}")
    frames = torch.cat(frames)
    ids = router.predict(frames)
    cpu_ids = cpu_router.predict(frames.cpu())
    truth = np.repeat(np.arange(len(net.archis)), DEPTH_FRAMES)
    route = {"input_key": router.input_key, "ids_equal_cpu":
             bool(np.array_equal(ids, cpu_ids)),
             "accuracy": float((ids == truth).mean())}
    if router.input_key != "image" or not route["ids_equal_cpu"]:
        failures.append(f"depth router: {route}, card {ids.tolist()} vs "
                        f"CPU {cpu_ids.tolist()}")
    log(f"[depth] committed router on {len(ids)} frames: {json.dumps(route)}")
    return {"task": manifest["task"], "paths": paths, "router": route}


def write_legacy_depth(net, path) -> None:
    """Task 0's path of a depth net as the reference saves a checkpoint
    (rag_depth/src/run.py:204-206): candidate 0 of every site and head
    under the reference's keys, OIHW weights, a dormant BatchNorm on each
    bn=False block and num_batches_tracked on every BatchNorm, in torch's
    legacy (non-zip) format."""
    from collections import OrderedDict

    sd = OrderedDict()
    stem_key = {v: k for k, v in torch_import._STEM_MAP.items()}

    def convbr(prefix, params, stats, bn_off=False):
        w = params["w"].detach().cpu()
        sd[f"{prefix}.conv.weight"] = w.permute(3, 2, 0, 1).contiguous()
        ones, zeros = torch.ones(w.shape[-1]), torch.zeros(w.shape[-1])
        bn = ({"weight": ones, "bias": zeros, "running_mean": zeros,
               "running_var": ones} if bn_off else
              {"weight": params["scale"], "bias": params["bias"],
               "running_mean": stats["mean"], "running_var": stats["var"]})
        for k, v in bn.items():
            sd[f"{prefix}.bn.{k}"] = v.detach().cpu().clone()
        sd[f"{prefix}.bn.num_batches_tracked"] = torch.tensor(0)

    arch = net.archis[0]
    for site in SITE_NAMES:
        u = net.units[site][arch[site]]
        if site.startswith("cell_"):
            prefix = f"cells_{site[5:7]}.{site[7:]}.0"
            convbr(f"{prefix}.pre_preprocess", u.params["pre"],
                   u.stats["pre"])
            convbr(f"{prefix}.preprocess", u.params["prep"], u.stats["prep"])
            for row, (edge, op) in enumerate(u.spec.gene):
                if op == 1:
                    convbr(f"{prefix}._ops.{row}", u.params["ops"][str(edge)],
                           u.stats["ops"][str(edge)])
        else:
            convbr(f"{stem_key[site]}.0", u.params, u.stats,
                   bn_off=not u.spec.bn)
    for h in net.heads:
        u = net.heads[h][arch[h]]
        convbr(f"{h}.0", u.params, u.stats, bn_off=not u.spec.bn)
    hp = net.depth_head.params
    sd["depth_head.conv1.weight"] = hp["w"].detach().cpu().permute(
        3, 2, 0, 1).contiguous()
    sd["depth_head.conv1.bias"] = hp["bias1"].detach().cpu().clone()
    torch.save({"task": 0, "model": sd, "optimizer": {}}, path,
               _use_new_zipfile_serialization=False)


def depth_legacy_import(dev, failures):
    """A legacy reference checkpoint written from the committed depth
    checkpoint's task-0 tensors, imported onto the card and onto the CPU
    (compat.torch_import): task 0's depth metrics on DEPTH_FRAMES frames of
    480x960, card vs CPU within DEPTH_ATOL."""
    net, _ = load_checkpoint(str(DEPTH_CKPT), device="cpu")
    scene = depth_scene("cpu", 0, DEPTH_FRAMES, H, W, DeviceCache(), 30)
    batches = list(scene.batches(1, False, drop_last=False))
    out = {}
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "checkpoint_task0.ckpt")
        write_legacy_depth(net, path)
        t0 = time.perf_counter()
        gnet, info = torch_import.import_depth_checkpoint(path, dev)
        out["import_s"] = time.perf_counter() - t0
        cnet, _ = torch_import.import_depth_checkpoint(path, "cpu")
    metrics = {}
    for name, inet, d in (("card", gnet, dev), ("cpu", cnet, "cpu")):
        specs, params, stats = inet.path(inet.archis[0])
        step = make_depth_eval_step(specs)
        metrics[name] = AverageMeterDict().update_batched(
            [step(params, stats, b["image"].to(d), b["depth"].to(d))
             for b in batches]).mean()
    diff = max(abs(metrics["card"][k] - metrics["cpu"][k])
               for k in metrics["cpu"])
    out.update(info={k: v for k, v in info.items() if k != "candidates"},
               metrics=metrics["card"], vs_cpu_max=diff,
               size_m=gnet.size_m())
    if not (diff <= DEPTH_ATOL and info["unused"] == []
            and all(np.isfinite(v) for v in metrics["card"].values())):
        failures.append(f"depth legacy import: card vs CPU {diff:.3g} "
                        f"(tolerance {DEPTH_ATOL}) or {out}")
    log(f"[depth] legacy checkpoint of task 0 imported: {json.dumps(out)}")
    return out


def phase_depth(dev, smi):
    """(a) the committed depth checkpoint and router on the card; (b)
    DepthContinualDriver.run over two styled depth scenes, every stage
    launching no kernel, zero forgetting in all ten metrics and the
    checkpoint round trip; (c) cli --variant depth --eval-only of the
    committed checkpoint. Each part sets every launch count to 0 just
    before it and reads them just after; every count must stay 0."""
    t_phase = time.perf_counter()
    failures, segments = [], {}
    zero_launches()
    restored = depth_restored(dev, failures)
    torch.cuda.synchronize()
    segments["restored"] = read_launches()
    zero_launches()
    legacy = depth_legacy_import(dev, failures)
    torch.cuda.synchronize()
    segments["legacy_import"] = read_launches()

    counts = {"trained": 0, "evaluated": 0}
    cache = DeviceCache()
    (hh, ww), n_tr, n_va, n_te = DEPTH_TRAIN_HW, *DEPTH_PAIRS
    mk = lambda n, h, w, seed: [Counted(depth_scene(dev, t, n, h, w, cache,
                                                    seed), counts)
                                for t in range(LEARN_TASKS)]
    train, valid, test = (mk(n_tr, hh, ww, 10), mk(n_va, hh, ww, 20),
                          mk(n_te, H, W, 30))
    writer = Scalars()
    log(f"[depth] configuration: {json.dumps(cfg_dict(DEPTH_CFG))};"
        f" cut from the canonical run: {'; '.join(DEPTH_CUTS)}")
    with tempfile.TemporaryDirectory() as ckpt:
        drv = StagedDepth(DEPTH_CFG, writer=writer, log=log,
                          checkpoint_dir=ckpt, device=dev, counts=counts)
        zero_launches()
        t0 = time.perf_counter()
        matrix = drv.run(train, valid, test)
        run_s = time.perf_counter() - t0
        bad, forget, segments["stages"], segments["outside_stages"] = \
            run_checks(drv, matrix, writer, "depth", depth=True)
        failures += bad
        if set(matrix.metric_names) != {"loss", *DEPTH_METRIC_NAMES}:
            failures.append(f"depth: matrix tracks {matrix.metric_names}")
        zero_launches()
        back, manifest = load_checkpoint(ckpt, LEARN_TASKS - 1, device=dev)
        roundtrip = {}
        for u in range(LEARN_TASKS):
            specs, params, stats = back.path(back.archis[u])
            step = make_depth_eval_step(specs)
            got = AverageMeterDict().update_batched(
                [step(params, stats, b["image"], b["depth"]) for b in
                 test[u].ds.batches(1, False, drop_last=False)]).mean()
            err = max(abs(got[k] - matrix.m[k][LEARN_TASKS - 1, u])
                      / max(abs(matrix.m[k][LEARN_TASKS - 1, u]), 1e-30)
                      for k in matrix.metric_names)
            roundtrip[u] = err
            if manifest["variant"] != "depth" or not err <= ROUNDTRIP_RTOL:
                failures.append(f"depth checkpoint round trip: task {u} "
                                f"differs by {err:.3g} relative")
        log(f"[depth] checkpoint {manifest['extra']['stage']} of task "
            f"{manifest['task']} reloaded: worst relative difference per task"
            f" {roundtrip}; router input {drv.router.input_key}")
        torch.cuda.synchronize()
        segments["roundtrip"] = read_launches()
    zero_launches()
    t0 = time.perf_counter()
    res = cli.main(["--variant", "depth", "--eval-only", "--checkpoint-dir",
                    str(DEPTH_CKPT), "--synthetic-size", str(DEPTH_FRAMES),
                    "--synthetic-hw", str(H), str(W)], device=dev)
    torch.cuda.synchronize()
    eval_only = {"s": time.perf_counter() - t0, "metrics": res["synthetic"]}
    segments["eval_only"] = read_launches()
    if not all(np.isfinite(v) for v in res["synthetic"].values()):
        failures.append(f"depth --eval-only: non-finite {res}")
    log(f"[depth] cli --variant depth --eval-only: {json.dumps(eval_only)}")
    for part, n in segments.items():
        failures += launch_failures(f"depth {part}", n, ())
    launches = {n: sum(seg[n] for seg in segments.values()) for n in KERNELS}
    log(f"[depth] launches by segment: " + json.dumps(
        {part: {k: c for k, c in n.items() if c} for part, n in segments.items()}))
    report = {"device": smi, "restored": restored, "legacy_import": legacy,
              "config": cfg_dict(DEPTH_CFG), "cuts": DEPTH_CUTS,
              "run_s": run_s, "stages": drv.stages,
              "genotypes": [str(g) for g in drv.net.genotypes],
              "archis": drv.net.archis,
              "matrix": {k: matrix.m[k].tolist() for k in ("silog", "d1")},
              "zero_forgetting": forget, "roundtrip_rel": roundtrip,
              "eval_only": eval_only, "launches": launches,
              "launches_by_segment": segments,
              "wall_s": time.perf_counter() - t_phase}
    log(f"[depth] phase wall time {report['wall_s']:.1f} s (driver run "
        f"{run_s:.1f} s)")
    if failures:
        raise SystemExit("chip_smoke: depth failed:\n  "
                         + "\n  ".join(failures))
    return report


def per_key(results, calls, name, field):
    """Sum of a per-call number over one request (or step), averaged over
    the task paths (or configurations) that call the kernel."""
    sums = []
    for key_calls in calls.values():
        vals = [results[(n, s)][field] for n, s in key_calls if n == name]
        if not vals:
            continue
        if any(v is None for v in vals):
            return None
        sums.append(sum(vals))
    return float(np.mean(sums))


def kernel_numbers(results, calls, name):
    bound = per_key(results, calls, name, "bound_ms")
    bound_ops = per_key(results, calls, name, "bound_ops_ms")
    out = {"ms": per_key(results, calls, name, "ms"),
           "plain_ms": per_key(results, calls, name, "plain_ms"),
           "bound_ms": bound,
           "bound_by": "operations" if bound_ops >= bound / 2 else "bytes",
           "library_ms": per_key(results, calls, name, "lib_ms")}
    # the calls timed beside the kernel and A's tensor-core bound, summed
    # like its own time
    first = next(results[(n, s)] for c in calls.values() for n, s in c
                 if n == name)
    besides = {key: r["beside"] for key, r in results.items()}
    for field in first["beside"]:
        out[field] = per_key(besides, calls, name, field)
    if "bound_tf32_ms" in first["plan"]:
        plans = {key: r["plan"] for key, r in results.items()}
        out["bound_tf32_ms"] = per_key(plans, calls, name, "bound_tf32_ms")
    return out


def shape_numbers(results, calls, name):
    """Per distinct call of one kernel in one step: its calls per step and
    its numbers and plan at that shape."""
    sigs = [s for c in calls.values() for n, s in c if n == name]
    out = []
    for sig in dict.fromkeys(sigs):
        r = results[(name, sig)]
        out.append({"sig": str(sig), "calls": sigs.count(sig), "ms": r["ms"],
                    "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                    "plain_ms": r["plain_ms"], "library_ms": r["lib_ms"],
                    **r["beside"], **r["plan"]})
    return out


def side_by_side(runs, key):
    """{path: [{name: {key: v}} per turn]} -> 'name default v, v / variants
    v, v; ...' (each path's turns in order)."""
    names = runs["default"][0]
    return "; ".join(f"{n} " + " / ".join(
        ", ".join(f"{run[n][key]:.2f}" for run in runs[p]) for p in PATHS)
        for n in names)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", type=Path, default=None,
                    help="also profile one request and one train step per "
                         "path, one data-parallel step and one supernet "
                         "train step; write tables and traces here")
    ap.add_argument("--small-only", action="store_true",
                    help="build and check every kernel at the small shapes "
                         "only; no report")
    ap.add_argument("--repro-only", action="store_true",
                    help="build, then run the repro phase alone (every "
                         "train step twice from one state, the scope's "
                         "cost, maxdisp 190, kill and resume); no report")
    # one rank of the sp phase, started by it: RANK ADDRESS DIR
    ap.add_argument("--sp-rank", nargs=3, help=argparse.SUPPRESS)
    opts = ap.parse_args()
    if opts.sp_rank:
        return sp_rank(int(opts.sp_rank[0]), *opts.sp_rank[1:])
    t_start = time.perf_counter()

    smi = phase_device()
    dev = torch.device("cuda")
    phase_build()
    if opts.small_only:
        phase_kernels({}, dev)
        log(f"[small-only] all kernels agree at the small shapes; "
            f"{time.perf_counter() - t_start:.1f} s")
        return 0
    if opts.repro_only:
        phase_repro(dev)
        log(f"[repro-only] done; {time.perf_counter() - t_start:.1f} s")
        return 0

    t0 = time.perf_counter()
    net, _ = load_checkpoint(str(CKPT), 3, device=dev)
    ris = {p: RoutedInference(net, maxdisp=MAXDISP, device=dev, variants=v)
           for p, v in PATHS.items()}
    log(f"[serve] restored {CKPT.relative_to(ROOT)} task 3 "
        f"({len(net.archis)} task paths) in {time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(0)
    requests = {t: [stereo_pair(rng, H, W, TRUE_DISP)
                    for _ in range(REQUESTS)]
                for t in range(len(net.archis))}

    args_of, plain, calls, plain_train, train_calls = {}, {}, {}, {}, {}
    for p in PATHS:
        plain[p], calls[p] = phase_record(ris[p], requests, args_of, p)
        plain_train[p], train_calls[p] = phase_record_train(dev, args_of, p)
    bf16_calls, bf16_train_calls = {}, {}
    for p in PATHS:
        bf16_calls[p], bf16_train_calls[p] = phase_record_bf16(
            dev, args_of, requests, p)
    learn_args, self_args = {}, {}
    plain_learn = phase_record_learn(dev, learn_args)
    plain_self = phase_record_selfsup(dev, self_args)
    log(f"[record] {len(args_of)} distinct kernel signatures on the main "
        f"paths, {len(learn_args)} in the supernet step, {len(self_args)} "
        f"in the photometric step ({time.perf_counter() - t_start:.0f} s)")
    results = phase_kernels(args_of, dev, {"learn": learn_args,
                                           "selfsup": self_args})
    del args_of, learn_args, self_args
    torch.cuda.empty_cache()
    log(f"[kernels] done ({time.perf_counter() - t_start:.0f} s)")
    # launches summed over a kernel's runs (each instance); times kept per
    # turn
    launches = dict.fromkeys(ALL_KERNELS, 0)
    per_task, per_cfg, outs = ({p: [] for p in PATHS} for _ in range(3))
    for p in TURNS:
        n, tasks, o = phase_serve(ris[p], requests, plain[p], p,
                                  outs["default"][0] if p != "default"
                                  else None)
        per_task[p].append(tasks)
        outs[p].append(o)
        launches = {k: launches[k] + n.get(k, 0) for k in ALL_KERNELS}
    t_route = time.perf_counter()
    scene_cache = DeviceCache()
    router, scenes, ids, route = phase_route_setup(dev, scene_cache)
    routed_ris = {p: RoutedInference(net, router=router, maxdisp=MAXDISP,
                                     device=dev, variants=v)
                  for p, v in PATHS.items()}
    per_route = {p: [] for p in PATHS}
    for p in TURNS:
        n, res = phase_route(routed_ris[p], scenes, ids, p)
        per_route[p].append(res)
        launches = {k: launches[k] + n.get(k, 0) for k in ALL_KERNELS}
    route["router_alone"] = router_time(router, scenes)
    route["router_training"] = phase_router_train(dev, scenes)
    del routed_ris, router, scenes, scene_cache
    torch.cuda.empty_cache()
    route["wall_s"] = time.perf_counter() - t_route
    log(f"[route] phase wall time {route['wall_s']:.1f} s")
    for p in TURNS:
        n, cfgs = phase_train(dev, plain_train[p], p)
        per_cfg[p].append(cfgs)
        launches = {k: launches[k] + n.get(k, 0) for k in ALL_KERNELS}
    n, bf16_report = phase_bf16(dev, net, requests)
    launches = {k: launches[k] + n.get(k, 0) for k in ALL_KERNELS}
    torch.cuda.empty_cache()
    fp32_probe = phase_fp32_probe(dev)
    torch.cuda.empty_cache()
    n, dp = phase_dp(dev, plain_train["default"], per_cfg["default"], smi,
                     opts.profile)
    dp["fp32_probe"] = fp32_probe
    launches = {k: launches[k] + n.get(k, 0) for k in ALL_KERNELS}
    torch.cuda.empty_cache()
    n, sp = phase_sp(dev, plain_train["default"], per_cfg["default"], smi)
    launches = {k: launches[k] + n.get(k, 0) for k in ALL_KERNELS}
    torch.cuda.empty_cache()
    n, learn = phase_learn(dev, plain_learn, smi)
    launches = {k: launches[k] + n.get(k, 0) for k in ALL_KERNELS}
    del plain_learn
    torch.cuda.empty_cache()
    n, scenes = phase_scenes(dev, learn, smi)
    launches = {k: launches[k] + n.get(k, 0) for k in ALL_KERNELS}
    torch.cuda.empty_cache()
    n, cli_report = phase_cli(dev, smi)
    launches = {k: launches[k] + n.get(k, 0) for k in ALL_KERNELS}
    torch.cuda.empty_cache()
    n, self_report = phase_selfsup(dev, plain_self, smi)
    launches = {k: launches[k] + n.get(k, 0) for k in ALL_KERNELS}
    del plain_self
    torch.cuda.empty_cache()
    depth_report = phase_depth(dev, smi)
    torch.cuda.empty_cache()
    # last, after every phase that times the host: it opens profiler
    # sessions of its own
    n, repro = phase_repro(dev)
    launches = {k: launches[k] + n.get(k, 0) for k in ALL_KERNELS}
    torch.cuda.empty_cache()
    if opts.profile is not None:
        phase_profile(ris, requests, dev, opts.profile)

    # serving kernels report per request over the task paths of their path
    # (and carry their training numbers apart); backward kernels per
    # training step of task 0's stage, the configuration that runs them all
    # the bf16 instances: per bf16 request (task 0's path) and per bf16
    # step of task 0's stage
    report = []
    for name, k in ALL_KERNELS.items():
        p = k["path"]
        bf = name in BF16_KERNELS
        train0 = {"task0": (bf16_train_calls if bf else train_calls)[p][
            "task0"]}
        serving = bf16_calls[p] if bf else calls[p]
        entry = {"name": name, "route": "cuda", "source": k["source"],
                 "replaces": k["replaces"],
                 "launches": launches[name],
                 "max_abs_err": k["max_err"],
                 **kernel_numbers(results, serving if k["serving"]
                                  else train0, name),
                 "path": p, "dtype": "bfloat16" if bf else "float32",
                 "status": "ok"}
        if k["serving"]:
            entry["train_step"] = kernel_numbers(results, train0, name)
        if k.get("per_shape"):
            entry["shapes"] = shape_numbers(results, train0, name)
        report.append(entry)
    log("[report] serving kernels: times per request summed over its calls "
        "and averaged over the task paths of their path; every kernel's "
        "\"train_step\" or own numbers: per step of task 0's stage; "
        "launches: every serve, route and train run of both paths, the "
        "dp run, the learn run, the cli runs, the selfsup phase (its "
        "compared step, its timed steps, its driver run and its round "
        "trip) and the repro phase; the depth phase launches none")
    log("[report] ms/request (default turns 1, 4 / variants turns 2, 3): "
        + side_by_side(per_task, "ms_per_request"))
    log("[report] peak GB per request (default / variants): "
        + side_by_side(per_task, "peak_gb"))
    for key in ("ms_per_step", "pairs_per_s", "peak_gb"):
        log(f"[report] {key} (default turns 1, 4 / variants turns 2, 3): "
            + side_by_side(per_cfg, key))
    log("[report] routed ms/request (default turns 1, 4 / variants turns "
        "2, 3): " + " / ".join(", ".join(f"{r['routed_ms']:.2f}"
                                        for r in per_route[p]) for p in PATHS)
        + "; task given: " + " / ".join(
            ", ".join(f"{r['fixed_ms']:.2f}" for r in per_route[p])
            for p in PATHS))
    log(f"[report] total wall time {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"route": {"device": smi, **route,
                                "turns": {p: per_route[p] for p in PATHS}}}))
    print(json.dumps({"learn": learn}))
    print(json.dumps({"cli": cli_report}))
    print(json.dumps({"selfsup": self_report}))
    print(json.dumps({"depth": depth_report}))
    print(json.dumps({"dp": dp}))
    print(json.dumps({"sp": sp}))
    print(json.dumps({"scenes": scenes}))
    print(json.dumps({"bf16": bf16_report}))
    print(json.dumps({"repro": repro}))
    print(json.dumps({"kernels": report}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
