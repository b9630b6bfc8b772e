"""Training over more than one step against the JAX package, on the CPU.

Three ``make_train_step`` steps of task 3's fine-tune stage of the
committed checkpoint ``logs/canonical_learn_r4`` (BN-train = trainable =
``trainable_sites(3)``), in float64, under the cosine learning rate, on
the batches of a styled ``SyntheticStereoDataset`` scene (B=2, 48x96,
maxdisp 192): the port's dataset yields them, and they must equal
rag_tpu's bytes before both packages step on them. Every step is held at
tests/test_torch_port_train_slice.py's float64 bounds: dp/lr and momentum
within 1e-9 of each leaf's largest value, BatchNorm statistics within
1e-12 of max(1, |stat|). The loss and EPE are held within 1e-12 relative
at the first step, which starts from an equal state, and within 1e-10 at
the later ones: those start from params that already differ by the first
step's rounding (up to the 1e-9 above), which moves a loss of ~20 px
by more than one step's own rounding (1.28e-12 measured at step 2).
"""

from pathlib import Path

import jax
import numpy as np

from rag_tpu.continual.state import load_checkpoint as jax_load_checkpoint
from rag_tpu.data.synthetic import SyntheticStereoDataset as JaxSynthetic
from rag_tpu.train import trainer as jtrainer
from rag_tpu_torch.continual.state import load_checkpoint
from rag_tpu_torch.data.synthetic import WEATHER_STYLES, SyntheticStereoDataset
from rag_tpu_torch.train.trainer import cosine_lr
from test_torch_port_train_slice import LR, _Pair

ROOT = Path(__file__).resolve().parent.parent
CKPT = str(ROOT / "logs" / "canonical_learn_r4")
STEPS, EPOCHS = 3, 10
LATER_LOSS_RTOL = 1e-10  # loss and EPE after the first step


def test_checkpoint_task3_three_steps_synthetic():
    jnet = jax_load_checkpoint(CKPT, 3)[0]
    tnet = load_checkpoint(CKPT, 3, device="cpu")[0]
    sites = tnet.trainable_sites(3)
    assert sites == jnet.trainable_sites(3)
    specs_j, params_j, stats_j = jnet.path(jnet.archis[3])
    specs_t, _, _ = tnet.path(tnet.archis[3])
    pair = _Pair(specs_j, specs_t,
                 jax.tree_util.tree_map(np.asarray, params_j),
                 jax.tree_util.tree_map(np.asarray, stats_j),
                 sites, sites, 192, np.float64)
    kw = dict(seed=13, max_disp=40.0, style=WEATHER_STYLES[3])
    scene = SyntheticStereoDataset(2 * STEPS, 48, 96, device="cpu", **kw)
    ref = list(JaxSynthetic(2 * STEPS, 48, 96, **kw).batches(2, True, seed=0))
    got = list(scene.batches(2, True, seed=0))
    assert len(got) == len(ref) == STEPS
    losses = []
    for epoch, (b, r) in enumerate(zip(got, ref)):
        b = {k: v.numpy() for k, v in b.items()}
        for k in r:
            np.testing.assert_array_equal(b[k], r[k], err_msg=k)
        lr = cosine_lr(LR, EPOCHS, epoch)
        assert lr == jtrainer.cosine_lr(LR, EPOCHS, epoch)
        sc = pair.step_and_compare(lr, b["left"], b["right"], b["disparity"],
                                   loss_tol=LATER_LOSS_RTOL if epoch else None)
        losses.append(float(sc["loss"]))
    assert np.isfinite(losses).all()
