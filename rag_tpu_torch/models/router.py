"""Scene Router: per-frame path selection at inference time.

Counterpart of rag_tpu/models/router.py. A small convolutional scene
classifier over the left frame: three stride-2 3x3 convs with ReLU, then a
linear head over the global mean and standard deviation of the last
features (the std half separates styles that differ in variance, such as
rain's noise). ``route`` returns the task whose path the grown network
runs for each frame. The reference runs it through XLA with no Pallas
kernel, so here it is plain PyTorch, in full float32 (no TF32).

Layouts are the reference's, so stored leaves round-trip unchanged:
weights HWIO (3, 3, cin, cout), frames NHWC, head (2 * 4 * width,
num_tasks). Training is softmax cross-entropy under optax's Adam, written
out on the leaves (``Adam``); ``SceneRouter.state_arrays`` flattens
(params, Adam state) in the order of ``jax.tree_util.tree_flatten`` of the
reference's ``(params, optax.adam(lr).init(params))``:

    0-4    params b, c0, c1, c2, w (sorted keys)
    5      Adam count (int32, 0-d)
    6-10   mu of b, c0, c1, c2, w
    11-15  nu of b, c0, c1, c2, w
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from rag_tpu_torch.models.stereo import full_fp32, reproducible

CONVS = ("c0", "c1", "c2")
PARAM_KEYS = ("b", "c0", "c1", "c2", "w")   # sorted, as jax flattens a dict


def init_router(generator: torch.Generator, num_tasks: int, width: int = 16,
                device="cuda") -> Dict[str, torch.Tensor]:
    """The reference's shapes and He-style std, drawn from ``generator``
    (a CPU generator; the draws are not the reference's)."""
    def normal(shape, std):
        return (torch.randn(shape, generator=generator) * std).to(device)

    def conv(cin, cout):
        return normal((3, 3, cin, cout), math.sqrt(2.0 / (cout * 9)))

    return {"c0": conv(3, width), "c1": conv(width, width * 2),
            "c2": conv(width * 2, width * 4),
            "w": normal((width * 8, num_tasks), 0.01),
            "b": torch.zeros(num_tasks, device=device)}


def _same_pad(n: int, stride: int = 2, k: int = 3):
    """(before, after) of XLA's "SAME" padding along an axis of size n:
    (0, 1) on an even size and (1, 1) on an odd one at stride 2."""
    total = max((-(-n // stride) - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def router_logits(params, image: torch.Tensor) -> torch.Tensor:
    """image: (B,H,W,3) NHWC -> (B,num_tasks) logits."""
    with full_fp32():
        x = image.permute(0, 3, 1, 2)
        for name in CONVS:
            (t, b), (l, r) = _same_pad(x.shape[2]), _same_pad(x.shape[3])
            x = F.conv2d(F.pad(x, (l, r, t, b)),
                         params[name].permute(3, 2, 0, 1), stride=2)
            x = torch.relu(x)
        mean = x.mean(dim=(2, 3))
        std = torch.sqrt(torch.clamp(
            (x * x).mean(dim=(2, 3)) - mean * mean, min=0.0))
        feat = torch.cat([mean, std], dim=-1)
        return feat @ params["w"] + params["b"]


def route(params, image: torch.Tensor) -> torch.Tensor:
    """(B,) predicted task ids."""
    return torch.argmax(router_logits(params, image), dim=-1)


class Adam:
    """optax.adam(lr) (b1 0.9, b2 0.999, eps 1e-8, eps_root 0) written
    out in optax's order: count + 1; mu = (1 - b1) g + b1 mu; nu =
    (1 - b2) g^2 + b2 nu; update = -lr * mu_hat / (sqrt(nu_hat) + eps)
    with both moments bias-corrected by the new count. The state is
    {"count": int32 0-d, "mu": tree, "nu": tree}."""

    def __init__(self, lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps

    def init(self, params) -> Dict:
        return {"count": torch.zeros((), dtype=torch.int32,
                                     device=params["b"].device),
                "mu": {k: torch.zeros_like(v) for k, v in params.items()},
                "nu": {k: torch.zeros_like(v) for k, v in params.items()}}

    @torch.no_grad()
    def apply(self, params, grads, state):
        """(new params, new state); nothing is updated in place."""
        count = state["count"] + 1
        new_p, mu, nu = {}, {}, {}
        for k, p in params.items():
            g = grads[k]
            mu[k] = (1 - self.b1) * g + self.b1 * state["mu"][k]
            nu[k] = (1 - self.b2) * (g * g) + self.b2 * state["nu"][k]
            # the corrections 1 - b^count in the leaf's dtype, as optax
            c = count.to(p.dtype)
            mu_hat = mu[k] / (1 - torch.full_like(c, self.b1) ** c)
            nu_hat = nu[k] / (1 - torch.full_like(c, self.b2) ** c)
            new_p[k] = p + (mu_hat / (torch.sqrt(nu_hat) + self.eps)) * -self.lr
        return new_p, {"count": count, "mu": mu, "nu": nu}


def make_router_train_step(optimizer: Adam):
    """step(params, opt_state, images, labels) -> (params, opt_state, loss):
    softmax cross-entropy with integer labels, mean over the batch, then
    one optimizer update. The forward and backward run in
    ``reproducible()``, as the stereo train steps' do."""
    def step(params, opt_state, images, labels):
        with reproducible(), torch.enable_grad():
            handles = {k: v.detach().requires_grad_(True)
                       for k, v in params.items()}
            loss = F.cross_entropy(router_logits(handles, images),
                                   labels.to(torch.int64))
            grads = torch.autograd.grad(loss, list(handles.values()))
        params, opt_state = optimizer.apply(
            params, dict(zip(handles, grads)), opt_state)
        return params, opt_state, loss.detach()

    return step


class SceneRouter:
    """Trainer/predictor for the scene classifier on ``device``."""

    def __init__(self, num_tasks: int, seed: int = 0, lr: float = 1e-3,
                 input_key: str = "left", device="cuda"):
        self.num_tasks = num_tasks
        self.input_key = input_key      # "left" (stereo) / "image" (depth)
        self.device = torch.device(device)
        self.trained_task = -1          # the last task trained after
        self.params = init_router(torch.Generator().manual_seed(seed),
                                  num_tasks, device=self.device)
        self.optimizer = Adam(lr)
        self.opt_state = self.optimizer.init(self.params)
        self._step = make_router_train_step(self.optimizer)

    def to(self, device) -> "SceneRouter":
        """Move params and optimizer state to ``device`` (in place)."""
        self.device = torch.device(device)
        self.params = {k: v.to(self.device) for k, v in self.params.items()}
        self.opt_state = {
            "count": self.opt_state["count"].to(self.device),
            **{m: {k: v.to(self.device)
                   for k, v in self.opt_state[m].items()}
               for m in ("mu", "nu")}}
        return self

    def _tensor(self, a) -> torch.Tensor:
        dtype = self.params["b"].dtype
        return torch.as_tensor(a, dtype=dtype, device=self.device)

    def train(self, datasets, epochs: int = 3, batch: int = 8,
              log=None) -> List[float]:
        """datasets: one per scene (index = label), balanced round-robin.
        Returns each epoch's last loss, the value the log line prints."""
        losses = []
        for epoch in range(epochs):
            batch_eff = max(1, min(batch, min(len(d) for d in datasets)))
            iters = [d.batches(batch_eff, True, seed=epoch) for d in datasets]
            done = [False] * len(iters)
            loss = None
            while not all(done):
                for t, it in enumerate(iters):
                    if done[t]:
                        continue
                    try:
                        b = next(it)
                    except StopIteration:
                        done[t] = True
                        continue
                    frames = self._tensor(b[self.input_key])
                    labels = torch.full((frames.shape[0],), t,
                                        dtype=torch.int64, device=self.device)
                    self.params, self.opt_state, loss = self._step(
                        self.params, self.opt_state, frames, labels)
            if loss is not None:
                losses.append(float(loss))
                if log:
                    log(f"[router] epoch {epoch} loss {losses[-1]:.4f}")
        return losses

    @torch.inference_mode()
    def predict(self, images) -> np.ndarray:
        """(B,) task ids (int64) of a batch of frames (B,H,W,3)."""
        return route(self.params, self._tensor(images)).cpu().numpy()

    def state_arrays(self) -> Dict[str, np.ndarray]:
        """Flat {router_leaf_i: np.ndarray} of params + Adam state."""
        flat = ([self.params[k] for k in PARAM_KEYS]
                + [self.opt_state["count"]]
                + [self.opt_state[m][k] for m in ("mu", "nu")
                   for k in PARAM_KEYS])
        return {f"router_leaf_{i}": v.detach().cpu().numpy()
                for i, v in enumerate(flat)}

    def load_arrays(self, arrays) -> None:
        """Inverse of state_arrays; the leaves must have this router's
        shapes (the same num_tasks and width)."""
        n = len(PARAM_KEYS)
        leaves = [arrays[f"router_leaf_{i}"] for i in range(3 * n + 1)]
        if f"router_leaf_{3 * n + 1}" in arrays:
            raise ValueError(f"more than {3 * n + 1} router leaves")
        for i, k in enumerate(PARAM_KEYS):
            for j in (i, n + 1 + i, 2 * n + 1 + i):
                if tuple(leaves[j].shape) != tuple(self.params[k].shape):
                    raise ValueError(
                        f"router_leaf_{j}: shape {leaves[j].shape}, "
                        f"expected {tuple(self.params[k].shape)}")

        def tensor(a):
            return torch.from_numpy(np.array(a, copy=True)).to(self.device)

        self.params = {k: tensor(leaves[i]) for i, k in enumerate(PARAM_KEYS)}
        self.opt_state = {
            "count": tensor(np.asarray(leaves[n], np.int32)),
            "mu": {k: tensor(leaves[n + 1 + i])
                   for i, k in enumerate(PARAM_KEYS)},
            "nu": {k: tensor(leaves[2 * n + 1 + i])
                   for i, k in enumerate(PARAM_KEYS)}}

    def accuracy(self, datasets, batch: int = 8) -> float:
        correct = total = 0
        for t, d in enumerate(datasets):
            for b in d.batches(batch, False, seed=0, drop_last=False):
                pred = self.predict(b[self.input_key])
                correct += int((pred == t).sum())
                total += len(pred)
        return correct / max(total, 1)
