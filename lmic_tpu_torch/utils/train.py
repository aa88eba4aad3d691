"""Training: rate-distortion loss, dual Adam optimizers, the train step.

Counterpart of lmic_tpu/utils/train.py (reference examples/train.py):

- `rate_distortion_loss`: loss = lambda[q] * MSE(x_hat, x) + bpp, with the
  fork's lambda table indexed by quality - 1 and
  bpp = sum(-log2 likelihood) / (B*H*W) (train.py:59-82). Targets are NCHW.
- Two Adams: the main one (lr 1e-4, gradients clipped at global norm 1.0)
  on every parameter but the bottleneck `quantiles`, the aux one (lr 1e-3)
  on the quantiles (train.py:111-142). The aux loss detaches the transform
  parameters and the training-mode RD loss never reads the quantiles, so
  one backward of `rd + aux` gives each optimizer exactly the gradients of
  the reference's two backward passes.
- `step_lr`: StepLR(40 epochs, 0.5) as a function of the main optimizer's
  update count, as optax counts it (the first update sees count 0).

The parameters live in the module; `TrainState` holds it with both
optimizers and the step count. The step draws its quantization noise from
an explicit `torch.Generator` on the batch's device. `remat=True` is
lmic_tpu's `--remat`: the forward keeps only the inputs of its transform
blocks and the backward recomputes them (layers/remat.py), the same
gradients for less memory. `matmul_precision="bfloat16"` is its
`--bf16` (ops/precision.py). `data_parallel=True` is its data parallelism
over a mesh: one process a device under DistributedDataParallel
(parallel/), each rank stepping on its rows of the global batch.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Callable, Dict, Iterable, Optional, Union

import torch
from torch import nn

from lmic_tpu_torch.layers.remat import rematerialize
from lmic_tpu_torch.ops.precision import matmul_precision as precision

# fork's lambda table, indexed by quality - 1 (examples/train.py:65)
LAMBDA_TABLE = (256, 512, 1024, 2048, 4096, 8192, 10240)

Schedule = Union[float, Callable[[int], float]]


def rate_distortion_loss(output, target, lmbda: float):
    """Returns dict(loss, mse_loss, bpp_loss); `target` is (B, C, H, W)."""
    num_pixels = target.shape[0] * target.shape[2] * target.shape[3]
    bpp = sum(
        torch.sum(torch.log(lik)) / (-math.log(2.0) * num_pixels)
        for lik in output["likelihoods"].values()
    )
    mse = torch.mean((output["x_hat"] - target) ** 2)
    return {"loss": lmbda * mse + bpp, "mse_loss": mse, "bpp_loss": bpp}


def step_lr(base_lr: float, steps_per_epoch: int, step_size: int = 40,
            gamma: float = 0.5) -> Callable[[int], float]:
    """StepLR(step_size epochs, gamma) as a function of the update count."""

    def schedule(count: int) -> float:
        epoch = count // steps_per_epoch
        return base_lr * gamma ** (epoch // step_size)

    return schedule


def clip_by_global_norm(grads: Iterable[torch.Tensor], max_norm: float):
    """Scale `grads` in place to global norm `max_norm` when their norm is
    not below it, as `optax.clip_by_global_norm` does: `g / norm * max_norm`
    (no epsilon, unlike `torch.nn.utils.clip_grad_norm_`). Stays on the
    device (no host sync). Returns the norm before clipping."""
    grads = [g for g in grads if g is not None]
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, (g / norm) * max_norm))
    return norm


def _is_aux(name: str) -> bool:
    return name.rsplit(".", 1)[-1] == "quantiles"


@dataclasses.dataclass(frozen=True)
class DualOptimizer:
    """What `make_optimizer` returns: the settings of the two Adams, which
    `create_train_state` instantiates on a module's parameters."""

    learning_rate: Schedule = 1e-4
    aux_learning_rate: float = 1e-3
    clip_grad_norm: Optional[float] = 1.0

    def lr(self, count: int) -> float:
        """The main learning rate at update `count`."""
        if callable(self.learning_rate):
            return float(self.learning_rate(count))
        return float(self.learning_rate)


def make_optimizer(learning_rate: Schedule = 1e-4,
                   aux_learning_rate: float = 1e-3,
                   clip_grad_norm: Optional[float] = 1.0) -> DualOptimizer:
    """Dual optimizer: Adam(lr) on transform params (with global-norm
    clipping), Adam(aux_lr) on the bottleneck quantiles. `learning_rate`
    may be a schedule of the update count (`step_lr`)."""
    return DualOptimizer(learning_rate, aux_learning_rate, clip_grad_norm)


@dataclasses.dataclass
class TrainState:
    """The parameters (in `module`), both optimizer states and the count
    of steps taken."""

    module: nn.Module
    main: torch.optim.Adam  # every parameter but `quantiles`
    aux: torch.optim.Adam  # the bottleneck `quantiles`
    step: int = 0

    def state_dict(self) -> Dict:
        return {"params": self.module.state_dict(),
                "main": self.main.state_dict(),
                "aux": self.aux.state_dict(), "step": self.step}

    def load_state_dict(self, sd: Dict):
        self.module.load_state_dict(sd["params"])
        self.main.load_state_dict(sd["main"])
        self.aux.load_state_dict(sd["aux"])
        self.step = int(sd["step"])


def create_train_state(module: nn.Module,
                       optimizer: DualOptimizer) -> TrainState:
    named = list(module.named_parameters())
    main = [p for n, p in named if not _is_aux(n)]
    aux = [p for n, p in named if _is_aux(n)]
    # optax.adam's defaults: b1 0.9, b2 0.999, eps 1e-8
    return TrainState(
        module=module,
        main=torch.optim.Adam(main, lr=optimizer.lr(0)),
        aux=torch.optim.Adam(aux, lr=optimizer.aux_learning_rate),
    )


def rd_aux_loss(module: nn.Module, out, target: torch.Tensor,
                lmbda: float):
    """The step's objective: (RD loss + `module`'s aux loss, metrics)."""
    rd = rate_distortion_loss(out, target, lmbda)
    aux = module.aux_loss()
    metrics = {k: v.detach() for k, v in rd.items()}
    metrics["aux_loss"] = aux.detach()
    return rd["loss"] + aux, metrics


def train_update(state: TrainState, optimizer: DualOptimizer,
                 loss_fn: Callable):
    """One update of `state`: the scheduled learning rate, `loss_fn()` ->
    (loss, metrics), one backward, the global-norm clip of the main
    gradients, both Adams. Returns (state, metrics)."""
    for group in state.main.param_groups:
        group["lr"] = optimizer.lr(state.step)
    state.main.zero_grad(set_to_none=True)
    state.aux.zero_grad(set_to_none=True)
    loss, metrics = loss_fn()
    loss.backward()
    if optimizer.clip_grad_norm is not None:
        clip_by_global_norm(
            (p.grad for group in state.main.param_groups
             for p in group["params"]),
            optimizer.clip_grad_norm,
        )
    state.main.step()
    state.aux.step()
    state.step += 1
    return state, metrics


def expandable_segments(device) -> bool:
    """Switch the CUDA caching allocator to expandable segments for a
    `--remat` run on `device`, unless PYTORCH_CUDA_ALLOC_CONF is set.
    Remat trains at batches near the card's memory, where fixed segments
    fragment until cuDNN gets no workspace and falls back to its direct
    data-gradient kernel: the master q7 at batch 16 on the H100 spent 166
    s of a 174 s step in it, and 8.4 s a step with expandable segments
    (PERF.md). Returns whether it switched."""
    if (torch.device(device).type != "cuda"
            or "PYTORCH_CUDA_ALLOC_CONF" in os.environ):
        return False
    set_settings = getattr(torch._C, "_accelerator_setAllocatorSettings",
                           None) or torch.cuda.memory._set_allocator_settings
    set_settings("expandable_segments:True")
    return True


def make_train_step(module: nn.Module, optimizer: DualOptimizer,
                    lmbda: float, remat: bool = False,
                    matmul_precision: Optional[str] = None,
                    data_parallel: bool = False) -> Callable:
    """Build the train step (with `remat`, rematerializing the transform
    blocks). `matmul_precision="bfloat16"` is lmic_tpu's `--bf16`: the
    module's training forward runs under `ops/precision.py`'s mode (its
    convs and products on bf16-rounded operands, their backward too),
    the RD and aux losses outside it, as in lmic_tpu/utils/train.py:
    126-133.

    step(state, batch, generator) -> (state, metrics). `batch` is
    (B, C, H, W) in [0, 1] on the module's device (channels_last memory);
    `generator` draws the quantization noise on that device. The state is
    updated in place (parameters and optimizer moments) and returned;
    the metrics are 0-d tensors on the device, so the step does not wait
    for the card.

    With `data_parallel`, in a process group (`parallel.launch`), the
    forward runs under DistributedDataParallel (`parallel.data_parallel`)
    on this rank's rows: the backward all-reduces the mean gradient
    before the clip and both Adams, so every rank takes the update of the
    global batch, and the metrics are their means over the ranks.
    """
    forward = module
    if data_parallel:
        from lmic_tpu_torch import parallel

        forward = parallel.data_parallel(module,
                                         next(module.parameters()).device)

    def train_step(state: TrainState, batch: torch.Tensor,
                   generator: Optional[torch.Generator] = None):
        def loss_fn():
            with rematerialize(remat), precision(matmul_precision):
                out = forward(batch, training=True, generator=generator)
            return rd_aux_loss(module, out, batch, lmbda)

        state, metrics = train_update(state, optimizer, loss_fn)
        if data_parallel:
            metrics = parallel.mean_over_ranks(metrics)
        return state, metrics

    return train_step


def make_eval_step(module: nn.Module, lmbda: float) -> Callable:
    """eval_step(batch) -> RD metrics and PSNR of the eval-mode (rounded)
    forward, without gradients."""

    @torch.no_grad()
    def eval_step(batch: torch.Tensor):
        out = module(batch, training=False)
        rd = rate_distortion_loss(out, batch, lmbda)
        return {**rd, "psnr": -10.0 * torch.log10(rd["mse_loss"])}

    return eval_step
