"""The rank entry of tests/test_torch_parallel.py's data-parallel step: a
spawned process imports this module alone (never JAX, which the test
process holds), so it imports nothing of lmic_tpu or of
torch_port_helpers."""

import numpy as np
import torch

from lmic_tpu_torch import zoo
from lmic_tpu_torch.entropy import entropy_models
from lmic_tpu_torch.utils import train


def noise(nchw_shape):
    """U(-0.5, 0.5) noise for a port-layout shape, from the shape alone
    (torch_port_helpers.noise)."""
    rng = np.random.default_rng([11, *nchw_shape])
    return rng.uniform(-0.5, 0.5, nchw_shape)


def rows_of_global_noise(rank, world):
    """A `quantize_noise` for rank `rank` of `world`: the noise of the
    global batch's shape, of which the rank adds its rows (the first dim
    of an NCHW tensor, the last of the bottleneck's (C, 1, B*H*W))."""
    def quantize_noise(x, generator=None):
        dim = 2 if x.dim() == 3 else 0
        n = x.shape[dim]
        shape = x.shape[:dim] + (n * world,) + x.shape[dim + 1:]
        drawn = torch.from_numpy(noise(tuple(shape)))
        return x + drawn.narrow(dim, rank * n, n).to(x.dtype)

    return quantize_noise


def ddp_step(rank, world, device, arch, widths, state_dict, batch, lmbda,
             out_dir):
    """One `make_train_step(..., data_parallel=True)` step of `arch` at
    `widths` on `state_dict`'s weights, on this rank's rows of the NHWC
    numpy `batch` (taken NCHW, channels_last in memory), with the rows of
    the global noise; writes the step's metrics and (rank 0) the
    parameters' gradients to `out_dir`/rank<r>.pt."""
    from lmic_tpu_torch import parallel

    entropy_models.quantize_noise = rows_of_global_noise(rank, world)
    module = zoo.make_module(arch, 1, **widths)
    module.load_state_dict(state_dict)
    module = module.to(device, memory_format=torch.channels_last)
    opt = train.make_optimizer()
    step = train.make_train_step(module, opt, lmbda, data_parallel=True)
    x = torch.from_numpy(parallel.rank_rows(batch, rank, world)).permute(
        0, 3, 1, 2).to(device)
    _, metrics = step(train.create_train_state(module, opt), x)
    out = {"metrics": {k: float(v) for k, v in metrics.items()}}
    if rank == 0:
        out["grads"] = {n: p.grad.detach().clone()
                        for n, p in module.named_parameters()}
    torch.save(out, f"{out_dir}/rank{rank}.pt")


def ddp_step_and_card_check(rank, world, device, step_args, check_args):
    """`ddp_step(*step_args)`, then chip_smoke.py's two-rank check
    (`crosscheck.data_parallel_rank(*check_args)`) in the same process
    group: one spawn for both."""
    from lmic_tpu_torch.utils import crosscheck

    quantize_noise = entropy_models.quantize_noise
    ddp_step(rank, world, device, *step_args)
    entropy_models.quantize_noise = quantize_noise
    crosscheck.data_parallel_rank(rank, world, device, *check_args)
