"""Training CLI: the examples/train.py recipes for the port's image codecs.

Counterpart of lmic_tpu/utils/train_cli.py (`make_master_train_step`,
`parse_args`, `train_single`, `train_master`, `main`), on CUDA unless
`--device cpu`. Its two recipes:

- single-model training of any zoo arch the port has (the image codecs,
  the AR codecs mbt2018 and cheng2020-*, the RGB-T guide `guided` and
  the paired RGB-T guides `mbt2018_R`, `cheng2020-anchor_R`,
  `cheng2020-attn_R`) with the RD loss `lambda[q] * MSE + bpp`, dual Adam optimizers,
  StepLR(40 epochs, 0.5), best-checkpoint selection on a test split when
  the dataset has one, and resume from a checkpoint; `--channel 1` trains
  on one 8-bit grayscale (thermal) channel;
- master training (`--arch master`, f32): a frozen guide, loaded from a
  `--guided-checkpoint` of this CLI, runs in eval mode without gradients,
  and its reconstruction and decoder maps condition the master's step.

`--amp` runs the transforms in bf16 (params, quantization noise and
likelihoods stay f32) for the archs in AMP_ARCHS. `--bf16` is lmic_tpu's
bf16 matmul precision: every conv and product of the training forward that
lmic_tpu leaves at its default precision, and of its backward, takes
bf16-rounded operands with f32 sums (ops/precision.py; the GDN, the
bottleneck and the losses stay f32), for every arch that trains alone; it
combines with `--amp` and `--remat`. The master trains in f32 only, as
lmic_tpu's master step does whatever the flags say. `--remat` recomputes
the transform blocks in the backward instead of keeping their
activations (layers/remat.py), for every arch and both recipes: the same
step in less memory; on CUDA it also gives the caching allocator
expandable segments (`train.expandable_segments`).

Usage:
  python -m lmic_tpu_torch.utils.train_cli --arch mbt2018-mean -q 7 \\
      -d /path/dataset --epochs 100 --batch-size 16
  python -m lmic_tpu_torch.utils.train_cli --arch master -q 3 --channel 1 \\
      -d /path/FLIR/train/thermal_8_bit --guided-checkpoint guided.ckpt

`--devices N` trains data-parallel over the first N local devices (all of
them by default, as lmic_tpu does; one with `--device cpu`): one process
a device, spawned by this command, each stepping under
DistributedDataParallel on its contiguous rows of the global batch (the
batch size must divide by N), NCCL on CUDA and gloo on the CPU
(`parallel.launch`). Each rank seeds its noise from the seed and its rank;
rank 0 alone prints and writes checkpoints; every rank resumes from
`--checkpoint` onto its own device; the test loss is the mean over the
ranks. With one device it is the plain step, with no process group.

The `*_D` archs have no training recipe, as in lmic_tpu.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch

from lmic_tpu_torch import default_device, parallel, zoo
from lmic_tpu_torch.layers.remat import rematerialize
from lmic_tpu_torch.utils import checkpoint as ckpt
from lmic_tpu_torch.utils.train import (
    LAMBDA_TABLE,
    create_train_state,
    expandable_segments,
    make_eval_step,
    make_optimizer,
    make_train_step,
    rd_aux_loss,
    step_lr,
    train_update,
)

# lmic_tpu's AMP_ARCHS: the archs whose transforms take a compute dtype
AMP_ARCHS = {
    "bmshj2018-factorized",
    "bmshj2018-hyperprior",
    "mbt2018-mean",
    "mbt2018",
    "cheng2020-anchor",
    "cheng2020-attn",
    "guided",
}


def make_master_train_step(master_module, guided_module, optimizer,
                           lmbda: float, remat: bool = False,
                           data_parallel: bool = False):
    """The master step (reference train.py:208-274): the frozen guide's
    eval forward without gradients feeds the master's training forward
    (with `remat`, rematerializing the master's transform blocks), then
    RD + aux, one backward, the clip and both Adams. With
    `data_parallel`, the master alone runs under DistributedDataParallel
    (`train.make_train_step`); the frozen guide stays outside it.

    step(state, master_batch, guided_batch, generator) -> (state,
    metrics); the batches are NCHW in [0, 1] on the modules' device."""
    forward = master_module
    if data_parallel:
        forward = parallel.data_parallel(
            master_module, next(master_module.parameters()).device)

    def step(state, master_batch, guided_batch, generator=None):
        with torch.no_grad():
            g_out = guided_module(guided_batch, training=False)
        guided_hat = g_out["x_hat"]
        # the master reads the decoder's maps only; drop the encoder's
        # before the master's activations are allocated
        hidden = {k: g_out["hidden"][k] for k in ("gs1", "gs2", "gs3")}
        del g_out

        def loss_fn():
            with rematerialize(remat):
                out = forward(master_batch, guided_hat, hidden,
                              training=True, generator=generator)
            return rd_aux_loss(master_module, out, master_batch, lmbda)

        state, metrics = train_update(state, optimizer, loss_fn)
        if data_parallel:
            metrics = parallel.mean_over_ranks(metrics)
        return state, metrics

    return step


def parse_args(argv):
    p = argparse.ArgumentParser(description="lmic_tpu_torch training")
    p.add_argument("--arch", default="bmshj2018-factorized",
                   help="architecture name from the zoo")
    p.add_argument("-q", "--quality", type=int, default=1)
    p.add_argument("-d", "--dataset", required=True)
    p.add_argument("--channel", type=int, default=3)
    p.add_argument("-e", "--epochs", type=int, default=100)
    p.add_argument("-lr", "--learning-rate", type=float, default=1e-4)
    p.add_argument("--aux-learning-rate", type=float, default=1e-3)
    p.add_argument("-n", "--batch-size", type=int, default=16)
    p.add_argument("--patch-size", type=int, nargs=2, default=(256, 256))
    p.add_argument("--crop-size", type=int, nargs=2, default=(512, 640),
                   help="guide crop for master training")
    p.add_argument("--seed", type=int, default=1926)
    p.add_argument("--clip-max-norm", type=float, default=1.0)
    p.add_argument("--checkpoint", default=None, help="resume path")
    p.add_argument("--guided-checkpoint", default=None,
                   help="frozen guide params for master training (a "
                        "training checkpoint of --arch guided)")
    p.add_argument("--save-path", default="checkpoint.ckpt")
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--amp", action="store_true",
                   help="bf16 activations through the transform stacks "
                        "(params, quantization noise and likelihoods stay "
                        f"f32); {', '.join(sorted(AMP_ARCHS))}")
    p.add_argument("--prefetch", type=int, default=2,
                   help="host batches prepared ahead on a background "
                        "thread (0 disables)")
    p.add_argument("--steps-per-epoch", type=int, default=None)
    p.add_argument("--device", default=None,
                   help="torch device (default: CUDA; raises without a GPU "
                        "unless 'cpu' is given)")
    p.add_argument("--bf16", action="store_true",
                   help="bf16 matmul precision: the training forward's "
                        "convs and products (and their gradients) on "
                        "bf16-rounded operands with f32 sums; not for "
                        "--arch master")
    p.add_argument("--remat", action="store_true",
                   help="recompute the transform blocks in the backward "
                        "instead of keeping their activations (less "
                        "memory, about a third more compute)")
    p.add_argument("--devices", type=int, default=None,
                   help="train data-parallel on the first N local devices "
                        "(default: all; one with --device cpu); the batch "
                        "size must divide by N")
    return p.parse_args(argv)


def _batches(dl, n: int):
    """Apply background prefetch when requested."""
    if n and n > 0:
        from lmic_tpu_torch.datasets import prefetch

        return prefetch(iter(dl), size=n)
    return dl


def _to_device(batch: np.ndarray, device) -> torch.Tensor:
    """(B, H, W, C) numpy -> (B, C, H, W) float32 on `device`; the NHWC
    memory is already the channels_last layout."""
    return torch.from_numpy(batch.astype(np.float32)).permute(
        0, 3, 1, 2).to(device)


def _train_state(args, module, steps_per_epoch):
    """The optimizer (StepLR(40 epochs, 0.5) on the main one, reference
    train.py:395), the train state, resumed from `--checkpoint` when
    given, and the epoch to start from and the best loss so far."""
    optimizer = make_optimizer(
        step_lr(args.learning_rate, steps_per_epoch),
        args.aux_learning_rate, args.clip_max_norm,
    )
    state = create_train_state(module, optimizer)
    start_epoch, best_loss = 0, float("inf")
    if args.checkpoint:
        state, extra = ckpt.load_checkpoint(args.checkpoint, state)
        start_epoch = extra.get("epoch", 0) + 1
        best_loss = extra.get("best_loss", float("inf"))
    return optimizer, state, start_epoch, best_loss


def _epochs(args, arch, state, dl, run_step, start_epoch, best_loss,
            eval_loss=None, rank: int = 0):
    """The epoch loop: `run_step(batch)` -> metrics for each batch of `dl`,
    a log line every `--log-every` steps, the epoch's loss (`eval_loss()`
    when given and not None, else the mean of the logged losses), and a
    checkpoint (with its best copy) after each epoch. Under data
    parallelism the metrics are the ranks' means, so every rank tracks
    the same best loss; rank 0 alone prints and writes."""
    say = print if rank == 0 else (lambda *a, **k: None)
    for epoch in range(start_epoch, args.epochs):
        t0 = time.time()
        running = []
        for i, batch in enumerate(_batches(dl, args.prefetch)):
            if args.steps_per_epoch and i >= args.steps_per_epoch:
                break
            metrics = run_step(batch)
            if i % args.log_every == 0:
                m = {k: float(v) for k, v in metrics.items()}
                running.append(m["loss"])
                say(
                    f"epoch {epoch} it {i}: loss={m['loss']:.4f} "
                    f"mse={m['mse_loss']:.6f} "
                    f"bpp={m['bpp_loss']:.4f} "
                    f"aux={m['aux_loss']:.1f}",
                    flush=True,
                )
        epoch_loss = eval_loss() if eval_loss is not None else None
        if epoch_loss is not None:
            say(f"epoch {epoch} test loss={epoch_loss:.4f}", flush=True)
        else:  # no test split, or one smaller than a batch
            epoch_loss = float(np.mean(running)) if running else float("inf")
        is_best = epoch_loss < best_loss
        best_loss = min(epoch_loss, best_loss)
        if rank == 0:
            ckpt.save_checkpoint(
                args.save_path, state,
                {"epoch": epoch, "best_loss": best_loss, "arch": arch,
                 "quality": args.quality},
                is_best=is_best,
            )
        say(f"epoch {epoch} done in {time.time()-t0:.1f}s "
              f"loss={epoch_loss:.4f}{' (best)' if is_best else ''}",
              flush=True)
    return state


def _rows(batch, rank: int, world: int, device):
    """This rank's rows of a global numpy batch, NCHW on `device`."""
    return _to_device(parallel.rank_rows(batch, rank, world), device)


def train_single(args, rank: int = 0, world: int = 1, device=None):
    """Single-model training; with `world` > 1 as rank `rank` of a
    process group (`main` spawns the ranks), on `device`."""
    from lmic_tpu_torch.datasets import DataLoader, ImageFolder, ImageFolderT

    device = default_device(device or args.device)
    if args.remat:
        expandable_segments(device)
    lmbda = LAMBDA_TABLE[args.quality - 1]
    dtype = torch.bfloat16 if args.amp else None
    codec = zoo.create_model(args.arch, args.quality, seed=args.seed,
                             channel=args.channel, device=device,
                             dtype=dtype)
    module = codec.module

    if args.channel == 3:
        loader, kwargs = ImageFolder, {}
    else:
        # grayscale modalities stay single-channel (reference
        # image_rgbt_t.py)
        loader, kwargs = ImageFolderT, {"channel": args.channel}
    ds = loader(args.dataset, "train", patch_size=tuple(args.patch_size),
                seed=args.seed, **kwargs)
    dl = DataLoader(ds, args.batch_size, seed=args.seed)
    # held-out test epoch for best-checkpoint selection when the dataset
    # has a test split (the reference recipe, examples/train.py test_epoch)
    eval_loss = None
    if (Path(args.dataset) / "test").is_dir():
        test_ds = loader(args.dataset, "test", train=False,
                         patch_size=tuple(args.patch_size), **kwargs)
        test_dl = DataLoader(test_ds, args.batch_size, shuffle=False,
                             seed=0)
        eval_fn = make_eval_step(module, lmbda)

        def eval_loss():
            losses = [eval_fn(_rows(b, rank, world, device))["loss"]
                      for b in test_dl]
            if not losses:
                return None
            if world > 1:  # each rank's rows: the mean over the ranks
                losses = list(parallel.mean_over_ranks(
                    dict(enumerate(losses))).values())
            return float(np.mean([float(v) for v in losses]))

    optimizer, state, start_epoch, best_loss = _train_state(
        args, module, args.steps_per_epoch or max(1, len(dl)))
    step_fn = make_train_step(
        module, optimizer, lmbda, remat=args.remat,
        matmul_precision="bfloat16" if args.bf16 else None,
        data_parallel=world > 1)
    generator = torch.Generator(device=device).manual_seed(
        parallel.rank_seed(args.seed, rank))

    def run_step(batch):
        nonlocal state
        state, metrics = step_fn(state, _rows(batch, rank, world, device),
                                 generator)
        return metrics

    return _epochs(args, args.arch, state, dl, run_step, start_epoch,
                   best_loss, eval_loss, rank)


def train_master(args, rank: int = 0, world: int = 1, device=None):
    """The master against a frozen guide (lmic_tpu train_cli.py:264-374):
    the guide is the complementary modality (`guided`, first conv at
    stride 2) with the params of `--guided-checkpoint`. With `world` > 1
    as rank `rank` of a process group, on `device`."""
    from lmic_tpu_torch.datasets import DataLoader, ImageFolderRGB

    device = default_device(device or args.device)
    if args.remat:
        expandable_segments(device)
    lmbda = LAMBDA_TABLE[args.quality - 1]
    guided = zoo.create_model(
        "guided", args.quality, seed=args.seed,
        channel=1 if args.channel == 3 else 3, first_stride=2,
        device=device,
    ).module
    if args.guided_checkpoint:
        ckpt.load_train_params(args.guided_checkpoint, guided)
    elif rank == 0:
        print("WARNING: training master against a randomly initialized "
              "guide (pass --guided-checkpoint)", flush=True)
    guided.eval().requires_grad_(False)
    master = zoo.create_model("master", args.quality, seed=args.seed,
                              channel=args.channel, device=device).module

    ds = ImageFolderRGB(args.dataset, crop_size=tuple(args.crop_size),
                        channel=args.channel, seed=args.seed)
    dl = DataLoader(ds, args.batch_size, seed=args.seed)
    optimizer, state, start_epoch, best_loss = _train_state(
        args, master, args.steps_per_epoch or max(1, len(dl)))
    step_fn = make_master_train_step(master, guided, optimizer, lmbda,
                                     remat=args.remat,
                                     data_parallel=world > 1)
    generator = torch.Generator(device=device).manual_seed(
        parallel.rank_seed(args.seed, rank))

    def run_step(batch):
        nonlocal state
        x, guide = (_rows(b, rank, world, device) for b in batch)
        state, metrics = step_fn(state, x, guide, generator)
        return metrics

    return _epochs(args, "master", state, dl, run_step, start_epoch,
                   best_loss, rank=rank)


def _train(rank: int, world: int, device, args):
    """One rank's training (`parallel.launch`'s entry for each process),
    or the whole of it with `world` 1."""
    if args.arch == "master":
        train_master(args, rank, world, device)
    else:
        train_single(args, rank, world, device)


def main(argv=None):
    args = parse_args(argv if argv is not None else sys.argv[1:])
    if args.arch.endswith("_D"):
        raise SystemExit(
            f"{args.arch} is a paired dependent-modality model: its forward "
            "consumes the matching '_R' model's hidden maps per batch and "
            "has no standalone training recipe (the reference provides "
            "none either) — train the '_R' model instead"
        )
    if args.amp and args.arch not in AMP_ARCHS:
        raise SystemExit(
            f"--amp supports {sorted(AMP_ARCHS)}; {args.arch} trains in "
            "f32 only"
        )
    if args.bf16 and args.arch == "master":
        # lmic_tpu's make_master_train_step ignores the flag (ROADMAP.md
        # C, differences that are not faults)
        raise SystemExit(
            "--bf16 is not taken by the master recipe, which trains in f32 "
            "only (lmic_tpu's master step ignores the flag; ROADMAP.md C)")
    n_devices = args.devices
    if (n_devices is None and args.device is not None
            and torch.device(args.device).index is not None):
        n_devices = 1  # one device, named by --device
    mesh = parallel.make_mesh(n_devices, device=args.device)
    if args.batch_size % mesh.size:
        raise SystemExit(
            f"--batch-size {args.batch_size} does not split over "
            f"{mesh.size} devices (--devices): each device takes an equal "
            "block of rows")
    try:
        if mesh.size == 1:
            _train(0, 1, args.device, args)
        else:
            parallel.launch(_train, mesh, args)
    except Exception:
        # long training runs leave a postmortem trail beside the checkpoint
        # (reference examples/train.py:481-491)
        log = os.path.join(os.path.dirname(args.save_path) or ".",
                           "error.log")
        with open(log, "a") as f:
            f.write(traceback.format_exc() + "\n")
        raise
    return 0


if __name__ == "__main__":
    sys.exit(main())
