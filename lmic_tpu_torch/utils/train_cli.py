"""Training CLI: the examples/train.py recipe for the port's image codecs.

Counterpart of lmic_tpu/utils/train_cli.py (`parse_args`, `train_single`,
`main`): single-model training of bmshj2018-factorized,
bmshj2018-hyperprior and mbt2018-mean with the RD loss
`lambda[q] * MSE + bpp`, dual Adam optimizers, StepLR(40 epochs, 0.5),
best-checkpoint selection on a test split when the dataset has one, and
resume from a checkpoint. `--amp` runs the transforms in bf16 (params and
likelihoods stay f32). On one device: CUDA unless `--device cpu`.

Usage:
  python -m lmic_tpu_torch.utils.train_cli --arch mbt2018-mean -q 7 \\
      -d /path/dataset --epochs 100 --batch-size 16

Not ported yet (each raises, see ROADMAP.md): the autoregressive archs
mbt2018 and cheng2020-* (queue A, item 10c), master training and the `_D`
archs (queue A, item 12), `--bf16`, `--remat` and `--devices` (queue A,
item 8), single-channel datasets (`--channel 1`, item 12).
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

from lmic_tpu_torch import default_device, zoo
from lmic_tpu_torch.utils import checkpoint as ckpt
from lmic_tpu_torch.utils.train import (
    LAMBDA_TABLE,
    create_train_state,
    make_eval_step,
    make_optimizer,
    make_train_step,
    step_lr,
)

# the archs of lmic_tpu's AMP_ARCHS that the port has
AMP_ARCHS = {"bmshj2018-factorized", "bmshj2018-hyperprior", "mbt2018-mean"}
# the port serves these but does not train them yet
AR_ARCHS = {"mbt2018", "cheng2020-anchor", "cheng2020-attn"}

# flags of lmic_tpu's CLI that the port does not take yet
_NOT_PORTED = {
    "bf16": "--bf16 (bf16 matmul precision) is not ported: use --amp; "
            "ROADMAP.md queue A, item 8",
    "remat": "--remat (rematerialized forward) is not ported; ROADMAP.md "
             "queue A, item 8",
    "devices": "--devices (data parallel over local devices) is not "
               "ported; ROADMAP.md queue A, item 8",
}


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
    p.add_argument("--seed", type=int, default=1926)
    p.add_argument("--clip-max-norm", type=float, default=1.0)
    p.add_argument("--checkpoint", default=None, help="resume path")
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
    p.add_argument("--bf16", action="store_true", help="not ported")
    p.add_argument("--remat", action="store_true", help="not ported")
    p.add_argument("--devices", type=int, default=None, help="not ported")
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


def train_single(args):
    from lmic_tpu_torch.datasets import DataLoader, ImageFolder

    device = default_device(args.device)
    lmbda = LAMBDA_TABLE[args.quality - 1]
    dtype = None
    if args.amp:
        if args.arch not in AMP_ARCHS:
            raise SystemExit(
                f"--amp supports {sorted(AMP_ARCHS)}; {args.arch} does not "
                "plumb an activation dtype through its transforms yet"
            )
        dtype = torch.bfloat16
    if args.arch in AR_ARCHS:
        raise SystemExit(
            f"{args.arch}: training the autoregressive codecs is not "
            "ported; ROADMAP.md queue A, item 10c"
        )
    codec = zoo.create_model(args.arch, args.quality, seed=args.seed,
                             channel=args.channel, device=device,
                             dtype=dtype)
    module = codec.module

    ds = ImageFolder(args.dataset, "train",
                     patch_size=tuple(args.patch_size), seed=args.seed)
    dl = DataLoader(ds, args.batch_size, seed=args.seed)
    # held-out test epoch for best-checkpoint selection when the dataset
    # has a test split (the reference recipe, examples/train.py test_epoch)
    test_dl = None
    if (Path(args.dataset) / "test").is_dir():
        test_ds = ImageFolder(args.dataset, "test", train=False,
                              patch_size=tuple(args.patch_size))
        test_dl = DataLoader(test_ds, args.batch_size, shuffle=False,
                             seed=0)

    steps_per_epoch = args.steps_per_epoch or max(1, len(dl))
    # StepLR(40 epochs, 0.5) on the main optimizer (reference train.py:395)
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

    step_fn = make_train_step(module, optimizer, lmbda)
    eval_fn = make_eval_step(module, lmbda) if test_dl else None
    generator = torch.Generator(device=device).manual_seed(args.seed)

    for epoch in range(start_epoch, args.epochs):
        t0 = time.time()
        running = []
        for i, batch in enumerate(_batches(dl, args.prefetch)):
            if args.steps_per_epoch and i >= args.steps_per_epoch:
                break
            state, metrics = step_fn(state, _to_device(batch, device),
                                     generator)
            if i % args.log_every == 0:
                m = {k: float(v) for k, v in metrics.items()}
                running.append(m["loss"])
                print(
                    f"epoch {epoch} it {i}: loss={m['loss']:.4f} "
                    f"mse={m['mse_loss']:.6f} "
                    f"bpp={m['bpp_loss']:.4f} "
                    f"aux={m['aux_loss']:.1f}",
                    flush=True,
                )
        if test_dl is not None:
            test_losses = [float(eval_fn(_to_device(b, device))["loss"])
                           for b in test_dl]
            if test_losses:
                epoch_loss = float(np.mean(test_losses))
                print(f"epoch {epoch} test loss={epoch_loss:.4f}",
                      flush=True)
            else:  # test split smaller than one batch: fall back
                epoch_loss = (float(np.mean(running)) if running
                              else float("inf"))
        else:
            epoch_loss = float(np.mean(running)) if running else float("inf")
        is_best = epoch_loss < best_loss
        best_loss = min(epoch_loss, best_loss)
        ckpt.save_checkpoint(
            args.save_path, state,
            {"epoch": epoch, "best_loss": best_loss, "arch": args.arch,
             "quality": args.quality},
            is_best=is_best,
        )
        print(f"epoch {epoch} done in {time.time()-t0:.1f}s "
              f"loss={epoch_loss:.4f}{' (best)' if is_best else ''}",
              flush=True)
    return state


def main(argv=None):
    args = parse_args(argv if argv is not None else sys.argv[1:])
    if args.arch == "master" or args.arch.endswith("_D"):
        raise SystemExit(
            f"{args.arch}: the RGB-T recipes (master training, the paired "
            "'_D' models) are not ported; ROADMAP.md queue A, item 12"
        )
    for flag, why in _NOT_PORTED.items():
        if getattr(args, flag):
            raise NotImplementedError(why)
    if args.channel != 3:
        raise NotImplementedError(
            "single-channel (thermal) datasets are not ported; ROADMAP.md "
            "queue A, item 12"
        )
    try:
        train_single(args)
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
