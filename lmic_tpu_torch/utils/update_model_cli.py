"""Finalize a training checkpoint for deployment.

Counterpart of lmic_tpu/utils/update_model_cli.py: load the params of a
training checkpoint (utils/checkpoint.py), bake the integer coding tables
(`codec.update(force=True)`, evaluated on the CPU whatever the device) and
write `<arch>-q<q>-<sha256[:8]>.ckpt`. The other inputs and outputs
(lmic_tpu/utils/update_model_cli.py:64-100):

- `--from-torch`: the checkpoint is a CompressAI-format .pth(.tar), the
  reference's published weights or its deployment files
  (zoo/pretrained.py); its baked tables are adopted when it has them
  (the reference's and lmic_tpu's bytes), else baked here;
- `--no-update`: write the bare params, `<dir>/<name>.ckpt`, no tables;
- `--raw-params`: the checkpoint is such bare params.

Usage:
  python -m lmic_tpu_torch.utils.update_model_cli train.ckpt \\
      -a mbt2018-mean -q 7 -d out/
  python -m lmic_tpu_torch.utils.update_model_cli \\
      mbt2018-mean-8-8089ae3e.pth.tar --from-torch -a mbt2018-mean -q 8

`-a ssf2020` builds the video codec (`zoo.create_video_model`) and stores
its three sub-codecs' tables. `--aot-shape BxHxW[xC]` (`BxTxHxW[xC]` for
ssf2020) also exports the finalized codec's serving bundle
(utils/aot.py) to `<dir>/<name>-aot`, on `--device`, and prints its path.
"""

from __future__ import annotations

import argparse
import os
import sys

from lmic_tpu_torch import zoo
from lmic_tpu_torch.utils import checkpoint as ckpt
from lmic_tpu_torch.zoo import pretrained


def parse_args(argv):
    p = argparse.ArgumentParser(description="lmic_tpu_torch update_model")
    p.add_argument("checkpoint", help="training checkpoint (.ckpt)")
    p.add_argument("-a", "--arch", default="bmshj2018-factorized")
    p.add_argument("-q", "--quality", type=int, default=1)
    p.add_argument("--channel", type=int, default=3)
    p.add_argument("-d", "--dir", dest="out_dir", default=".",
                   help="output directory")
    p.add_argument("-n", "--name", default=None,
                   help="output stem (default: <arch>-q<quality>)")
    p.add_argument("--device", default=None,
                   help="torch device (default: CUDA; raises without a GPU "
                        "unless 'cpu' is given)")
    p.add_argument("--no-update", action="store_true",
                   help="write the bare params, without coding tables")
    p.add_argument("--raw-params", action="store_true",
                   help="the checkpoint holds bare params (--no-update's "
                        "output), not a training state")
    p.add_argument("--from-torch", action="store_true",
                   help="the checkpoint is a CompressAI-format .pth(.tar): "
                        "adopt its baked tables, or bake them")
    p.add_argument("--aot-shape", default=None,
                   help="also export a serving bundle for this input "
                        "shape: BxHxW[xC], or BxTxHxW[xC] for ssf2020")
    return p.parse_args(argv)


def run(argv=None):
    args = parse_args(argv if argv is not None else sys.argv[1:])
    if args.arch in zoo.video_architectures:
        codec = zoo.create_video_model(args.arch, args.quality,
                                       device=args.device)
    else:
        codec = zoo.create_model(args.arch, args.quality,
                                 channel=args.channel, device=args.device)
    baked = False
    if args.from_torch:
        sd = pretrained.load_torch_state_dict(args.checkpoint)
        codec.module.load_state_dict(pretrained.import_reference_state_dict(
            args.arch, sd, codec.module))
        baked = pretrained.adopt_coding_state(args.arch, sd, codec)
    elif args.raw_params:
        ckpt.load_params(args.checkpoint, codec.module)
    else:
        # params only: works whatever optimizer settings the run used
        ckpt.load_train_params(args.checkpoint, codec.module)
    name = args.name or f"{args.arch}-q{args.quality}"
    if args.no_update:
        os.makedirs(args.out_dir, exist_ok=True)
        out = os.path.join(args.out_dir, f"{name}.ckpt")
        ckpt.save_params(out, codec.module)
    else:
        out = ckpt.update_model_file(args.out_dir, codec, name,
                                     update=not baked)
    if args.aot_shape:
        from lmic_tpu_torch.utils.aot import export_serving_bundle

        shape = tuple(int(d) for d in args.aot_shape.lower().split("x"))
        want = 5 if args.arch in zoo.video_architectures else 4
        if len(shape) == want - 1:
            shape = (*shape, 3)
        if len(shape) != want:
            raise SystemExit(
                "--aot-shape must be BxTxHxW[xC] for ssf2020, "
                "BxHxW[xC] otherwise"
            )
        codec.update()  # a no-op unless --no-update left no tables
        print(export_serving_bundle(codec, f"{args.out_dir}/{name}-aot",
                                    shape))
    print(out)
    return out


def main(argv=None):
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
