"""Finalize a training checkpoint for deployment.

Counterpart of lmic_tpu/utils/update_model_cli.py, its plain path: load
the params of a training checkpoint (utils/checkpoint.py), bake the
integer coding tables (`codec.update(force=True)`, evaluated on the CPU
whatever the device) and write `<arch>-q<q>-<sha256[:8]>.ckpt`.

Usage:
  python -m lmic_tpu_torch.utils.update_model_cli train.ckpt \\
      -a mbt2018-mean -q 7 -d out/

`-a ssf2020` builds the video codec (`zoo.create_video_model`) and stores
its three sub-codecs' tables. `--aot-shape BxHxW[xC]` (`BxTxHxW[xC]` for
ssf2020) also exports the finalized codec's serving bundle
(utils/aot.py) to `<dir>/<name>-aot`, on `--device`, and prints its path.

Not ported yet (each raises, see ROADMAP.md queue A, item 8):
`--from-torch`, `--raw-params`, `--no-update` (bare params, which only
`--raw-params` reads back).
"""

from __future__ import annotations

import argparse
import sys

from lmic_tpu_torch import zoo
from lmic_tpu_torch.utils import checkpoint as ckpt


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
    for flag in ("--raw-params", "--from-torch", "--no-update"):
        p.add_argument(flag, action="store_true", help="not ported")
    p.add_argument("--aot-shape", default=None,
                   help="also export a serving bundle for this input "
                        "shape: BxHxW[xC], or BxTxHxW[xC] for ssf2020")
    return p.parse_args(argv)


def run(argv=None):
    args = parse_args(argv if argv is not None else sys.argv[1:])
    for flag in ("raw_params", "from_torch", "no_update"):
        if getattr(args, flag):
            raise NotImplementedError(
                f"--{flag.replace('_', '-')} is not ported; ROADMAP.md "
                "queue A, item 8"
            )
    if args.arch in zoo.video_architectures:
        codec = zoo.create_video_model(args.arch, args.quality,
                                       device=args.device)
    else:
        codec = zoo.create_model(args.arch, args.quality,
                                 channel=args.channel, device=args.device)
    # params only: works whatever optimizer settings the run used
    ckpt.load_train_params(args.checkpoint, codec.module)
    name = args.name or f"{args.arch}-q{args.quality}"
    out = ckpt.update_model_file(args.out_dir, codec, name)
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
        print(export_serving_bundle(codec, f"{args.out_dir}/{name}-aot",
                                    shape))
    print(out)
    return out


def main(argv=None):
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
