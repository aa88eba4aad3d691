"""The RGB-T pairs' eval against lmic_tpu's: `eval_rgbt_pair` (the
guided/master pair, beta/gamma's side bits) on carried weights and
tables, and `eval_rd_pair` (the `_R`/`_D` archs) on lmic_tpu's default-key
weights, with the paired golden (tests/expected/eval_rgbt_mbt2018_D_1.json,
rtol 1e-4) through `eval_model.main --rgbt` from two checkpoints."""

import json
import warnings

import numpy as np
import pytest
import torch

from lmic_tpu.utils import eval_model as jeval
from lmic_tpu_torch.utils import eval_model
from test_eval_golden import _check_golden, _write_images
from torch_port_helpers import (  # noqa: F401
    default_codecs,
    deployment_checkpoint,
    match_eval,
    one_thread,
    rgbt_pair,
)

torch.set_num_threads(2)


@pytest.mark.parametrize("entropy_estimation", [False, True])
def test_eval_rgbt_pair_matches_lmic_tpu(entropy_estimation):
    """The guided/master pair (channel-1 master 64x64, RGB guide 128x128):
    the master's strings plus 64*2*4*8 bits of beta/gamma."""
    (jg, pg, _), (jm, pm, _) = rgbt_pair(1)
    rng = np.random.default_rng(4)
    x = rng.random((1, 64, 64, 1), dtype=np.float32)
    guided = rng.random((1, 128, 128, 3), dtype=np.float32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = eval_model.eval_rgbt_pair(pg, pm, x, guided,
                                        entropy_estimation)
        want = jeval.eval_rgbt_pair(jg, jm, x, guided, entropy_estimation)
    match_eval(got, want, exact_bpp=not entropy_estimation,
           timings=not entropy_estimation)
    if not entropy_estimation:
        out = pm.compress(x, pg.compress(guided, hidden=False,
                                         reconstruct=True)["x_hat"])
        bits = sum(len(s) for g in out["strings"] for s in g) * 8
        assert got["bpp"] == (bits + eval_model.RGBT_SIDE_BITS) / 64 / 64


def _rd_pair():
    """mbt2018_R (the RGB guide) and mbt2018_D (thermal) on lmic_tpu's
    default key, as its paired eval builds them (ESA needs 128 px)."""
    return (default_codecs("mbt2018_R", 1, 3, (128, 128)),
            default_codecs("mbt2018_D", 1, 1, (128, 128)))


@pytest.mark.usefixtures("one_thread")
def test_eval_rd_pair_golden(tmp_path):
    """The `_R`/`_D` paired eval (entropy estimation) through `main
    --rgbt`, from the pair's two deployment checkpoints."""
    (_, pg), (_, pm) = _rd_pair()
    master_dir = tmp_path / "val" / "thermal_8_bit"
    _write_images(master_dir, ["FLIR_08865.png"], size=(256, 320), mode="L")
    _write_images(tmp_path / "val" / "RGB", ["FLIR_08865.png"],
                  size=(256, 320))
    out = tmp_path / "r.json"
    eval_model.main([
        "--arch", "mbt2018_D", "-q", "1", "--channel", "1",
        "-d", str(master_dir), "--rgbt", "--entropy-estimation",
        "--crop-size", "128", "128", "--device", "cpu", "--output", str(out),
        "--checkpoint", deployment_checkpoint(tmp_path / "d.ckpt", pm),
        "--guided-checkpoint", deployment_checkpoint(tmp_path / "r.ckpt",
                                                     pg),
    ])
    with open(out) as f:
        _check_golden(json.load(f)[-1]["results"],
                      "eval_rgbt_mbt2018_D_1.json")


@pytest.mark.parametrize("entropy_estimation", [False, True])
def test_eval_rd_pair_matches_lmic_tpu(entropy_estimation):
    (jg, pg), (jm, pm) = _rd_pair()
    rng = np.random.default_rng(3)
    x = rng.random((1, 128, 128, 1), dtype=np.float32)
    guided = rng.random((1, 128, 128, 3), dtype=np.float32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = eval_model.eval_rd_pair(pg, pm, x, guided, entropy_estimation)
        want = jeval.eval_rd_pair(jg, jm, x, guided, entropy_estimation)
    match_eval(got, want, exact_bpp=not entropy_estimation,
           timings=not entropy_estimation)
