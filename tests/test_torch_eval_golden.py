"""The port's eval CLIs reproduce lmic_tpu's RD goldens
(tests/expected/eval_*.json, rtol 1e-4 as tests/test_eval_golden.py holds
lmic_tpu to them) on lmic_tpu's default-key weights, carried into port
checkpoints:

- the 12 `eval_ee_*` and the 6 tier-1 `eval_rans_*` through
  `eval_model.main --checkpoint` on a deployment checkpoint of the
  converted weights and lmic_tpu's coding tables (the port's own tables
  may drift by an ulp, ROADMAP C, and move a byte count);
- `slow`, out of tier-1 as lmic_tpu's are: the 6 other `eval_rans_*`
  (cheng2020 at q1, the mean and AR families at their width-switch
  qualities) and the guided/master pair's `eval_rgbt_master_*` and
  `eval_rans_rgbt_master_*` through `main --rgbt` with both codecs'
  checkpoints (`python -m pytest -m slow tests/test_torch_eval_golden.py`),
  held as `_check_golden` holds lmic_tpu, with lmic_tpu's own f32 MS-SSIM
  error (`MS_SSIM_F32`) allowed beside the 1e-4 on ms-ssim: at
  cheng2020-attn q4 the random weights' ms-ssim is 0.0165, and the port's
  f64 value lands 1.7e-6 (1.05e-4 relative) from the golden, about half
  of it the golden's f32 sums and half x_hat's f32 conv sums (ROADMAP C).

The images are the goldens' own (tests/test_eval_golden.py); the paired
and video goldens are in tests/test_torch_eval.py.
"""

import json

import numpy as np
import pytest

from lmic_tpu_torch.utils import eval_model
from test_eval_golden import (
    ALL_ARCHS,
    EE_CASES,
    EXPECTED_DIR,
    NON_DETERMINISTIC,
    RGBT_VIDEO_QS,
    SWITCH_Q,
    _check_golden,
    _write_images,
)
from torch_port_helpers import (  # noqa: F401
    MS_SSIM_F32,
    default_codecs,
    deployment_checkpoint,
    one_thread,
)


# one CPU thread for every case (torch_port_helpers.one_thread)
pytestmark = pytest.mark.usefixtures("one_thread")

RANS_CASES = ([(a, 1) for a in ALL_ARCHS[:4]]
              + [(a, SWITCH_Q[a]) for a in ALL_ARCHS[:2]])
SLOW_RANS_CASES = ([(a, 1) for a in ALL_ARCHS[4:]]
                   + [(a, SWITCH_Q[a]) for a in ALL_ARCHS[2:]])


def _run_eval(tmp_path, argv):
    out = tmp_path / "results.json"
    eval_model.main(argv + ["--output", str(out), "--device", "cpu"])
    with open(out) as f:
        return json.load(f)[-1]["results"]


@pytest.mark.parametrize("arch,quality", EE_CASES)
def test_eval_entropy_estimation_golden(tmp_path, arch, quality):
    _, pc = default_codecs(arch, quality)
    d = tmp_path / "images"
    _write_images(d, ["a.png", "b.png"])
    results = _run_eval(tmp_path, [
        "--arch", arch, "-q", str(quality), "-d", str(d),
        "--entropy-estimation", "--checkpoint",
        deployment_checkpoint(tmp_path / "m.ckpt", pc),
    ])
    _check_golden(results, f"eval_ee_{arch}_{quality}.json")


@pytest.mark.parametrize("arch,quality", RANS_CASES)
def test_eval_codec_golden(tmp_path, arch, quality):
    """The real coder: image -> pad -> compress -> rANS -> decompress ->
    metrics, the byte counts included (mbt2018: the wavefront loops)."""
    _check_codec_golden(tmp_path, arch, quality)


@pytest.mark.slow
@pytest.mark.parametrize("arch,quality", SLOW_RANS_CASES)
def test_eval_codec_golden_slow(tmp_path, arch, quality):
    """cheng2020 at q1 and the mean and AR families at their width-switch
    qualities (wide transforms and wavefront loops)."""
    _check_codec_golden(tmp_path, arch, quality, _check_golden_f64)


def _check_codec_golden(tmp_path, arch, quality, check=_check_golden):
    _, pc = default_codecs(arch, quality)
    d = tmp_path / "images"
    _write_images(d, ["a.png", "b.png"])
    results = _run_eval(tmp_path, [
        "--arch", arch, "-q", str(quality), "-d", str(d), "--checkpoint",
        deployment_checkpoint(tmp_path / "m.ckpt", pc),
    ])
    check(results, f"eval_rans_{arch}_{quality}.json")


def _check_golden_f64(results, golden_name):
    """`_check_golden` (rtol 1e-4 on every key), ms-ssim also within
    lmic_tpu's own f32 error of the golden (see the module doc)."""
    with open(EXPECTED_DIR / golden_name) as f:
        want = json.load(f)
    got = {k: v for k, v in results.items() if k not in NON_DETERMINISTIC}
    assert set(got) == set(want), (sorted(got), sorted(want))
    for k in want:
        np.testing.assert_allclose(
            got[k], want[k], rtol=1e-4,
            atol=MS_SSIM_F32 if k == "ms-ssim" else 0,
            err_msg=f"{golden_name}: {k}")


def _check_rgbt_golden(tmp_path, quality, flags, golden):
    """`main --rgbt` on the channel-1 pair, each codec from a deployment
    checkpoint of lmic_tpu's default-key weights and tables (its eval
    inits the guide at 64x64 and the master at 128x128)."""
    _, guided = default_codecs("guided", quality, channel=3)
    _, master = default_codecs("master", quality, channel=1,
                               input_size=(128, 128))
    master_dir = tmp_path / "val" / "thermal_8_bit"
    _write_images(master_dir, ["FLIR_08865.png"], size=(512, 640), mode="L")
    _write_images(tmp_path / "val" / "RGB", ["FLIR_08865.png"],
                  size=(512, 640))
    results = _run_eval(tmp_path, [
        "--arch", "master", "-q", str(quality), "--channel", "1",
        "-d", str(master_dir), "--rgbt", "--crop-size", "64", "64",
        "--checkpoint", deployment_checkpoint(tmp_path / "m.ckpt", master),
        "--guided-checkpoint", deployment_checkpoint(tmp_path / "g.ckpt",
                                                     guided),
        *flags,
    ])
    _check_golden_f64(results, golden)


@pytest.mark.slow
@pytest.mark.parametrize("quality", RGBT_VIDEO_QS)
def test_eval_rgbt_golden(tmp_path, quality):
    """The paired guided + master estimate, the beta/gamma side
    information's bits included."""
    _check_rgbt_golden(tmp_path, quality, ["--entropy-estimation"],
                       f"eval_rgbt_master_{quality}.json")


@pytest.mark.slow
@pytest.mark.parametrize("quality", RGBT_VIDEO_QS)
def test_eval_rgbt_codec_golden(tmp_path, quality):
    """The same pair through the real coder (the guide's wavefront loops,
    the master's streams)."""
    _check_rgbt_golden(tmp_path, quality, [],
                       f"eval_rans_rgbt_master_{quality}.json")
