"""The port's eval CLIs reproduce lmic_tpu's RD goldens
(tests/expected/eval_*.json, rtol 1e-4 as tests/test_eval_golden.py holds
lmic_tpu to them) on lmic_tpu's default-key weights, carried into port
checkpoints:

- the 12 `eval_ee_*` and the 6 tier-1 `eval_rans_*` through
  `eval_model.main --checkpoint` on a deployment checkpoint of the
  converted weights and lmic_tpu's coding tables (the port's own tables
  may drift by an ulp, ROADMAP C, and move a byte count).

The images are the goldens' own (tests/test_eval_golden.py); the paired
and video goldens are in tests/test_torch_eval.py.
"""

import json

import pytest

from lmic_tpu_torch.utils import eval_model
from test_eval_golden import (
    ALL_ARCHS,
    EE_CASES,
    SWITCH_Q,
    _check_golden,
    _write_images,
)
from torch_port_helpers import (  # noqa: F401
    default_codecs,
    deployment_checkpoint,
    one_thread,
)


# one CPU thread for every case (torch_port_helpers.one_thread)
pytestmark = pytest.mark.usefixtures("one_thread")

RANS_CASES = ([(a, 1) for a in ALL_ARCHS[:4]]
              + [(a, SWITCH_Q[a]) for a in ALL_ARCHS[:2]])


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
    _, pc = default_codecs(arch, quality)
    d = tmp_path / "images"
    _write_images(d, ["a.png", "b.png"])
    results = _run_eval(tmp_path, [
        "--arch", arch, "-q", str(quality), "-d", str(d), "--checkpoint",
        deployment_checkpoint(tmp_path / "m.ckpt", pc),
    ])
    _check_golden(results, f"eval_rans_{arch}_{quality}.json")
