"""CompressAI-format checkpoints of the RGB-T archs in the port against
lmic_tpu on the CPU (the image archs and ssf2020 are in
tests/test_torch_pretrained.py): the guide and the master of the paper's
pair (channel-1 role, N = 32, M = 48) and the paired `_R`/`_D` archs
(N = M = 32), each written by `crosscheck.write_reference_checkpoint` with
lmic_tpu's baked tables, finalized by both packages' `update_model_cli
--from-torch`, and coded to the same bytes with tables equal to the
file's buffers bit for bit.

The reference's `_R` classes carry the modules they inherit; lmic_tpu's
cheng2020-attn_R importer reads the inherited `enc1`/`dec1` before it
replaces them (lmic_tpu/zoo/pretrained.py:837-840), so that file carries
mbt2018_R's, which the port drops."""

import numpy as np
import pytest
import torch
from test_torch_pretrained import _assert_tables_are_the_files
from test_torch_rgbt_joint import _codecs as paired_codecs
from test_torch_rgbt_joint import _guide, _port_maps
from torch_port_helpers import (
    RGBT_GEOMETRY,
    RGBT_M,
    RGBT_N,
    pixels,
    rgbt_pair,
)

from lmic_tpu import zoo as jzoo
from lmic_tpu.utils import checkpoint as jckpt
from lmic_tpu.utils import update_model_cli as jcli
from lmic_tpu_torch import zoo as tzoo
from lmic_tpu_torch.utils import checkpoint as ckpt
from lmic_tpu_torch.utils import update_model_cli
from lmic_tpu_torch.utils.crosscheck import write_reference_checkpoint
from lmic_tpu_torch.zoo.convert import state_dict_from_jax

torch.set_num_threads(2)

ROLE = 1  # a thermal master with a 2x RGB guide
PAIRED = ("mbt2018_R", "mbt2018_D", "cheng2020-anchor_R",
          "cheng2020-anchor_D", "cheng2020-attn_R", "cheng2020-attn_D")


def _widths(arch):
    if arch in ("guided", "master"):
        return (RGBT_N, RGBT_M)
    return (32, 32) if arch.startswith("mbt2018") else (32,)


def _channel(arch):
    if arch in ("guided", "master"):
        return 4 - ROLE if arch == "guided" else ROLE
    return 1 if arch.endswith("_D") else 3


def _case(arch):
    """(lmic_tpu's codec, the port's with lmic_tpu's tables, the modules
    the reference's file carries beside the port's keys)."""
    if arch in ("guided", "master"):
        jc, pc, _ = rgbt_pair(ROLE)[arch == "master"]
        return jc, pc, {}
    jc, pc, _ = paired_codecs(arch)
    extra = {}
    if arch == "cheng2020-attn_R":
        extra = {k: v for k, v in state_dict_from_jax(
            "mbt2018_R", paired_codecs("mbt2018_R")[2]).items()
            if k.startswith(("enc1.", "dec1."))}
    return jc, pc, extra


def _codes(arch, jf, tf):
    """(the port's strings, lmic_tpu's) of the finalized codecs."""
    if arch == "master":
        (mH, mW), (gH, gW) = RGBT_GEOMETRY[ROLE]
        jg = rgbt_pair(ROLE)[0][0]
        g = jg.compress(pixels((1, gH, gW, 4 - ROLE), seed=1),
                        hidden=False)
        g_hat = np.asarray(jg.decompress(g["strings"], g["shape"])["x_hat"])
        xm = pixels((1, mH, mW, ROLE), seed=2)
        return (tf.compress(xm, g_hat)["strings"],
                jf.compress(xm, g_hat)["strings"])
    if arch.endswith("_D"):
        family = arch[:-2]
        enc, _ = _guide(family)
        ga = {k: np.asarray(v) for k, v in enc["hidden"].items()}
        x = pixels((1, 128, 128, 1), seed=3).astype(np.float32) / 255
        return (tf.compress(x, _port_maps(ga))["strings"],
                jf.compress(x, ga)["strings"])
    size = (64, 64) if arch == "guided" else (128, 128)
    x = pixels((1, *size, 3), seed=2)
    return tf.compress(x)["strings"], jf.compress(x)["strings"]


@pytest.mark.parametrize("arch", ("guided", "master") + PAIRED)
def test_from_torch_codes_lmic_tpus_bytes(arch, tmp_path, monkeypatch):
    jc, pc, extra = _case(arch)
    path = tmp_path / f"{arch}.pth.tar"
    sd = write_reference_checkpoint(str(path), pc, extra=extra)
    assert all(k in torch.load(path, weights_only=True)
               for k in ("module." + k for k in extra))
    monkeypatch.setitem(jzoo.cfgs, arch, {1: _widths(arch)})
    monkeypatch.setitem(tzoo.cfgs, arch, {1: _widths(arch)})
    args = [str(path), "-a", arch, "-q", "1", "--channel",
            str(_channel(arch)), "--from-torch"]
    jout = jcli.run(args + ["-d", str(tmp_path / "jax")])
    tout = update_model_cli.run(args + ["-d", str(tmp_path / "port"),
                                        "--device", "cpu"])
    jf = jckpt.load_updated_model(jout, jc)
    tf = ckpt.load_updated_model(tout, tzoo.create_model(
        arch, 1, channel=_channel(arch), device="cpu", seed=3))
    _assert_tables_are_the_files(tf, sd)
    _assert_tables_are_the_files(jf, sd)
    assert set(tf.module.state_dict()) == set(pc.module.state_dict())
    for k, v in tf.module.state_dict().items():
        assert torch.equal(v, sd[k]), k
    got, want = _codes(arch, jf, tf)
    assert got == want
