"""The port reads lmic_tpu's flax-msgpack checkpoints without flax or JAX
(`utils/checkpoint.py`): lmic_tpu writes its training checkpoint, its
bare params and its deployment file for bmshj2018-factorized and
mbt2018-mean at N = 16, M = 24, and the port loads

- the same `state_dict` as `state_dict_from_jax` on the live params, bit
  for bit;
- the deployment file's tables bit for bit, and codes an image to
  lmic_tpu's strings byte for byte;

through the readers every `--checkpoint` path calls, with no new flag.
A pickle that names anything but numpy's arrays and builtin types is
refused. flax's extension types (bf16 arrays, complex, numpy scalars)
and chunked arrays decode as flax decodes them."""

import os
import pathlib
import pickle
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from lmic_tpu.utils import checkpoint as jckpt
from lmic_tpu.utils.train import create_train_state, make_optimizer, step_lr
from lmic_tpu_torch import zoo as tzoo
from lmic_tpu_torch.utils import checkpoint as tckpt
from lmic_tpu_torch.utils import update_model_cli
from lmic_tpu_torch.zoo.convert import state_dict_from_jax
from torch_port_helpers import M, N, jax_codec, jax_params, pixels

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCHS = ("bmshj2018-factorized", "mbt2018-mean")


def _fresh(arch):
    """A port codec at the test widths whose weights are not the file's."""
    return tzoo.create_model(arch, 1, seed=3, device="cpu", N=N, M=M)


def _assert_state(module, arch, params):
    got, want = module.state_dict(), state_dict_from_jax(arch, params)
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


@pytest.fixture(scope="module", params=ARCHS)
def files(request, tmp_path_factory):
    """lmic_tpu's three files of one arch, and what went into them."""
    arch = request.param
    d = tmp_path_factory.mktemp(arch)
    params = jax_params(arch)
    jc = jax_codec(arch, params)
    # a scheduled, clipped optimizer, as lmic-train saves it
    state = create_train_state(params, make_optimizer(step_lr(1e-4, 10),
                                                      1e-3, 1.0))
    extra = {"epoch": 3, "loss": np.float32(1.25), "best": 0.5}
    jckpt.save_checkpoint(str(d / "train.ckpt"), state, extra)
    jckpt.save_params(str(d / "params.ckpt"), params)
    deploy = jckpt.update_model_file("", str(d), jc, arch, update=False)
    return arch, params, jc, extra, d, deploy


def test_training_checkpoint(files):
    arch, params, _, extra, d, _ = files
    module, got_extra = tckpt.load_train_params(str(d / "train.ckpt"),
                                                _fresh(arch).module)
    _assert_state(module, arch, params)
    assert got_extra == extra


def test_bare_params(files):
    arch, params, _, _, d, _ = files
    module = tckpt.load_params(str(d / "params.ckpt"), _fresh(arch).module)
    _assert_state(module, arch, params)


def test_deployment_file_tables_and_strings(files):
    arch, params, jc, _, _, deploy = files
    pc = tckpt.load_updated_model(deploy, _fresh(arch))
    _assert_state(pc.module, arch, params)
    for name, last in (("eb_state", "medians"), ("gc_state", "scale_table")):
        want, got = getattr(jc, name), getattr(pc, name)
        assert (want is None) == (got is None), name
        if want is None:
            continue
        for k in ("cdf", "cdf_length", "offset"):
            a, b = getattr(got.table, k), np.asarray(getattr(want.table, k))
            assert a.dtype == b.dtype and np.array_equal(a, b), (name, k)
        a, b = getattr(got, last), np.asarray(getattr(want, last))
        assert np.array_equal(a.reshape(b.shape), b), (name, last)
    x = pixels((1, 64, 64, 3), seed=4).astype(np.float32) / 255.0
    want = jc.compress(x)
    got = pc.compress(x)
    assert [list(s) for s in got["strings"]] == [list(s) for s in
                                                 want["strings"]]
    assert tuple(got["shape"]) == tuple(want["shape"])


def test_update_model_cli_takes_lmic_tpu_files(files, tmp_path,
                                               monkeypatch):
    """`update_model_cli` on lmic_tpu's training checkpoint and, with
    `--raw-params`, on its bare params: no new flag."""
    arch, params, _, _, d, _ = files
    monkeypatch.setitem(tzoo.cfgs, arch, {1: (N, M)})
    for name, flags in (("train.ckpt", []), ("params.ckpt",
                                             ["--raw-params"])):
        out = update_model_cli.run([str(d / name), "-a", arch, "-q", "1",
                                    "-d", str(tmp_path / name),
                                    "--device", "cpu", *flags])
        pc = tckpt.load_updated_model(out, _fresh(arch))
        _assert_state(pc.module, arch, params)


class _Evil:
    def __reduce__(self):
        return (os.system, ("true",))


@pytest.mark.parametrize("payload", [
    {"params": b"", "eb_state": _Evil()},
    {"state": b"", "extra": {"when": __import__("datetime").date.today()}},
], ids=["os.system", "datetime"])
def test_foreign_globals_are_refused(tmp_path, payload):
    path = tmp_path / "bad.ckpt"
    path.write_bytes(pickle.dumps(payload))
    module = _fresh("bmshj2018-factorized").module
    with pytest.raises(pickle.UnpicklingError, match="not allowed"):
        tckpt.load_train_params(str(path), module)
    with pytest.raises(pickle.UnpicklingError, match="not allowed"):
        tckpt.load_updated_model(str(path), _fresh("bmshj2018-factorized"))


def test_other_files_are_refused(tmp_path):
    path = tmp_path / "text.ckpt"
    path.write_text("not a checkpoint")
    with pytest.raises(ValueError, match="neither"):
        tckpt.load_params(str(path), _fresh("bmshj2018-factorized").module)


def test_msgpack_ext_types_and_chunks(monkeypatch):
    tree = {
        "f32": np.arange(12, dtype=np.float32).reshape(3, 4),
        "i8": np.array([-1, 2], np.int8),
        "bf16": jnp.asarray([1.5, -2.25, 3.0], jnp.bfloat16),
        "scalar": np.float32(2.5),
        "complex": complex(1.0, -2.0),
        "nested": {"big": np.arange(40, dtype=np.float64).reshape(5, 8)},
    }
    # arrays of 2^30 bytes or more are chunked; shrink the limit
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    data = serialization.msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" in data
    got = tckpt._msgpack_restore(data)
    want = serialization.msgpack_restore(data)
    np.testing.assert_array_equal(got["f32"], want["f32"])
    assert got["i8"].dtype == np.int8
    np.testing.assert_array_equal(got["nested"]["big"], tree["nested"]["big"])
    assert got["bf16"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["bf16"].float().numpy(),
                                  np.asarray(want["bf16"], np.float32))
    assert got["scalar"] == want["scalar"] and isinstance(got["scalar"],
                                                          np.float32)
    assert got["complex"] == complex(1.0, -2.0)


def test_readers_need_no_jax_or_flax(files, tmp_path):
    """In a process where jax and flax cannot be imported, the port reads
    the three files to the same state and tables."""
    arch, params, _, _, d, deploy = files
    want = tmp_path / "want.pt"
    torch.save(state_dict_from_jax(arch, params), want)
    code = f"""
import sys
for name in ("jax", "jaxlib", "flax", "optax", "lmic_tpu"):
    sys.modules[name] = None
import torch
from lmic_tpu_torch import zoo
from lmic_tpu_torch.utils import checkpoint as c
want = torch.load({str(want)!r})
def fresh():
    return zoo.create_model({arch!r}, 1, seed=3, device="cpu", N={N}, M={M})
mods = [c.load_train_params({str(d / "train.ckpt")!r}, fresh().module)[0],
        c.load_params({str(d / "params.ckpt")!r}, fresh().module),
        c.load_updated_model({deploy!r}, fresh()).module]
for m in mods:
    got = m.state_dict()
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], v) for k, v in want.items())
print("ok")
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr
