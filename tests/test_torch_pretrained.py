"""CompressAI-format checkpoints in the port (zoo/pretrained.py,
zoo/urls.py, `update_model_cli --from-torch/--no-update/--raw-params`)
against lmic_tpu on the CPU: the image archs and ssf2020 here, the RGB-T
archs in tests/test_torch_pretrained_rgbt.py.

A file is written by `crosscheck.write_reference_checkpoint` from the
port's codec on lmic_tpu's weights (converted by `state_dict_from_jax`)
with lmic_tpu's baked tables carried across: the keys, the reference's
buffers, a `module.` prefix and old `_matrices.0`/`downsample` spellings.
Both packages' CLIs finalize the same file with `--from-torch`; the two
finalized codecs code the same bytes, with tables equal to the file's
buffers bit for bit. Without baked buffers both bake their own, from the
same params (their tables may differ by one in a few entries, ROADMAP.md
queue C, so no byte check there)."""

import hashlib
import os
import urllib.error

import jax
import numpy as np
import pytest
import torch
from torch_port_helpers import (
    VIDEO_GOP,
    carry_tables,
    jax_codec,
    jax_params,
    pixels,
    port_codec,
    video_codecs,
)

from lmic_tpu import zoo as jzoo
from lmic_tpu.utils import checkpoint as jckpt
from lmic_tpu.utils import update_model_cli as jcli
from lmic_tpu.zoo import pretrained as jpre
from lmic_tpu.zoo import urls as jurls
from lmic_tpu_torch import zoo as tzoo
from lmic_tpu_torch.utils import checkpoint as ckpt
from lmic_tpu_torch.utils import update_model_cli
from lmic_tpu_torch.utils.crosscheck import (
    coding_states,
    reference_table_mismatches,
    write_reference_checkpoint,
)
from lmic_tpu_torch.zoo import pretrained, urls
from lmic_tpu_torch.zoo.convert import state_dict_from_jax

torch.set_num_threads(2)

# the image archs at test widths, as their quality table entry
WIDTHS = {
    "bmshj2018-factorized": (16, 24),
    "bmshj2018-hyperprior": (16, 24),
    "mbt2018-mean": (16, 24),
    "mbt2018": (16, 24),
    "cheng2020-anchor": (16,),
    "cheng2020-attn": (16,),
}
IMAGE = (1, 64, 64, 3)


def _codecs(arch):
    """lmic_tpu's codec at WIDTHS with its baked tables, and the port's on
    the converted weights with those tables carried across."""
    n, m = WIDTHS[arch][0], WIDTHS[arch][-1]
    params = jax_params(arch, n=n, m=m)
    jc = jax_codec(arch, params, n, m)
    return jc, carry_tables(jc, port_codec(arch, params, n, m)), params


def _narrow(monkeypatch, arch, widths):
    monkeypatch.setitem(jzoo.cfgs, arch, {1: widths})
    monkeypatch.setitem(tzoo.cfgs, arch, {1: widths})


def _finalize(tmp_path, path, arch, *flags, channel=3):
    """Both packages' `update_model_cli.run` on `path`: (lmic_tpu's
    output, the port's)."""
    args = [str(path), "-a", arch, "-q", "1", "--channel", str(channel),
            *flags]
    return (jcli.run(args + ["-d", str(tmp_path / "jax")]),
            update_model_cli.run(args + ["-d", str(tmp_path / "port"),
                                         "--device", "cpu"]))


def _assert_tables_are_the_files(codec, sd):
    """Every coding table of `codec` equals the file's buffers, bit for
    bit: the CDFs, lengths and offsets, the medians `quantiles[:, 0, 1]`
    and the scale table."""
    assert coding_states(codec)
    assert reference_table_mismatches(codec, sd) == []


@pytest.mark.parametrize("arch", sorted(WIDTHS))
def test_from_torch_codes_lmic_tpus_bytes(arch, tmp_path, monkeypatch):
    """Both packages finalize a CompressAI file with baked tables: the
    finalized codecs code byte-identical strings, and both adopted the
    file's tables bit for bit."""
    jc, pc, _ = _codecs(arch)
    path = tmp_path / f"{arch}.pth.tar"
    sd = write_reference_checkpoint(str(path), pc)
    _narrow(monkeypatch, arch, WIDTHS[arch])
    jout, tout = _finalize(tmp_path, path, arch, "--from-torch")
    jf = jckpt.load_updated_model(jout, jc)
    tf = ckpt.load_updated_model(
        tout, tzoo.create_model(arch, 1, device="cpu", seed=3))
    _assert_tables_are_the_files(tf, sd)
    _assert_tables_are_the_files(jf, sd)
    for k, v in tf.module.state_dict().items():
        assert torch.equal(v, sd[k]), k
    x = pixels(IMAGE, seed=7)
    got = tf.compress(x)
    assert got["strings"] == jf.compress(x)["strings"]
    assert got["strings"] == pc.compress(x)["strings"]


def test_from_torch_ssf2020_codes_lmic_tpus_bytes(tmp_path):
    """ssf2020: the three sub-codecs' baked tables adopted by both
    packages (`install_tables` in the port), and a 3-frame GOP coded to
    the same bytes."""
    jc, pc, _ = video_codecs(0)
    path = tmp_path / "ssf2020.pth.tar"
    sd = write_reference_checkpoint(str(path), pc)
    jout, tout = _finalize(tmp_path, path, "ssf2020", "--from-torch")
    jf = jckpt.load_updated_model(jout, jc)
    tf = ckpt.load_updated_model(
        tout, tzoo.create_video_model(device="cpu", seed=3))
    _assert_tables_are_the_files(tf, sd)
    _assert_tables_are_the_files(jf, sd)
    x = pixels(VIDEO_GOP, seed=4)
    got, shapes = tf.compress(x)
    want, want_shapes = jf.compress(x)
    assert shapes == want_shapes
    assert repr(got) == repr(want)


@pytest.mark.parametrize("arch", ["bmshj2018-factorized", "mbt2018-mean"])
def test_from_torch_without_tables_bakes_its_own(arch, tmp_path,
                                                 monkeypatch):
    """A file without baked buffers: both packages load the same params,
    and the port's tables are its own `update(force=True)` of them."""
    jc, pc, params = _codecs(arch)
    path = tmp_path / f"{arch}.pth.tar"
    sd = write_reference_checkpoint(str(path), pc, baked=False)
    assert not any(k.endswith("_quantized_cdf") for k in sd)
    _narrow(monkeypatch, arch, WIDTHS[arch])
    jout, tout = _finalize(tmp_path, path, arch, "--from-torch")
    jf = jckpt.load_updated_model(jout, jc)
    tf = ckpt.load_updated_model(
        tout, tzoo.create_model(arch, 1, device="cpu", seed=3))
    want = state_dict_from_jax(arch, jax.tree.map(np.asarray,
                                                  jf.variables["params"]))
    for k, v in tf.module.state_dict().items():
        assert torch.equal(v, sd[k]) and torch.equal(v, want[k]), k
    fresh = port_codec(arch, params, *WIDTHS[arch])
    fresh.update(force=True)
    for name, st in coding_states(fresh).items():
        mine = coding_states(tf)[name]
        for attr in ("cdf", "cdf_length", "offset"):
            assert np.array_equal(getattr(mine.table, attr),
                                  getattr(st.table, attr)), (name, attr)


def test_no_update_then_raw_params_is_the_plain_finalization(tmp_path,
                                                             monkeypatch):
    """`--from-torch --no-update` writes the bare params; `--raw-params`
    finalizes them to the same file as finalizing the same weights
    without baked tables (the name is the sha256 of the bytes). lmic_tpu's
    bare params (flax msgpack) are the same weights."""
    arch = "mbt2018-mean"
    jc, pc, params = _codecs(arch)
    baked, plain = tmp_path / "baked.pth.tar", tmp_path / "plain.pth.tar"
    write_reference_checkpoint(str(baked), pc)
    write_reference_checkpoint(str(plain), pc, baked=False)
    _narrow(monkeypatch, arch, WIDTHS[arch])
    jbare, bare = _finalize(tmp_path, baked, arch, "--from-torch",
                            "--no-update")
    assert os.path.basename(bare) == f"{arch}-q1.ckpt"
    raw = torch.load(bare, weights_only=True)
    assert set(raw) == set(pc.module.state_dict())
    got = jckpt.load_params(jbare, jc.variables["params"])
    want = state_dict_from_jax(arch, jax.tree.map(np.asarray, got))
    for k, v in raw.items():
        assert torch.equal(v, want[k]), k
    final = update_model_cli.run([bare, "-a", arch, "-q", "1", "-d",
                                  str(tmp_path / "raw"), "--raw-params",
                                  "--device", "cpu"])
    direct = update_model_cli.run([str(plain), "-a", arch, "-q", "1", "-d",
                                   str(tmp_path / "direct"), "--from-torch",
                                   "--device", "cpu"])
    assert os.path.basename(final) == os.path.basename(direct)
    with open(final, "rb") as a, open(direct, "rb") as b:
        assert a.read() == b.read()


# -- the importer's parts -----------------------------------------------------

RENAMES = [
    "module.g_a.0.weight",
    "entropy_bottleneck._matrices.0",
    "entropy_bottleneck.matrices.3",
    "module.entropy_bottleneck._biases.2",
    "entropy_bottleneck._factors.1",
    "img_hyperprior.entropy_bottleneck._matrices.4",
    "g_a.0.downsample.weight",
    "module.g_s.2.downsample.bias",
    "decoder.downsample1.weight",
    "entropy_bottleneck._matrix0",
    "gaussian_conditional._quantized_cdf",
    "module.module.h_a.0.weight",
]


@pytest.mark.parametrize("key", RENAMES)
def test_rename_reference_keys_matches_lmic_tpu(key):
    value = torch.zeros(1)
    got = pretrained.rename_reference_keys({key: value})
    assert got == jpre.rename_reference_keys({key: value})
    assert next(iter(got.values())) is value


def test_import_is_strict_on_the_modules_keys(tmp_path):
    """Every key of the module is required at the module's shape; the
    file's other keys are dropped; an arch lmic_tpu imports nothing of
    is refused."""
    _, pc, _ = _codecs("mbt2018-mean")
    path = tmp_path / "f.pth.tar"
    write_reference_checkpoint(str(path), pc,
                               extra={"g_x.0.weight": torch.ones(2)})
    sd = pretrained.load_torch_state_dict(str(path))
    assert "g_x.0.weight" in sd and "entropy_bottleneck._matrix0" in sd
    got = pretrained.import_reference_state_dict("mbt2018-mean", sd,
                                                 pc.module)
    assert set(got) == set(pc.module.state_dict())
    missing = dict(sd)
    del missing["h_s.2.bias"]
    with pytest.raises(KeyError, match="h_s.2.bias"):
        pretrained.import_reference_state_dict("mbt2018-mean", missing,
                                               pc.module)
    wrong = dict(sd, **{"g_a.1.gamma": torch.zeros(3, 3)})
    with pytest.raises(ValueError, match="g_a.1.gamma"):
        pretrained.import_reference_state_dict("mbt2018-mean", wrong,
                                               pc.module)
    with pytest.raises(ValueError, match="no reference importer"):
        pretrained.import_reference_state_dict("mbt2018-mean-x", sd,
                                               pc.module)
    assert set(pretrained.IMPORTABLE) == set(jpre._IMPORTERS)
    # a training checkpoint with a 'state_dict' entry reads the same
    torch.save({"epoch": 3, "state_dict": torch.load(
        path, weights_only=True)}, tmp_path / "train.pth.tar")
    again = pretrained.load_torch_state_dict(str(tmp_path / "train.pth.tar"))
    assert set(again) == set(sd)


def test_partial_tables_leave_the_codec_untouched(tmp_path):
    """Gaussian-conditional buffers missing or partial: False and the
    codec as it was. The factorized prior needs only the bottleneck's."""
    _, pc, _ = _codecs("mbt2018-mean")
    sd = write_reference_checkpoint(str(tmp_path / "f.pth.tar"), pc)
    fresh = tzoo.create_model("mbt2018-mean", 1, device="cpu", N=16, M=24)
    no_gc = {k: v for k, v in sd.items()
             if not k.startswith("gaussian_conditional.")}
    partial = {k: v for k, v in sd.items()
               if k != "gaussian_conditional._offset"}
    empty = dict(sd, **{"entropy_bottleneck._offset": torch.zeros(0)})
    for bad in (no_gc, partial, empty):
        assert not pretrained.import_reference_coding_state(bad, fresh)
        assert fresh.eb_state is None and fresh.gc_state is None
    _, fc, _ = _codecs("bmshj2018-factorized")
    fsd = write_reference_checkpoint(str(tmp_path / "g.pth.tar"), fc)
    factorized = tzoo.create_model("bmshj2018-factorized", 1, device="cpu",
                                   N=16, M=24)
    assert pretrained.import_reference_coding_state(fsd, factorized)
    _assert_tables_are_the_files(factorized, fsd)


def test_adopting_tables_rebuilds_the_fast_path(tmp_path):
    """The uint8 fast path built from the old tables (`_ensure`'s cache)
    is forgotten: after adoption the codec codes with the file's tables,
    as a codec that adopted them first does."""
    _, pc, _ = _codecs("mbt2018-mean")
    sd = write_reference_checkpoint(str(tmp_path / "f.pth.tar"), pc)
    codec = tzoo.create_model("mbt2018-mean", 1, device="cpu", N=16, M=24,
                              state_dict={k: sd[k] for k in
                                          pc.module.state_dict()})
    x = pixels(IMAGE, seed=7)
    codec.update(force=True)
    codec.compress(x)  # builds the fast path on the codec's own tables
    assert "_built_for" in codec.__dict__
    assert pretrained.import_reference_coding_state(sd, codec)
    assert "_built_for" not in codec.__dict__
    assert codec.compress(x)["strings"] == pc.compress(x)["strings"]


def test_load_reference_checkpoint(tmp_path):
    _, pc, _ = _codecs("mbt2018")
    path = tmp_path / "f.pth.tar"
    sd = write_reference_checkpoint(str(path), pc)
    codec = pretrained.load_reference_checkpoint(
        "mbt2018", str(path), device="cpu", N=16, M=24)
    _assert_tables_are_the_files(codec, sd)
    x = pixels(IMAGE, seed=7)
    assert codec.compress(x)["strings"] == pc.compress(x)["strings"]
    bare = pretrained.load_reference_checkpoint(
        "mbt2018", str(path), device="cpu", update=False, N=16, M=24)
    assert bare.eb_state is None


# -- the URL table and the cache ----------------------------------------------


def test_url_table_is_lmic_tpus():
    assert urls.model_urls == jurls.model_urls
    assert urls.root_url == jurls.root_url
    assert urls.pretrained_url("mbt2018-mean", 3) == \
        jurls.pretrained_url("mbt2018-mean", 3)
    assert urls.pretrained_url("cheng2020-attn", 2, "ms-ssim").endswith(
        "cheng2020_attn-ms-ssim-2-5dad201d.pth.tar")
    with pytest.raises(ValueError, match="no pretrained entry"):
        urls.pretrained_url("mbt2018-mean", 9)
    with pytest.raises(ValueError, match="no pretrained entry"):
        urls.pretrained_url("ssf2020", 1, "ms-ssim")
    with pytest.raises(ValueError, match="external links"):
        urls.pretrained_url("master", 3)


def _no_download(*_args, **_kw):
    raise AssertionError("a cache hit downloads nothing")


def test_cache_dir_is_lmic_tpus(monkeypatch, tmp_path):
    monkeypatch.delenv("LMIC_PRETRAINED_DIR", raising=False)
    assert urls.cache_dir() == jurls.cache_dir()
    assert urls.cache_dir().endswith(
        os.path.join(".cache", "lmic_tpu", "pretrained"))
    monkeypatch.setenv("LMIC_PRETRAINED_DIR", str(tmp_path))
    assert urls.cache_dir() == jurls.cache_dir() == str(tmp_path)


def test_fetch_hits_the_cache_and_loads(monkeypatch, tmp_path):
    """A file placed in the cache under the zoo's name is found without a
    download, and `load_pretrained_model` serves it with its tables."""
    monkeypatch.setenv("LMIC_PRETRAINED_DIR", str(tmp_path))
    monkeypatch.setattr("urllib.request.urlretrieve", _no_download)
    _, pc, _ = _codecs("bmshj2018-hyperprior")
    name = urls.pretrained_url("bmshj2018-hyperprior", 1).rsplit("/", 1)[1]
    sd = write_reference_checkpoint(str(tmp_path / name), pc)
    assert urls.fetch_pretrained("bmshj2018-hyperprior", 1) == \
        str(tmp_path / name) == jurls.fetch_pretrained(
            "bmshj2018-hyperprior", 1)
    monkeypatch.setitem(tzoo.cfgs, "bmshj2018-hyperprior", {1: (16, 24)})
    codec = urls.load_pretrained_model("bmshj2018-hyperprior", 1,
                                       device="cpu")
    _assert_tables_are_the_files(codec, sd)
    x = pixels(IMAGE, seed=7)
    assert codec.compress(x)["strings"] == pc.compress(x)["strings"]


def test_fetch_offline_says_where_to_put_the_file(monkeypatch, tmp_path):
    monkeypatch.setenv("LMIC_PRETRAINED_DIR", str(tmp_path / "cache"))

    def offline(url, path):
        raise urllib.error.URLError("no network")

    monkeypatch.setattr("urllib.request.urlretrieve", offline)
    want = tmp_path / "cache" / "mbt2018-8-dd0097aa.pth.tar"
    with pytest.raises(RuntimeError, match="place the file at") as e:
        urls.fetch_pretrained("mbt2018", 8)
    assert str(want) in str(e.value) and not want.exists()


def test_download_is_checked_against_its_name(monkeypatch, tmp_path):
    """A download whose sha256 does not start with the name's fragment is
    removed and refused; one that does is cached under the name."""
    monkeypatch.setenv("LMIC_PRETRAINED_DIR", str(tmp_path))

    def fetch(payload):
        def urlretrieve(url, path):
            with open(path, "wb") as f:
                f.write(payload)
        return urlretrieve

    monkeypatch.setattr("urllib.request.urlretrieve", fetch(b"corrupted"))
    with pytest.raises(RuntimeError, match="does not match"):
        urls.fetch_pretrained("mbt2018-mean", 1)
    assert not os.listdir(tmp_path)
    payload = b"a checkpoint"
    fragment = hashlib.sha256(payload).hexdigest()[:8]
    monkeypatch.setitem(urls.model_urls["mbt2018-mean"]["mse"], 1,
                        f"{urls.root_url}/mbt2018-mean-1-{fragment}.pth.tar")
    monkeypatch.setattr("urllib.request.urlretrieve", fetch(payload))
    path = urls.fetch_pretrained("mbt2018-mean", 1)
    assert path.endswith(f"-{fragment}.pth.tar")
    with open(path, "rb") as f:
        assert f.read() == payload


def test_register_architecture(monkeypatch, tmp_path):
    """A registered arch builds, trains' checkpoints finalize through the
    CLI, as in lmic_tpu's registry."""
    from lmic_tpu_torch.models.codec import HyperpriorCodec
    from lmic_tpu_torch.models.image import MeanScaleHyperprior

    monkeypatch.setattr(tzoo, "model_architectures",
                        dict(tzoo.model_architectures))
    monkeypatch.setitem(tzoo.cfgs, "my-mean-scale", {2: (16, 24)})
    tzoo.register_architecture("my-mean-scale", MeanScaleHyperprior,
                               HyperpriorCodec)
    assert tzoo.model_architectures["my-mean-scale"] == (
        MeanScaleHyperprior, HyperpriorCodec)
    codec = tzoo.create_model("my-mean-scale", 2, device="cpu")
    assert isinstance(codec, HyperpriorCodec) and codec.module.N == 16
    torch.save({"params": codec.module.state_dict()},
               tmp_path / "train.ckpt")
    out = update_model_cli.run([str(tmp_path / "train.ckpt"), "-a",
                                "my-mean-scale", "-q", "2", "-d",
                                str(tmp_path), "--device", "cpu"])
    final = ckpt.load_updated_model(
        out, tzoo.create_model("my-mean-scale", 2, device="cpu", seed=1))
    x = pixels(IMAGE, seed=7)
    codec.update(force=True)
    assert final.compress(x)["strings"] == codec.compress(x)["strings"]
    with pytest.raises(ValueError, match="Invalid architecture"):
        tzoo.create_model("my-other", 1, device="cpu")
