"""The port's paired RGB-T archs (`mbt2018_R`/`_D`, `cheng2020-anchor_R`/
`_D`, `cheng2020-attn_R`/`_D`) against lmic_tpu on the CPU, the cases of
tests/test_rgbt_joint.py: N = M = 32, a 128x128 RGB guide through the
`_R` codec (first conv at stride 2) and a 128x128 thermal image through
the `_D` codec, on lmic_tpu weights from seeds converted with
`state_dict_from_jax` and coding tables carried across.

Bars: ESA, SELayer and the forwards within 1e-5 of the largest value,
max|a-b| / max(1, max|b|) (f32 sums in another order by XLA and by
torch); strings byte-identical; the `_D` decoder's latents equal to its
encoder's, bit for bit; one `_R` training step with the f32 bars of
tests/test_torch_train_rgbt.py's `guided` step."""

import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import (
    _perturb_gammas,
    carry_tables,
    jax_codec,
    nchw,
    nhwc,
    patch_same_noise,
    pixels,
    port_codec,
    write_images,
)

from lmic_tpu import zoo as jzoo
from lmic_tpu.layers import ESA as JESA
from lmic_tpu.layers import SELayer as JSELayer
from lmic_tpu.utils import train as jtrain
from lmic_tpu.zoo.pretrained import import_reference_state_dict
from lmic_tpu_torch import zoo as tzoo
from lmic_tpu_torch.layers import SELayer
from lmic_tpu_torch.models.codec import _symbols_to_host
from lmic_tpu_torch.ops import gdn
from lmic_tpu_torch.utils import checkpoint as ckpt
from lmic_tpu_torch.utils import train as ttrain
from lmic_tpu_torch.utils import train_cli, update_model_cli
from lmic_tpu_torch.zoo.convert import state_dict_from_jax

torch.set_num_threads(2)

TOL = 1e-5
WIDTH = 32
SIZE = (128, 128)
FAMILIES = ("mbt2018", "cheng2020-anchor", "cheng2020-attn")
ARCHS = tuple(f + s for f in FAMILIES for s in ("_R", "_D"))
# the guide's RGB image and the dependent thermal image, one of each
GUIDE, IMAGE = (1, *SIZE, 3), (1, *SIZE, 1)
MAPS = ("ga1", "ga2", "ga3", "gs1", "gs2", "gs3")
LMBDA = 1024.0
LOSSES = ("loss", "mse_loss", "bpp_loss", "aux_loss")


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / max(1.0, np.abs(want).max())
    assert err < TOL, err


def _same_pixels(got, want):
    """Clipped [0, 1] images within one 8-bit level."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    levels = np.abs(np.round(got * 255) - np.round(want * 255))
    assert levels.max() <= 1, levels.max()


def _channel(arch):
    return 1 if arch.endswith("_D") else 3


def _perturb_biases(tree, rng):
    """Every conv bias (zero at init) off zero, so a swapped or dropped
    leaf, of the fusion layers too, shows."""
    for k, node in tree.items():
        if isinstance(node, dict):
            _perturb_biases(node, rng)
        elif k == "bias":
            tree[k] = (node + rng.uniform(-0.1, 0.1, node.shape)).astype(
                np.float32)


def _params(arch, seed):
    """lmic_tpu's init of `arch` at WIDTH, numpy, with every GDN gamma
    pushed off the diagonal, every conv bias off zero and the bottleneck
    medians off zero."""
    codec = jzoo.create_model(arch, 1, key=jax.random.key(seed),
                              input_size=SIZE, N=WIDTH, M=WIDTH,
                              channel=_channel(arch))
    params = jax.tree.map(np.asarray, codec.variables["params"])
    rng = np.random.default_rng(seed)
    _perturb_gammas(params, rng)
    _perturb_biases(params, rng)
    q = params["entropy_bottleneck"]["quantiles"].copy()
    q[:, :, 1] += rng.uniform(-0.3, 0.3, q.shape[0])[:, None]
    params["entropy_bottleneck"]["quantiles"] = q.astype(np.float32)
    return params


@functools.lru_cache(maxsize=None)
def _codecs(arch):
    """(lmic_tpu's codec, the port's on the converted weights with the
    tables carried across, the params)."""
    params = _params(arch, 0 if arch.endswith("_R") else 1)
    jc = jax_codec(arch, params, WIDTH, WIDTH, _channel(arch))
    pc = carry_tables(jc, port_codec(arch, params, WIDTH, WIDTH,
                                     _channel(arch)))
    return jc, pc, params


@functools.lru_cache(maxsize=None)
def _guide(family):
    """lmic_tpu's `_R` codec on the seeded guide: its compress output and
    its decoder's output, maps as NHWC numpy."""
    jc = _codecs(family + "_R")[0]
    enc = jc.compress(pixels(GUIDE, seed=2))
    dec = jc.decompress(enc["strings"], enc["shape"])
    return enc, {"x_hat": np.asarray(dec["x_hat"]),
                 "hidden": {k: np.asarray(v) for k, v in
                            dec["hidden"].items()}}


def _forward_maps(family):
    """The six maps of lmic_tpu's `_R` eval forward on the guide."""
    jc = _codecs(family + "_R")[0]
    xf = pixels(GUIDE, seed=2).astype(np.float32) / 255
    out = jc.module.apply(jc.variables, jnp.asarray(xf), training=False)
    return {k: np.asarray(v) for k, v in out["hidden"].items()}


def _port_maps(maps, prefix=""):
    return {k: nchw(v) for k, v in maps.items() if k.startswith(prefix)}


@pytest.fixture()
def same_noise(monkeypatch):
    patch_same_noise(monkeypatch)


# -- the layers --------------------------------------------------------------

@pytest.mark.parametrize("H,W", [(16, 16), (20, 28), (64, 80)])
def test_esa_matches_lmic_tpu(H, W):
    """ESA of the first fusion level of mbt2018_D: the VALID conv and max
    pool, the bilinear resize back (from 1x1 at 16x16, 1x3 at the ragged
    20x28) and the sigmoid gate, so |out| <= |x|."""
    _, pc, params = _codecs("mbt2018_D")
    x = np.random.default_rng(H * W).standard_normal(
        (1, H, W, WIDTH)).astype(np.float32)
    want = JESA().apply({"params": params["enc_fuse_0"]["ESA_0"]},
                        jnp.asarray(x))
    with torch.no_grad():
        got = pc.module.attention1(nchw(x))
    _close(nhwc(got), want)
    assert np.all(np.abs(nhwc(got)) <= np.abs(x) + 1e-6)


def test_se_layer_matches_lmic_tpu():
    x = np.random.default_rng(0).standard_normal((2, 8, 8, 32)).astype(
        np.float32)
    se = JSELayer()
    v = se.init(jax.random.key(1), jnp.asarray(x))
    want = se.apply(v, jnp.asarray(x))
    port = SELayer(32)
    dense = v["params"]
    with torch.no_grad():
        for i, name in ((0, "Dense_0"), (2, "Dense_1")):
            port.fc[i].weight.copy_(torch.from_numpy(
                np.array(dense[name]["kernel"]).T))
        got = port(nchw(x))
    _close(nhwc(got), want)


# -- the forwards ------------------------------------------------------------

@pytest.mark.parametrize("family", FAMILIES)
def test_r_forward(family):
    """The `_R` eval forward: x_hat, likelihoods and the six maps."""
    jc, pc, _ = _codecs(family + "_R")
    xf = pixels(GUIDE, seed=2).astype(np.float32) / 255
    want = jc.module.apply(jc.variables, jnp.asarray(xf), training=False)
    with torch.no_grad():
        got = pc.module(nchw(xf), training=False)
    _close(nhwc(got["x_hat"]), want["x_hat"])
    assert set(got["hidden"]) == set(MAPS)
    for group in ("hidden", "likelihoods"):
        for k, v in want[group].items():
            _close(nhwc(got[group][k]), v)


@pytest.mark.parametrize("training", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("family", FAMILIES)
def test_d_forward(family, training, same_noise):
    """The `_D` forward on the `_R` model's maps (lmic_tpu's, the same
    arrays to both), in eval and with the same training noise: x_hat and
    the likelihoods."""
    jc, pc, _ = _codecs(family + "_D")
    maps = _forward_maps(family)
    xf = pixels(IMAGE, seed=3).astype(np.float32) / 255
    want = jc.module.apply(
        jc.variables, jnp.asarray(xf),
        {k: jnp.asarray(v) for k, v in maps.items()}, training=training,
        rngs={"noise": jax.random.key(0)} if training else None)
    with torch.no_grad():
        got = pc.module(nchw(xf), _port_maps(maps), training=training)
    assert got["x_hat"].shape == (1, 1, *SIZE)
    _close(nhwc(got["x_hat"]), want["x_hat"])
    for k, v in want["likelihoods"].items():
        lik = got["likelihoods"][k]
        assert torch.all(lik > 0)
        _close(nhwc(lik), v)


def test_cheng_anchor_r_hyper_swap():
    """cheng2020's h_a keeps z at y/4 with two stride-2 3x3 convs: a
    128x128 guide gives a 2x2 z, as lmic_tpu's."""
    jc, pc, _ = _codecs("cheng2020-anchor_R")
    x = np.zeros(GUIDE, np.float32)
    want = jc.module.apply(jc.variables, jnp.asarray(x), training=False)
    with torch.no_grad():
        got = pc.module(nchw(x), training=False)
    assert got["likelihoods"]["z"].shape[2:] == (2, 2)
    _close(nhwc(got["likelihoods"]["z"]), want["likelihoods"]["z"])


# -- the wire ----------------------------------------------------------------

@pytest.mark.parametrize("family", FAMILIES)
def test_strings_byte_identical(family):
    """The `_R` guide's strings, and its maps within 1e-5 on both legs;
    the `_D` strings on the same ga* maps (lmic_tpu's), and its decode on
    the same gs* maps within one level of lmic_tpu's: the decoded pixels
    are clipped outputs of maps that reach |x| ~ 4,000 with random weights
    (cheng2020-attn_R's gs3), where both frameworks' f32 x_hat are up to
    1e-3 from the f64 one (measured: the port 1.0e-3, lmic_tpu 8.1e-4),
    as in tests/test_torch_ar.py's cross decode. The `_D` image goes in
    as float in [0, 1], as lmic_tpu's paired eval feeds it: lmic_tpu's
    FusedARCodec.compress reads uint8 pixels as 0-255 (it skips the
    `_as_unit_float` of its guide codec), the port as x / 255 like every
    other codec, so the port's uint8 strings are its float strings."""
    (jr, pr, _), (jd, pd, _) = _codecs(family + "_R"), _codecs(family + "_D")
    enc, dec = _guide(family)
    got = pr.compress(pixels(GUIDE, seed=2))
    assert got["strings"] == enc["strings"]
    assert tuple(got["shape"]) == tuple(enc["shape"])
    for k, v in enc["hidden"].items():
        _close(nhwc(got["hidden"][k]), v)
    got_dec = pr.decompress(got["strings"], got["shape"])
    _same_pixels(nhwc(got_dec["x_hat"]), dec["x_hat"])
    for k, v in dec["hidden"].items():
        _close(nhwc(got_dec["hidden"][k]), v)
    u8 = pixels(IMAGE, seed=3)
    x = u8.astype(np.float32) / 255
    ga = {k: np.asarray(v) for k, v in enc["hidden"].items()}
    want = jd.compress(x, ga)
    out = pd.compress(x, _port_maps(ga))
    assert out["strings"] == want["strings"]
    assert pd.compress(u8, _port_maps(ga))["strings"] == want["strings"]
    assert tuple(out["shape"]) == tuple(want["shape"])
    rec = pd.decompress(out["strings"], out["shape"],
                        _port_maps(dec["hidden"]))["x_hat"]
    assert rec.shape == x.shape and rec.min() >= 0 and rec.max() <= 1
    _same_pixels(rec, jd.decompress(want["strings"], want["shape"],
                                    dec["hidden"])["x_hat"])


@pytest.mark.parametrize("family", FAMILIES)
def test_d_decode_reproduces_encoder_y_hat(family):
    """On the port's own `_R` maps: the `_D` decoder's latents are its
    encoder's, and the codec's strings are the fused analysis's."""
    pr, pd = _codecs(family + "_R")[1], _codecs(family + "_D")[1]
    g = pr.compress(pixels(GUIDE, seed=2))
    x = pixels(IMAGE, seed=3)
    with torch.inference_mode():
        y, z = pd.module.analyze_fused(pd._pixels(x), g["hidden"])
        z_sym = _symbols_to_host(torch.round(z - pd._medians(pd.eb_state)))
        enc = pd._code_y_z([y], z_sym, keep_y_hat=True)
        dec = pd._decode_y_hat(enc["strings"], enc["shape"])
    assert torch.equal(dec, enc["y_hat_latent"])
    assert enc["strings"] == pd.compress(x, g["hidden"])["strings"]


# -- weights -----------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_weight_round_trip(arch):
    """The converted state dict has the port's keys (it loads strict, and
    the `_D` modules build no unused g_a/g_s or pic2_*) and lmic_tpu's
    importer maps it back to the original params leaf for leaf."""
    jc, pc, params = _codecs(arch)
    sd = state_dict_from_jax(arch, params)
    assert set(sd) == set(pc.module.state_dict())
    if arch == "cheng2020-attn_R":
        # lmic_tpu's importer reads CompressAI's inherited enc1/dec1
        # first and then replaces them (pretrained.py:837-840); the
        # port's module has none, so give the importer any
        sd = {**{k: v for k, v in state_dict_from_jax(
            "mbt2018_R", _codecs("mbt2018_R")[2]).items()
            if k.startswith(("enc1.", "dec1."))}, **sd}
    back = import_reference_state_dict(arch, sd, variables=jc.variables)
    flat_a = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back["params"])[0])
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)


@pytest.mark.parametrize("arch", ARCHS)
def test_converter_refuses_leftover_params(arch):
    params = dict(_codecs(arch)[2])
    params["extra"] = params["h_a_net"]
    with pytest.raises(ValueError, match="converted"):
        state_dict_from_jax(arch, params)


# -- entry points ------------------------------------------------------------

def test_zoo_paired_geometry():
    for arch in ARCHS:
        assert sorted(tzoo.cfgs[arch]) == list(range(1, 8))
        m = tzoo.make_module(arch, 7, channel=_channel(arch))
        assert (m.N, m.M, m.downsampling_factor) == (192, 192, 64)
    r = tzoo.make_module("mbt2018_R", 7, first_stride=1, N=16, M=24)
    assert r.downsampling_factor == 32 and r.enc1.g_a_conv1.stride == (1, 1)
    with pytest.raises(TypeError, match="first_stride"):
        tzoo.make_module("mbt2018_D", 7, first_stride=1)
    d = tzoo.make_module("cheng2020-attn_D", 1, channel=1, N=16)
    names = {n.split(".")[0] for n, _ in d.named_parameters()}
    assert not names & {"enc1", "dec1", "g_a", "g_s", "pic2_g_a_conv1"}
    assert {"eg_ext12", "tran_conv6", "attention6", "g_a_rbs1"} <= names
    with pytest.raises(NotImplementedError, match="g_s_fused"):
        d.g_s(torch.zeros(1, 16, 1, 1))


def test_create_model_draws_every_weight_from_the_seed():
    a, b = (tzoo.create_model("cheng2020-attn_D", 1, seed=4, channel=1,
                              N=16, device="cpu").module.state_dict()
            for _ in range(2))
    assert all(torch.equal(v, b[k]) for k, v in a.items())
    assert a["attention1.conv2.weight"].abs().max() > 0
    assert a["attention1.conv2.bias"].abs().max() == 0


def test_pair_on_one_device_launches_no_kernel():
    """The cross-device stage check of the pair, run on the CPU twice, is
    exact; the CPU launches no kernel."""
    from lmic_tpu_torch.utils.crosscheck import paired_agreement

    pair = (_codecs("mbt2018_R")[1], _codecs("mbt2018_D")[1])
    before = dict(gdn.LAUNCHES)
    assert paired_agreement(pair, pair, pixels(IMAGE, seed=3),
                            pixels(GUIDE, seed=2)) == 0
    assert gdn.LAUNCHES == before


# -- training the `_R` archs -------------------------------------------------

def _jax_step(arch, params, batch):
    module = jzoo.make_module(arch, 1, N=WIDTH, M=WIDTH)

    def loss_fn(p):
        out = module.apply({"params": p}, batch, training=True,
                           rngs={"noise": jax.random.key(0)})
        rd = jtrain.rate_distortion_loss(out, batch, LMBDA)
        aux = module.apply({"params": p}, method=type(module).aux_loss)
        return rd["loss"] + aux, {**rd, "aux_loss": aux}

    grads, metrics = jax.jit(jax.grad(loss_fn, has_aux=True))(
        jax.tree.map(jnp.asarray, params))
    return ({k: float(v) for k, v in metrics.items()},
            state_dict_from_jax(arch, jax.tree.map(np.asarray, grads)))


@pytest.mark.parametrize("family", FAMILIES)
def test_r_train_step_matches_lmic_tpu(family, same_noise):
    """One f32 step of the `_R` arch (the loss `train_cli` trains) on a
    batch of 2 seeded 128x128 guides against lmic_tpu's on the same
    weights and noise, with the f32 bars of the `guided` step
    (tests/test_torch_train_rgbt.py): losses to 1e-5 relative, every
    gradient leaf to 1e-3 of its largest value (measured: losses within
    1.4e-6, leaves within 3.2e-4, cheng2020-attn_R's
    dec.atten2.conv_b.1.conv.0.bias; 1.4e-5 and 8.2e-6 for the other
    two; no gate flips as F32_GATE_FLIPS's). cheng2020-attn's `res3`
    makes the tap h3 only, so its leaves get no gradient in the port and
    a zero one in lmic_tpu."""
    arch = family + "_R"
    params = _codecs(arch)[2]
    batch = (pixels((2, *SIZE, 3), seed=5) / 255.0).astype(np.float32)
    want_m, want_g = _jax_step(arch, params, jnp.asarray(batch))
    module = tzoo.make_module(arch, 1, N=WIDTH, M=WIDTH)
    module.load_state_dict(state_dict_from_jax(arch, params))
    module.to(memory_format=torch.channels_last)
    x = nchw(batch)
    loss, metrics = ttrain.rd_aux_loss(module, module(x, training=True), x,
                                       LMBDA)
    loss.backward()
    for k in LOSSES:
        assert abs(metrics[k].item() - want_m[k]) <= 1e-5 * abs(want_m[k]), k
    got_g = {n: p.grad for n, p in module.named_parameters()}
    assert set(got_g) == set(want_g)
    for name, want in want_g.items():
        got = got_g[name]
        scale = want.abs().max().item()
        if scale == 0:  # the quantiles' share of the RD loss; res3's
            assert got is None or got.abs().max().item() == 0, name
            continue
        err = (got - want).abs().max().item() / scale
        assert err < 1e-3, (name, err)


@pytest.mark.parametrize("family", FAMILIES)
def test_train_cli_trains_and_finalizes_r(family, tmp_path, capsys,
                                          monkeypatch):
    """`train_cli` trains the `_R` arch for one step on seeded 64x64 PNGs
    (the quality table patched to WIDTH): a finite loss and a checkpoint
    of the arch; `update_model_cli` finalizes it to a guide codec whose
    round trip decodes to the same maps as its one-pass reconstruct."""
    arch = family + "_R"
    widths = (WIDTH, WIDTH) if family == "mbt2018" else (WIDTH,)
    monkeypatch.setitem(tzoo.cfgs, arch, {1: widths})
    write_images(tmp_path / "ds" / "train", 2, (72, 72), seed=1)
    save = tmp_path / "r.ckpt"
    assert train_cli.main(
        ["--arch", arch, "-q", "1", "-d", str(tmp_path / "ds"),
         "--batch-size", "2", "--patch-size", "64", "64", "--epochs", "1",
         "--log-every", "1", "--prefetch", "0", "--save-path", str(save),
         "--device", "cpu"]) == 0
    losses = [float(v) for v in re.findall(r"loss=([0-9.]+) mse",
                                           capsys.readouterr().out)]
    assert len(losses) == 1 and np.isfinite(losses[0])
    out = update_model_cli.run([str(save), "-a", arch, "-q", "1", "-d",
                                str(tmp_path / "final"), "--device", "cpu"])
    codec = ckpt.load_updated_model(
        out, tzoo.create_model(arch, 1, device="cpu", seed=3))
    assert ckpt.load_train_params(str(save), tzoo.make_module(arch, 1))[
        1]["arch"] == arch
    x = pixels((1, 64, 64, 3))
    rec = codec.compress(x, hidden=False, reconstruct=True)
    dec = codec.decompress(rec["strings"], rec["shape"])
    assert dec["x_hat"].shape == (1, 3, 64, 64)
    assert torch.equal(rec["x_hat"], dec["x_hat"])
