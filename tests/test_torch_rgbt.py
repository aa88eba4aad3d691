"""The port's RGB-T pair (the guided codec and the master codec) against
lmic_tpu on the CPU, on weights converted with `state_dict_from_jax` and
coding tables carried across, for both roles of the master: channel 1 (a
64x64 thermal master, a 128x128 RGB guide) and channel 3 (a 128x128 RGB
master, a 64x64 thermal guide), N = 32, M = 48.

Bars: the window helpers, relative index and shift mask exactly equal;
the Swin pieces, the aligners, the feature codecs and both compressers'
forwards within 1e-5 of the largest value, max|a-b| / max(1, max|b|)
(f32 sums in another order by XLA and by torch); strings byte-identical;
the guide's one-pass reconstruct equal to its decompress and the master's
decoder latents equal to its encoder's, bit for bit."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmic_tpu import parallel as jparallel
from lmic_tpu.models import rgbt as jr
from lmic_tpu.zoo.pretrained import import_reference_state_dict
from lmic_tpu_torch import parallel
from lmic_tpu_torch import zoo as tzoo
from lmic_tpu_torch.models import rgbt as tr
from lmic_tpu_torch.models.codec import _symbols_to_host
from lmic_tpu_torch.ops import gdn
from lmic_tpu_torch.zoo.convert import state_dict_from_jax
from torch_port_helpers import (
    RGBT_GEOMETRY,
    nchw,
    nhwc,
    pixels,
    rgbt_pair,
)

torch.set_num_threads(2)

TOL = 1e-5
ROLES = (1, 3)


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / max(1.0, np.abs(want).max())
    assert err < TOL, err


def _rng(seed):
    return np.random.default_rng(seed)


def _normal(shape, seed):
    return _rng(seed).standard_normal(shape).astype(np.float32)


@pytest.fixture(scope="module", params=ROLES, ids=["channel1", "channel3"])
def role(request):
    return request.param


@pytest.fixture(scope="module")
def pair(role):
    """The codecs, the seeded master and guide images, and lmic_tpu's guide
    reconstruction of the guide (x_hat and gs* maps, NHWC numpy)."""
    (jg, pg, gp), (jm, pm, mp) = rgbt_pair(role)
    (mH, mW), (gH, gW) = RGBT_GEOMETRY[role]
    xm = pixels((1, mH, mW, role), seed=2)
    xg = pixels((1, gH, gW, 4 - role), seed=1)
    g_out = jg.compress(xg, hidden=False)
    g_dec = jg.decompress(g_out["strings"], g_out["shape"])
    g_dec = {"x_hat": np.asarray(g_dec["x_hat"]),
             "hidden": {k: np.asarray(v) for k, v in g_dec["hidden"].items()}}
    return dict(jg=jg, pg=pg, gp=gp, jm=jm, pm=pm, mp=mp, xm=xm, xg=xg,
                g_out=g_out, g_dec=g_dec)


def _port_guide(g_dec):
    return {"x_hat": nchw(g_dec["x_hat"]),
            "hidden": {k: nchw(v) for k, v in g_dec["hidden"].items()}}


# -- window helpers ----------------------------------------------------------

@pytest.mark.parametrize("H,W,ws,shift", [(8, 8, 4, 2), (8, 12, 4, 2),
                                          (16, 8, 4, 2), (12, 12, 6, 3)])
def test_window_helpers_equal(H, W, ws, shift):
    x = _normal((2, H, W, 5), 0)
    windows = tr.window_partition(torch.from_numpy(x), ws)
    np.testing.assert_array_equal(windows.numpy(),
                                  jr.window_partition(jnp.asarray(x), ws))
    back = tr.window_reverse(windows, ws, H, W)
    np.testing.assert_array_equal(back.numpy(), x)
    np.testing.assert_array_equal(tr._relative_position_index(ws),
                                  jr._relative_position_index(ws))
    np.testing.assert_array_equal(tr._shift_attn_mask(H, W, ws, shift),
                                  jr._shift_attn_mask(H, W, ws, shift))


# -- the pair's own modules, on the master's converted weights ---------------

def _aligner(pair, i):
    return (pair["mp"]["g_s_net"][f"sp_aligner{i}"],
            getattr(pair["pm"].module.decoder, f"sp_aligner{i}"))


@pytest.mark.parametrize("masked", [False, True])
def test_window_cross_attention(pair, masked):
    params, port = _aligner(pair, 1)
    x, g = _normal((8, 16, 96), 3), _normal((8, 16, 96), 4)
    mask = jr._shift_attn_mask(8, 8, 4, 2) if masked else None
    want = jr.WindowCrossAttention(dim=96, window_size=4, num_heads=3).apply(
        {"params": params["block_0"]["WindowCrossAttention_0"]},
        jnp.asarray(x), jnp.asarray(g),
        None if mask is None else jnp.asarray(mask))
    with torch.no_grad():
        got = port.blocks[0].attn(
            torch.from_numpy(x), torch.from_numpy(g),
            None if mask is None else torch.from_numpy(mask))
    _close(got.numpy(), want)


@pytest.mark.parametrize("block", [0, 1], ids=["shift0", "shift2"])
def test_swin_cross_block(pair, block):
    """An 8x8 token grid: block 0 unshifted, block 1 shifted by 2."""
    params, port = _aligner(pair, 2)
    x, g = _normal((1, 8, 8, 96), 5), _normal((1, 8, 8, 96), 6)
    want = jr.SwinCrossBlock(dim=96, num_heads=3, window_size=4,
                             shift_size=2 * block).apply(
        {"params": params[f"block_{block}"]}, jnp.asarray(x), jnp.asarray(g))
    assert port.blocks[block].shift_size == 2 * block
    with torch.no_grad():
        got = port.blocks[block](torch.from_numpy(x), torch.from_numpy(g))
    _close(got.numpy(), want)


def test_swin_cross_block_grid_of_one_window(pair):
    """A grid of side ws runs unshifted in one window, as lmic_tpu's."""
    params, port = _aligner(pair, 1)
    x, g = _normal((2, 4, 8, 96), 7), _normal((2, 4, 8, 96), 8)
    want = jr.SwinCrossBlock(dim=96, num_heads=3, shift_size=2).apply(
        {"params": params["block_1"]}, jnp.asarray(x), jnp.asarray(g))
    with torch.no_grad():
        got = port.blocks[1](torch.from_numpy(x), torch.from_numpy(g))
        _close(got.numpy(), want)
        with pytest.raises(ValueError, match="smaller than"):
            port.blocks[1](torch.zeros(1, 2, 8, 96), torch.zeros(1, 2, 8, 96))


@pytest.mark.parametrize("H,W", [(16, 16), (16, 32)])
def test_spatial_aligner(pair, H, W):
    """Both streams patch-embedded, two blocks, and the reference's raw
    view of the tokens before the recovery (non-square grids included)."""
    params, port = _aligner(pair, 3)
    C = pair["pm"].module.N
    x, g = _normal((1, H, W, C), 9), _normal((1, H, W, C), 10)
    want = jr.SpatialAligner(out_channel=C).apply(
        {"params": params}, jnp.asarray(x), jnp.asarray(g))
    with torch.no_grad():
        got = port(nchw(x).contiguous(memory_format=torch.channels_last),
                   nchw(g))
    _close(nhwc(got), want)


def test_channel_aligner(pair):
    xf, gf = _normal((1, 8, 12, 64), 11), _normal((1, 8, 12, 64), 12)
    want = jr.ChannelAligner().apply({"params": pair["mp"]["ch_aligner"]},
                                     jnp.asarray(xf), jnp.asarray(gf))
    with torch.no_grad():
        got = pair["pm"].module.ch_aligner(nchw(xf), nchw(gf))
    assert got[1].shape == (1, 64, 1, 1) and got[2].shape == (1, 64, 1, 1)
    for a, b in zip(got, want):
        _close(nhwc(a), b)


def test_feature_codecs(pair, role):
    """fencoder1 (the master's stride), fencoder2 (the guide's) and the
    feature decoder from 192 channels back to the master's pixels."""
    m = pair["pm"].module
    roles = m._roles()
    for name, stride, chl in (
            ("fencoder1", roles["master_stride"], roles["master_chl"]),
            ("fencoder2", roles["guided_stride"], roles["guided_chl"])):
        x = _normal((1, 16, 24, chl), 13)
        want = jr.FeatureEncoder(64, stride=stride).apply(
            {"params": pair["mp"][name]}, jnp.asarray(x))
        with torch.no_grad():
            got = getattr(m, name)(nchw(x))
        _close(nhwc(got), want)
    f = _normal((1, 8, 12, 192), 14)
    want = jr.FeatureDecoder(out_channel=roles["master_chl"],
                             stride=roles["master_stride"]).apply(
        {"params": pair["mp"]["fdecoder"]}, jnp.asarray(f))
    with torch.no_grad():
        got = m.fdecoder(nchw(f))
    _close(nhwc(got), want)


# -- the compressers ---------------------------------------------------------

def test_guided_forward(pair):
    """The eval forward: x_hat, likelihoods and the six hidden maps."""
    xf = pair["xg"].astype(np.float32) / 255
    jg, pg = pair["jg"], pair["pg"]
    want = jg.module.apply(jg.variables, jnp.asarray(xf), training=False)
    with torch.no_grad():
        got = pg.module(nchw(xf), training=False)
    _close(nhwc(got["x_hat"]), want["x_hat"])
    assert set(got["hidden"]) == {"ga1", "ga2", "ga3", "gs1", "gs2", "gs3"}
    for group in ("hidden", "likelihoods"):
        for k, v in want[group].items():
            _close(nhwc(got[group][k]), v)


def test_master_forward(pair):
    """The eval forward on lmic_tpu's guide reconstruction: x_hat,
    likelihoods, beta and gamma."""
    jm, pm, g = pair["jm"], pair["pm"], pair["g_dec"]
    xf = pair["xm"].astype(np.float32) / 255
    want = jm(jnp.asarray(xf), jnp.asarray(g["x_hat"]),
              jax.tree.map(jnp.asarray, g["hidden"]))
    pg = _port_guide(g)
    with torch.no_grad():
        got = pm.module(nchw(xf), pg["x_hat"], pg["hidden"], training=False)
    for k in ("x_hat", "beta", "gamma"):
        _close(nhwc(got[k]), want[k])
    for k, v in want["likelihoods"].items():
        _close(nhwc(got["likelihoods"][k]), v)


def test_training_forwards(pair):
    pg, pm = pair["pg"].module, pair["pm"].module
    gen = torch.Generator().manual_seed(0)
    xg = nchw(pair["xg"].astype(np.float32) / 255)
    with torch.no_grad():
        g = pg(xg, training=True, generator=gen)
        m = pm(nchw(pair["xm"].astype(np.float32) / 255), g["x_hat"],
               {k: g["hidden"][k] for k in ("gs1", "gs2", "gs3")},
               training=True, generator=gen)
    assert g["x_hat"].shape == xg.shape
    for out in (g, m):
        for lik in out["likelihoods"].values():
            assert torch.all(lik > 0) and torch.all(lik <= 1)


# -- the wire ----------------------------------------------------------------

def test_guided_strings_byte_identical(pair):
    jg, pg, xg = pair["jg"], pair["pg"], pair["xg"]
    got = pg.compress(xg)
    assert got["strings"] == pair["g_out"]["strings"]
    assert tuple(got["shape"]) == tuple(pair["g_out"]["shape"])
    want = jg.compress(xg)["hidden"]
    for k, v in want.items():
        _close(nhwc(got["hidden"][k]), v)


def test_guided_reconstruct_equals_decompress(pair):
    """The one-pass reconstruct is the decoder's output bit for bit, and
    uint8 and float pixels give the same hidden maps."""
    pg, xg = pair["pg"], pair["xg"]
    rec = pg.compress(xg, hidden=False, reconstruct=True)
    assert "hidden" not in rec
    dec = pg.decompress(rec["strings"], rec["shape"])
    assert torch.equal(rec["x_hat"], dec["x_hat"])
    assert set(dec["hidden"]) == {"gs1", "gs2", "gs3"}
    for k, v in dec["hidden"].items():
        assert torch.equal(rec["hidden_dec"][k], v)
    # lmic_tpu decodes the same streams to the same pixels and maps
    _close(nhwc(dec["x_hat"]), pair["g_dec"]["x_hat"])
    for k, v in pair["g_dec"]["hidden"].items():
        _close(nhwc(dec["hidden"][k]), v)
    as_u8 = pg.compress(xg)["hidden"]
    as_float = pg.compress(xg.astype(np.float32) / 255)["hidden"]
    for k in as_u8:
        assert torch.equal(as_u8[k], as_float[k])


def test_master_strings_byte_identical(pair):
    """On the same guide reconstruction: the same strings, and beta/gamma
    within 1e-5; the port's decode of them within 1e-5 of lmic_tpu's."""
    jm, pm, xm, g = pair["jm"], pair["pm"], pair["xm"], pair["g_dec"]
    want = jm.compress(xm, g["x_hat"])
    got = pm.compress(xm, g["x_hat"])
    assert got["strings"] == want["strings"]
    assert tuple(got["shape"]) == tuple(want["shape"])
    assert got["beta"].shape == (1, 64, 1, 1)
    for k in ("beta", "gamma"):
        _close(got[k].reshape(-1), np.asarray(want[k]).reshape(-1))
    rec = pm.decompress(got, _port_guide(g))["x_hat"]
    _close(rec, jm.decompress(want, g)["x_hat"])
    u8 = pm.decompress(got, _port_guide(g), u8=True)["x_hat"]
    assert u8.dtype == np.uint8 and u8.shape == xm.shape


def test_pair_fans_out_over_a_mesh(pair, role):
    """`shard_codec` over two CPU entries fans the pair's images out
    (JointARCodec.fanout): the guide's strings, maps and pixels and the
    master's strings, beta/gamma and pixels of one device, and the strings
    of lmic_tpu's pair sharded over a two-device mesh on the same guide
    reconstruction (tests/test_rgbt.py:211, 275)."""
    jg, pg, jm, pm = (pair[k] for k in ("jg", "pg", "jm", "pm"))
    (mH, mW), (gH, gW) = RGBT_GEOMETRY[role]
    xg = pixels((2, gH, gW, 4 - role), seed=7)
    xm = pixels((2, mH, mW, role), seed=8)
    mesh = parallel.make_mesh(2, device="cpu")
    fan_g = parallel.shard_codec(copy.copy(pg), mesh)
    fan_m = parallel.shard_codec(copy.copy(pm), mesh)
    assert fan_g._fanout_devices == fan_m._fanout_devices == mesh.devices
    want_g = pg.compress(xg, hidden=False)
    got_g = fan_g.compress(xg, hidden=False)
    assert got_g["strings"] == want_g["strings"]
    dec = pg.decompress(want_g["strings"], want_g["shape"])
    got_dec = fan_g.decompress(got_g["strings"], got_g["shape"])
    assert torch.equal(got_dec["x_hat"], dec["x_hat"])
    for k, v in dec["hidden"].items():
        assert torch.equal(got_dec["hidden"][k], v)
    guide = nhwc(dec["x_hat"])
    want_m = pm.compress(xm, guide)
    got_m = fan_m.compress(xm, guide)
    assert got_m["strings"] == want_m["strings"]
    for k in ("beta", "gamma"):
        assert torch.equal(torch.as_tensor(got_m[k]),
                           torch.as_tensor(want_m[k]))
    np.testing.assert_array_equal(fan_m.decompress(got_m, dec)["x_hat"],
                                  pm.decompress(want_m, dec)["x_hat"])
    jmesh = jparallel.make_mesh(2)
    jfan_g = jparallel.shard_codec(copy.copy(jg), jmesh)
    jfan_m = jparallel.shard_codec(copy.copy(jm), jmesh)
    assert jfan_g.compress(xg, hidden=False)["strings"] == got_g["strings"]
    assert jfan_m.compress(xm, guide)["strings"] == got_m["strings"]


def test_master_decode_reproduces_encoder_y_hat(pair):
    """The decoder's latents are the encoder's, and the decoder's alignment
    from the transmitted beta/gamma is the encoder's aligned feature."""
    pm, xm = pair["pm"], pair["xm"]
    g = nchw(pair["g_dec"]["x_hat"])
    with torch.inference_mode():
        x_feature, align, beta, gamma = pm.module.features(pm._pixels(xm), g)
        y, z = pm.module.analyze_features(x_feature, align)
        z_sym = _symbols_to_host(torch.round(z - pm._medians(pm.eb_state)))
        enc = pm._code_y_z([y], z_sym, keep_y_hat=True)
        dec = pm._decode_y_hat(enc["strings"], enc["shape"])
        align_dec = pm.module.guided_align_from(g, beta, gamma)
    assert torch.equal(dec, enc["y_hat_latent"])
    assert torch.equal(align_dec, align)
    assert enc["strings"] == pm.compress(xm, pair["g_dec"]["x_hat"])[
        "strings"]


def test_bad_geometry_raises_as_lmic_tpu(pair, role):
    jm, pm, xm, g = pair["jm"], pair["pm"], pair["xm"], pair["g_dec"]
    factor = 64 * (2 if role == 3 else 1)
    assert pm.module.downsampling_factor == jm.module.downsampling_factor \
        == factor
    half = xm[:, :factor // 2, :factor // 2]
    cut = g["x_hat"][:, :16, :16]
    for x, guide, match in ((half, g["x_hat"], f"multiples of {factor}"),
                            (xm, cut, "guide reconstruction must be")):
        with pytest.raises(ValueError, match=match) as want:
            jm.compress(x, guide)
        with pytest.raises(ValueError, match=match) as got:
            pm.compress(x, guide)
        assert str(got.value) == str(want.value)
    assert pm.expected_guide_hw(*xm.shape[1:3]) == RGBT_GEOMETRY[role][1]
    with pytest.raises(NotImplementedError, match="synthesize"):
        pm.module.g_s(torch.zeros(1, 48, 1, 1))


@pytest.mark.parametrize("arch", ["guided", "master"])
def test_weight_round_trip(pair, arch):
    """The converted state dict has the port's keys (loads strict) and
    lmic_tpu's importer maps it back to the original params leaf for
    leaf."""
    jc, pc, params = ((pair["jg"], pair["pg"], pair["gp"]) if arch == "guided"
                      else (pair["jm"], pair["pm"], pair["mp"]))
    sd = state_dict_from_jax(arch, params)
    assert set(sd) == set(pc.module.state_dict())
    back = import_reference_state_dict(arch, sd, variables=jc.variables)
    flat_a = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back["params"])[0])
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)


def test_converter_refuses_leftover_params(pair):
    params = dict(pair["mp"])
    params["ch_aligner"] = dict(params["ch_aligner"],
                                Conv_6=params["ch_aligner"]["Conv_0"])
    with pytest.raises(ValueError, match="converted"):
        state_dict_from_jax("master", params)


# -- entry points ------------------------------------------------------------

def test_zoo_pair_geometry():
    for arch in ("guided", "master"):
        assert all(w == (192, 192) for w in tzoo.cfgs[arch].values())
        assert sorted(tzoo.cfgs[arch]) == list(range(1, 8))
    m1 = tzoo.make_module("master", 7, channel=1)
    m3 = tzoo.make_module("master", 7, channel=3)
    assert (m1.N, m1.M) == (192, 192)
    assert hasattr(m1.decoder, "downsample1")
    assert not hasattr(m3.decoder, "downsample1")
    assert (m1.downsampling_factor, m3.downsampling_factor) == (64, 128)
    assert any(k.startswith("decoder.downsample3.")
               for k in m1.state_dict())
    g = tzoo.make_module("guided", 7, first_stride=1, N=16, M=24)
    assert g.downsampling_factor == 32 and g.enc1.g_a_conv1.stride == (1, 1)
    with pytest.raises(TypeError, match="first_stride"):
        tzoo.make_module("master", 7, first_stride=1)


def test_create_model_draws_every_weight_from_the_seed(monkeypatch):
    a, b = (tzoo.create_model("master", 1, seed=4, channel=1, N=16, M=24,
                              device="cpu").module.state_dict()
            for _ in range(2))
    assert all(torch.equal(v, b[k]) for k, v in a.items())
    table = a["decoder.sp_aligner1.blocks.0.attn.relative_position_bias_table"]
    assert 0 < table.abs().max() <= 0.04
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        tzoo.create_model("guided", 1, N=16, M=24)


def test_cpu_pair_launches_no_kernel(pair):
    before = dict(gdn.LAUNCHES)
    pair["pg"].compress(pair["xg"], hidden=False, reconstruct=True)
    assert gdn.LAUNCHES == before
