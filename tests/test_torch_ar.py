"""The port's autoregressive codecs (mbt2018, cheng2020-anchor,
cheng2020-attn) against lmic_tpu on the CPU, on weights converted with
`state_dict_from_jax` and coding tables carried across.

Bars: the layers, transforms, likelihoods and the wavefront step's scales
and means within 1e-5 of the largest value, max|a-b| / max(1, max|b|)
(the bar of tests/test_pallas_gdn.py: f32 sums in another order by XLA
and by torch; with random weights cheng2020-attn's g_s reaches |x| ~ 150,
where both packages are ~1.5e-4 from the f64 result), scale indexes equal
at every step; strings byte-identical; each package
decodes the other's streams to the same latents (within 1e-5: a symbol
off by one would differ by 1); the port's decoder reproduces its
encoder's latents exactly; and the port reproduces lmic_tpu's frozen AR
wire (tests/expected/ar_mbt2018_golden.json)."""

import hashlib
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmic_tpu.entropy import coder as jrans
from lmic_tpu.layers import layers as jl
from lmic_tpu.models.joint import (
    JointARCodec as JJointARCodec,
)
from lmic_tpu.models.joint import (
    JointAutoregressiveHierarchicalPriors as JJoint,
)
from lmic_tpu.models.joint import make_wavefront_step as jax_step
from lmic_tpu.zoo.pretrained import import_reference_state_dict
from lmic_tpu_torch import layers as tl
from lmic_tpu_torch import zoo as tzoo
from lmic_tpu_torch.entropy import coder as trans
from lmic_tpu_torch.models.joint import (
    PAD,
    make_wavefront_step,
    wavefront_schedule,
)
from lmic_tpu_torch.ops import gdn
from lmic_tpu_torch.utils import checkpoint as ckpt
from lmic_tpu_torch.utils import train_cli, update_model_cli
from lmic_tpu_torch.utils.train import create_train_state, make_optimizer
from lmic_tpu_torch.zoo.convert import block_state_dict, state_dict_from_jax
from torch_port_helpers import (
    _perturb_gammas,
    carry_tables,
    jax_codec,
    jax_params,
    nchw,
    nhwc,
    pixels,
    port_codec,
)

torch.set_num_threads(2)

AR_ARCHS = ("mbt2018", "cheng2020-anchor", "cheng2020-attn")
WIDTH = 16  # N = M = 16: cheng2020 has M = N
TOL = 1e-5
SHAPES = {"square": (2, 64, 64, 3), "wide": (2, 64, 128, 3)}


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / max(1.0, np.abs(want).max())
    assert err < TOL, err


@pytest.fixture(scope="module", params=AR_ARCHS)
def pair(request):
    arch = request.param
    params = jax_params(arch, n=WIDTH, m=WIDTH)
    jc = jax_codec(arch, params, WIDTH, WIDTH)
    pc = carry_tables(jc, port_codec(arch, params, WIDTH, WIDTH))
    return arch, params, jc, pc


# -- layers ------------------------------------------------------------------

C_IN, C_OUT = 6, 8


def _masked(kind):
    return (jl.MaskedConv2d(C_OUT, mask_type=kind),
            tl.MaskedConv2d(C_IN, C_OUT, 5, kind), None)


LAYERS = {  # name -> (flax layer, port layer, block kind of the converter)
    "masked_conv_A": lambda: _masked("A"),
    "masked_conv_B": lambda: _masked("B"),
    "conv3x3_s2": lambda: (jl.conv3x3(C_OUT, stride=2),
                           tl.conv3x3(C_IN, C_OUT, 2), "conv"),
    "conv1x1": lambda: (jl.conv1x1(C_OUT), tl.conv1x1(C_IN, C_OUT), "conv"),
    "subpel_conv3x3": lambda: (jl.SubpelConv3x3(C_OUT, 2),
                               tl.SubpelConv3x3(C_IN, C_OUT, 2), "subpel"),
    "residual_block_with_stride": lambda: (
        jl.ResidualBlockWithStride(C_OUT, stride=2),
        tl.ResidualBlockWithStride(C_IN, C_OUT, 2), "rbs"),
    "residual_block_upsample": lambda: (
        jl.ResidualBlockUpsample(C_OUT, 2),
        tl.ResidualBlockUpsample(C_IN, C_OUT, 2), "rbu"),
    "residual_block_skip": lambda: (jl.ResidualBlock(C_OUT),
                                    tl.ResidualBlock(C_IN, C_OUT), "rb"),
    "residual_block": lambda: (jl.ResidualBlock(C_IN),
                               tl.ResidualBlock(C_IN, C_IN), "rb"),
    "attention_block": lambda: (jl.AttentionBlock(),
                                tl.AttentionBlock(C_IN), "attn"),
}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_matches_lmic_tpu(name):
    jlayer, tlayer, kind = LAYERS[name]()
    x = np.random.default_rng(3).standard_normal((2, 8, 12, C_IN)).astype(
        np.float32)
    params = jax.tree.map(np.asarray, jlayer.init(
        jax.random.key(5), jnp.asarray(x))["params"])
    _perturb_gammas(params, np.random.default_rng(4))
    if kind is None:  # the masked conv: the raw kernel, masked on use
        sd = {"weight": params["kernel"].transpose(3, 2, 0, 1),
              "bias": params["bias"]}
    else:
        sd = block_state_dict(kind, params)
    tlayer.load_state_dict({k: torch.from_numpy(np.array(v))
                            for k, v in sd.items()})
    want = jlayer.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = nhwc(tlayer(nchw(x)))
    assert got.shape == want.shape
    _close(got, want)


@pytest.mark.parametrize("k", [3, 5])
def test_conv_gemm_route_matches_conv2d(k):
    """The card's route for stride-1 convs without autograd (im2col +
    GEMM) against F.conv2d on the CPU: f32 sums in another order."""
    from lmic_tpu_torch.layers.layers import _conv_gemm

    g = torch.Generator().manual_seed(k)
    conv = tl.Conv(C_IN, C_OUT, k, 1)
    x = torch.randn((2, C_IN, 9, 13), generator=g).contiguous(
        memory_format=torch.channels_last)
    with torch.no_grad():
        got = _conv_gemm(x, conv.weight, conv.bias, conv.padding)
        _close(got, conv(x))
    assert conv._gemm_route and not tl.Conv(C_IN, C_OUT, 5, 2)._gemm_route


def test_pixel_shuffle_and_masks_are_lmic_tpu_s():
    x = np.random.default_rng(0).standard_normal((2, 3, 5, 12)).astype(
        np.float32)
    np.testing.assert_array_equal(
        nhwc(tl.pixel_shuffle(nchw(x), 2)), jl.pixel_shuffle(x, 2))
    for k in (3, 5, 7):
        for kind in ("A", "B"):
            np.testing.assert_array_equal(
                tl.make_causal_mask(k, k, kind).numpy(),
                jl.make_causal_mask(k, k, kind))
    with pytest.raises(ValueError, match="mask_type"):
        tl.make_causal_mask(5, 5, "C")


# -- models ------------------------------------------------------------------

def _apply(jc, *args, method):
    return jc.module.apply(jc.variables, *args,
                           method=getattr(type(jc.module), method))


def test_transforms_and_likelihoods(pair):
    _, _, jc, pc = pair
    x = np.random.default_rng(1).random(SHAPES["wide"]).astype(np.float32)
    y_j, z_j = _apply(jc, jnp.asarray(x), method="analyze")
    z_hat = np.round(np.asarray(z_j))
    p_j = _apply(jc, jnp.asarray(z_hat), method="hyper_to_params")
    x_j = _apply(jc, jnp.round(y_j), method="g_s")
    want = jc.module.apply(jc.variables, jnp.asarray(x), training=False)
    m = pc.module
    with torch.no_grad():
        y_t = m.g_a(nchw(x))
        z_t = m.h_a(nchw(np.asarray(y_j)))
        p_t = m.hyper_to_params(nchw(z_hat))
        x_t = m.g_s(torch.round(nchw(np.asarray(y_j))))
        got = m(nchw(x), training=False)
    for a, b in ((y_t, y_j), (z_t, z_j), (p_t, p_j), (x_t, x_j),
                 (got["x_hat"], want["x_hat"])):
        _close(nhwc(a), b)
    assert p_t.shape[1] == 2 * m.M  # hyper params stay unsplit
    for k, v in want["likelihoods"].items():
        _close(nhwc(got["likelihoods"][k]), v)


def test_training_forward(pair):
    _, _, _, pc = pair
    x = nchw(np.random.default_rng(2).random(SHAPES["square"]).astype(
        np.float32))
    with torch.no_grad():
        out = pc.module(x, training=True,
                        generator=torch.Generator().manual_seed(0))
    assert out["x_hat"].shape == x.shape
    for lik in out["likelihoods"].values():
        assert torch.all(lik > 0) and torch.all(lik <= 1)


def test_wavefront_step_every_step(pair):
    """The step on lmic_tpu's encoder state (its final buffer holds every
    wavefront's causal context): the schedule equal, scales and means
    within 1e-5, indexes equal, at every step."""
    _, _, jc, pc = pair
    x = np.random.default_rng(6).random((1, 64, 128, 3)).astype(np.float32)
    y, z = _apply(jc, jnp.asarray(x), method="analyze")
    med = jc.eb_state.medians.reshape(1, 1, 1, -1)
    z_hat = jnp.asarray(np.round(np.asarray(z) - med) + med)
    params = jc._params_on_scan_device(z_hat)[0]
    H, W, M = y.shape[1:]
    _, _, _, y_hat_pad = jc._get_encode_scan(H, W)(y[0], params)
    prepare_j, step_j = jax_step(jc.module, jc.variables, H, W,
                                 jc.gc_state.scale_table)
    step_j = jax.jit(step_j)
    pre1_j = prepare_j(params)

    sched = wavefront_schedule(H, W, "cpu")
    prepare_t, step_t = make_wavefront_step(pc.module, sched,
                                            pc.gc_state.scale_table)
    buf = torch.from_numpy(np.array(y_hat_pad).reshape(-1, M))
    with torch.no_grad():
        pre1_t = prepare_t(nchw(np.asarray(params)[None]))
        _close(pre1_t.reshape(H, W, -1), pre1_j)
        for t in range(sched.T):
            h, w, valid, s_j, m_j, i_j = step_j(t, y_hat_pad, pre1_j)
            np.testing.assert_array_equal(sched.pix[t].numpy(), h * W + w)
            np.testing.assert_array_equal(sched.valid[t], valid)
            lo, hi = sched.lo[t], sched.hi[t]
            assert valid[lo:hi].all() and valid.sum() == hi - lo
            s_t, m_t, i_t = step_t(t, buf, pre1_t)
            _close(s_t, s_j)
            _close(m_t, m_j)
            np.testing.assert_array_equal(i_t.numpy(), i_j)


# -- the wire ----------------------------------------------------------------

@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_strings_byte_identical(pair, shape):
    _, _, jc, pc = pair
    x = pixels(SHAPES[shape])
    want, got = jc.compress(x), pc.compress(x)
    assert tuple(got["shape"]) == tuple(want["shape"])
    assert got["strings"] == want["strings"]


def test_cross_decode_both_ways(pair):
    _, _, jc, pc = pair
    x = pixels((2, 128, 64, 3), seed=1)
    from_jax, from_port = jc.compress(x), pc.compress(x)
    for enc in (from_jax, from_port):
        with torch.inference_mode():
            y_t = pc._decode_y_hat(enc["strings"], enc["shape"])
        y_j = jc._decode_y_hat(enc["strings"], list(enc["shape"]))
        _close(nhwc(y_t), y_j)
        # the pixels: g_s of those latents, clipped; with random weights
        # g_s reaches |x| ~ 150 before the clip, so a rounding edge may
        # flip one level
        got = pc.decompress(enc["strings"], enc["shape"], u8=True)["x_hat"]
        want = np.asarray(jc.decompress(enc["strings"], list(enc["shape"]),
                                        u8=True)["x_hat"])
        assert got.shape == want.shape and got.dtype == want.dtype
        assert np.abs(got.astype(int) - want).max() <= 1


def test_decode_reproduces_encoder_y_hat(pair):
    """Bit-exact AR consistency: the decoder's latents are the encoder's."""
    _, _, _, pc = pair
    x = pixels(SHAPES["wide"], seed=4)
    with torch.inference_mode():
        ys, z_sym = pc._analyze(x)
        enc = pc._code_y_z(ys, z_sym, keep_y_hat=True)
        dec = pc._decode_y_hat(enc["strings"], enc["shape"])
    assert enc["strings"] == pc.compress(x)["strings"]
    assert torch.equal(dec, enc["y_hat_latent"])
    rec = pc.decompress(enc["strings"], enc["shape"], u8=True)["x_hat"]
    assert rec.shape == x.shape and rec.dtype == np.uint8


def test_batch_composition_invariance(pair):
    _, _, _, pc = pair
    x = pixels((3, 64, 64, 3), seed=2)
    whole = pc.compress(x)["strings"]
    for i in range(x.shape[0]):
        one = pc.compress(x[i:i + 1])["strings"]
        assert [g[0] for g in one] == [g[i] for g in whole]


def test_truncated_stream_fails_safe(pair):
    """A truncated y stream decodes to finite (garbage) pixels without a
    hang or an overread, and the codec stays usable."""
    _, _, _, pc = pair
    x = pixels(SHAPES["square"], seed=13)
    out = pc.compress(x)
    bad = [[out["strings"][0][0][:8], out["strings"][0][1]],
           out["strings"][1]]
    assert np.isfinite(pc.decompress(bad, out["shape"])["x_hat"]).all()
    rec = pc.decompress(out["strings"], out["shape"], u8=True)["x_hat"]
    assert rec.shape == x.shape


def test_weight_round_trip(pair):
    arch, params, jc, pc = pair
    sd = state_dict_from_jax(arch, params)
    assert set(sd) == set(pc.module.state_dict())
    back = import_reference_state_dict(arch, sd, variables=jc.variables)
    flat_a = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back["params"])[0])
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)


def test_buffered_encoder_matches_lmic_tpu(pair):
    _, _, jc, pc = pair
    rng = np.random.default_rng(8)
    table_j, table_t = jc.gc_state.table, pc.gc_state.table
    enc_j, enc_t = jrans.BufferedRansEncoder(), trans.BufferedRansEncoder()
    chunks = []
    for n in (1, 37, 300, 5):
        idx = rng.integers(0, len(table_t.cdf), n).astype(np.int32)
        sym = rng.integers(-40, 40, n).astype(np.int32)  # escapes too
        chunks.append((sym, idx))
        enc_j.encode_with_indexes(sym, idx, table_j)
        enc_t.encode_with_indexes(sym, idx, table_t)
    stream = enc_t.flush()
    assert stream == enc_j.flush()
    dec = trans.RansDecoder()
    dec.set_stream(stream)
    for sym, idx in chunks:
        np.testing.assert_array_equal(dec.decode_stream(idx, table_t), sym)
    with pytest.raises(ValueError, match="same size"):
        enc_t.encode_with_indexes(sym, idx[:-1], table_t)


def test_port_reproduces_frozen_ar_wire():
    """lmic_tpu's golden AR codec (tests/test_joint.py: N=32, M=48, key 0)
    carried across with its tables codes the golden input to the md5s of
    tests/expected/ar_mbt2018_golden.json."""
    module = JJoint(N=32, M=48)
    v = module.init({"params": jax.random.key(0), "noise": jax.random.key(1)},
                    jnp.zeros((1, 64, 64, 3)))
    jc = JJointARCodec(module, v)
    jc.update(force=True)
    params = jax.tree.map(np.asarray, v["params"])
    pc = carry_tables(jc, tzoo.create_model(
        "mbt2018", 1, device="cpu", N=32, M=48,
        state_dict=state_dict_from_jax("mbt2018", params)))
    x = np.asarray(jax.random.uniform(jax.random.key(12), (2, 64, 64, 3)))
    out = pc.compress(x)
    got = {
        "y_md5": [hashlib.md5(s).hexdigest() for s in out["strings"][0]],
        "z_md5": [hashlib.md5(s).hexdigest() for s in out["strings"][1]],
        "shape": [int(v) for v in out["shape"]],
    }
    path = Path(__file__).parent / "expected" / "ar_mbt2018_golden.json"
    assert got == json.loads(path.read_text())


# -- entry points ------------------------------------------------------------

@pytest.mark.parametrize("arch", AR_ARCHS)
def test_create_model_needs_cuda_or_explicit_cpu(arch, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        tzoo.create_model(arch, 1, N=WIDTH, M=WIDTH)
    codec = tzoo.create_model(arch, 1, N=WIDTH, M=WIDTH, device="cpu")
    assert codec.device.type == "cpu"
    m = tzoo.make_module(arch, 1)  # the quality table's widths
    assert (m.N, m.M) == ((192, 192) if arch == "mbt2018" else (128, 128))


def test_cpu_round_trip_launches_no_kernel():
    before = dict(gdn.LAUNCHES)
    pc = tzoo.create_model("cheng2020-anchor", 1, device="cpu", N=WIDTH)
    pc.update()
    x = pixels((1, 64, 64, 3))
    assert pc.decompress(**pc.compress(x))["x_hat"].shape == x.shape
    assert gdn.LAUNCHES == before


def test_train_cli_refuses_and_update_model_cli_finalizes(tmp_path):
    # train_cli trains the AR archs (tests/test_torch_train_ar.py) and
    # their '_R' variants in f32 (tests/test_torch_rgbt_joint.py); '_D'
    # has no training recipe, and '_R' is not among the AMP archs, as in
    # lmic_tpu
    for arch in AR_ARCHS:
        for args, why in (([arch + "_D"], "no standalone training recipe"),
                          ([arch + "_R", "--amp"], "--amp supports")):
            with pytest.raises(SystemExit, match=why):
                train_cli.main(["-d", str(tmp_path), "--device", "cpu",
                                "--arch", *args])
    # update_model_cli builds the quality table's widths: N = M = 192
    path = tmp_path / "train.ckpt"
    wide = tzoo.make_module("mbt2018", 1)
    ckpt.save_checkpoint(str(path), create_train_state(wide,
                                                       make_optimizer()))
    out = update_model_cli.run([str(path), "-a", "mbt2018", "-q", "1",
                                "-d", str(tmp_path / "final"),
                                "--device", "cpu"])
    codec = ckpt.load_updated_model(
        out, tzoo.create_model("mbt2018", 1, device="cpu", seed=3))
    for k, v in wide.state_dict().items():
        assert torch.equal(v, codec.module.state_dict()[k]), k
    x = pixels((1, 64, 64, 3))
    assert codec.decompress(**codec.compress(x))["x_hat"].shape == x.shape


def test_wavefront_counts():
    assert PAD == 2
    sched = wavefront_schedule(4, 8, "cpu")
    assert (sched.T, sched.R) == (3 * 4 + 8 - 3, 4)
    # Kodak 512x768: a 32x48 latent, 141 wavefronts of 17 rows
    kodak = wavefront_schedule(32, 48, "cpu")
    assert (kodak.T, kodak.R) == (141, 17)
    assert int(sum(kodak.hi - kodak.lo)) == 32 * 48
