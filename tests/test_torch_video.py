"""ssf2020's modules in the port against lmic_tpu's, on the CPU: the
scale-space ops (f32, 1e-6; the warp also against 5-D `F.grid_sample`),
QReLU and its surrogate gradient, the training forward over a 3-frame GOP
with the same quantization noise on both sides, the aux loss, one MSE
gradient, the weight converter both ways, and the raw-video and clip
loaders. The codec's strings are in tests/test_torch_video_codec.py."""

from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from lmic_tpu import datasets as jds
from lmic_tpu.layers import qrelu as jqrelu
from lmic_tpu.ops import video as jops
from lmic_tpu.zoo.pretrained import _import_ssf2020
from lmic_tpu_torch import datasets as tds
from lmic_tpu_torch.layers import qrelu
from lmic_tpu_torch.ops import video as tops
from lmic_tpu_torch.zoo.convert import state_dict_from_jax
from torch_port_helpers import (
    VIDEO_GOP,
    nchw,
    nhwc,
    patch_same_noise,
    video_codecs,
)

torch.set_num_threads(2)

OPS_TOL = 1e-6


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _images(shape, seed):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


# -- ops ----------------------------------------------------------------------

@pytest.mark.parametrize("k,sigma", [(11, 1.5), (7, 0.7), (17, 2.3)])
def test_gaussian_kernels_match_lmic_tpu(k, sigma):
    for name in ("gaussian_kernel1d", "gaussian_kernel2d"):
        got = getattr(tops, name)(k, sigma).numpy()
        want = np.asarray(getattr(jops, name)(k, sigma))
        assert got.shape == want.shape and _rel(got, want) < OPS_TOL, name


@pytest.mark.parametrize("op,shape", [
    ("gaussian_blur", (2, 16, 20, 3)), ("avg_pool2x2", (1, 8, 12, 2)),
    ("upsample2x_bilinear", (1, 5, 7, 2))])
def test_image_ops_match_lmic_tpu(op, shape):
    x = _images(shape, seed=len(op))
    args_t, args_j = [nchw(x)], [jnp.asarray(x)]
    if op == "gaussian_blur":
        args_t.append(tops.gaussian_kernel2d(11, 1.5))
        args_j.append(jops.gaussian_kernel2d(11, 1.5))
    got = nhwc(getattr(tops, op)(*args_t))
    want = np.asarray(getattr(jops, op)(*args_j))
    assert got.shape == want.shape and _rel(got, want) < OPS_TOL


def test_gaussian_volume_matches_lmic_tpu():
    x = _images((1, 32, 48, 3), seed=5)
    got = tops.gaussian_volume(nchw(x), 1.5, 5)
    want = np.asarray(jops.gaussian_volume(jnp.asarray(x), 1.5, 5))
    assert got.shape == (1, 3, 6, 32, 48)
    got = got.permute(0, 2, 3, 4, 1).numpy()  # lmic_tpu's (N, D, H, W, C)
    np.testing.assert_array_equal(got[:, 0], x)
    assert _rel(got, want) < OPS_TOL


def test_base_grid_matches_lmic_tpu():
    for got, want in zip(tops.base_grid(6, 10), jops.base_grid(6, 10)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _warp_inputs(seed, N=2, D=6, H=8, W=10, C=3, reach=1.6):
    """A volume, a flow that reaches past the border and a scale field
    past both depth ends, with exact -1 and 1 depths in the first row."""
    rng = np.random.default_rng(seed)
    vol = rng.random((N, C, D, H, W), dtype=np.float32)
    flow = ((rng.random((N, 2, H, W)) - 0.5) * reach).astype(np.float32)
    scale = ((rng.random((N, 1, H, W)) - 0.5) * 2.6).astype(np.float32)
    scale[:, :, 0, :W // 2] = -1.0
    scale[:, :, 0, W // 2:] = 1.0
    return vol, flow, scale


@pytest.mark.parametrize("seed", [0, 1])
def test_warp_volume_matches_lmic_tpu_and_grid_sample(seed):
    vol, flow, scale = _warp_inputs(seed)
    got = tops.warp_volume(*map(torch.from_numpy, (vol, flow, scale)))
    want = np.asarray(jops.warp_volume(
        jnp.asarray(vol.transpose(0, 2, 3, 4, 1)),
        jnp.asarray(flow.transpose(0, 2, 3, 1)),
        jnp.asarray(scale.transpose(0, 2, 3, 1))))
    assert _rel(nhwc(got), want) < OPS_TOL
    # 5-D grid_sample on the same grid (reference video/google.py:357-375)
    N, C, D, H, W = vol.shape
    theta = torch.eye(2, 3).unsqueeze(0).expand(N, 2, 3)
    grid = F.affine_grid(theta, (N, C, H, W), align_corners=False)
    grid = torch.cat([grid + torch.from_numpy(flow).permute(0, 2, 3, 1),
                      torch.from_numpy(scale).permute(0, 2, 3, 1)], -1)
    ref = F.grid_sample(torch.from_numpy(vol), grid.unsqueeze(1),
                        mode="bilinear", padding_mode="border",
                        align_corners=False)[:, :, 0]
    assert (got - ref).abs().max().item() < 1e-5


def test_warp_at_the_depth_ends_and_identity():
    """Zero flow at depth -1 reads level 0, at depth 1 the last level."""
    vol, _, _ = _warp_inputs(2, N=1)
    flow = torch.zeros(1, 2, 8, 10)
    for z, level in ((-1.0, 0), (1.0, -1)):
        got = tops.warp_volume(torch.from_numpy(vol), flow,
                               torch.full((1, 1, 8, 10), z))
        np.testing.assert_allclose(got.numpy(), vol[:, :, level],
                                   atol=1e-6)


def test_scale_space_warp_matches_lmic_tpu():
    x = _images((1, 32, 32, 3), seed=7)
    vol, flow, scale = _warp_inputs(3, N=1, H=32, W=32)
    got = tops.scale_space_warp(nchw(x), torch.from_numpy(flow),
                                torch.from_numpy(scale), 1.5, 5)
    want = jops.scale_space_warp(
        jnp.asarray(x), jnp.asarray(flow.transpose(0, 2, 3, 1)),
        jnp.asarray(scale.transpose(0, 2, 3, 1)), 1.5, 5)
    assert _rel(nhwc(got), want) < OPS_TOL


# -- qrelu ----------------------------------------------------------------

def test_qrelu_and_its_gradient_match_lmic_tpu():
    rng = np.random.default_rng(8)
    x = np.concatenate([rng.uniform(-40, 300, 4000),
                        [-1e-3, 0.0, 1e-3, 254.999, 255.0, 255.001]]
                       ).astype(np.float32)
    g = rng.normal(size=x.shape).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = qrelu(xt)
    np.testing.assert_array_equal(y.detach().numpy(),
                                  np.asarray(jqrelu(jnp.asarray(x))))
    (y * torch.from_numpy(g)).sum().backward()
    want = np.asarray(jax.grad(
        lambda v: jnp.sum(jqrelu(v) * jnp.asarray(g)))(jnp.asarray(x)))
    outside = (x < 0) | (x > 255)
    assert outside.sum() > 100 and (~outside).sum() > 100
    got = xt.grad.numpy()
    np.testing.assert_array_equal(got[~outside], want[~outside])
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-6


# -- the module -------------------------------------------------------------

@pytest.fixture(scope="module")
def codecs():
    return video_codecs(0)


def _gop(seed=4):
    return (np.random.default_rng(seed).random(VIDEO_GOP)
            .astype(np.float32))


def _frames_nchw(x):
    return torch.from_numpy(x).permute(0, 1, 4, 2, 3)


def _jax_forward(jc, params, x):
    return jc.module.apply({"params": params}, jnp.asarray(x),
                           training=True,
                           rngs={"noise": jax.random.key(0)})


def test_training_forward_matches_lmic_tpu(codecs, monkeypatch):
    """x_hat and every likelihood of a 3-frame GOP, with the same noise
    on both sides, to 1e-5 of each tensor's largest value."""
    jc, pc, params = codecs
    patch_same_noise(monkeypatch)
    x = _gop()
    want = _jax_forward(jc, params, x)
    with torch.no_grad():
        got = pc.module(_frames_nchw(x), training=True)
    assert got["x_hat"].shape == (1, 3, 3, 128, 128)
    assert _rel(got["x_hat"].permute(0, 1, 3, 4, 2).numpy(),
                want["x_hat"]) < 1e-5
    assert len(got["likelihoods"]) == len(want["likelihoods"]) == 3
    for g_frame, w_frame in zip(got["likelihoods"], want["likelihoods"]):
        assert set(g_frame) == set(w_frame)
        for part, group in w_frame.items():
            for k, w in group.items():
                g = g_frame[part][k]
                assert (g > 0).all(), (part, k)
                assert _rel(nhwc(g), w) < 1e-5, (part, k)


def test_aux_loss_matches_lmic_tpu(codecs):
    jc, pc, params = codecs
    want = float(jc.module.apply({"params": params},
                                 method=type(jc.module).aux_loss))
    got = pc.module.aux_loss().item()
    assert np.isfinite(got) and abs(got - want) <= 1e-5 * abs(want)


def test_mse_gradient_matches_lmic_tpu(codecs, monkeypatch):
    """The gradient of the GOP's MSE, every leaf to 1e-3 of its largest
    value (the f32 bar of tests/test_torch_train.py). The MSE reaches the
    48 leaves of the encoders and decoders; the hyperpriors get none
    (`ste_round(y - means) + means` passes no gradient to the means): no
    gradient in the port, zero in lmic_tpu."""
    jc, _, params = codecs
    patch_same_noise(monkeypatch)
    x = _gop(seed=6)[:, :2]

    def loss_fn(p):
        out = jc.module.apply({"params": p}, jnp.asarray(x), training=True,
                              rngs={"noise": jax.random.key(0)})
        return jnp.mean((out["x_hat"] - x) ** 2)

    want_loss, want_g = jax.value_and_grad(loss_fn)(
        jax.tree.map(jnp.asarray, params))
    want_g = state_dict_from_jax("ssf2020", jax.tree.map(np.asarray, want_g))
    module = type(codecs[1].module)()
    module.load_state_dict(state_dict_from_jax("ssf2020", params))
    frames = _frames_nchw(x)
    out = module(frames, training=True)
    loss = torch.mean((out["x_hat"] - frames) ** 2)
    loss.backward()
    assert abs(loss.item() - float(want_loss)) <= 1e-5 * float(want_loss)
    got_g = dict(module.named_parameters())
    assert set(got_g) == set(want_g)
    n_grads = 0
    for name, want in want_g.items():
        got = got_g[name].grad
        scale = want.abs().max().item()
        if got is None or scale == 0:
            assert scale == 0 and (got is None or not got.any()), name
            continue
        n_grads += 1
        assert (got - want).abs().max().item() / scale < 1e-3, name
    assert n_grads == 48


def test_state_dict_converts_both_ways(codecs):
    """The converter's keys are the module's, and lmic_tpu's importer of
    CompressAI keys gives the original params back exactly."""
    _, pc, params = codecs
    sd = state_dict_from_jax("ssf2020", params)
    assert set(sd) == set(pc.module.state_dict())
    back = _import_ssf2020({k: v.numpy() for k, v in sd.items()})
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)
    params = jax.tree.map(np.copy, params)  # the fixture's stays whole
    del params["img_encoder"]["Conv_0"]
    with pytest.raises(KeyError):
        state_dict_from_jax("ssf2020", params)


# -- datasets ----------------------------------------------------------------

def _plain(info):
    return {k: (v.value if k == "format" else v) for k, v in info.items()}


# the port's framerate of each name. lmic_tpu reads the first run of digits
# in the whole path as the framerate (the width in each name here but the
# last, "64" or "1920"), so only "clip_30fps.yuv" holds the port to
# lmic_tpu's framerate; every other key is held to lmic_tpu's on every name.
FRAMERATES = {
    "seq_64x32_30fps_420_8bit.yuv": Fraction(30),
    "BasketballDrive_1920x1080_50.yuv": Fraction(50),
    "a_416x240_29.97fps_yuv444p10le.yuv": Fraction(30000, 1001),
    "b_352x288_23.976_444_10bit.yuv": Fraction(24000, 1001),
    "c_32x16_60Hz_yuv400.yuv": Fraction(60),
    "d_64x48.yuv": None,
    "seq_64x32_420_8bit.yuv": None,
    "clip_30fps.yuv": Fraction(30),
}


@pytest.mark.parametrize("name", list(FRAMERATES))
def test_raw_video_file_info_matches_lmic_tpu(name):
    got = tds.get_raw_video_file_info(name)
    want = jds.get_raw_video_file_info(name)
    assert got.pop("framerate", None) == FRAMERATES[name]
    if name == "clip_30fps.yuv":
        assert want["framerate"] == FRAMERATES[name]
    want.pop("framerate", None)
    assert _plain(got) == _plain(want)


@pytest.mark.parametrize("path,want", [
    ("/data/2024/run_3/e_64x48_25fps.yuv",
     {"width": 64, "height": 48, "framerate": Fraction(25)}),
    ("/tmp/pytest-7/popen-gw2/clip_128x128_30_yuv420.yuv",
     {"width": 128, "height": 128, "framerate": Fraction(30),
      "format": "yuv420"}),
    ("/data/1080x720/30fps/clip.yuv", {})])
def test_raw_video_file_info_reads_the_basename(path, want):
    """Digits in a directory are neither a size nor a framerate: the video
    eval's kbps moved with the directory it ran in."""
    assert _plain(tds.get_raw_video_file_info(path)) == want


@pytest.mark.parametrize("name,frame_bytes", [
    ("seq_64x32_30fps_420_8bit.yuv", 64 * 32 * 3 // 2),
    ("seq_32x16_25fps_yuv444_10bit.yuv", 32 * 16 * 3 * 2)])
def test_raw_video_sequence_matches_lmic_tpu(tmp_path, name, frame_bytes):
    path = tmp_path / name
    data = np.random.default_rng(9).integers(0, 256, 3 * frame_bytes,
                                             dtype=np.uint8)
    path.write_bytes(data.tobytes())
    ours = tds.RawVideoSequence.from_file(str(path))
    theirs = jds.RawVideoSequence.from_file(str(path))
    assert len(ours) == len(theirs) == 3
    # the name's framerate; lmic_tpu's comes from the first digits of the
    # temporary directory's path
    assert ours.framerate == {"seq_64x32_30fps_420_8bit.yuv": 30,
                              "seq_32x16_25fps_yuv444_10bit.yuv": 25}[name]
    for i in range(3):
        for plane in ("y", "u", "v"):
            np.testing.assert_array_equal(ours[i][plane], theirs[i][plane])
    ours.close()
    with pytest.raises(ValueError):
        tds.RawVideoSequence.from_file(str(tmp_path / "nosize.yuv"))


@pytest.fixture(scope="module")
def clip_root(tmp_path_factory):
    from PIL import Image

    root = tmp_path_factory.mktemp("vimeo")
    rng = np.random.default_rng(10)
    clips = ["00001/0001", "00001/0002", "00002/0001"]
    for clip in clips:
        d = root / "sequences" / clip
        d.mkdir(parents=True)
        for i in range(1, 8):
            arr = (rng.random((40, 56, 3)) * 255).astype(np.uint8)
            Image.fromarray(arr).save(d / f"im{i}.png")
    (root / "sep_trainlist.txt").write_text("\n".join(clips) + "\n")
    (root / "sep_testlist.txt").write_text(clips[0] + "\n")
    return root


@pytest.mark.parametrize("split,train,interval,order", [
    ("train", True, True, True), ("train", True, False, False),
    ("test", False, False, False)])
def test_video_folder_matches_lmic_tpu(clip_root, split, train, interval,
                                       order):
    kw = dict(rnd_interval=interval, rnd_temp_order=order, split=split,
              patch_size=(32, 24), train=train, seed=3)
    ours, theirs = tds.VideoFolder(clip_root, **kw), \
        jds.VideoFolder(clip_root, **kw)
    assert len(ours) == len(theirs) == (3 if train else 1)
    for _ in range(2):
        for i in range(len(ours)):
            a, b = ours[i], theirs[i]
            assert a.shape == (3, 32, 24, 3) and a.dtype == np.float32
            np.testing.assert_array_equal(a, b)
    with pytest.raises(RuntimeError):
        tds.VideoFolder(clip_root / "sequences")
