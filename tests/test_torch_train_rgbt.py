"""The paper's two-stage RGB-T training recipe in the port against
lmic_tpu's on the CPU, at `rgbt_pair`'s widths (N = 32, M = 48) and
geometry: the guide's step (`guided`) in f32, f64 and bf16 AMP, the
master's step against a frozen guide (lmic_tpu's
`make_master_train_step`) in f32 and f64 for both roles, the FLIR loaders
element for element, and `train_cli`'s two stages on seeded PNG trees in
FLIR's `RGB/` and `thermal_8_bit/` layout.

The noise: `torch_port_helpers.patch_same_noise` (see there)."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch_port_helpers import (
    RGBT_GEOMETRY,
    RGBT_M,
    RGBT_N,
    patch_same_noise,
    pixels,
    rgbt_pair,
    write_images,
)

from lmic_tpu import datasets as jds
from lmic_tpu import zoo as jzoo
from lmic_tpu.utils import train as jtrain
from lmic_tpu.utils import train_cli as jcli
from lmic_tpu_torch import datasets as tds
from lmic_tpu_torch import zoo as tzoo
from lmic_tpu_torch.datasets import image as timage
from lmic_tpu_torch.utils import checkpoint as ckpt
from lmic_tpu_torch.utils import train as ttrain
from lmic_tpu_torch.utils import train_cli
from lmic_tpu_torch.zoo.convert import state_dict_from_jax

torch.set_num_threads(2)
LMBDA = 1024.0
LOSSES = ("loss", "mse_loss", "bpp_loss", "aux_loss")
ROLES = (1, 3)
WIDTHS = dict(N=RGBT_N, M=RGBT_M)
# the layers with parameters that stay f32 under AMP
F32_LAYERS = ("context_prediction", "entropy_parameters",
              "entropy_bottleneck")
# the f64 bar of the guide's and the master's gradients: lmic_tpu's guide
# casts y, x_hat and its hidden maps to f32 whatever the params' dtype
# (`.astype(jnp.float32)`, lmic_tpu/models/rgbt.py:430-460), and the master
# reads them; the port's `from_amp` keeps f64. Measured: 7.9e-7 of a leaf's
# largest value (the guide's h_a.2.weight), 5.7e-8 (the master)
F64_BAR = 1e-5
# lmic_tpu's bf16 step rounds every op's output to bf16, as torch does
# (XLA otherwise keeps fused elementwise intermediates in f32)
ROUND_EVERY_OP = {"xla_allow_excess_precision": False}


@pytest.fixture()
def same_noise(monkeypatch):
    patch_same_noise(monkeypatch)


def _f64(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float64), tree)


def _port(arch, params, channel, dtype=np.float32, compute=None):
    module = tzoo.make_module(arch, 1, channel=channel, dtype=compute,
                              **WIDTHS)
    module.load_state_dict(state_dict_from_jax(arch, params))
    return module.to(torch.float64 if dtype == np.float64 else
                     torch.float32).to(memory_format=torch.channels_last)


def _nchw(a):
    return torch.from_numpy(np.asarray(a)).permute(0, 3, 1, 2)


def _batches(role, dtype=np.float32):
    """A batch of 2 seeded (master, guide) pairs of `role`, in [0, 1]."""
    (mH, mW), (gH, gW) = RGBT_GEOMETRY[role]
    return ((pixels((2, mH, mW, role), seed=5) / 255.0).astype(dtype),
            (pixels((2, gH, gW, 4 - role), seed=6) / 255.0).astype(dtype))


def _check_grads(got_g, want_g, bar):
    assert set(got_g) == set(want_g)
    for name, want in want_g.items():
        got = got_g[name]
        assert got is not None and got.dtype == want.dtype, name
        scale = want.abs().max().item()
        if scale == 0:  # the quantiles' share of the RD loss
            assert got.abs().max().item() == 0, name
            continue
        err = (got - want).abs().max().item() / scale
        assert err < bar, (name, err, bar)


def _check_losses(got_m, want_m, bar):
    for k in LOSSES:
        assert abs(got_m[k] - want_m[k]) <= bar * abs(want_m[k]), k


# ---------------------------------------------------------------------------
# the guide's step
# ---------------------------------------------------------------------------


def _guided_jax(params, batch, channel, compute=None, options=None):
    module = jzoo.make_module("guided", 1, channel=channel, dtype=compute,
                              **WIDTHS)

    def loss_fn(p):
        out = module.apply({"params": p}, batch, training=True,
                           rngs={"noise": jax.random.key(0)})
        rd = jtrain.rate_distortion_loss(out, batch, LMBDA)
        aux = module.apply({"params": p}, method=type(module).aux_loss)
        return rd["loss"] + aux, {**rd, "aux_loss": aux}

    params = jax.tree.map(jnp.asarray, params)
    step = jax.jit(jax.grad(loss_fn, has_aux=True)).lower(params)
    grads, metrics = step.compile(compiler_options=options or {})(params)
    return ({k: float(v) for k, v in metrics.items()},
            state_dict_from_jax("guided", jax.tree.map(np.asarray, grads)))


def _guided_port(params, batch, channel, dtype=np.float32, compute=None):
    module = _port("guided", params, channel, dtype, compute)
    x = _nchw(batch)
    loss, metrics = ttrain.rd_aux_loss(module, module(x, training=True), x,
                                       LMBDA)
    loss.backward()
    return ({k: v.item() for k, v in metrics.items()},
            {n: p.grad for n, p in module.named_parameters()})


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
def test_guided_step_matches_lmic_tpu(dtype, same_noise):
    """The guide (an RGB guide of the channel-1 master, 128x128, first
    conv at stride 2): losses to 1e-5 relative, every gradient leaf to
    1e-3 of its largest value in f32 (measured at most 1.3e-5) and to
    F64_BAR in f64."""
    params = rgbt_pair(1)[0][2]
    batch = _batches(1, dtype)[1]
    enabled = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", dtype == np.float64)
    try:
        if dtype == np.float64:
            params = _f64(params)
        want_m, want_g = _guided_jax(params, jnp.asarray(batch), 3)
    finally:
        jax.config.update("jax_enable_x64", enabled)
    got_m, got_g = _guided_port(params, batch, 3, dtype)
    _check_losses(got_m, want_m, 1e-5)
    _check_grads(got_g, want_g, 1e-3 if dtype == np.float32 else F64_BAR)


def _rel_fro(a, b):
    return ((a.double() - b.double()).norm() / b.double().norm()).item()


@pytest.mark.parametrize("role", ROLES, ids=["rgb_guide", "thermal_guide"])
def test_guided_amp_step_matches_lmic_tpu_bf16(role, same_noise):
    """The guide's bf16 AMP step against lmic_tpu's bf16 model compiled
    with ROUND_EVERY_OP, with the bars of tests/test_torch_train_ar.py:
    losses to 2e-3 relative, every leaf no further from lmic_tpu's f32
    gradient (relative Frobenius norm) than 2e-2 plus 2 times lmic_tpu's
    own bf16 gradient is, a bf16 layer's bias measured against that
    layer's weight. Measured: losses within 3.6e-5, leaves at most 0.48 of
    the bar (h_a.0). The hidden maps the master reads come out f32."""
    params = rgbt_pair(role)[0][2]
    batch = _batches(role)[1]
    channel = 4 - role
    want_m, want_g = _guided_jax(params, jnp.asarray(batch), channel,
                                 jnp.bfloat16, ROUND_EVERY_OP)
    _, f32_g = _guided_jax(params, jnp.asarray(batch), channel)
    module = _port("guided", params, channel, compute=torch.bfloat16)
    with torch.no_grad():
        out = module(_nchw(batch), training=True)
    assert all(v.dtype == torch.float32 for v in
               [out["x_hat"], *out["hidden"].values(),
                *out["likelihoods"].values()])
    got_m, got_g = _guided_port(params, batch, channel,
                                compute=torch.bfloat16)
    _check_losses(got_m, want_m, 2e-3)
    for name, ref in f32_g.items():
        got = got_g[name]
        assert got is not None and got.dtype == torch.float32, name
        if ref.abs().max().item() == 0:
            assert got.abs().max().item() == 0, name
            continue
        own = name
        if name.endswith(".bias") and not name.startswith(F32_LAYERS):
            own = name[:-len("bias")] + "weight"
        bar = 2e-2 + 2 * _rel_fro(want_g[own], f32_g[own])
        err = _rel_fro(got, ref)
        assert err < bar, (name, err, bar)


# ---------------------------------------------------------------------------
# the master's step against the frozen guide
# ---------------------------------------------------------------------------


def _capture():
    """An optax transformation that keeps the last gradients as its state
    and moves nothing: the gradients of lmic_tpu's master step."""
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))


def _master_jax(role, gparams, mparams, xm, xg):
    jm = jzoo.make_module("master", 1, channel=role, **WIDTHS)
    jg = jzoo.make_module("guided", 1, channel=4 - role, **WIDTHS)
    opt = _capture()
    state = jtrain.create_train_state(jax.tree.map(jnp.asarray, mparams),
                                      opt)
    step = jcli.make_master_train_step(
        jm, jg, jax.tree.map(jnp.asarray, gparams), opt, LMBDA)
    state, metrics = step(state, jnp.asarray(xm), jnp.asarray(xg),
                          jax.random.key(0))
    return ({k: float(v) for k, v in metrics.items()},
            state_dict_from_jax("master",
                                jax.tree.map(np.asarray, state.opt_state)))


def _master_port(role, gparams, mparams, xm, xg, dtype=np.float32):
    guide = _port("guided", gparams, 4 - role, dtype)
    guide.eval().requires_grad_(False)
    master = _port("master", mparams, role, dtype)
    # lr 0 and no clip: the step leaves the parameters and the raw
    # gradients in place
    opt = ttrain.make_optimizer(0.0, 0.0, None)
    state = ttrain.create_train_state(master, opt)
    step = train_cli.make_master_train_step(master, guide, opt, LMBDA)
    _, metrics = step(state, _nchw(xm), _nchw(xg))
    return ({k: float(v) for k, v in metrics.items()},
            {n: p.grad for n, p in master.named_parameters()}, guide)


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("role", ROLES, ids=["channel1", "channel3"])
def test_master_step_matches_lmic_tpu(role, dtype, same_noise):
    """One master step against lmic_tpu's `make_master_train_step` on the
    same frozen guide weights, master weights, batch and noise: losses to
    1e-5 relative; every gradient leaf to 1e-3 of its largest value in
    f32 (measured at most 7.6e-4, decoder.sp_aligner2.blocks.0.mlp.fc2)
    and to F64_BAR in f64. No gradient reaches the guide, and its weights
    stay as they were."""
    (_, _, gparams), (_, _, mparams) = rgbt_pair(role)
    xm, xg = _batches(role, dtype)
    enabled = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", dtype == np.float64)
    try:
        if dtype == np.float64:
            gparams, mparams = _f64(gparams), _f64(mparams)
        want_m, want_g = _master_jax(role, gparams, mparams, xm, xg)
    finally:
        jax.config.update("jax_enable_x64", enabled)
    got_m, got_g, guide = _master_port(role, gparams, mparams, xm, xg,
                                       dtype)
    _check_losses(got_m, want_m, 1e-5)
    _check_grads(got_g, want_g, 1e-3 if dtype == np.float32 else F64_BAR)
    frozen = state_dict_from_jax("guided", gparams)
    for n, p in guide.named_parameters():
        assert p.grad is None, n
        assert torch.equal(p.detach(), frozen[n].to(p.dtype)), n


# ---------------------------------------------------------------------------
# the FLIR loaders
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def flir(tmp_path_factory):
    """A FLIR-like tree: RGB/ frames at twice the size of the 8-bit
    thermal_8_bit/ frames, paired by sorted name; and train/ + test/
    splits of RGB and of grayscale images for the single-modality
    loaders."""
    root = tmp_path_factory.mktemp("flir")
    write_images(root / "RGB", 3, (80, 96), seed=1)
    write_images(root / "thermal_8_bit", 3, (40, 48), seed=2, channels=1)
    for split, n in (("train", 3), ("test", 2)):
        write_images(root / "rgb" / split, n, (44, 52), seed=3)
        write_images(root / "gray" / split, n, (44, 52), seed=4, channels=1)
    return root


def _same(got, want):
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for a, b in zip(got, want):
            _same(a, b)
        return
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("channel", [1, 3])
def test_image_folder_rgb_matches_lmic_tpu(flir, channel):
    """(master, guide) pairs, channel 3 (a random scale, a 2:1 crop, a
    shared flip) and channel 1 (whole frames, the RGB guide resized to
    1024x1280, a shared flip), element for element for one seed; and the
    DataLoader's batches of pairs."""
    root = flir / ("RGB" if channel == 3 else "thermal_8_bit")
    kw = dict(crop_size=(32, 40), channel=channel, seed=7)
    ours, theirs = tds.ImageFolderRGB(root, **kw), \
        jds.ImageFolderRGB(root, **kw)
    assert len(ours) == len(theirs) == 3
    for i in (0, 1, 2, 0):  # the sequence of draws goes on
        _same(ours[i], theirs[i])
    x, g = ours[1]
    assert (x.shape, g.shape) == (((64, 80, 3), (32, 40, 1)) if channel == 3
                                  else ((40, 48, 1), (1024, 1280, 3)))
    if channel == 3:
        dl = [tds.DataLoader(tds.ImageFolderRGB(root, **kw), 2, seed=3),
              jds.DataLoader(jds.ImageFolderRGB(root, **kw), 2, seed=3,
                             prefetch=0)]
        (a,), (b,) = (list(d) for d in dl)
        _same(a, b)


@pytest.mark.parametrize("channel", [1, 3])
@pytest.mark.parametrize("split,train", [("train", True), ("test", False)])
def test_image_folder_t_matches_lmic_tpu(flir, channel, split, train):
    """One FLIR modality: RGB resized to 1024x1280, or grayscale kept at
    one channel; crop and flip for training, whole frames for testing."""
    root = flir / ("rgb" if channel == 3 else "gray")
    kw = dict(patch_size=(32, 24), train=train, channel=channel, seed=5)
    ours = tds.ImageFolderT(root, split, **kw)
    theirs = jds.ImageFolderT(root, split, **kw)
    for i in range(len(theirs)):
        _same(ours[i], theirs[i])
    assert ours[0].shape[-1] == channel


def test_image_folder_resize_matches_lmic_tpu(flir):
    kw = dict(patch_size=(32, 24), train=True, resize=(60, 50), seed=5)
    ours = tds.ImageFolder(flir / "rgb", "train", **kw)
    theirs = jds.ImageFolder(flir / "rgb", "train", **kw)
    for i in range(len(theirs)):
        _same(ours[i], theirs[i])


def test_scale_array_is_lmic_tpus():
    assert tds.TRAIN_SCALE_ARRAY == jds.image.TRAIN_SCALE_ARRAY


# ---------------------------------------------------------------------------
# train_cli: the guide, then the master against it
# ---------------------------------------------------------------------------


def _narrow(monkeypatch):
    """The quality table's q1 of the pair at the test widths."""
    for arch in ("guided", "master"):
        monkeypatch.setitem(tzoo.cfgs, arch, {1: (RGBT_N, RGBT_M)})


@pytest.mark.parametrize("amp", [False, True], ids=["f32", "amp"])
@pytest.mark.parametrize("channel", [1, 3])
def test_train_cli_trains_guided(channel, amp, tmp_path, capsys,
                                 monkeypatch):
    """`train_cli --arch guided` from 3-channel (ImageFolder) and 1-channel
    (ImageFolderT) data, in f32 and AMP: finite losses, a checkpoint."""
    _narrow(monkeypatch)
    write_images(tmp_path / "ds" / "train", 2, (72, 72), seed=1,
                 channels=channel)
    save = tmp_path / "g.ckpt"
    assert train_cli.main(
        ["--arch", "guided", "-q", "1", "--channel", str(channel), "-d",
         str(tmp_path / "ds"), "--batch-size", "2", "--patch-size", "64",
         "64", "--epochs", "1", "--log-every", "1", "--prefetch", "0",
         "--save-path", str(save), "--device", "cpu"]
        + (["--amp"] if amp else [])) == 0
    losses = [float(v) for v in re.findall(r"loss=([0-9.]+) mse",
                                           capsys.readouterr().out)]
    assert len(losses) == 1 and np.isfinite(losses[0])
    _, extra = ckpt.load_train_params(
        str(save), tzoo.make_module("guided", 1, channel=channel))
    assert extra["arch"] == "guided"


def test_train_cli_trains_master_against_a_guide_checkpoint(
        tmp_path, capsys, monkeypatch):
    """The paper's recipe: `train_cli --arch guided` on RGB images saves
    the guide, then `train_cli --arch master --channel 1
    --guided-checkpoint` trains the thermal master against it (FLIR's RGB
    frames resized to 128x128 here, 64x64 thermal frames) for one epoch:
    the checkpoint is the master's, and its frozen guide holds the guide
    checkpoint's weights."""
    _narrow(monkeypatch)
    monkeypatch.setattr(timage, "FLIR_RGB_SIZE", (128, 128))
    write_images(tmp_path / "rgb" / "train", 2, (72, 72), seed=1)
    guide_ckpt = tmp_path / "guided.ckpt"
    common = ["-q", "1", "--batch-size", "2", "--epochs", "1",
              "--log-every", "1", "--prefetch", "0", "--device", "cpu"]
    train_cli.main(["--arch", "guided", "-d", str(tmp_path / "rgb"),
                    "--patch-size", "64", "64", "--save-path",
                    str(guide_ckpt)] + common)
    write_images(tmp_path / "flir" / "RGB", 2, (96, 96), seed=2)
    write_images(tmp_path / "flir" / "thermal_8_bit", 2, (64, 64), seed=3,
                 channels=1)
    capsys.readouterr()
    save = tmp_path / "master.ckpt"
    loaded = {}
    original = ckpt.load_train_params

    def load(path, module):
        loaded[path] = module
        return original(path, module)

    monkeypatch.setattr(ckpt, "load_train_params", load)
    assert train_cli.main(
        ["--arch", "master", "--channel", "1", "-d",
         str(tmp_path / "flir" / "thermal_8_bit"), "--guided-checkpoint",
         str(guide_ckpt), "--save-path", str(save)] + common) == 0
    out = capsys.readouterr().out
    assert "WARNING" not in out
    losses = [float(v) for v in re.findall(r"loss=([0-9.]+) mse", out)]
    assert len(losses) == 1 and np.isfinite(losses[0])
    guide = loaded[str(guide_ckpt)]
    want = torch.load(str(guide_ckpt), weights_only=True)["params"]
    for k, v in guide.state_dict().items():
        assert torch.equal(v, want[k]), k
    master = tzoo.make_module("master", 1, channel=1)
    _, extra = original(str(save), master)
    assert extra["arch"] == "master" and extra["epoch"] == 0


def test_master_step_agreement_on_one_device():
    """The cross-device master check, run on the CPU twice: the fixed
    noise makes the two steps equal, no kernel is counted, and the
    original noise is restored."""
    from lmic_tpu_torch.entropy import entropy_models as tem
    from lmic_tpu_torch.ops import gdn
    from lmic_tpu_torch.utils.crosscheck import master_step_agreement

    original = tem.quantize_noise
    xm, xg = _batches(1)
    loss_err, grad_err, launched = master_step_agreement(
        1, 1, _nchw(xm), _nchw(xg), LMBDA, devices=("cpu", "cpu"),
        **WIDTHS)
    assert loss_err == 0 and grad_err == 0
    assert launched == {k: 0 for k in gdn.LAUNCHES}
    assert tem.quantize_noise is original


def test_master_step_under_ddp_is_the_plain_step():
    """`make_master_train_step(..., data_parallel=True)` in a one-rank
    gloo group: the master alone under DistributedDataParallel (every
    parameter gets its gradient in the one backward), the frozen guide
    outside it; the metrics and the master's gradients those of the
    plain step bit for bit, and the guide gets no gradient."""
    from lmic_tpu_torch import parallel
    from lmic_tpu_torch.utils.crosscheck import fixed_noise

    xm, xg = (_nchw(b) for b in _batches(1))

    def step(data_parallel):
        guided = tzoo.create_model("guided", 1, seed=0, channel=3,
                                   first_stride=2, device="cpu",
                                   **WIDTHS).module
        guided.eval().requires_grad_(False)
        master = tzoo.create_model("master", 1, seed=1, channel=1,
                                   device="cpu", **WIDTHS).module
        opt = ttrain.make_optimizer()
        run = train_cli.make_master_train_step(
            master, guided, opt, LMBDA, data_parallel=data_parallel)
        with fixed_noise():
            _, metrics = run(ttrain.create_train_state(master, opt), xm,
                             xg)
        assert all(p.grad is None for p in guided.parameters())
        return ({k: float(v) for k, v in metrics.items()},
                [p.grad for p in master.parameters()])

    plain = step(False)
    with parallel.process_group("gloo"):
        ddp = step(True)
    assert ddp[0] == plain[0]
    assert all(torch.equal(a, b) for a, b in zip(ddp[1], plain[1]))
