"""The port's training path against lmic_tpu's on the CPU: the train step
(losses, gradients, parameters after two steps) for the three non-AR archs
on the same weights and the same quantization noise, in f32 and f64; the
optimizer grouping, the StepLR schedule and the global-norm clip; bf16 AMP;
checkpoints, deployment finalization and the two CLIs.

The noise: `jax.random` and `torch.Generator` draw different numbers, so
`quantize_noise` is replaced in both packages' entropy modules (in this
test process only) by one that adds the same numpy-made noise, transposed
between lmic_tpu's NHWC and the port's NCHW."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch_port_helpers import ARCHS, IMAGE, M, N, jax_params, pixels

from lmic_tpu import zoo as jzoo
from lmic_tpu.entropy import entropy_models as jem
from lmic_tpu.utils import train as jtrain
from lmic_tpu_torch import zoo as tzoo
from lmic_tpu_torch.entropy import entropy_models as tem
from lmic_tpu_torch.ops import gdn as tgdn
from lmic_tpu_torch.utils import checkpoint as ckpt
from lmic_tpu_torch.utils import train as ttrain
from lmic_tpu_torch.utils import train_cli, update_model_cli
from lmic_tpu_torch.utils.crosscheck import train_step_agreement
from lmic_tpu_torch.zoo.convert import state_dict_from_jax

torch.set_num_threads(2)
LMBDA = 1024.0
LR, AUX_LR = 1e-4, 1e-3
LOSSES = ("loss", "mse_loss", "bpp_loss", "aux_loss")


def _noise(nchw_shape):
    """U(-0.5, 0.5) noise for a port-layout shape, from the shape alone."""
    rng = np.random.default_rng([11, *nchw_shape])
    return rng.uniform(-0.5, 0.5, nchw_shape)


def _jax_noise(x, key):
    shape = tuple(x.shape)
    if len(shape) == 4:  # GaussianConditional input, NHWC
        n = _noise((shape[0], shape[3], shape[1], shape[2]))
        n = n.transpose(0, 2, 3, 1)
    else:  # EntropyBottleneck values (C, 1, B*H*W), the same in both
        n = _noise(shape)
    return x + jnp.asarray(n, x.dtype)


def _torch_noise(x, generator=None):
    return x + torch.from_numpy(_noise(tuple(x.shape))).to(x.dtype)


@pytest.fixture()
def same_noise(monkeypatch):
    monkeypatch.setattr(jem, "quantize_noise", _jax_noise)
    monkeypatch.setattr(tem, "quantize_noise", _torch_noise)


def _batch(dtype=np.float32):
    return (pixels(IMAGE, seed=3) / 255.0).astype(dtype)


def _port_module(arch, params, dtype=np.float32, compute=None):
    module = tzoo.make_module(arch, 1, N=N, M=M, dtype=compute)
    module.load_state_dict(state_dict_from_jax(arch, params))
    return module.to(torch.float64 if dtype == np.float64 else
                     torch.float32).to(memory_format=torch.channels_last)


def _nchw(batch):
    return torch.from_numpy(batch).permute(0, 3, 1, 2)


def _jax_loss_and_grads(arch, params, batch, compute=None):
    module = jzoo.make_module(arch, 1, N=N, M=M, dtype=compute)

    def loss_fn(p):
        out = module.apply({"params": p}, batch, training=True,
                           rngs={"noise": jax.random.key(0)})
        rd = jtrain.rate_distortion_loss(out, batch, LMBDA)
        aux = module.apply({"params": p}, method=type(module).aux_loss)
        return rd["loss"] + aux, {**rd, "aux_loss": aux}

    grads, metrics = jax.jit(jax.grad(loss_fn, has_aux=True))(params)
    return ({k: float(v) for k, v in metrics.items()},
            jax.tree.map(np.asarray, grads))


def _port_loss_and_grads(module, batch):
    out = module(batch, training=True)
    rd = ttrain.rate_distortion_loss(out, batch, LMBDA)
    aux = module.aux_loss()
    (rd["loss"] + aux).backward()
    return ({**{k: v.item() for k, v in rd.items()}, "aux_loss": aux.item()},
            {n: p.grad for n, p in module.named_parameters()})


def _compare_step(arch, dtype, grad_bar):
    params = jax_params(arch)
    if dtype == np.float64:
        params = jax.tree.map(lambda a: a.astype(np.float64), params)
    batch = _batch(dtype)
    want_m, want_g = _jax_loss_and_grads(
        arch, jax.tree.map(jnp.asarray, params), jnp.asarray(batch))
    module = _port_module(arch, params, dtype)
    got_m, got_g = _port_loss_and_grads(module, _nchw(batch))
    for k in LOSSES:
        assert abs(got_m[k] - want_m[k]) <= 1e-5 * abs(want_m[k]), k
    want_g = state_dict_from_jax(arch, want_g)
    assert set(want_g) == set(got_g)
    for name, want in want_g.items():
        got = got_g[name]
        assert got is not None and got.dtype == want.dtype, name
        scale = want.abs().max().item()
        if scale == 0:  # e.g. quantiles' share of the RD loss
            assert got.abs().max().item() == 0, name
            continue
        err = (got - want).abs().max().item() / scale
        assert err < grad_bar, (name, err)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_lmic_tpu_f32(arch, same_noise):
    """f32: the losses to 1e-5 relative, every gradient leaf to 1e-3 of its
    largest value (accumulation order differs between the frameworks)."""
    _compare_step(arch, np.float32, 1e-3)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_lmic_tpu_f64(arch, same_noise):
    """f64: only the algorithm shows; every gradient leaf to 1e-10."""
    enabled = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        _compare_step(arch, np.float64, 1e-10)
    finally:
        jax.config.update("jax_enable_x64", enabled)


@pytest.mark.parametrize("arch", ARCHS)
def test_two_steps_match_lmic_tpu(arch, same_noise):
    """Two full steps (clip, both Adams) from the same weights: the metrics
    of each step to 1e-5 relative, and the parameters after them. An Adam
    update is about lr in size whatever the gradient's size, so f32 noise in
    a small gradient shows in the update: the bar is that no entry is off
    by more than 1e-2 lr and 99 % agree to 1e-3 lr (measured: at most
    2.2e-7 = 2.2e-3 lr, and 99.9 % within 1e-3 lr)."""
    params = jax_params(arch)
    batch = _batch()
    jmod = jzoo.make_module(arch, 1, N=N, M=M)
    jopt = jtrain.make_optimizer(LR, AUX_LR)
    jstate = jtrain.create_train_state(jax.tree.map(jnp.asarray, params),
                                       jopt)
    jstep = jtrain.make_train_step(jmod, jopt, LMBDA)
    module = _port_module(arch, params)
    topt = ttrain.make_optimizer(LR, AUX_LR)
    tstate = ttrain.create_train_state(module, topt)
    tstep = ttrain.make_train_step(module, topt, LMBDA)
    for _ in range(2):
        jstate, jm = jstep(jstate, jnp.asarray(batch), jax.random.key(0))
        tstate, tm = tstep(tstate, _nchw(batch))
        for k in LOSSES:
            assert abs(float(tm[k]) - float(jm[k])) <= \
                1e-5 * abs(float(jm[k])), k
    assert tstate.step == int(jstate.step) == 2
    want = state_dict_from_jax(arch, jax.tree.map(np.asarray,
                                                  jstate.params))
    diffs = torch.cat([(module.state_dict()[k] - v).abs().flatten()
                       for k, v in want.items()])
    assert diffs.max().item() <= 1e-2 * LR
    assert (diffs <= 1e-3 * LR).float().mean().item() >= 0.99


def test_quantiles_only_updated_by_aux():
    module = _port_module(ARCHS[0], jax_params(ARCHS[0]))
    q_name = "entropy_bottleneck.quantiles"
    before = {k: v.clone() for k, v in module.state_dict().items()}
    opt = ttrain.make_optimizer(learning_rate=0.0, aux_learning_rate=1e-2)
    state = ttrain.create_train_state(module, opt)
    assert all(p is not module.entropy_bottleneck.quantiles
               for g in state.main.param_groups for p in g["params"])
    state, _ = ttrain.make_train_step(module, opt, LMBDA)(
        state, _nchw(_batch()), torch.Generator().manual_seed(0))
    after = module.state_dict()
    assert (after[q_name] - before[q_name]).abs().max() > 0
    for k in before:
        if k != q_name:
            assert torch.equal(after[k], before[k]), k


def test_step_lr_matches_lmic_tpu_schedule():
    for args in [(1e-4, 10, 40, 0.5), (3e-4, 7, 2, 0.1)]:
        ours, theirs = ttrain.step_lr(*args), jtrain.step_lr(*args)
        for count in range(0, 5 * args[1] * args[2]):
            assert ours(count) == pytest.approx(float(theirs(count)),
                                                rel=1e-12)
    # the step applies the schedule at the main optimizer's update count,
    # as optax counts it: the first update sees count 0
    module = _port_module(ARCHS[0], jax_params(ARCHS[0]))
    sched = ttrain.step_lr(1e-4, steps_per_epoch=1, step_size=1, gamma=0.5)
    opt = ttrain.make_optimizer(sched)
    state = ttrain.create_train_state(module, opt)
    step = ttrain.make_train_step(module, opt, LMBDA)
    for k in range(3):
        state, _ = step(state, _nchw(_batch()))
        assert state.main.param_groups[0]["lr"] == sched(k)


@pytest.mark.parametrize("norm_scale", [0.5, 3.0])
def test_clip_matches_optax(norm_scale):
    rng = np.random.default_rng(1)
    leaves = [rng.normal(0, 1, s).astype(np.float32)
              for s in [(3, 4), (5,), (2, 2, 2)]]
    total = np.sqrt(sum((a.astype(np.float64) ** 2).sum() for a in leaves))
    leaves = [a * np.float32(norm_scale / total) for a in leaves]
    want, _ = optax.clip_by_global_norm(1.0).update(
        [jnp.asarray(a) for a in leaves], None)
    got = [torch.from_numpy(a.copy()) for a in leaves]
    norm = ttrain.clip_by_global_norm(got, 1.0)
    assert norm.item() == pytest.approx(norm_scale, rel=1e-6)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=0)
    if norm_scale < 1.0:  # below the norm: untouched
        assert all(np.array_equal(a.numpy(), b)
                   for a, b in zip(got, leaves))


@pytest.mark.parametrize("arch", ARCHS)
def test_amp_step_tracks_f32(arch):
    """One bf16-activation step from the same weights moves the RD loss by
    under 1 %; parameters stay f32, likelihoods and x_hat are f32."""
    params = jax_params(arch)
    batch = _nchw(_batch())
    losses = {}
    for name, dtype in [("f32", None), ("amp", torch.bfloat16)]:
        module = tzoo.make_module(arch, 1, N=N, M=M, dtype=dtype)
        module.load_state_dict(state_dict_from_jax(arch, params))
        module = module.to(memory_format=torch.channels_last)
        opt = ttrain.make_optimizer()
        state = ttrain.create_train_state(module, opt)
        state, metrics = ttrain.make_train_step(module, opt, LMBDA)(
            state, batch, torch.Generator().manual_seed(1))
        assert all(p.dtype == torch.float32 for p in module.parameters())
        losses[name] = float(metrics["loss"])
        assert np.isfinite(losses[name])
        with torch.no_grad():
            out = module(batch, training=True,
                         generator=torch.Generator().manual_seed(1))
        assert out["x_hat"].dtype == torch.float32
        assert all(lik.dtype == torch.float32
                   for lik in out["likelihoods"].values())
    assert abs(losses["amp"] - losses["f32"]) / abs(losses["f32"]) < 0.01


def test_amp_does_not_change_f32_wires():
    """A codec built without `dtype` runs f32 transforms, and `dtype` does
    not change the weights drawn from a seed."""
    arch = "bmshj2018-hyperprior"
    a = tzoo.create_model(arch, 1, seed=0, device="cpu", N=N, M=M)
    b = tzoo.create_model(arch, 1, seed=0, device="cpu", N=N, M=M)
    amp = tzoo.create_model(arch, 1, seed=0, device="cpu", N=N, M=M,
                            dtype=torch.bfloat16)
    assert a.module.dtype is None
    with torch.no_grad():
        x = torch.zeros((1, 3, 64, 64))
        assert a.module.g_a(x).dtype == torch.float32
        assert a.module.g_a[0](x).dtype == torch.float32
        assert amp.module.g_a[0](x).dtype == torch.bfloat16
    for other in (b, amp):
        sa, so = a.module.state_dict(), other.module.state_dict()
        assert all(torch.equal(sa[k], so[k]) for k in sa)


def _rel_fro(a, b):
    return ((a - b).norm() / b.norm()).item()


@pytest.mark.parametrize("arch", ARCHS)
def test_amp_loss_and_grads_match_lmic_tpu_bf16(arch, same_noise):
    """The bf16 AMP step against lmic_tpu's bf16 model (`dtype=bfloat16`)
    on the same weights and noise. Bars, each with what was measured at
    this size (N=16, M=24, 2x64x128):

    - the losses to 1e-4 relative (measured at most 4.7e-5, bpp);
    - every g_a/g_s weight, GDN beta/gamma and entropy-bottleneck leaf to
      2e-2 of its largest value (measured at most 7.0e-3);
    - the g_a/g_s conv biases to lmic_tpu's *f32* gradient at 2e-2
      (measured at most 8.0e-3): XLA on the CPU sums a bf16 bias's
      cotangent in bf16, which stalls once the sum reaches 128 (lmic_tpu's
      bf16 step gives -128.0 where its f32 step gives -340.1, g_s.6.bias);
    - the hyper-path leaves (h_a, h_s) in relative Frobenius norm, to
      2e-2 plus twice what bf16 does to lmic_tpu's own gradient there:
      the scales sit below the Gaussian conditional's lower bound, whose
      gate, like the ReLUs', is flipped by bf16 rounding in either
      framework (measured at most 0.12 against a bar of 0.25,
      bmshj2018-hyperprior h_s.0.weight)."""
    params = jax_params(arch)
    batch = _batch()
    jparams = jax.tree.map(jnp.asarray, params)
    want_m, want_g = _jax_loss_and_grads(arch, jparams, jnp.asarray(batch),
                                         jnp.bfloat16)
    _, f32_g = _jax_loss_and_grads(arch, jparams, jnp.asarray(batch))
    module = _port_module(arch, params, compute=torch.bfloat16)
    got_m, got_g = _port_loss_and_grads(module, _nchw(batch))
    for k in LOSSES:
        assert abs(got_m[k] - want_m[k]) <= 1e-4 * abs(want_m[k]), k
    want_g = state_dict_from_jax(arch, want_g)
    f32_g = state_dict_from_jax(arch, f32_g)
    assert set(want_g) == set(got_g)
    for name, want in want_g.items():
        got = got_g[name]
        assert got is not None and got.dtype == torch.float32, name
        if name.startswith(("h_a.", "h_s.")):
            bar = 2e-2 + 2 * _rel_fro(want, f32_g[name])
            err = _rel_fro(got, want)
        else:
            if name.endswith(".bias"):
                want = f32_g[name]
            scale = want.abs().max().item()
            if scale == 0:  # quantiles' share of the RD loss
                assert got.abs().max().item() == 0, name
                continue
            bar, err = 2e-2, (got - want).abs().max().item() / scale
        assert err < bar, (name, err, bar)


def _trained_state(arch=ARCHS[2], steps=1):
    module = _port_module(arch, jax_params(arch))
    opt = ttrain.make_optimizer()
    state = ttrain.create_train_state(module, opt)
    step = ttrain.make_train_step(module, opt, LMBDA)
    for k in range(steps):
        state, _ = step(state, _nchw(_batch()),
                        torch.Generator().manual_seed(k))
    return state, step


def test_checkpoint_round_trip_and_resume(tmp_path):
    arch = ARCHS[2]
    state, step = _trained_state(arch)
    path = str(tmp_path / "run" / "ck.ckpt")
    ckpt.save_checkpoint(path, state, {"epoch": 3}, is_best=True)
    assert (tmp_path / "run" / "ck_best_loss.ckpt").exists()
    assert not (tmp_path / "run" / "ck.ckpt.tmp").exists()

    other, other_step = _trained_state(arch, steps=0)
    with torch.no_grad():  # a template with other values
        for p in other.module.parameters():
            p.add_(1.0)
    other, extra = ckpt.load_checkpoint(path, other)
    assert extra == {"epoch": 3} and other.step == state.step == 1
    for k, v in state.module.state_dict().items():
        assert torch.equal(other.module.state_dict()[k], v), k
    for opt_a, opt_b in ((state.main, other.main), (state.aux, other.aux)):
        sa, sb = opt_a.state_dict(), opt_b.state_dict()
        assert sa["param_groups"] == sb["param_groups"]
        for i, s in sa["state"].items():
            for k, v in s.items():
                assert torch.equal(sb["state"][i][k], v), (i, k)

    # a resumed step equals an uninterrupted one
    batch = _nchw(_batch())
    state, _ = step(state, batch, torch.Generator().manual_seed(9))
    other, _ = other_step(other, batch, torch.Generator().manual_seed(9))
    for k, v in state.module.state_dict().items():
        assert torch.equal(other.module.state_dict()[k], v), k

    module = tzoo.make_module(arch, 1, N=N, M=M)
    module, extra = ckpt.load_train_params(path, module)
    assert extra["epoch"] == 3


def test_update_model_file_round_trip(tmp_path):
    arch = ARCHS[2]
    state, _ = _trained_state(arch)
    codec = tzoo.create_model(arch, 1, device="cpu", N=N, M=M,
                              state_dict=state.module.state_dict())
    path = ckpt.update_model_file(str(tmp_path), codec, f"{arch}-q1")
    assert re.fullmatch(rf"{arch}-q1-[0-9a-f]{{8}}\.ckpt",
                        path.rsplit("/", 1)[-1])
    fresh = tzoo.create_model(arch, 1, seed=5, device="cpu", N=N, M=M)
    fresh = ckpt.load_updated_model(path, fresh)
    x = pixels()
    out = codec.compress(x)
    assert fresh.compress(x)["strings"] == out["strings"]
    np.testing.assert_array_equal(
        fresh.decompress(out["strings"], out["shape"], u8=True)["x_hat"],
        codec.decompress(out["strings"], out["shape"], u8=True)["x_hat"])


def _write_images(d, n, size, seed=0):
    from PIL import Image

    d.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        arr = (rng.random((*size, 3)) * 255).astype(np.uint8)
        Image.fromarray(arr).save(d / f"img_{i:03d}.png")


def test_train_cli_trains_resumes_and_finalizes(tmp_path, capsys):
    """One short epoch on seeded PNGs, the checkpoint and its best copy,
    a resume from the next epoch, a test split, and update_model_cli."""
    root = tmp_path / "ds"
    _write_images(root / "train", 16, (40, 40), seed=1)
    _write_images(root / "test", 8, (40, 40), seed=2)
    save = tmp_path / "out" / "ck.ckpt"
    args = ["--arch", "bmshj2018-factorized", "-q", "1", "-d", str(root),
            "--batch-size", "8", "--patch-size", "32", "32",
            "--log-every", "1", "--prefetch", "1", "--seed", "7",
            "--save-path", str(save), "--device", "cpu"]
    assert train_cli.main(args + ["--epochs", "1"]) == 0
    out = capsys.readouterr().out
    assert "epoch 0 it 0: loss=" in out and "epoch 0 it 1: loss=" in out
    assert "epoch 0 test loss=" in out and "epoch 0 done" in out
    losses = [float(v) for v in re.findall(r"loss=([0-9.]+) mse", out)]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert save.exists() and (save.parent / "ck_best_loss.ckpt").exists()
    assert not (save.parent / "error.log").exists()

    train_cli.main(args + ["--epochs", "2", "--checkpoint", str(save)])
    out = capsys.readouterr().out
    assert "epoch 1 it 0" in out and "epoch 0 it" not in out

    final = update_model_cli.run([str(save), "-a", "bmshj2018-factorized",
                                  "-q", "1", "-d", str(tmp_path / "final"),
                                  "--device", "cpu"])
    assert re.fullmatch(r"bmshj2018-factorized-q1-[0-9a-f]{8}\.ckpt",
                        final.rsplit("/", 1)[-1])
    codec = ckpt.load_updated_model(
        final, tzoo.create_model("bmshj2018-factorized", 1, device="cpu"))
    x = pixels((1, 32, 32, 3))
    got = codec.decompress(**codec.compress(x), u8=True)["x_hat"]
    assert got.shape == x.shape
    # the finalized params are the checkpoint's
    trained = tzoo.make_module("bmshj2018-factorized", 1)
    ckpt.load_train_params(str(save), trained)
    for k, v in trained.state_dict().items():
        assert torch.equal(v, codec.module.state_dict()[k]), k


def test_clis_refuse_what_is_not_ported(tmp_path):
    base = ["-d", str(tmp_path), "--device", "cpu",
            "--save-path", str(tmp_path / "ck.ckpt")]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        train_cli.main(base + ["--bf16"])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        train_cli.main(base + ["--devices", "2"])
    # the '_D' archs have no training recipe, in lmic_tpu either
    with pytest.raises(SystemExit, match="no standalone training recipe"):
        train_cli.main(base + ["--arch", "guided_D"])
    # the '_R' archs train in f32 only: lmic_tpu's AMP_ARCHS leaves them
    # out
    for arch in ("mbt2018_R", "cheng2020-anchor_R", "cheng2020-attn_R"):
        with pytest.raises(SystemExit, match="--amp supports"):
            train_cli.main(base + ["--amp", "--arch", arch])
    # the master trains in f32 only (lmic_tpu ignores the flag there)
    with pytest.raises(SystemExit, match="--amp supports"):
        train_cli.main(base + ["--amp", "--arch", "master"])
    # --aot-shape is ported: it also writes a serving bundle that loads
    # and codes as the finalized checkpoint does
    from lmic_tpu_torch.utils.aot import load_serving_bundle

    module = tzoo.make_module("bmshj2018-factorized", 1)
    torch.save({"params": module.state_dict()}, tmp_path / "train.ckpt")
    with pytest.raises(SystemExit, match="BxHxW"):
        update_model_cli.run([str(tmp_path / "train.ckpt"), "--device",
                              "cpu", "-d", str(tmp_path), "--aot-shape",
                              "64x64"])
    final = update_model_cli.run([
        str(tmp_path / "train.ckpt"), "--device", "cpu", "-d",
        str(tmp_path), "--aot-shape", "1x64x64"])
    served = load_serving_bundle(
        str(tmp_path / "bmshj2018-factorized-q1-aot"), device="cpu")
    assert served.bundle_meta["input_shape"] == [1, 64, 64, 3]
    live = ckpt.load_updated_model(
        final, tzoo.create_model("bmshj2018-factorized", 1, device="cpu"))
    x = pixels((1, 64, 64, 3), seed=4)
    out = served.compress(x)
    assert out["strings"] == live.compress(x)["strings"]
    np.testing.assert_array_equal(
        served.decompress(out["strings"], out["shape"], u8=True)["x_hat"],
        live.decompress(out["strings"], out["shape"], u8=True)["x_hat"])


def test_backward_runs_the_gdn_function():
    """On the CPU a training step goes through the autograd Function and
    its plain backward; no kernel is counted."""
    before = dict(tgdn.LAUNCHES)
    module = tzoo.make_module(ARCHS[0], 1, N=N, M=M)
    x = _nchw(_batch()).requires_grad_()
    y = module.g_a[1](module.g_a[0](x))
    assert isinstance(y.grad_fn.next_functions[0][0],
                      tgdn.GDNCore._backward_cls)
    y.sum().backward()
    assert tgdn.LAUNCHES == before


def test_train_step_agreement_on_one_device():
    """The cross-device check, run on the CPU twice: the fixed noise makes
    the two steps equal (unseeded `torch.rand` would not), no kernel is
    counted, and the original noise is restored."""
    original = tem.quantize_noise
    loss_err, grad_err, launched = train_step_agreement(
        ARCHS[2], 1, _nchw(_batch()), LMBDA, devices=("cpu", "cpu"),
        N=N, M=M)
    assert loss_err == 0 and grad_err == 0
    assert launched == {k: 0 for k in tgdn.LAUNCHES}
    assert tem.quantize_noise is original
