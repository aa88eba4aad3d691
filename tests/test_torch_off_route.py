"""mbt2018-mean at a GDN width off the wide bf16 kernels' route (N = 40, M =
48: on the card every AMP GDN of it runs gdn_fwd_stream_kernel and
gdn_bwd_dx_stream_kernel, as in chip_smoke.py's phase 17) against lmic_tpu on
the CPU, on weights carried by `zoo/convert.py::state_dict_from_jax` and
the same quantization noise: the training forward in f32 and in bf16 AMP,
and the AMP step's losses and gradients at the bars of
tests/test_torch_train.py's AMP test."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import IMAGE, jax_params, pixels

from lmic_tpu import zoo as jzoo
from lmic_tpu.entropy import entropy_models as jem
from lmic_tpu.utils import train as jtrain
from lmic_tpu_torch import zoo as tzoo
from lmic_tpu_torch.entropy import entropy_models as tem
from lmic_tpu_torch.utils import train as ttrain
from lmic_tpu_torch.zoo.convert import state_dict_from_jax

torch.set_num_threads(2)
ARCH = "mbt2018-mean"
N, M = 40, 48
LMBDA = 1024.0
LOSSES = ("loss", "mse_loss", "bpp_loss", "aux_loss")
# the bars of tests/test_pallas_gdn.py: max|a-b| / max(1, max|b|)
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _noise(nchw_shape):
    rng = np.random.default_rng([13, *nchw_shape])
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


def _batch():
    return (pixels(IMAGE, seed=4) / 255.0).astype(np.float32)


def _port_module(params, compute=None):
    module = tzoo.make_module(ARCH, 1, N=N, M=M, dtype=compute)
    module.load_state_dict(state_dict_from_jax(ARCH, params))
    return module.float().to(memory_format=torch.channels_last)


def _jax_module(compute=None):
    return jzoo.make_module(ARCH, 1, N=N, M=M, dtype=compute)


def _rel_err(got, want):
    a = np.asarray(got, np.float32)
    b = np.asarray(want, np.float32)
    return float(np.abs(a - b).max() / max(1.0, np.abs(b).max()))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_lmic_tpu(dtype, same_noise):
    """The training forward (same noise): the reconstruction and the
    likelihoods of y and z within the GDN bars of the dtype."""
    params = jax_params(ARCH, n=N, m=M)
    batch = _batch()
    compute = None if dtype == "float32" else jnp.bfloat16
    want = _jax_module(compute).apply(
        {"params": jax.tree.map(jnp.asarray, params)}, jnp.asarray(batch),
        training=True, rngs={"noise": jax.random.key(0)})
    module = _port_module(params, None if dtype == "float32"
                          else torch.bfloat16)
    with torch.no_grad():
        got = module(torch.from_numpy(batch).permute(0, 3, 1, 2),
                     training=True)
    x_hat = got["x_hat"].float().permute(0, 2, 3, 1).numpy()
    assert _rel_err(x_hat, np.asarray(want["x_hat"], np.float32)) \
        < TOL[dtype]
    for k in ("y", "z"):
        g = got["likelihoods"][k].float()
        w = np.asarray(want["likelihoods"][k], np.float32)
        if g.dim() == 4 and w.ndim == 4:
            g = g.permute(0, 2, 3, 1)
        assert g.shape == w.shape, k
        assert _rel_err(g.numpy(), w) < TOL[dtype], k


def _rel_fro(a, b):
    return ((a - b).norm() / b.norm().clamp(min=1e-30)).item()


def _jax_loss_and_grads(params, batch, compute=None):
    module = _jax_module(compute)

    def loss_fn(p):
        out = module.apply({"params": p}, batch, training=True,
                           rngs={"noise": jax.random.key(0)})
        rd = jtrain.rate_distortion_loss(out, batch, LMBDA)
        aux = module.apply({"params": p}, method=type(module).aux_loss)
        return rd["loss"] + aux, {**rd, "aux_loss": aux}

    grads, metrics = jax.jit(jax.grad(loss_fn, has_aux=True))(params)
    return ({k: float(v) for k, v in metrics.items()},
            jax.tree.map(np.asarray, grads))


def test_amp_step_matches_lmic_tpu_bf16(same_noise):
    """The bf16 AMP step's losses and gradients against lmic_tpu's bf16
    model, at the bars of test_amp_loss_and_grads_match_lmic_tpu_bf16: the
    losses to 1e-4 relative; every g_a/g_s weight, GDN beta/gamma and
    entropy-bottleneck leaf to 2e-2 of its largest value; the g_a/g_s
    conv biases to lmic_tpu's f32 gradient at 2e-2; the hyper-path
    leaves in relative Frobenius norm to 2e-2 plus twice what bf16 does to
    lmic_tpu's own gradient there."""
    params = jax_params(ARCH, n=N, m=M)
    batch = _batch()
    jparams = jax.tree.map(jnp.asarray, params)
    want_m, want_g = _jax_loss_and_grads(jparams, jnp.asarray(batch),
                                         jnp.bfloat16)
    _, f32_g = _jax_loss_and_grads(jparams, jnp.asarray(batch))
    module = _port_module(params, torch.bfloat16)
    x = torch.from_numpy(batch).permute(0, 3, 1, 2)
    out = module(x, training=True)
    rd = ttrain.rate_distortion_loss(out, x, LMBDA)
    aux = module.aux_loss()
    (rd["loss"] + aux).backward()
    got_m = {**{k: v.item() for k, v in rd.items()}, "aux_loss": aux.item()}
    for k in LOSSES:
        assert abs(got_m[k] - want_m[k]) <= 1e-4 * abs(want_m[k]), k
    want_g = state_dict_from_jax(ARCH, want_g)
    f32_g = state_dict_from_jax(ARCH, f32_g)
    got_g = {n: p.grad for n, p in module.named_parameters()}
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
