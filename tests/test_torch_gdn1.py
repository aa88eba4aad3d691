"""`layers.GDN1` against lmic_tpu's `GDN1` (forward and inverse, values
and the gradients in x, beta and gamma, on carried weights), and the
`LMIC_ABLATE_GDN` switch of `layers.GDN` against lmic_tpu's under the
same switch: an mbt2018-mean forward with every GDN the identity, and no
GDN kernel called. Card against CPU: tests/test_torch_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmic_tpu.layers.layers import GDN1 as JGDN1
from lmic_tpu_torch.layers import GDN1
from lmic_tpu_torch.layers import layers as tlayers
from lmic_tpu import zoo as jzoo
from torch_port_helpers import N, M, jax_params, nchw, nhwc, port_codec

torch.set_num_threads(2)

# max|a-b| / max(1, max|b|) < TOL, the f32 bar of tests/test_pallas_gdn.py
TOL = 1e-5


def _rel_err(got, want) -> float:
    a = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                   np.float32)
    b = np.asarray(want, np.float32)
    return float(np.abs(a - b).max() / max(1.0, np.abs(b).max()))


def _layer(C, inverse, seed):
    """A port GDN1 with beta and gamma moved off their init, and its
    params as lmic_tpu's tree."""
    rng = np.random.default_rng(seed)
    layer = GDN1(C, inverse=inverse)
    with torch.no_grad():
        layer.beta.add_(torch.from_numpy(rng.uniform(0, 0.5, C)).float())
        layer.gamma.add_(torch.from_numpy(
            rng.uniform(0, 0.1, (C, C))).float())
    params = {"beta": layer.beta.detach().numpy().copy(),
              "gamma": layer.gamma.detach().numpy().copy()}
    return layer, params


def test_init_matches_lmic_tpu():
    x = jnp.zeros((1, 2, 2, 16))
    want = JGDN1().init(jax.random.key(0), x)["params"]
    got = GDN1(16)
    for name in ("beta", "gamma"):
        np.testing.assert_array_equal(getattr(got, name).detach().numpy(),
                                      np.asarray(want[name]))


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("C", [16, 192])
def test_gdn1_values_and_grads_match_lmic_tpu(C, inverse):
    rng = np.random.default_rng(C)
    x = rng.normal(0, 1, (2, 5, 7, C)).astype(np.float32)
    layer, params = _layer(C, inverse, seed=C + 1)

    def loss(xj, p):
        return jnp.sum(jnp.sin(JGDN1(inverse=inverse).apply({"params": p},
                                                            xj)))

    jp = {k: jnp.asarray(v) for k, v in params.items()}
    want_y = JGDN1(inverse=inverse).apply({"params": jp}, jnp.asarray(x))
    want = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jp)

    xt = torch.from_numpy(x).requires_grad_()
    y = layer(xt)
    torch.sin(y).sum().backward()
    assert y.shape == xt.shape and y.dtype == torch.float32
    assert _rel_err(y, want_y) < TOL
    for name, a, b in (("x", xt.grad, want[0]),
                       ("beta", layer.beta.grad, want[1]["beta"]),
                       ("gamma", layer.gamma.grad, want[1]["gamma"])):
        assert _rel_err(a, b) < TOL, name


@pytest.fixture(scope="module")
def mbt2018_mean():
    params = jax_params("mbt2018-mean")
    # the forward only: no coding tables
    jc = jzoo.create_model("mbt2018-mean", 1, variables={"params": params},
                           N=N, M=M)
    pc = port_codec("mbt2018-mean", params)
    x = np.random.default_rng(5).random((1, 64, 64, 3)).astype(np.float32)
    return jc, pc, x


def _forward(pc, x, monkeypatch):
    """The port's forward, counting the calls of `gdn_core`."""
    calls = []
    core = tlayers.gdn_core

    def counted(*args, **kwargs):
        calls.append(1)
        return core(*args, **kwargs)

    monkeypatch.setattr(tlayers, "gdn_core", counted)
    with torch.no_grad():
        out = pc.module(nchw(x), training=False)
    return out, len(calls)


def test_ablate_gdn_matches_lmic_tpu_and_calls_no_gdn(mbt2018_mean,
                                                      monkeypatch):
    jc, pc, x = mbt2018_mean
    plain, n_plain = _forward(pc, x, monkeypatch)
    monkeypatch.setenv("LMIC_ABLATE_GDN", "1")
    # lmic_tpu reads the switch while it traces: apply it eagerly
    want = jc.module.apply(jc.variables, jnp.asarray(x), training=False)
    got, n_ablated = _forward(pc, x, monkeypatch)
    assert n_plain == 6 and n_ablated == 0
    assert _rel_err(nhwc(got["x_hat"]), want["x_hat"]) < TOL
    for k, v in want["likelihoods"].items():
        assert _rel_err(nhwc(got["likelihoods"][k]), v) < TOL, k
    assert not np.allclose(nhwc(got["x_hat"]), nhwc(plain["x_hat"]))

    monkeypatch.delenv("LMIC_ABLATE_GDN")
    again, n_again = _forward(pc, x, monkeypatch)
    assert n_again == 6
    assert torch.equal(again["x_hat"], plain["x_hat"])


def test_ablated_gdn_gives_its_params_no_gradient(monkeypatch):
    layer = tlayers.GDN(8)
    x = torch.randn(2, 8, 4, 4, requires_grad=True)
    monkeypatch.setenv("LMIC_ABLATE_GDN", "1")
    y = layer(x)
    assert torch.equal(y, x)
    y.sum().backward()
    assert layer.beta.grad is None and layer.gamma.grad is None
    assert torch.equal(x.grad, torch.ones_like(x))
