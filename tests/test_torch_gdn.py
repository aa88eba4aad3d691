"""GDN/IGDN of the port: the plain versions `gdn_reference` and
`gdn_bwd_reference` against lmic_tpu's `_gdn_jnp`/`_gdn_bwd_jnp` and
against its Pallas kernels in interpret mode, the dispatch of `gdn_core`
and its autograd Function, and the `GDN` layer (output and gradients)
against lmic_tpu's. The CUDA kernels themselves are held to the plain
versions on the card by tests/test_torch_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmic_tpu.layers import GDN as JGDN
from lmic_tpu.ops import pallas_gdn
from lmic_tpu_torch.layers import GDN
from lmic_tpu_torch.ops import gdn as tgdn

torch.set_num_threads(2)

# the bars of tests/test_pallas_gdn.py: max|a-b| / max(1, max|b|)
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
C = 64


def _data(seed, shape, dtype):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, shape).astype(np.float32)
    beta = rng.uniform(0.5, 1.5, shape[-1]).astype(np.float32)
    # elementwise non-negative gamma, as the reparametrization guarantees
    gamma = (rng.uniform(0, 0.02, (shape[-1], shape[-1]))
             + 0.1 * np.eye(shape[-1])).astype(np.float32)
    jx = [jnp.asarray(a).astype(dtype) for a in (x, beta, gamma)]
    tx = [torch.from_numpy(a).to(getattr(torch, dtype))
          for a in (x, beta, gamma)]
    return jx, tx


def _rel_err(got: torch.Tensor, want) -> float:
    a = got.float().numpy()
    b = np.asarray(want, np.float32)
    return float(np.abs(a - b).max() / max(1.0, np.abs(b).max()))


SHAPES = [(2, 9, 7, C), (2 * pallas_gdn.TILE_N + 7, C)]  # both ragged


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("shape", SHAPES, ids=["nhwc", "rows"])
def test_reference_matches_jnp(dtype, inverse, shape):
    (jx, jb, jg), (tx, tb, tg) = _data(0, shape, dtype)
    want = pallas_gdn._gdn_jnp(jx, jb, jg, inverse)
    got = tgdn.gdn_reference(tx, tb, tg, inverse)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    assert _rel_err(got, want) < TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("inverse", [False, True])
def test_reference_matches_pallas_interpret(dtype, inverse, monkeypatch):
    (jx, jb, jg), (tx, tb, tg) = _data(1, SHAPES[1], dtype)
    monkeypatch.setenv("LMIC_PALLAS", "interpret")
    want = pallas_gdn.gdn_core(jx, jb, jg, inverse)
    got = tgdn.gdn_core(tx, tb, tg, inverse)  # CPU tensor: plain version
    assert _rel_err(got, want) < TOL[dtype]


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("width", [128, 192])
@pytest.mark.parametrize("rows", [63, 65, 2 * 64 + 7])
def test_bf16_reference_matches_pallas_at_the_wide_widths(
        rows, width, inverse, monkeypatch):
    """The bf16 plain forward, which the card holds gdn_fwd_wide_kernel to,
    against lmic_tpu's Pallas kernel run by the interpreter at the widths
    of that kernel's route, around its 64-row tile."""
    (jx, jb, jg), (tx, tb, tg) = _data(8, (rows, width), "bfloat16")
    monkeypatch.setenv("LMIC_PALLAS", "interpret")
    want = pallas_gdn.gdn_core(jx, jb, jg, inverse)
    got = tgdn.gdn_reference(tx, tb, tg, inverse)
    assert got.dtype == torch.bfloat16 and got.shape == tx.shape
    assert _rel_err(got, want) < TOL["bfloat16"]


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("width", [37, 256, 320, 1024])
@pytest.mark.parametrize("rows", [63, 65, 135])
def test_bf16_reference_matches_pallas_at_the_stream_widths(
        rows, width, inverse, monkeypatch):
    """The bf16 plain forward, which the card holds gdn_fwd_stream_kernel
    to, against lmic_tpu's Pallas kernel run by the interpreter at widths
    of that kernel's route: C not a multiple of 8 (its padded copies), two
    column blocks (256, 320) and six (1024), around 64-row boxes and past
    a 128-row tile."""
    (jx, jb, jg), (tx, tb, tg) = _data(9, (rows, width), "bfloat16")
    monkeypatch.setenv("LMIC_PALLAS", "interpret")
    want = pallas_gdn.gdn_core(jx, jb, jg, inverse)
    got = tgdn.gdn_reference(tx, tb, tg, inverse)
    assert got.dtype == torch.bfloat16 and got.shape == tx.shape
    assert _rel_err(got, want) < TOL["bfloat16"]


def test_core_dispatch_on_cpu_and_elsewhere():
    _, (tx, tb, tg) = _data(2, (5, C), "float32")
    assert torch.equal(tgdn.gdn_core(tx, tb, tg),
                       tgdn.gdn_reference(tx, tb, tg))
    with pytest.raises(ValueError):
        tgdn.gdn_core(tx.to("meta"), tb.to("meta"), tg.to("meta"))


@pytest.mark.parametrize("inverse", [False, True])
def test_gdn_layer_matches_lmic_tpu(inverse):
    rng = np.random.default_rng(3)
    x = rng.normal(0, 1, (2, 9, 7, C)).astype(np.float32)
    layer = GDN(C, inverse=inverse)
    with torch.no_grad():  # reparametrized values off the init diagonal
        layer.beta.add_(torch.from_numpy(rng.uniform(0, 0.5, C)).float())
        layer.gamma.add_(torch.from_numpy(
            rng.uniform(0, 0.1, (C, C))).float())
    params = {"beta": layer.beta.detach().numpy(),
              "gamma": layer.gamma.detach().numpy()}
    want = JGDN(inverse=inverse).apply({"params": params}, jnp.asarray(x))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)  # NCHW, channels_last
    assert xt.is_contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        got = layer(xt)
        # an NCHW-contiguous input takes an explicit copy, same values
        got_nchw = layer(xt.contiguous())
    assert got.shape == xt.shape
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), rtol=1e-5, atol=1e-5)
    assert torch.equal(got, got_nchw)



def _cotangent(seed, shape, dtype):
    g = np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)
    return jnp.asarray(g).astype(dtype), torch.from_numpy(g).to(
        getattr(torch, dtype))


@pytest.mark.parametrize("against", ["jnp", "interpret"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("ragged", [0, 7])
def test_bwd_reference_matches_lmic_tpu(against, dtype, inverse, ragged,
                                        monkeypatch):
    """The plain backward against `_gdn_bwd_jnp` and against the fused
    Pallas backward run by the interpreter, at the bars of
    `test_fused_backward_matches_jnp`, full and ragged tiles."""
    shape = (2 * pallas_gdn.TILE_N + ragged, C)
    (jx, jb, jg), (tx, tb, tg) = _data(4, shape, dtype)
    jc, tc = _cotangent(5, shape, dtype)
    if against == "jnp":
        want = pallas_gdn._gdn_bwd_jnp(inverse, (jx, jb, jg), jc)
    else:
        monkeypatch.setenv("LMIC_PALLAS", "interpret")
        want = pallas_gdn._gdn_bwd(inverse, (jx, jb, jg), jc)
    got = tgdn.gdn_bwd_reference(tx, tb, tg, tc, inverse)
    for name, a, b in zip(("dx", "dbeta", "dgamma"), got, want):
        assert str(a.dtype).removeprefix("torch.") == str(b.dtype), name
        assert a.shape == b.shape, name
        assert _rel_err(a, b) < TOL[dtype], name


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("width", [37, 320, 1024])
@pytest.mark.parametrize("rows", [63, 65, 135])
def test_bf16_bwd_reference_matches_pallas_at_the_stream_widths(
        rows, width, inverse, monkeypatch):
    """The bf16 plain backward, which the card holds
    gdn_bwd_dx_stream_kernel to, against lmic_tpu's fused Pallas backward
    run by the interpreter at widths of that kernel's route: C not a
    multiple of 8 (its padded copies), two column blocks (320) and six
    (1024), around the 64-row tiles of dn's sums and past a 128-row tile;
    dx, dbeta and dgamma at the bf16 bar."""
    shape = (rows, width)
    (jx, jb, jg), (tx, tb, tg) = _data(10, shape, "bfloat16")
    jc, tc = _cotangent(11, shape, "bfloat16")
    monkeypatch.setenv("LMIC_PALLAS", "interpret")
    want = pallas_gdn._gdn_bwd(inverse, (jx, jb, jg), jc)
    got = tgdn.gdn_bwd_reference(tx, tb, tg, tc, inverse)
    for name, a, b in zip(("dx", "dbeta", "dgamma"), got, want):
        assert a.dtype == torch.bfloat16 and a.shape == b.shape, name
        assert _rel_err(a, b) < TOL["bfloat16"], name


def test_core_records_a_gradient_only_when_asked():
    _, (tx, tb, tg) = _data(6, (5, C), "float32")
    tx.requires_grad_()
    y = tgdn.gdn_core(tx, tb, tg)
    assert isinstance(y.grad_fn, tgdn.GDNCore._backward_cls)
    with torch.no_grad():
        assert tgdn.gdn_core(tx, tb, tg).grad_fn is None
    with torch.inference_mode():
        assert tgdn.gdn_core(tx, tb, tg).grad_fn is None
    # the Function's backward is the plain backward on the CPU
    g = torch.ones_like(y)
    (dx,) = torch.autograd.grad(y, tx, g)
    assert torch.equal(dx, tgdn.gdn_bwd_reference(tx.detach(), tb, tg, g)[0])


def _layer_grads(inverse, dtype):
    """Gradients of sum(sin(GDN(x))) w.r.t. x and the stored beta/gamma
    (through the reparametrization), in the port and in lmic_tpu."""
    rng = np.random.default_rng(7)
    x = rng.normal(0, 1, (2, 9, 7, C))
    layer = GDN(C, inverse=inverse).to(getattr(torch, dtype))
    with torch.no_grad():  # reparametrized values off the init diagonal
        layer.beta.add_(torch.from_numpy(rng.uniform(0, 0.5, C)))
        layer.gamma.add_(torch.from_numpy(rng.uniform(0, 0.1, (C, C))))
    params = {"beta": layer.beta.detach().numpy(),
              "gamma": layer.gamma.detach().numpy()}
    xt = torch.from_numpy(x.astype(dtype)).permute(0, 3, 1, 2)
    xt.requires_grad_()
    torch.sin(layer(xt)).sum().backward()
    got = [xt.grad.permute(0, 2, 3, 1), layer.beta.grad, layer.gamma.grad]

    def loss(xj, p):
        return jnp.sum(jnp.sin(JGDN(inverse=inverse).apply({"params": p},
                                                           xj)))

    jp = {k: jnp.asarray(v) for k, v in params.items()}
    gx, gp = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x.astype(dtype)), jp)
    return got, [gx, gp["beta"], gp["gamma"]]


@pytest.mark.parametrize("inverse", [False, True])
def test_gdn_layer_grads_match_lmic_tpu_f32(inverse):
    got, want = _layer_grads(inverse, "float32")
    for name, a, b in zip(("x", "beta", "gamma"), got, want):
        assert _rel_err(a, b) < 1e-5, name


@pytest.mark.parametrize("inverse", [False, True])
def test_gdn_layer_grads_match_lmic_tpu_f64(inverse):
    """The bar of `test_gradient_parity_f64`: in f64 only the algorithm
    shows, not the summation order."""
    enabled = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        got, want = _layer_grads(inverse, "float64")
    finally:
        jax.config.update("jax_enable_x64", enabled)
    for name, a, b in zip(("x", "beta", "gamma"), got, want):
        assert a.dtype == torch.float64, name
        b = np.asarray(b)
        err = np.abs(a.numpy() - b).max() / max(1.0, np.abs(b).max())
        assert err < 1e-10, name
