"""GDN/IGDN forward of the port: the plain version `gdn_reference` against
lmic_tpu's `_gdn_jnp` and against its Pallas kernel in interpret mode, the
dispatch of `gdn_core`, and the `GDN` layer against lmic_tpu's. The CUDA
kernel itself is held to `gdn_reference` on the card by
tests/test_torch_cuda.py."""

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

