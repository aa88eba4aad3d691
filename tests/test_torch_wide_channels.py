"""GDN past the widths the port's kernels once refused (f32 384, bf16 1024),
against lmic_tpu on the CPU: the plain versions `gdn_reference` and
`gdn_bwd_reference`, which the card holds gdn_fwd_f32_blocked_kernel,
gdn_bwd_dx_f32_blocked_kernel and the bf16 stream kernels to, against
lmic_tpu's `gdn_core` and its VJP through `_gdn_jnp`/`_gdn_bwd_jnp` and
through its Pallas kernels run by the interpreter; and mbt2018-mean at
N = M = 400 on weights carried by `zoo/convert.py::state_dict_from_jax`
(chip_smoke.py's phase 18 on the card): likelihoods, reconstruction,
strings and one f32 train step."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import (
    carry_tables,
    jax_codec,
    jax_params,
    nchw,
    nhwc,
    pixels,
    port_codec,
)

from lmic_tpu import zoo as jzoo
from lmic_tpu.entropy import entropy_models as jem
from lmic_tpu.ops import pallas_gdn
from lmic_tpu.utils import train as jtrain
from lmic_tpu_torch import zoo as tzoo
from lmic_tpu_torch.entropy import entropy_models as tem
from lmic_tpu_torch.ops import gdn as tgdn
from lmic_tpu_torch.utils import train as ttrain
from lmic_tpu_torch.zoo.convert import state_dict_from_jax

torch.set_num_threads(2)

# the bars of tests/test_pallas_gdn.py: max|a-b| / max(1, max|b|)
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# (dtype, C): f32 past 384 (385 ragged, 520 a ragged last column block),
# bf16 past 1024
WIDTHS = [("float32", 385), ("float32", 520), ("bfloat16", 1032)]
# (dtype, C, rows): each width around the 64-row tiles and past a 128-row
# tile, and f32 at 640 (five 128-column blocks, the last half full) around
# a 128-row tile
CASES = ([(dtype, width, rows) for dtype, width in WIDTHS
          for rows in (63, 65, 135)]
         + [("float32", 640, 127), ("float32", 640, 129)])
ARCH = "mbt2018-mean"
N = M = 400
IMAGE = (1, 64, 64, 3)
LMBDA = 1024.0
LOSSES = ("loss", "mse_loss", "bpp_loss", "aux_loss")


def _data(seed, shape, dtype):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, shape).astype(np.float32)
    beta = rng.uniform(0.5, 1.5, shape[-1]).astype(np.float32)
    # elementwise non-negative gamma, as the reparametrization guarantees
    gamma = (rng.uniform(0, 0.02, (shape[-1], shape[-1]))
             + 0.1 * np.eye(shape[-1])).astype(np.float32)
    g = rng.normal(0, 1, shape).astype(np.float32)
    jx = [jnp.asarray(a).astype(dtype) for a in (x, beta, gamma, g)]
    tx = [torch.from_numpy(a).to(getattr(torch, dtype))
          for a in (x, beta, gamma, g)]
    return jx, tx


def _rel_err(got, want) -> float:
    a = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                   np.float32)
    b = np.asarray(want, np.float32)
    return float(np.abs(a - b).max() / max(1.0, np.abs(b).max()))


@pytest.mark.parametrize("against", ["jnp", "interpret"])
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("dtype,width,rows", CASES)
def test_plain_gdn_matches_lmic_tpu_past_the_old_caps(
        dtype, width, rows, inverse, against, monkeypatch):
    """The forward and the backward (dx, dbeta, dgamma for a seeded
    cotangent) against `_gdn_jnp`/`_gdn_bwd_jnp`, or against the Pallas
    forward and fused backward run by the interpreter, around the 64-row
    tiles of the bf16 CUDA kernels and the 128-row tiles of the f32
    blocked ones, and past a 128-row tile."""
    (jx, jb, jg, jc), (tx, tb, tg, tc) = _data(width + rows,
                                               (rows, width), dtype)
    if against == "jnp":
        want = pallas_gdn._gdn_jnp(jx, jb, jg, inverse)
        want_bwd = pallas_gdn._gdn_bwd_jnp(inverse, (jx, jb, jg), jc)
    else:
        monkeypatch.setenv("LMIC_PALLAS", "interpret")
        want = pallas_gdn.gdn_core(jx, jb, jg, inverse)
        want_bwd = pallas_gdn._gdn_bwd(inverse, (jx, jb, jg), jc)
    got = tgdn.gdn_reference(tx, tb, tg, inverse)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    assert _rel_err(got, want) < TOL[dtype]
    got_bwd = tgdn.gdn_bwd_reference(tx, tb, tg, tc, inverse)
    for name, a, b in zip(("dx", "dbeta", "dgamma"), got_bwd, want_bwd):
        assert str(a.dtype).removeprefix("torch.") == str(b.dtype), name
        assert a.shape == b.shape, name
        assert _rel_err(a, b) < TOL[dtype], name


@pytest.fixture(scope="module")
def wide_pair():
    """lmic_tpu's mbt2018-mean at N = M = 400 from seed 0 (GDN gammas off
    the diagonal, medians off zero) and the port's codec on the converted
    weights with lmic_tpu's tables carried across."""
    params = jax_params(ARCH, n=N, m=M, input_size=IMAGE[1:3], jit=True)
    jc = jax_codec(ARCH, params, n=N, m=M)
    pc = carry_tables(jc, port_codec(ARCH, params, n=N, m=M))
    return params, jc, pc


def test_eval_forward_matches_lmic_tpu(wide_pair):
    """The eval forward on a 64x64 image: x_hat and the likelihoods of y
    and z within 1e-5 (f32 convolutions summed in another order)."""
    _, jc, pc = wide_pair
    x = np.random.default_rng(1).random(IMAGE).astype(np.float32)
    want = jax.jit(lambda v, xj: jc.module.apply(v, xj, training=False))(
        jc.variables, jnp.asarray(x))
    with torch.no_grad():
        got = pc.module(nchw(x), training=False)
    assert _rel_err(nhwc(got["x_hat"]), want["x_hat"]) < 1e-5
    assert set(got["likelihoods"]) == set(want["likelihoods"])
    for k, v in want["likelihoods"].items():
        assert _rel_err(nhwc(got["likelihoods"][k]), v) < 1e-5, k


def test_strings_byte_identical(wide_pair):
    _, jc, pc = wide_pair
    x = pixels(IMAGE, seed=2)
    want = jc.compress(x)
    got = pc.compress(x)
    assert tuple(got["shape"]) == tuple(want["shape"])
    assert got["strings"] == want["strings"]


def _noise(nchw_shape):
    """U(-0.5, 0.5) noise for a port-layout shape, from the shape alone."""
    rng = np.random.default_rng([17, *nchw_shape])
    return rng.uniform(-0.5, 0.5, nchw_shape)


def _jax_noise(x, key):
    shape = tuple(x.shape)
    if len(shape) == 4:  # GaussianConditional input, NHWC
        n = _noise((shape[0], shape[3], shape[1], shape[2]))
        n = n.transpose(0, 2, 3, 1)
    else:  # EntropyBottleneck values (C, 1, B*H*W), the same in both
        n = _noise(shape)
    return x + jnp.asarray(n, x.dtype)


def test_f32_train_step_matches_lmic_tpu(wide_pair, monkeypatch):
    """One f32 step on the same weights and noise, at the bars of
    tests/test_torch_train.py's f32 test: the losses to 1e-5 relative,
    every gradient leaf to 1e-3 of its largest value."""
    params = wide_pair[0]
    monkeypatch.setattr(jem, "quantize_noise", _jax_noise)
    monkeypatch.setattr(tem, "quantize_noise", lambda x, generator=None: (
        x + torch.from_numpy(_noise(tuple(x.shape))).to(x.dtype)))
    batch = (pixels(IMAGE, seed=3) / 255.0).astype(np.float32)
    jmod = jzoo.make_module(ARCH, 1, N=N, M=M)

    def loss_fn(p):
        out = jmod.apply({"params": p}, jnp.asarray(batch), training=True,
                         rngs={"noise": jax.random.key(0)})
        rd = jtrain.rate_distortion_loss(out, jnp.asarray(batch), LMBDA)
        aux = jmod.apply({"params": p}, method=type(jmod).aux_loss)
        return rd["loss"] + aux, {**rd, "aux_loss": aux}

    grads, metrics = jax.jit(jax.grad(loss_fn, has_aux=True))(
        jax.tree.map(jnp.asarray, params))
    want_m = {k: float(v) for k, v in metrics.items()}
    want_g = state_dict_from_jax(ARCH, jax.tree.map(np.asarray, grads))

    module = tzoo.make_module(ARCH, 1, N=N, M=M)
    module.load_state_dict(state_dict_from_jax(ARCH, params))
    module = module.to(memory_format=torch.channels_last)
    x = nchw(batch)
    out = module(x, training=True)
    rd = ttrain.rate_distortion_loss(out, x, LMBDA)
    aux = module.aux_loss()
    (rd["loss"] + aux).backward()
    got_m = {**{k: v.item() for k, v in rd.items()}, "aux_loss": aux.item()}
    for k in LOSSES:
        assert abs(got_m[k] - want_m[k]) <= 1e-5 * abs(want_m[k]), k
    got_g = {n: p.grad for n, p in module.named_parameters()}
    assert set(want_g) == set(got_g)
    for name, want in want_g.items():
        got = got_g[name]
        assert got is not None and got.dtype == want.dtype, name
        scale = want.abs().max().item()
        if scale == 0:  # e.g. quantiles' share of the RD loss
            assert got.abs().max().item() == 0, name
            continue
        assert (got - want).abs().max().item() / scale < 1e-3, name
