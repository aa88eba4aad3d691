"""The port's transforms and eval-mode likelihoods against lmic_tpu on the
same weights, for the three non-AR archs; and the weight conversion
JAX -> port state_dict -> lmic_tpu's reference importer is lossless."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmic_tpu.zoo.pretrained import import_reference_state_dict
from lmic_tpu_torch.zoo.convert import state_dict_from_jax
from torch_port_helpers import (
    ARCHS,
    IMAGE,
    jax_codec,
    jax_params,
    nchw,
    nhwc,
    port_codec,
)

torch.set_num_threads(2)

# f32 convolutions summed in another order by XLA and by torch (and the
# deconv as a dilated correlation against a transposed conv): ~1e-6
RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    arch = request.param
    params = jax_params(arch)
    jc = jax_codec(arch, params)
    pc = port_codec(arch, params)
    x = np.random.default_rng(1).random(IMAGE).astype(np.float32)
    return arch, params, jc, pc, x


def _apply(jc, *args, method):
    return jc.module.apply(jc.variables, *args,
                           method=getattr(type(jc.module), method))


def _close(got, want):
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)


def test_g_a_and_g_s(pair):
    _, _, jc, pc, x = pair
    y_j = _apply(jc, jnp.asarray(x), method="g_a")
    with torch.no_grad():
        y_t = pc.module.g_a(nchw(x))
        _close(nhwc(y_t), y_j)
        x_t = pc.module.g_s(nchw(np.asarray(y_j)))
    _close(nhwc(x_t), _apply(jc, y_j, method="g_s"))


@pytest.mark.parametrize("pair", ARCHS[1:], indirect=True)
def test_hyper_paths(pair):
    _, _, jc, pc, x = pair
    y_j, z_j = _apply(jc, jnp.asarray(x), method="analyze")
    z_hat = np.round(np.asarray(z_j))
    s_j, m_j = _apply(jc, jnp.asarray(z_hat), method="hyper_to_params")
    with torch.no_grad():
        y_t, z_t = pc.module.analyze(nchw(x))
        h_t = pc.module.h_a(pc.module._hyper_input(nchw(np.asarray(y_j))))
        s_t, m_t = pc.module.hyper_to_params(nchw(z_hat))
    _close(nhwc(z_t), z_j)
    _close(nhwc(h_t), z_j)
    _close(nhwc(s_t), s_j)
    assert (m_t is None) == (m_j is None)
    if m_j is not None:
        _close(nhwc(m_t), m_j)


def test_eval_likelihoods(pair):
    _, _, jc, pc, x = pair
    want = jc.module.apply(jc.variables, jnp.asarray(x), training=False)
    with torch.no_grad():
        got = pc.module(nchw(x), training=False)
    _close(nhwc(got["x_hat"]), want["x_hat"])
    for k, v in want["likelihoods"].items():
        _close(nhwc(got["likelihoods"][k]), v)


def test_weight_round_trip(pair):
    arch, params, jc, pc, _ = pair
    sd = state_dict_from_jax(arch, params)
    assert set(sd) == set(pc.module.state_dict())
    back = import_reference_state_dict(arch, sd, variables=jc.variables)
    flat_a = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back["params"])[0])
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)
