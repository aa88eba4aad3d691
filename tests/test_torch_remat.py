"""`--remat` in the port (layers/remat.py, `make_train_step(remat=True)`,
`make_master_train_step(remat=True)`, `train_cli --remat`) on the CPU:

- a remat step equals the plain step exactly (the same weights, batch and
  generator seed), in f32 and in AMP where the arch takes it;
- it matches lmic_tpu's `make_train_step(remat=True)` (the master:
  lmic_tpu's master step, which has no remat) at the f32 bars of
  tests/test_torch_train_ar.py and tests/test_torch_train_rgbt.py, on the
  same weights and noise (`patch_same_noise`);
- it recomputes: every GDN of a checkpointed block runs its forward twice,
  its backward once;
- it keeps less: the bytes saved for backward (distinct storages of the
  tensors the autograd graph saves, counted with
  `torch.autograd.graph.saved_tensors_hooks`, parameters left out as they
  stay whatever the step does) are below half of the plain step's.

Widths are the parity tests' (N = 16, M = 24; cheng2020 M = N; the RGB-T
pair N = 32, M = 48 on a 64x64 thermal master with a 128x128 guide)."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_train_ar import F32_GATE_FLIPS
from torch_port_helpers import (
    RGBT_GEOMETRY,
    RGBT_M,
    RGBT_N,
    jax_params,
    patch_same_noise,
    pixels,
    rgbt_pair,
    write_images,
)

from lmic_tpu import zoo as jzoo
from lmic_tpu.utils import train as jtrain
from lmic_tpu.utils import train_cli as jcli
from lmic_tpu_torch import zoo as tzoo
from lmic_tpu_torch.layers.remat import rematerialize
from lmic_tpu_torch.ops import gdn
from lmic_tpu_torch.utils import checkpoint as ckpt
from lmic_tpu_torch.utils import train as ttrain
from lmic_tpu_torch.utils import train_cli
from lmic_tpu_torch.zoo.convert import state_dict_from_jax

torch.set_num_threads(2)
LMBDA = 1024.0
LOSSES = ("loss", "mse_loss", "bpp_loss", "aux_loss")
# the archs of the single-model recipe, at the parity tests' widths
WIDTHS = {
    "mbt2018-mean": dict(N=16, M=24),
    "mbt2018": dict(N=16, M=24),
    "cheng2020-attn": dict(N=16, M=16),
    "guided": dict(N=16, M=24),
    "cheng2020-attn_R": dict(N=16, M=16),
}
AMP = ("mbt2018-mean", "mbt2018", "cheng2020-attn", "guided")
ROLE = 1
BATCH = (2, 64, 64, 3)


def _x(shape=BATCH, seed=3):
    return torch.from_numpy(pixels(shape, seed=seed) / 255.0).float() \
        .permute(0, 3, 1, 2)


def _master_inputs():
    (mH, mW), (gH, gW) = RGBT_GEOMETRY[ROLE]
    return (_x((2, mH, mW, ROLE), seed=5), _x((2, gH, gW, 4 - ROLE),
                                              seed=6))


def _single(arch, dtype=None):
    """A module of `arch` from seed 0 and its batch."""
    return (tzoo.create_model(arch, 1, seed=0, device="cpu", dtype=dtype,
                              **WIDTHS[arch]).module, _x())


def _pair():
    """The frozen guide (seed 0) and the master (seed 1)."""
    guided = tzoo.create_model("guided", 1, seed=0, channel=4 - ROLE,
                               device="cpu", N=RGBT_N, M=RGBT_M).module
    guided.eval().requires_grad_(False)
    master = tzoo.create_model("master", 1, seed=1, channel=ROLE,
                               device="cpu", N=RGBT_N, M=RGBT_M).module
    return guided, master


def _step(arch, remat, dtype=None, clip=1.0):
    """One step (lr 0: the parameters stay, the clipped gradients are
    kept) with a generator seeded 0: (metrics, {name: grad})."""
    opt = ttrain.make_optimizer(0.0, 0.0, clip)
    gen = torch.Generator().manual_seed(0)
    if arch == "master":
        guided, module = _pair()
        step = train_cli.make_master_train_step(module, guided, opt, LMBDA,
                                                remat=remat)
        _, metrics = step(ttrain.create_train_state(module, opt),
                          *_master_inputs(), gen)
    else:
        module, x = _single(arch, dtype)
        step = ttrain.make_train_step(module, opt, LMBDA, remat=remat)
        _, metrics = step(ttrain.create_train_state(module, opt), x, gen)
    return ({k: v.item() for k, v in metrics.items()},
            {n: p.grad for n, p in module.named_parameters()})


CASES = ([(a, None) for a in WIDTHS] + [(a, torch.bfloat16) for a in AMP]
         + [("master", None)])
IDS = [f"{a}-{'amp' if d else 'f32'}" for a, d in CASES]


@pytest.mark.parametrize("arch,dtype", CASES, ids=IDS)
def test_remat_step_equals_the_plain_step(arch, dtype):
    """The same weights, batch and generator seed: the losses and every
    clipped gradient leaf equal, bit for bit. The noise is drawn outside
    every checkpointed block, so the recompute meets the same values.
    (cheng2020-attn_R's `enc.res3` makes a tap the step does not read:
    no gradient in either.)"""
    plain_m, plain_g = _step(arch, False, dtype)
    remat_m, remat_g = _step(arch, True, dtype)
    assert remat_m == plain_m
    assert set(remat_g) == set(plain_g)
    for name, want in plain_g.items():
        got = remat_g[name]
        if want is None:
            assert got is None and name.startswith("enc.res3."), name
            continue
        assert torch.equal(got, want), name


# -- against lmic_tpu ---------------------------------------------------------


@pytest.fixture()
def same_noise(monkeypatch):
    patch_same_noise(monkeypatch)


def _capture():
    """An optax transformation whose state is the last raw gradients and
    that moves nothing."""
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))


def _check(arch, got_m, got_g, want_m, want_g):
    for k in LOSSES:
        assert abs(got_m[k] - want_m[k]) <= 1e-5 * abs(want_m[k]), k
    assert set(got_g) == set(want_g)
    flipped, flip_bar = F32_GATE_FLIPS.get(arch, ((), 1e-3))
    for name, want in want_g.items():
        got = got_g[name]
        scale = want.abs().max().item()
        if scale == 0:  # the quantiles' share of the RD loss
            assert got.abs().max().item() == 0, name
            continue
        bar = flip_bar if name.startswith(flipped) else 1e-3
        err = (got - want).abs().max().item() / scale
        assert err < bar, (name, err, bar)


@pytest.mark.parametrize("arch", ["mbt2018-mean", "mbt2018",
                                  "cheng2020-attn", "guided"])
def test_remat_step_matches_lmic_tpus_remat_step(arch, same_noise):
    """lmic_tpu's `make_train_step(remat=True)` and the port's on the same
    weights, batch and noise: the losses to 1e-5 relative, each raw
    gradient leaf to 1e-3 of its largest value (cheng2020-attn's two
    leaves past a leaky-ReLU gate that the two f32 sums set differently:
    1e-2, F32_GATE_FLIPS)."""
    n, m = WIDTHS[arch]["N"], WIDTHS[arch]["M"]
    params = jax_params(arch, n=n, m=m)
    batch = pixels(BATCH, seed=3) / 255.0
    jmod = jzoo.make_module(arch, 1, N=n, M=m)
    opt = _capture()
    state, jm = jtrain.make_train_step(jmod, opt, LMBDA, remat=True)(
        jtrain.create_train_state(jax.tree.map(jnp.asarray, params), opt),
        jnp.asarray(batch, jnp.float32), jax.random.key(0))
    want_g = state_dict_from_jax(arch, jax.tree.map(np.asarray,
                                                    state.opt_state))
    module = tzoo.make_module(arch, 1, N=n, M=m)
    module.load_state_dict(state_dict_from_jax(arch, params))
    module = module.to(memory_format=torch.channels_last)
    topt = ttrain.make_optimizer(0.0, 0.0, None)
    _, tm = ttrain.make_train_step(module, topt, LMBDA, remat=True)(
        ttrain.create_train_state(module, topt),
        torch.from_numpy(batch).float().permute(0, 3, 1, 2))
    _check(arch, {k: float(v) for k, v in tm.items()},
           {k: p.grad for k, p in module.named_parameters()},
           {k: float(v) for k, v in jm.items()}, want_g)


def test_master_remat_step_matches_lmic_tpu(same_noise):
    """The master's remat step against its frozen guide and lmic_tpu's
    master step (lmic_tpu rematerializes only the single-model step; the
    gradients are the same function): the bars of
    tests/test_torch_train_rgbt.py's master step."""
    (_, _, gparams), (_, _, mparams) = rgbt_pair(ROLE)
    (mH, mW), (gH, gW) = RGBT_GEOMETRY[ROLE]
    xm = (pixels((2, mH, mW, ROLE), seed=5) / 255.0).astype(np.float32)
    xg = (pixels((2, gH, gW, 4 - ROLE), seed=6) / 255.0).astype(np.float32)
    widths = dict(N=RGBT_N, M=RGBT_M)
    jm = jzoo.make_module("master", 1, channel=ROLE, **widths)
    jg = jzoo.make_module("guided", 1, channel=4 - ROLE, **widths)
    opt = _capture()
    state, metrics = jcli.make_master_train_step(
        jm, jg, jax.tree.map(jnp.asarray, gparams), opt, LMBDA)(
        jtrain.create_train_state(jax.tree.map(jnp.asarray, mparams), opt),
        jnp.asarray(xm), jnp.asarray(xg), jax.random.key(0))
    want_g = state_dict_from_jax("master", jax.tree.map(np.asarray,
                                                        state.opt_state))
    guide = tzoo.make_module("guided", 1, channel=4 - ROLE, **widths)
    guide.load_state_dict(state_dict_from_jax("guided", gparams))
    guide.eval().requires_grad_(False)
    master = tzoo.make_module("master", 1, channel=ROLE, **widths)
    master.load_state_dict(state_dict_from_jax("master", mparams))
    topt = ttrain.make_optimizer(0.0, 0.0, None)
    _, tm = train_cli.make_master_train_step(
        master, guide, topt, LMBDA, remat=True)(
        ttrain.create_train_state(master, topt),
        *(torch.from_numpy(a).permute(0, 3, 1, 2) for a in (xm, xg)))
    _check("master", {k: float(v) for k, v in tm.items()},
           {k: p.grad for k, p in master.named_parameters()},
           {k: float(v) for k, v in metrics.items()}, want_g)


# -- what it recomputes and what it keeps -------------------------------------


@pytest.fixture()
def gdn_calls(monkeypatch):
    """Counts of the GDN forward (`ops/gdn.py::_forward`, under the layer
    and under the autograd function) and of its backward on the CPU."""
    calls = {"fwd": 0, "bwd": 0}
    forward, backward = gdn._forward, gdn.gdn_bwd_reference

    def counted_forward(*args):
        calls["fwd"] += 1
        return forward(*args)

    def counted_backward(*args):
        calls["bwd"] += 1
        return backward(*args)

    monkeypatch.setattr(gdn, "_forward", counted_forward)
    monkeypatch.setattr(gdn, "gdn_bwd_reference", counted_backward)
    return calls


@pytest.mark.parametrize("arch", list(WIDTHS) + ["master"])
def test_remat_runs_every_gdn_forward_twice(arch, gdn_calls):
    """Every GDN/IGDN is in a checkpointed block: a remat step runs 12 GDN
    forwards where the plain step runs 6 (the master: 18 and 12, the
    frozen guide's 6 running once, without gradients); 6 backwards in
    both."""
    counts = {}
    for remat in (False, True):
        gdn_calls.update(fwd=0, bwd=0)
        _step(arch, remat)
        counts[remat] = dict(gdn_calls)
    guide = 6 if arch == "master" else 0
    assert counts[False] == {"fwd": guide + 6, "bwd": 6}
    assert counts[True] == {"fwd": guide + 12, "bwd": 6}


def _saved_bytes(module, forward, remat):
    """Bytes of the distinct storages the forward saves for backward,
    parameters left out."""
    params = {p.untyped_storage().data_ptr() for p in module.parameters()}
    saved = {}

    def pack(t):
        storage = t.untyped_storage()
        if storage.data_ptr() not in params:
            saved[storage.data_ptr()] = storage.nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        with rematerialize(remat):
            out = forward()
        loss, _ = ttrain.rd_aux_loss(module, out, out["x"], LMBDA)
    loss.backward()
    return sum(saved.values())


@pytest.mark.parametrize("arch", list(WIDTHS) + ["master"])
def test_remat_saves_less_than_half(arch):
    """The forward and loss of a remat step keep less than half the bytes
    of the plain step's for the backward (measured: 0.471 mbt2018-mean,
    0.408 mbt2018 and guided, 0.245 cheng2020-attn, 0.244 its `_R`, 0.081
    the master)."""
    sizes = {}
    for remat in (False, True):
        gen = torch.Generator().manual_seed(0)
        if arch == "master":
            guided, module = _pair()
            xm, xg = _master_inputs()
            with torch.no_grad():
                g = guided(xg, training=False)
            hidden = {k: g["hidden"][k] for k in ("gs1", "gs2", "gs3")}

            def forward():
                return dict(module(xm, g["x_hat"], hidden, training=True,
                                   generator=gen), x=xm)
        else:
            module, x = _single(arch)

            def forward():
                return dict(module(x, training=True, generator=gen), x=x)

        sizes[remat] = _saved_bytes(module, forward, remat)
    assert sizes[True] < 0.5 * sizes[False], sizes


# -- the CLI ------------------------------------------------------------------


def test_train_cli_remat_trains_as_the_plain_run(tmp_path, capsys,
                                                 monkeypatch):
    """`train_cli --remat` and the plain run from the same seed (the
    quality table patched to N = 16, M = 24): the same logged losses and
    the same checkpoint, bit for bit."""
    monkeypatch.setitem(tzoo.cfgs, "mbt2018-mean", {1: (16, 24)})
    write_images(tmp_path / "ds" / "train", 4, (72, 72), seed=1)
    outs = {}
    for flag in ([], ["--remat"]):
        save = tmp_path / f"ck{len(flag)}.ckpt"
        assert train_cli.main(
            ["--arch", "mbt2018-mean", "-q", "1", "-d",
             str(tmp_path / "ds"), "--batch-size", "2", "--patch-size",
             "64", "64", "--epochs", "1", "--log-every", "1",
             "--prefetch", "0", "--save-path", str(save), "--device",
             "cpu"] + flag) == 0
        losses = re.findall(r"loss=([0-9.]+) mse", capsys.readouterr().out)
        module = tzoo.make_module("mbt2018-mean", 1)
        ckpt.load_train_params(str(save), module)
        outs[bool(flag)] = (losses, module.state_dict())
    assert len(outs[True][0]) == 2 and outs[True][0] == outs[False][0]
    for k, v in outs[False][1].items():
        assert torch.equal(outs[True][1][k], v), k
