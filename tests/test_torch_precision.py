"""bf16 matmul precision in the port (`ops/precision.py`; `train_cli
--bf16`, `eval_model --half`) against lmic_tpu on the CPU.

lmic_tpu's flags run under `jax.default_matmul_precision("bfloat16")`,
which XLA on the CPU ignores. The reference is `bf16_reference`
(tests/torch_port_helpers.py): lmic_tpu's jaxpr evaluated with the f32
operands of every default-precision `dot_general`/`conv_general_dilated`
rounded to bf16, as a TPU computes it; its `jax.grad` carries the same
precision on the transposed ops, so it gives the bf16 gradients too.

Bars (N = 16, M = 24; cheng2020 M = N; 64x128 images):

- the port's rounded calls in a training forward equal the reference's
  default-precision ops, per arch;
- forward outputs and the wavefront step's scales within 2e-2 of each
  tensor's largest value of the reference, and rel-Fro(port, reference)
  at most 0.1 x rel-Fro(reference, lmic_tpu's f32): the port rounds
  where lmic_tpu does;
- the `--bf16` step's losses within 1e-3 relative, and its gradients,
  pooled over the leaves, at most 0.25 x as far from the reference as
  lmic_tpu's f32 gradients are;
- `--half` streams decode to the encoder's latents, differ from the f32
  streams of the same codec, leave its tables as they were;
- a `--bf16 --remat` step equals the `--bf16` step bit for bit.
"""

import functools

import jax
import jax.numpy as jnp
import flax.linen as fnn
import numpy as np
import pytest
import torch
from torch_port_helpers import (
    bf16_reference,
    nchw,
    nhwc,
    patch_same_noise,
    pixels,
    write_images,
)

from lmic_tpu import zoo as jzoo
from lmic_tpu.layers import layers as jl
from lmic_tpu.models import rgbt as jr
from lmic_tpu.models.joint import make_wavefront_step as jax_step
from lmic_tpu.utils import train as jtrain
from lmic_tpu.zoo.pretrained import import_reference_state_dict
from lmic_tpu_torch import layers as tl
from lmic_tpu_torch import zoo as tzoo
from lmic_tpu_torch.layers import GDN
from lmic_tpu_torch.models.codec import _symbols_to_host
from lmic_tpu_torch.models.joint import make_wavefront_step, wavefront_schedule
from lmic_tpu_torch.ops import precision
from lmic_tpu_torch.utils import train as ttrain
from lmic_tpu_torch.utils import train_cli
from lmic_tpu_torch.utils.crosscheck import fixed_noise
from lmic_tpu_torch.utils.serve import load_rgbt_codecs
from lmic_tpu_torch.zoo.convert import state_dict_from_jax

torch.set_num_threads(2)

BF16 = "bfloat16"
IMAGE = (1, 64, 128, 3)
WIDTHS = {"bmshj2018-hyperprior": (16, 24), "mbt2018-mean": (16, 24),
          "mbt2018": (16, 24), "cheng2020-attn": (16, 16),
          "guided": (16, 24), "master": (16, 24)}
MAX_BAR = 2e-2  # of each tensor's largest value
RATIO_BAR = 0.1  # of the bf16 rounding's own effect
GRAD_RATIO_BAR = 0.25
LMBDA = 1024.0


def _rel_fro(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _hold(name, got, ref, f32):
    """`got` (the port under the mode) against the bf16 reference `ref`
    and lmic_tpu's f32 `f32`, all numpy of one layout."""
    got, ref, f32 = (np.asarray(t, np.float64) for t in (got, ref, f32))
    assert got.shape == ref.shape, name
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err <= MAX_BAR, (name, err)
    near, effect = _rel_fro(got, ref), _rel_fro(ref, f32)
    assert near <= RATIO_BAR * effect, (name, near, effect)


def _np(t):
    return nhwc(t) if t.dim() == 4 else t.detach().numpy()


# -- round_bf16 ---------------------------------------------------------------

def _numpy_rne(a):
    """f32 -> bf16 -> f32 by bits, round to nearest even."""
    u = a.astype(np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    out = u.astype(np.uint32).view(np.float32)
    return np.where(np.isnan(a), a, out)


def test_round_bf16_is_round_to_nearest_even():
    ulp = 2.0 ** -7  # of bf16 at 1.0
    ties = np.array([1 + ulp / 2, 1 + 3 * ulp / 2, -(1 + ulp / 2),
                     -(1 + 3 * ulp / 2), 2 + ulp, 2 + 3 * ulp], np.float32)
    big = np.finfo(np.float32).max  # past bf16's largest: rounds to inf
    special = np.array([np.inf, -np.inf, big, -big, 0.0, -0.0, 1e-40,
                        np.finfo(np.float32).tiny], np.float32)
    rand = np.random.default_rng(0).standard_normal(4096).astype(
        np.float32) * np.float32(10.0) ** np.random.default_rng(1).integers(
        -30, 30, 4096).astype(np.float32)
    a = np.concatenate([ties, special, rand])
    got = precision.round_bf16(torch.from_numpy(a)).numpy()
    want = _numpy_rne(a)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    # ties to even: 1 + ulp/2 -> 1, 1 + 3ulp/2 -> 1 + 2ulp
    assert got[0] == 1.0 and got[1] == 1 + 2 * ulp
    assert np.isposinf(got[6:9:2]).all() and np.isneginf(got[7:10:2]).all()
    nan = precision.round_bf16(torch.tensor([float("nan")]))
    assert torch.isnan(nan).all()
    # the identity on bf16 and f64, which XLA does not round
    for dt in (torch.bfloat16, torch.float64):
        t = torch.randn(7, dtype=dt)
        assert precision.round_bf16(t) is t


def test_mode_nests_and_restores():
    assert precision.current() is None
    with precision.matmul_precision(BF16):
        assert precision.current() == BF16
        with precision.matmul_precision(None):
            assert precision.current() is None
        assert precision.current() == BF16
    assert precision.current() is None
    with pytest.raises(ValueError):
        with precision.matmul_precision("float16"):
            pass


# -- forwards -----------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _models(arch):
    """The port's module of `arch` at WIDTHS from seed 0 (GDN gammas moved
    off the diagonal), lmic_tpu's module and its params imported from the
    port's (CompressAI) state dict (no flax init to trace), and the inputs
    of a training forward (numpy NHWC; the master's: its image, the
    guide's x_hat and gs* maps from a port guide in f32)."""
    n, m = WIDTHS[arch]
    channel = 1 if arch == "master" else 3
    pmod = tzoo.create_model(arch, 1, seed=0, device="cpu", N=n, M=m,
                             channel=channel).module
    # every GDN gamma off the diagonal, as jax_params does, so that the
    # channel mixing (an f32 sum in every mode) is exercised
    rng = np.random.default_rng(0)
    with torch.no_grad():
        for name, p in pmod.named_parameters():
            if name.endswith(".gamma"):
                p += torch.from_numpy(rng.uniform(0, 0.05, p.shape)).float()
    params = import_reference_state_dict(arch, pmod.state_dict())["params"]
    jmod = jzoo.make_module(arch, 1, N=n, M=m, channel=channel)
    x = (pixels((*IMAGE[:3], channel), seed=3) / 255).astype(np.float32)
    inputs = (x,)
    if arch == "master":
        guide = tzoo.create_model("guided", 1, seed=1, channel=3,
                                  device="cpu", N=n, M=m).module
        g = (pixels((1, 2 * IMAGE[1], 2 * IMAGE[2], 3), seed=4) / 255)
        with torch.no_grad():
            out = guide(nchw(g.astype(np.float32)), training=False)
        inputs = (x, nhwc(out["x_hat"]),
                  {k: nhwc(out["hidden"][k]) for k in ("gs1", "gs2", "gs3")})
    return jmod, params, pmod, inputs


def _port_inputs(inputs):
    x, *rest = inputs
    if not rest:
        return (nchw(x),)
    g, hidden = rest
    return nchw(x), nchw(g), {k: nchw(v) for k, v in hidden.items()}


def _outputs(out):
    keys = ("x_hat", "beta", "gamma")
    got = {k: out[k] for k in keys if k in out}
    got.update({f"likelihoods.{k}": v for k, v in out["likelihoods"].items()})
    return got


# deep graphs: an f32 op that differs by an ulp between XLA and torch (a
# GDN's channel sum, a sigmoid, a softmax) flips bf16 roundings further
# on, and the flips cascade to the size of the rounding's own effect (a
# one-ulp move of g_a's GDN betas moves cheng2020-attn's bf16 x_hat by
# 0.0093 of its norm against the rounding's 0.0151; ROADMAP.md C). Their
# whole forward is held to the placement and the largest-value bar where
# it holds; the ratio bar block by block (test_deep_blocks_*).
SHALLOW = ("bmshj2018-hyperprior", "guided", "mbt2018", "mbt2018-mean")
DEEP_HELD = {"cheng2020-attn": ("x_hat", "likelihoods.z"),
             "master": ("x_hat", "beta", "gamma", "likelihoods.y",
                        "likelihoods.z")}


def _recording(monkeypatch):
    """Record (family, output elements) of each rounded op of the port."""
    log = []
    for fn, family in ((precision._Conv, "conv"), (precision._Linear, "dot"),
                       (precision._Matmul, "dot")):
        def apply(*args, _apply=fn.apply, _family=family):
            out = _apply(*args)
            log.append((_family, out.numel()))
            return out
        monkeypatch.setattr(fn, "apply", apply)
    return log


def _placement(rounded):
    return sorted(("conv" if name == "conv_general_dilated" else "dot",
                   numel) for name, numel in rounded)


@pytest.mark.parametrize("arch", sorted(WIDTHS))
def test_training_forward_rounds_where_lmic_tpu_does(arch, monkeypatch):
    """The port rounds the same ops as lmic_tpu (each one's kind and
    output size, so also their count); the outputs (and y, z of the
    analysis) meet the bars."""
    patch_same_noise(monkeypatch)
    jmod, params, pmod, inputs = _models(arch)
    key = jax.random.key(0)

    def forward(p, *args):
        return jmod.apply({"params": p}, *args, training=True,
                          rngs={"noise": key})

    ref, rounded = bf16_reference(forward, params, *inputs)
    f32 = jax.jit(forward)(params, *inputs)
    log = _recording(monkeypatch)
    precision.reset_rounded_calls()
    with torch.no_grad(), precision.matmul_precision(BF16):
        got = pmod(*_port_inputs(inputs), training=True)
    assert precision.rounded_calls() == len(rounded) > 0
    assert sorted(log) == _placement(rounded)
    ref, f32 = _outputs(ref), _outputs(f32)
    for name, t in _outputs(got).items():
        if arch in SHALLOW:
            _hold(name, _np(t), ref[name], f32[name])
        elif name in DEEP_HELD[arch]:
            err = np.abs(_np(t) - ref[name]).max() / np.abs(ref[name]).max()
            assert err <= MAX_BAR, (name, err)
    if arch not in SHALLOW:
        return

    def analyze(p, x):
        return jmod.apply({"params": p}, x, method=type(jmod).analyze)

    (ref_y, ref_z), _ = bf16_reference(analyze, params, inputs[0])
    f32_y, f32_z = jax.jit(analyze)(params, inputs[0])
    with torch.no_grad(), precision.matmul_precision(BF16):
        y, z = pmod.analyze(nchw(inputs[0]))
    _hold("y", nhwc(y), ref_y, f32_y)
    _hold("z", nhwc(z), ref_z, f32_z)


@pytest.mark.parametrize("side", ("g_a", "g_s"))
def test_deep_blocks_round_where_lmic_tpus_do(side):
    """cheng2020-attn's g_a and g_s block by block, each block fed the
    reference's input: rounded ops equal in count, outputs within both
    bars."""
    jmod, params, pmod, (x,) = _models("cheng2020-attn")

    def chain(p, h):
        def run(m, h):
            outs = [h]
            for layer in getattr(m, f"{side}_net").layers:
                outs.append(layer(outs[-1]))
            return outs
        return jmod.apply({"params": p}, h, method=run)

    def blocks(p, ins):
        return jmod.apply({"params": p}, ins, method=lambda m, ins: [
            layer(h) for layer, h in zip(getattr(m, f"{side}_net").layers,
                                         ins)])

    h = x
    if side == "g_s":
        (y, _), _ = bf16_reference(lambda p, x: jmod.apply(
            {"params": p}, x, method=type(jmod).analyze), params, x)
        h = np.round(np.asarray(y))
    ref, rounded = bf16_reference(chain, params, h)
    ins = [np.asarray(r) for r in ref[:-1]]
    f32 = jax.jit(blocks)(params, ins)
    precision.reset_rounded_calls()
    with torch.no_grad(), precision.matmul_precision(BF16):
        got = [block(nchw(i)) for block, i in zip(getattr(pmod, side), ins)]
    assert precision.rounded_calls() == len(rounded)
    for i, (g, r, f) in enumerate(zip(got, ref[1:], f32)):
        _hold(f"{side}[{i}]", nhwc(g), r, f)


def test_deep_master_stages_round_where_lmic_tpus_do():
    """The master's own rounded ops: its features stage (feature encoders
    and channel aligner) on its inputs within both bars, and each Swin
    spatial aligner on seeded maps of its geometry, the same ops rounded,
    within the largest-value bar."""
    jmod, params, pmod, (x, g, _) = _models("master")
    n = WIDTHS["master"][0]

    def features(p, x, g):
        return jmod.apply({"params": p}, x, g, method=type(jmod).features)

    ref, _ = bf16_reference(features, params, x, g)
    f32 = jax.jit(features)(params, x, g)
    with torch.no_grad(), precision.matmul_precision(BF16):
        got = pmod.features(nchw(x), nchw(g))
    for name, a, r, f in zip(("x_feature", "align", "beta", "gamma"), got,
                             ref, f32):
        _hold(name, _np(a), r, f)
    rng = np.random.default_rng(9)
    for k, (h, w) in enumerate(((8, 16), (16, 32), (32, 64)), 1):
        # each aligner at the largest-value bar: a LayerNorm's or a
        # softmax's ulps feed its rounded products, and the flips cascade
        # through its two Swin cross blocks (ROADMAP.md C)
        out, guide = (rng.standard_normal((1, h, w, n)).astype(np.float32)
                      for _ in range(2))
        aligner = jr.SpatialAligner(out_channel=n)
        ref, rounded = bf16_reference(
            lambda p, a, b: aligner.apply({"params": p}, a, b),
            params["g_s_net"][f"sp_aligner{k}"], out, guide)
        precision.reset_rounded_calls()
        with torch.no_grad(), precision.matmul_precision(BF16):
            got = nhwc(getattr(pmod.decoder, f"sp_aligner{k}")(
                nchw(out), nchw(guide)))
        assert precision.rounded_calls() == len(rounded)
        err = np.abs(got - ref).max() / np.abs(ref).max()
        assert err <= MAX_BAR, (k, err)


def test_gdn_and_bottleneck_stay_f32():
    """lmic_tpu computes both at HIGHEST: under the mode they round
    nothing and give the f32 bits."""
    pmod = _models("mbt2018-mean")[2]
    x = torch.randn(2, 16, 8, 8).contiguous(memory_format=torch.channels_last)
    gdn = GDN(16)
    eb = pmod.entropy_bottleneck
    z = torch.randn(2, eb.channels, 4, 8)
    with torch.no_grad():
        want = gdn(x), eb(z, training=False)[1]
        precision.reset_rounded_calls()
        with precision.matmul_precision(BF16):
            got = gdn(x), eb(z, training=False)[1]
    assert precision.rounded_calls() == 0
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_wavefront_step_scales_round_where_lmic_tpus_do():
    """mbt2018's step on the same latents and hyper params: every product
    but the taps' rounded (prepare's, the folded context bias, the three
    MLP layers), scales and means within the bars at every step."""
    jmod, params, pmod, _ = _models("mbt2018")
    M = WIDTHS["mbt2018"][1]
    H, W = IMAGE[1] // 16, IMAGE[2] // 16
    rng = np.random.default_rng(8)
    hyper = rng.standard_normal((H, W, 2 * M)).astype(np.float32)
    y_pad = np.round(3 * rng.standard_normal((H + 4, W + 4, M))).astype(
        np.float32)
    table = np.exp(np.linspace(np.log(0.11), np.log(256), 64)).astype(
        np.float32)
    sched = wavefront_schedule(H, W, "cpu")

    def steps(p, hyper, y_pad):
        prepare, step = jax_step(jmod, {"params": p}, H, W, table)
        pre1 = prepare(hyper)
        return [step(t, y_pad, pre1)[3:5] for t in range(sched.T)]

    ref, rounded = bf16_reference(steps, params, hyper, y_pad)
    f32 = jax.jit(steps)(params, hyper, y_pad)
    buf = torch.from_numpy(y_pad.reshape(-1, M))
    precision.reset_rounded_calls()
    with torch.no_grad(), precision.matmul_precision(BF16):
        prepare, step = make_wavefront_step(pmod, sched, table)
        pre1 = prepare(nchw(hyper[None]))
        got = [step(t, buf, pre1)[:2] for t in range(sched.T)]
    # per step three MLP products and the taps' (HIGHEST, not rounded),
    # once prepare's and the folded context bias's
    assert precision.rounded_calls() == len(rounded) == 3 * sched.T + 2
    for name, i in (("scales", 0), ("means", 1)):
        _hold(name, np.concatenate([g[i].numpy() for g in got]),
              np.concatenate([r[i] for r in ref]),
              np.concatenate([f[i] for f in f32]))


# -- the --bf16 step ----------------------------------------------------------

def test_bf16_step_matches_the_interpreted_grad(monkeypatch):
    """The losses and the gradients of lmic_tpu's `--bf16` loss (the
    module's forward rounded, the RD and aux losses f32) against the
    port's `make_train_step(matmul_precision="bfloat16")` objective, on
    mbt2018-mean. (cheng2020-attn's whole step cascades like its forward,
    ROADMAP.md C; each rounded op's backward is held below.)"""
    arch = "mbt2018-mean"
    patch_same_noise(monkeypatch)
    jmod, params, pmod, (x,) = _models(arch)
    key = jax.random.key(0)

    def loss_fn(p, x):
        out = jmod.apply({"params": p}, x, training=True, rngs={"noise": key})
        rd = jtrain.rate_distortion_loss(out, x, LMBDA)
        aux = jmod.apply({"params": p}, method=type(jmod).aux_loss)
        return rd["loss"] + aux, {**rd, "aux_loss": aux}

    grad = jax.grad(loss_fn, has_aux=True)
    (ref_g, ref_m), _ = bf16_reference(grad, params, x)
    f32_g, _ = jax.jit(grad)(params, x)
    pmod.zero_grad(set_to_none=True)
    with precision.matmul_precision(BF16):
        out = pmod(nchw(x), training=True)
    loss, metrics = ttrain.rd_aux_loss(pmod, out, nchw(x), LMBDA)
    loss.backward()
    for k, v in metrics.items():
        want = float(ref_m[k])
        assert abs(float(v) - want) <= 1e-3 * abs(want), k
    ref_g, f32_g = (state_dict_from_jax(arch, jax.tree.map(np.asarray, g))
                    for g in (ref_g, f32_g))
    near = effect = 0.0
    for name, p in pmod.named_parameters():
        ref, scale = ref_g[name].double(), ref_g[name].double().norm()
        if scale == 0:
            continue
        near += ((p.grad.double() - ref).norm() / scale).item() ** 2
        effect += ((f32_g[name].double() - ref).norm() / scale).item() ** 2
    assert effect > 0 and near <= GRAD_RATIO_BAR ** 2 * effect, (
        np.sqrt(near), np.sqrt(effect))


# one rounded op of each kind: (lmic_tpu's layer or function, the port's,
# input shape NHWC or tokens, the converter of a weight's gradient)
OPS = {
    "conv5x5_s2": (lambda: jl.Conv(8, 5, 2), lambda: tl.Conv(6, 8, 5, 2),
                   (2, 8, 12, 6), "conv"),
    "deconv5x5_s2": (lambda: jl.Deconv(8, 5, 2),
                     lambda: tl.Deconv(6, 8, 5, 2), (2, 8, 12, 6),
                     "deconv"),
    "masked_conv_A": (lambda: jl.MaskedConv2d(8, mask_type="A"),
                      lambda: tl.MaskedConv2d(6, 8, 5, "A"), (2, 8, 12, 6),
                      "conv"),
    "dense": (lambda: fnn.Dense(8), lambda: tl.Linear(6, 8), (2, 10, 6),
              "dense"),
}
_WEIGHT = {"conv": lambda k: k.transpose(3, 2, 0, 1),
           "deconv": lambda k: k[::-1, ::-1].transpose(2, 3, 0, 1),
           "dense": lambda k: k.T}


def _kernel_node(tree):
    """The dict holding a layer's `kernel` (lmic_tpu's Conv/Deconv nest
    flax's `Conv_0`)."""
    return tree if "kernel" in tree else _kernel_node(tree["Conv_0"])


@pytest.mark.parametrize("name", sorted(OPS) + ["matmul"])
def test_rounded_op_backward_is_jaxs_vjp(name):
    """Each kind of rounded op, forward and backward, against JAX's VJP of
    lmic_tpu's op under the reference (its transposed ops rounded too):
    the output and every gradient within both bars."""
    rng = np.random.default_rng(12)
    if name == "matmul":
        a, b = (rng.standard_normal(s).astype(np.float32)
                for s in ((2, 3, 5, 6), (2, 3, 6, 7)))
        g = rng.standard_normal((2, 3, 5, 7)).astype(np.float32)

        def vjp(a, b, g):
            y, back = jax.vjp(jnp.matmul, a, b)
            return (y, *back(g))

        ref, rounded = bf16_reference(vjp, a, b, g)
        f32 = jax.jit(vjp)(a, b, g)
        at, bt = (torch.from_numpy(v).requires_grad_() for v in (a, b))
        with precision.matmul_precision(BF16):
            y = precision.matmul(at, bt)
        y.backward(torch.from_numpy(g))
        got = (y.detach().numpy(), at.grad.numpy(), bt.grad.numpy())
        assert len(rounded) == 3  # the product and its two transposes
        for label, t, r, f in zip(("y", "da", "db"), got, ref, f32):
            _hold(label, t, r, f)
        return
    make_j, make_t, shape, kind = OPS[name]
    jlayer, tlayer = make_j(), make_t()
    x = rng.standard_normal(shape).astype(np.float32)
    params = jax.tree.map(np.asarray, jlayer.init(jax.random.key(3), x)[
        "params"])
    leaves = _kernel_node(params)
    leaves["bias"] = rng.uniform(-0.5, 0.5, leaves["bias"].shape).astype(
        np.float32)
    tlayer.load_state_dict({"weight": torch.from_numpy(np.ascontiguousarray(
        _WEIGHT[kind](leaves["kernel"]))),
        "bias": torch.from_numpy(leaves["bias"])}, strict=False)
    y_shape = jax.eval_shape(lambda p, x: jlayer.apply({"params": p}, x),
                             params, x).shape
    g = rng.standard_normal(y_shape).astype(np.float32)

    def vjp(p, x, g):
        y, back = jax.vjp(lambda p, x: jlayer.apply({"params": p}, x), p, x)
        return (y, *back(g))

    ref, rounded = bf16_reference(vjp, params, x, g)
    f32 = jax.jit(vjp)(params, x, g)
    image = len(shape) == 4
    xt = (nchw(x) if image else torch.from_numpy(x)).requires_grad_()
    with precision.matmul_precision(BF16):
        y = tlayer(xt)
    y.backward(nchw(g) if image else torch.from_numpy(g))
    assert len(rounded) == 3  # the op, its input's and its kernel's VJPs

    def lay(t):
        return nhwc(t) if image else t.detach().numpy()

    _hold("y", lay(y), ref[0], f32[0])
    _hold("dx", lay(xt.grad), ref[2], f32[2])
    ref_w, f32_w = _kernel_node(ref[1]), _kernel_node(f32[1])
    _hold("dw", tlayer.weight.grad.numpy(),
          _WEIGHT[kind](np.asarray(ref_w["kernel"])),
          _WEIGHT[kind](np.asarray(f32_w["kernel"])))
    np.testing.assert_allclose(tlayer.bias.grad.numpy(), ref_w["bias"],
                               rtol=1e-5, atol=1e-5)


def _step_grads(arch, remat, dtype=None):
    module = tzoo.create_model(arch, 1, seed=0, device="cpu", dtype=dtype,
                               N=WIDTHS[arch][0], M=WIDTHS[arch][1]).module
    opt = ttrain.make_optimizer(0.0, 0.0)
    step = ttrain.make_train_step(module, opt, LMBDA, remat=remat,
                                  matmul_precision=BF16)
    x = nchw(pixels((2, 64, 64, 3), seed=3) / 255.0).float()
    precision.reset_rounded_calls()
    with fixed_noise():
        _, metrics = step(ttrain.create_train_state(module, opt), x)
    return (precision.rounded_calls(),
            {k: v.item() for k, v in metrics.items()},
            {n: p.grad for n, p in module.named_parameters()})


@pytest.mark.parametrize("arch", ("mbt2018-mean", "cheng2020-attn"))
def test_bf16_remat_step_equals_the_bf16_step(arch):
    """The recompute re-enters the forward's mode: the losses and every
    clipped gradient equal bit for bit, with each checkpointed block's
    rounded ops run twice."""
    calls, plain_m, plain_g = _step_grads(arch, False)
    remat_calls, remat_m, remat_g = _step_grads(arch, True)
    assert remat_calls > calls > 0
    assert remat_m == plain_m
    for name, want in plain_g.items():
        assert torch.equal(remat_g[name], want), name


def test_amp_bf16_step_runs():
    """`--amp --bf16`: the rounding is the identity on the bf16 operands,
    so the rounded ops run the AMP step's products."""
    calls, metrics, grads = _step_grads("mbt2018-mean", False,
                                        torch.bfloat16)
    assert calls > 0 and all(np.isfinite(v) for v in metrics.values())
    assert all(torch.isfinite(g).all() for g in grads.values())


@pytest.mark.parametrize("flags", (["--bf16"], ["--bf16", "--remat"],
                                   ["--bf16", "--amp"]),
                         ids=("bf16", "bf16-remat", "bf16-amp"))
def test_train_cli_bf16(tmp_path, monkeypatch, flags):
    monkeypatch.setitem(tzoo.cfgs, "mbt2018-mean", {1: (16, 24)})
    write_images(tmp_path / "train", 2, (64, 64))
    save = tmp_path / "ck.ckpt"
    assert train_cli.main(["--arch", "mbt2018-mean", "-d", str(tmp_path),
                           "--device", "cpu", "--patch-size", "64", "64",
                           "--batch-size", "2", "--epochs", "1",
                           "--prefetch", "0", "--save-path", str(save)]
                          + flags) == 0
    assert save.exists()


# -- --half round trips -------------------------------------------------------

def _image_latents(codec, x):
    """The hyperprior family's decoded float pixels equal g_s of the
    encoder's latents, computed on the encode side."""
    with torch.inference_mode():
        y, z = codec.module.analyze(codec._pixels(x))
        z_sym = _symbols_to_host(
            torch.round(z - codec._medians(codec.eb_state)))
        _, means = codec._params_for_wire_z(z_sym)
        want = codec._synthesize(torch.round(y - means) + means,
                                 u8=False)["x_hat"]
    return want


def _round_trip(family):
    """(f32 strings, --half strings, --half strings again, the check that
    the --half stream decodes to its encoder's latents)."""
    if family == "rgbt":
        (guided, master), _ = load_rgbt_codecs(1, 1, seed=0, device="cpu",
                                               N=16, M=24)
        x = pixels((1, 64, 64, 1), seed=2)
        guide = pixels((1, 128, 128, 3), seed=1)

        def code():
            g_out = guided.compress(guide, hidden=False, reconstruct=True)
            return master.compress(x, g_out["x_hat"]), g_out

        def decodes(out, g_out):
            g_dec = guided.decompress(g_out["strings"], g_out["shape"])
            assert torch.equal(g_dec["x_hat"], g_out["x_hat"])
            with torch.inference_mode():
                feat, align, _, _ = master.module.features(
                    master._pixels(x), g_out["x_hat"])
                y, z = master.module.analyze_features(feat, align)
                z_sym = _symbols_to_host(
                    torch.round(z - master._medians(master.eb_state)))
                enc = master._code_y_z([y], z_sym, keep_y_hat=True)
                dec = master._decode_y_hat(enc["strings"], enc["shape"])
            assert enc["strings"] == out["strings"]
            assert torch.equal(dec, enc["y_hat_latent"])
            rec = master.decompress(out, g_dec)["x_hat"]
            assert rec.shape == x.shape

        codecs = (guided, master)
    else:
        arch = {"hyperprior": "mbt2018-mean", "ar": "mbt2018"}[family]
        codec = tzoo.create_model(arch, 1, seed=0, device="cpu", N=16,
                                  M=24)
        codec.update()
        x = pixels(IMAGE, seed=2)
        codecs = (codec,)

        def code():
            return codec.compress(x), None

        def decodes(out, _):
            if family == "ar":
                with torch.inference_mode():
                    ys, z_sym = codec._analyze(x)
                    enc = codec._code_y_z(ys, z_sym, keep_y_hat=True)
                    dec = codec._decode_y_hat(enc["strings"], enc["shape"])
                assert enc["strings"] == out["strings"]
                assert torch.equal(dec, enc["y_hat_latent"])
            got = codec.decompress(out["strings"], out["shape"])["x_hat"]
            if family == "hyperprior":
                assert np.array_equal(got, _image_latents(codec, x))
            assert got.shape == x.shape and np.isfinite(got).all()

    tables = [(c.eb_state, c.gc_state) for c in codecs]
    f32 = code()[0]
    with precision.matmul_precision(BF16):
        half, g_out = code()
        decodes(half, g_out)
    again = code()[0]
    assert tables == [(c.eb_state, c.gc_state) for c in codecs]
    return f32, half, again


@pytest.mark.parametrize("family", ("hyperprior", "ar", "rgbt"))
def test_half_round_trip(family):
    """A `--half` stream decodes under `--half` to the encoder's latents;
    it differs from the f32 stream of the same codec, which reads the
    mode at each call (f32 again after it), and the tables stay."""
    f32, half, again = _round_trip(family)
    assert half["strings"] != f32["strings"]
    assert again["strings"] == f32["strings"]


def test_export_refuses_under_the_mode(tmp_path):
    from lmic_tpu_torch.utils.aot import export_serving_bundle

    codec = tzoo.create_model("bmshj2018-factorized", 1, seed=0,
                              device="cpu", N=16, M=24)
    codec.update()
    with precision.matmul_precision(BF16):
        with pytest.raises(RuntimeError, match="matmul precision"):
            export_serving_bundle(codec, str(tmp_path), (1, 64, 64, 3))
    assert not (tmp_path / "fns").exists() or not any(
        (tmp_path / "fns").iterdir())


def _report():
    """The numbers behind ROADMAP.md C's bf16 entry: each arch's whole
    training forward against the reference (largest-value error, rel-Fro
    to the reference, the rounding's own rel-Fro), cheng2020-attn's and
    mbt2018-mean's `--bf16` gradients pooled, and how far a one-ulp move
    of g_a's GDN betas (an f32 op in every mode) moves each mode's
    x_hat."""
    monkeypatch = pytest.MonkeyPatch()
    patch_same_noise(monkeypatch)
    key = jax.random.key(0)
    for arch in sorted(WIDTHS):
        jmod, params, pmod, inputs = _models(arch)

        def forward(p, *args):
            return jmod.apply({"params": p}, *args, training=True,
                              rngs={"noise": key})

        ref = _outputs(bf16_reference(forward, params, *inputs)[0])
        f32 = _outputs(jax.jit(forward)(params, *inputs))
        with torch.no_grad(), precision.matmul_precision(BF16):
            got = _outputs(pmod(*_port_inputs(inputs), training=True))
        for name, t in got.items():
            g, r = _np(t), np.asarray(ref[name], np.float64)
            err = np.abs(g - r).max() / np.abs(r).max()
            print(f"{arch} {name}: max {err:.3g}, rel-Fro "
                  f"{_rel_fro(g, r):.3g}, rounding's "
                  f"{_rel_fro(r, f32[name]):.3g}")
    for arch in ("mbt2018-mean", "cheng2020-attn"):
        jmod, params, pmod, (x,) = _models(arch)

        def loss_fn(p, x):
            out = jmod.apply({"params": p}, x, training=True,
                             rngs={"noise": key})
            aux = jmod.apply({"params": p}, method=type(jmod).aux_loss)
            return jtrain.rate_distortion_loss(out, x, LMBDA)["loss"] + aux

        grad = jax.grad(loss_fn)
        ref_g, f32_g = (
            state_dict_from_jax(arch, jax.tree.map(np.asarray, g))
            for g in (bf16_reference(grad, params, x)[0],
                      jax.jit(grad)(params, x)))
        pmod.zero_grad(set_to_none=True)
        with precision.matmul_precision(BF16):
            out = pmod(nchw(x), training=True)
        ttrain.rd_aux_loss(pmod, out, nchw(x), LMBDA)[0].backward()
        near = effect = 0.0
        for name, p in pmod.named_parameters():
            ref, scale = ref_g[name].double(), ref_g[name].double().norm()
            if scale:
                near += ((p.grad.double() - ref).norm() / scale) ** 2
                effect += ((f32_g[name].double() - ref).norm() / scale) ** 2
        print(f"{arch} --bf16 gradients pooled: {near.sqrt().item():.3g} "
              f"against the rounding's {effect.sqrt().item():.3g}")
        n, m = WIDTHS[arch]
        module = tzoo.create_model(arch, 1, seed=0, device="cpu", N=n,
                                   M=m).module
        xt = nchw(x)

        def run(mode):
            with fixed_noise(), torch.no_grad(), \
                    precision.matmul_precision(mode):
                return module(xt, training=True)["x_hat"].numpy()

        before = {m: run(m) for m in (None, BF16)}
        with torch.no_grad():
            for name, p in module.named_parameters():
                if name.startswith("g_a") and name.endswith("beta"):
                    p.copy_(torch.nextafter(p, torch.full_like(p, 1e30)))
        print(f"{arch} one ulp on g_a's GDN betas moves x_hat: f32 "
              f"{_rel_fro(run(None), before[None]):.3g}, bf16 "
              f"{_rel_fro(run(BF16), before[BF16]):.3g}; the rounding's "
              f"{_rel_fro(before[BF16], before[None]):.3g}")
    monkeypatch.undo()


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu PYTHONPATH=.:tests python tests/test_torch_precision.py
    _report()
