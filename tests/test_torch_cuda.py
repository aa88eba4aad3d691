"""The port on the card: the CUDA GDN kernels (forward and backward)
against their plain versions, the layer, the codecs and a training step
against the CPU path. Every test needs an NVIDIA GPU and skips elsewhere.
This file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import warnings

import numpy as np
import pytest
import torch

from lmic_tpu_torch import zoo
from lmic_tpu_torch.layers import GDN
from lmic_tpu_torch.ops import gdn

pytestmark = pytest.mark.cuda

NON_AR = ("bmshj2018-factorized", "bmshj2018-hyperprior", "mbt2018-mean")
AR_ARCHS = ("mbt2018", "cheng2020-anchor", "cheng2020-attn")

# the bars of tests/test_pallas_gdn.py: max|a-b| / max(1, max|b|)
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")


def _data(rows, C, dtype, seed=0, skew=False):
    """x, beta, gamma; with `skew` gamma is upper-triangular, so a kernel
    that reads gamma^T for gamma is caught."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((rows, C), generator=g)
    beta = torch.rand(C, generator=g) + 0.5
    gamma = torch.rand((C, C), generator=g) * 0.02 + 0.1 * torch.eye(C)
    if skew:
        gamma = gamma.triu() * (200.0 / C)
    return [t.to("cuda", dtype) for t in (x, beta, gamma)]


def _rel_err(a, b):
    a, b = a.float(), b.float()
    return ((a - b).abs().max() / b.abs().max().clamp(min=1.0)).item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("rows,C", [(6151, 192), (6144, 128), (1, 16),
                                    (130, 320)])
def test_kernel_matches_reference(dtype, inverse, rows, C):
    x, beta, gamma = _data(rows, C, dtype)
    n0 = gdn.LAUNCHES["gdn_fwd"]
    got = gdn.gdn_core(x, beta, gamma, inverse)
    torch.cuda.synchronize()
    assert gdn.LAUNCHES["gdn_fwd"] == n0 + 1
    assert got.dtype == dtype and got.shape == x.shape
    assert _rel_err(got, gdn.gdn_reference(x, beta, gamma, inverse)) \
        < TOL[dtype]
    # no atomics, fixed summation order: the same bytes on every launch
    assert torch.equal(got, gdn.gdn_core(x, beta, gamma, inverse))


def test_kernel_refuses_what_it_does_not_take():
    x, beta, gamma = _data(64, 32, torch.float32)
    with pytest.raises(TypeError):
        gdn.gdn_fwd(x.double(), beta.double(), gamma.double())
    with pytest.raises(ValueError):
        gdn.gdn_fwd(x, beta[:16], gamma)
    with pytest.raises(ValueError):
        gdn.gdn_fwd(x, beta.cpu(), gamma)
    with pytest.raises(TypeError):
        gdn.gdn_bwd(x.double(), beta.double(), gamma.double(), x.double())
    with pytest.raises(ValueError):
        gdn.gdn_bwd(x, beta, gamma, x[:8])
    with pytest.raises(ValueError):
        gdn.gdn_bwd(x, beta, gamma.cpu(), x)
    # a CUDA input that needs a gradient runs the forward kernel once and
    # the three backward kernels once each on .backward()
    before = dict(gdn.LAUNCHES)
    y = gdn.gdn_core(x.requires_grad_(), beta, gamma)
    assert gdn.LAUNCHES["gdn_fwd"] == before["gdn_fwd"] + 1
    assert all(gdn.LAUNCHES[k] == before[k] for k in gdn.BWD_KERNELS)
    y.sum().backward()
    torch.cuda.synchronize()
    assert all(gdn.LAUNCHES[k] == before[k] + 1 for k in gdn.BWD_KERNELS)
    assert gdn.LAUNCHES["gdn_fwd"] == before["gdn_fwd"] + 1
    assert x.grad is not None and torch.isfinite(x.grad).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("rows,C", [(6151, 192), (6144, 128), (1, 16),
                                    (130, 320)])
def test_bwd_kernel_matches_reference(dtype, inverse, rows, C):
    x, beta, gamma = _data(rows, C, dtype)
    g = torch.randn((rows, C), generator=torch.Generator().manual_seed(1)
                    ).to("cuda", dtype)
    before = dict(gdn.LAUNCHES)
    got = gdn.gdn_bwd(x, beta, gamma, g, inverse)
    torch.cuda.synchronize()
    assert all(gdn.LAUNCHES[k] == before[k] + 1 for k in gdn.BWD_KERNELS)
    want = gdn.gdn_bwd_reference(x, beta, gamma, g, inverse)
    for name, a, b in zip(("dx", "dbeta", "dgamma"), got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert _rel_err(a, b) < TOL[dtype], name
    # partial sums in a fixed order, no atomics: the same bytes every time
    again = gdn.gdn_bwd(x, beta, gamma, g, inverse)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("rows", [327_680, 327_687])
def test_bwd_kernel_at_the_master_steps_rows(inverse, rows):
    """f32 gdn_bwd at the RGB-T master step's largest GDN (a batch of 4
    512x640 thermal masters: 327,680 rows at C = 192), and a ragged count
    beside it."""
    _check_bwd(torch.float32, inverse, rows, 192)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("rows", [1_310_720, 1_310_727])
def test_kernel_at_the_master_steps_guide_rows(inverse, rows):
    """f32 gdn_fwd at the RGB-T master step's frozen guide (a batch of 4
    1024x1280 RGB guides after a stride-2 first conv: 1,310,720 rows at
    C = 192), and a ragged count beside it: equal to the plain version,
    the same bytes on every launch."""
    x, beta, gamma = _data(rows, 192, torch.float32, seed=rows, skew=True)
    n0 = gdn.LAUNCHES["gdn_fwd"]
    got = gdn.gdn_fwd(x, beta, gamma, inverse)
    torch.cuda.synchronize()
    assert gdn.LAUNCHES["gdn_fwd"] == n0 + 1
    assert torch.equal(got, gdn.gdn_reference(x, beta, gamma, inverse))
    assert torch.equal(got, gdn.gdn_fwd(x, beta, gamma, inverse))


# the tiled paths: ragged row counts around the tiles (16-row fragments in
# bf16, 8-row thread tiles and 32-row warps in f32) and C that is not a
# multiple of the tile (zero-padded in shared memory) up to the widest GDN
# of the zoo. bf16 runs on the tensor cores; f32 on the FP32 register
# tiles of csrc/gdn_f32.cuh, where C = 37 takes the element copies. Exact
# equality with the plain version is chip_smoke.py's check at the main
# path's shapes: at a few rows cuBLAS may sum in another order.
TILED = ([(torch.bfloat16, rows, C) for rows in (1, 15, 17, 16391)
          for C in (16, 40, 200, 320)]
         + [(torch.float32, rows, C) for rows in (1, 15, 17, 16391)
            for C in (16, 37, 40, 200, 320)])


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("dtype,rows,C", TILED)
def test_tiled_kernel_matches_reference(dtype, inverse, rows, C):
    x, beta, gamma = _data(rows, C, dtype, seed=rows + C, skew=True)
    n0 = gdn.LAUNCHES["gdn_fwd"]
    got = gdn.gdn_fwd(x, beta, gamma, inverse)
    torch.cuda.synchronize()
    assert gdn.LAUNCHES["gdn_fwd"] == n0 + 1
    assert got.dtype == dtype and got.shape == x.shape
    assert _rel_err(got, gdn.gdn_reference(x, beta, gamma, inverse)) \
        < TOL[dtype]
    assert torch.equal(got, gdn.gdn_fwd(x, beta, gamma, inverse))


# gdn_bwd's partials and reduce at the edges of their 1024-row chunks: one
# row short of a chunk, a whole chunk, one row into the next, and one row
# into the third; C = 37 takes the element copies, 128 and 192 the kernels
# compiled for that width.
CHUNK_EDGES = [(dtype, rows, C) for dtype in (torch.float32, torch.bfloat16)
               for rows in (1023, 1024, 1025, 2049) for C in (37, 128, 192)]


# bf16 gdn_bwd at a training step's rows (batch 16 of 256x256: 262,144 /
# 65,536 / 16,384, and a ragged count) at C = 128 and 192; at the widest C
# the bf16 backward takes; and with a ragged last 64-row tile in a chunk
# past the first edge. They cover the bf16 partials' clusters of 1, 2 and 4
# CTAs a chunk, one and 3 x 3 blocks of dgamma, and its element copies.
TRAINING = ([(torch.bfloat16, rows, C)
             for rows in (262_144, 65_536, 16_384, 16_391)
             for C in (128, 192)]
            + [(torch.bfloat16, rows, 432) for rows in (1_000, 16_391)]
            + [(torch.bfloat16, rows, C) for rows in (5_000, 70_001)
               for C in (37, 192)])


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("dtype,rows,C", TILED + CHUNK_EDGES + TRAINING)
def test_tiled_bwd_kernel_matches_reference(dtype, inverse, rows, C):
    _check_bwd(dtype, inverse, rows, C)


def _check_bwd(dtype, inverse, rows, C):
    """gdn_bwd's three launches against the plain version, deterministic."""
    x, beta, gamma = _data(rows, C, dtype, seed=rows + C, skew=True)
    g = torch.randn((rows, C), generator=torch.Generator().manual_seed(1)
                    ).to("cuda", dtype)
    before = dict(gdn.LAUNCHES)
    got = gdn.gdn_bwd(x, beta, gamma, g, inverse)
    torch.cuda.synchronize()
    assert all(gdn.LAUNCHES[k] == before[k] + 1 for k in gdn.BWD_KERNELS)
    want = gdn.gdn_bwd_reference(x, beta, gamma, g, inverse)
    for name, a, b in zip(("dx", "dbeta", "dgamma"), got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert _rel_err(a, b) < TOL[dtype], name
    again = gdn.gdn_bwd(x, beta, gamma, g, inverse)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


# bf16 gdn_bwd and gdn_fwd on the routes of gdn_bwd_dx_wide_kernel and
# gdn_fwd_wide_kernel (C = 128 and 192, 16-byte aligned rows; persistent
# CTAs, one an SM, walk the 64-row tiles):
# around one tile (1, 63, 64, 65 rows), around one tile a CTA on a 132-SM
# card (131, 132, 133 tiles), an odd count of tiles a CTA (3: 396 tiles)
# and a ragged 397th tile, a ragged training layer and a whole one.
WIDE = [(rows, C) for rows in (1, 63, 64, 65, 131 * 64, 132 * 64, 133 * 64,
                               396 * 64, 397 * 64 - 3, 16_391, 262_144)
        for C in (128, 192)]


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("rows,C", WIDE)
def test_wide_dx_route_matches_reference(inverse, rows, C):
    _check_bwd(torch.bfloat16, inverse, rows, C)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("rows,C", [(65, 128), (133 * 64, 192),
                                    (16_391, 192), (16_391, 128)])
def test_wide_dx_outputs_match_plain(inverse, rows, C):
    """gdn_bwd_dx alone through the C ABI: dx, the bf16 dn scratch and the
    tile sums each against the plain version as chip_smoke.py forms it (run
    from the root of the checkout), the same bytes twice."""
    from chip_smoke import _dx_plain

    lib = gdn._load("gdn_bwd.cu")
    x, beta, gamma = _data(rows, C, torch.bfloat16, seed=rows + C, skew=True)
    g = torch.randn((rows, C), generator=torch.Generator().manual_seed(1)
                    ).to("cuda", torch.bfloat16)
    gamma_t = gamma.t().contiguous()
    dx = torch.empty_like(x)
    dn, dn_sums = gdn._dn_scratch(lib, rows, C, x.dtype, "cuda")

    def run():
        err = lib.lmic_gdn_bwd_dx(
            x.data_ptr(), g.data_ptr(), gamma_t.data_ptr(), gamma.data_ptr(),
            beta.data_ptr(), dx.data_ptr(), dn.data_ptr(),
            dn_sums.data_ptr(), rows, C, 1, int(inverse),
            torch.cuda.current_stream().cuda_stream)
        assert err == 0, lib.lmic_gdn_bwd_error_string(err).decode()
        torch.cuda.synchronize()
        return [t.clone() for t in (dx, dn, dn_sums)]

    got = run()
    want = _dx_plain(x, beta, gamma, g, inverse, lib.lmic_gdn_bwd_tile_rows())
    for name, a, b in zip(("dx", "dn", "dn_sums"), got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert _rel_err(a, b) < TOL[torch.bfloat16], name
    assert all(torch.equal(a, b) for a, b in zip(got, run()))


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("C", [128, 192])
def test_offset_view_takes_the_mma_kernel(inverse, C):
    """A view offset by one element is off the TMA's 16-byte route:
    gdn_bwd_dx_mma_kernel takes it, and it still matches the plain
    version; the aligned tensor takes the wide kernel."""
    rows = 1_000
    x, beta, gamma = _data(rows, C, torch.bfloat16, seed=C, skew=True)
    g = torch.randn((rows, C), generator=torch.Generator().manual_seed(1)
                    ).to("cuda", torch.bfloat16)
    buf = torch.empty(rows * C + 1, dtype=x.dtype, device="cuda")
    buf[1:].copy_(x.view(-1))
    offset = buf[1:].view(rows, C)
    assert offset.is_contiguous() and offset.data_ptr() % 16 != 0
    want = gdn.gdn_bwd_reference(x, beta, gamma, g, inverse)
    from chip_smoke import _routed_kernels
    for xi, kernel in ((offset, "gdn_bwd_dx_mma_kernel"),
                       (x, "gdn_bwd_dx_wide_kernel")):
        def run():
            return gdn.gdn_bwd(xi, beta, gamma, g, inverse)
        assert _routed_kernels(run) == [kernel]
        got = run()
        for name, a, b in zip(("dx", "dbeta", "dgamma"), got, want):
            assert _rel_err(a, b) < TOL[torch.bfloat16], name
        assert all(torch.equal(a, b) for a, b in zip(got, run()))


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("rows,C", WIDE)
def test_wide_fwd_route_matches_reference(inverse, rows, C):
    """bf16 gdn_fwd on the route of gdn_fwd_wide_kernel (persistent CTAs
    walk the 64-row tiles two deep) against the plain version, the same
    bytes twice."""
    x, beta, gamma = _data(rows, C, torch.bfloat16, seed=rows + C,
                           skew=True)
    got = gdn.gdn_fwd(x, beta, gamma, inverse)
    torch.cuda.synchronize()
    want = gdn.gdn_reference(x, beta, gamma, inverse)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert _rel_err(got, want) < TOL[torch.bfloat16]
    assert torch.equal(got, gdn.gdn_fwd(x, beta, gamma, inverse))


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("C", [128, 192])
def test_offset_view_takes_the_fwd_mma_kernel(inverse, C):
    """bf16 gdn_fwd: a view offset by one element is off the TMA's 16-byte
    route and takes gdn_fwd_mma_kernel, and so does C = 320, a width the
    wide kernel has no instance of; the aligned tensor takes
    gdn_fwd_wide_kernel. Each matches the plain version, the same bytes
    twice."""
    from chip_smoke import _routed_kernels

    rows = 1_000
    x, beta, gamma = _data(rows, C, torch.bfloat16, seed=C, skew=True)
    buf = torch.empty(rows * C + 1, dtype=x.dtype, device="cuda")
    buf[1:].copy_(x.view(-1))
    offset = buf[1:].view(rows, C)
    assert offset.is_contiguous() and offset.data_ptr() % 16 != 0
    wide = _data(rows, 320, torch.bfloat16, seed=C, skew=True)
    for (xi, bi, gi), kernel in (((offset, beta, gamma), "gdn_fwd_mma_kernel"),
                                 ((x, beta, gamma), "gdn_fwd_wide_kernel"),
                                 (wide, "gdn_fwd_mma_kernel")):
        def run():
            return gdn.gdn_fwd(xi, bi, gi, inverse)
        assert _routed_kernels(run) == [kernel]
        got = run()
        want = gdn.gdn_reference(xi, bi, gi, inverse)
        assert _rel_err(got, want) < TOL[torch.bfloat16], kernel
        assert torch.equal(got, run()), kernel


@pytest.mark.parametrize("dtype,offset,fwd,dx,partials", [
    (torch.float32, 0, "gdn_fwd_kernel", "gdn_bwd_dx_kernel",
     "gdn_bwd_partials_kernel"),
    (torch.bfloat16, 0, "gdn_fwd_wide_kernel", "gdn_bwd_dx_wide_kernel",
     "gdn_bwd_partials_wide_kernel"),
    (torch.bfloat16, 1, "gdn_fwd_mma_kernel", "gdn_bwd_dx_mma_kernel",
     "gdn_bwd_partials_wide_kernel"),
])
def test_kernel_launches_count_the_kernel_each_launch_took(dtype, offset, fwd,
                                                          dx, partials):
    """`gdn.kernel_launches` rises by one for the CUDA kernel each launch
    of gdn_fwd and gdn_bwd took, and for no other, on and off the wide
    route (a view offset by one element)."""
    rows, C = 1_000, 192
    x, beta, gamma = _data(rows, C, dtype, seed=3, skew=True)
    g = torch.randn((rows, C), generator=torch.Generator().manual_seed(4)
                    ).to("cuda", dtype)
    buf = torch.empty(rows * C + offset, dtype=dtype, device="cuda")
    buf[offset:].copy_(x.view(-1))
    x = buf[offset:].view(rows, C)

    def launched(run):
        torch.cuda.synchronize()
        before = gdn.kernel_launches()
        run()
        torch.cuda.synchronize()
        return {k: v - before.get(k, 0)
                for k, v in gdn.kernel_launches().items()
                if v != before.get(k, 0)}

    assert launched(lambda: gdn.gdn_fwd(x, beta, gamma)) == {fwd: 1}
    assert launched(lambda: gdn.gdn_bwd(x, beta, gamma, g)) == {
        dx: 1, partials: 1, "gdn_bwd_reduce_kernel": 1}


def test_dx_reads_gamma_t_off_the_wide_route_only():
    """The wrapper builds gamma^T only where the dx launch reads it: f32,
    and bf16 off the wide kernel's route (a width it has no instance of, a
    base off 16 bytes)."""
    lib = gdn._load("gdn_bwd.cu")
    buf = torch.empty(64 * 320 + 1, dtype=torch.bfloat16, device="cuda")

    def reads(C, dtype, at=0):
        x = buf[at:at + 64 * C].view(64, C)
        gamma = torch.empty((C, C), dtype=dtype, device="cuda")
        return lib.lmic_gdn_bwd_dx_reads_gamma_t(
            x.data_ptr(), x.data_ptr(), gamma.data_ptr(), x.data_ptr(),
            x.data_ptr(), 64, C, 0 if dtype == torch.float32 else 1)

    assert reads(128, torch.bfloat16) == reads(192, torch.bfloat16) == 0
    assert reads(192, torch.bfloat16, at=1) == 1
    assert reads(320, torch.bfloat16) == reads(37, torch.bfloat16) == 1
    assert reads(192, torch.float32) == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_refuse_channels_past_their_tile(dtype):
    for kernel in ("gdn_fwd", "gdn_bwd"):
        widest = gdn.max_channels(kernel, dtype)
        assert widest >= 320, kernel  # every GDN width of the zoo
        x, beta, gamma = _data(4, widest + 1, dtype)
        before = dict(gdn.LAUNCHES)
        with pytest.raises(ValueError, match="exceed"):
            if kernel == "gdn_fwd":
                gdn.gdn_fwd(x, beta, gamma)
            else:
                gdn.gdn_bwd(x, beta, gamma, x)
        assert gdn.LAUNCHES == before  # refused, never sent elsewhere


@pytest.mark.parametrize("inverse", [False, True])
def test_layer_on_card_matches_cpu(inverse):
    layer = GDN(64, inverse=inverse)
    with torch.no_grad():
        layer.gamma.add_(torch.rand((64, 64),
                                    generator=torch.Generator().manual_seed(1))
                         * 0.1)
        x = torch.randn((2, 64, 9, 7)).contiguous(
            memory_format=torch.channels_last)
        want = layer(x)
        layer.cuda()
        got = layer(x.cuda())
        # an NCHW-contiguous input takes an explicit copy, same bytes
        assert torch.equal(got, layer(x.cuda().contiguous()))
    assert _rel_err(got.cpu(), want) < 1e-5


@pytest.mark.parametrize("inverse", [False, True])
def test_layer_grads_on_card_match_cpu(inverse):
    """Gradients through the layer (x, and the stored beta/gamma through
    the reparametrization), with an incoming gradient that is
    NCHW-contiguous, so the NHWC view the kernel reads takes an explicit
    copy."""
    gen = torch.Generator().manual_seed(2)
    layer = GDN(64, inverse=inverse)
    with torch.no_grad():
        layer.gamma.add_(torch.rand((64, 64), generator=gen) * 0.1)
    x = torch.randn((2, 64, 9, 7), generator=gen).contiguous(
        memory_format=torch.channels_last)
    w = torch.randn((2, 64, 9, 7), generator=gen)  # NCHW-contiguous
    grads = []
    for device in ("cpu", "cuda"):
        layer.zero_grad()
        xd = x.detach().to(device).requires_grad_()  # a leaf on each
        (layer.to(device)(xd) * w.to(device)).sum().backward()
        grads.append([t.detach().cpu() for t in
                      (xd.grad, layer.beta.grad, layer.gamma.grad)])
    for name, want, got in zip(("x", "beta", "gamma"), *grads):
        assert _rel_err(got, want) < 1e-5, name


@pytest.mark.parametrize("arch", NON_AR)
def test_codec_on_card(arch):
    cuda = zoo.create_model(arch, 1, seed=0, device="cuda", N=32, M=48)
    cpu = zoo.create_model(arch, 1, seed=0, device="cpu", N=32, M=48)
    cuda.update()
    cpu.update()  # tables are evaluated on the CPU on both
    np.testing.assert_array_equal(cuda.eb_state.table.cdf,
                                  cpu.eb_state.table.cdf)
    x = (np.random.default_rng(0).random((2, 64, 128, 3)) * 255).astype(
        np.uint8)
    n0 = gdn.LAUNCHES["gdn_fwd"]
    out = cuda.compress(x)
    assert gdn.LAUNCHES["gdn_fwd"] == n0 + 3 * x.shape[0]  # per image
    assert cuda.compress(x)["strings"] == out["strings"]
    rec = cuda.decompress(out["strings"], out["shape"], u8=True)["x_hat"]
    assert rec.shape == x.shape and rec.dtype == np.uint8
    with torch.no_grad():
        xt = torch.from_numpy(x[:1]).permute(0, 3, 1, 2).float() / 255
        y_cpu = cpu.module.g_a(xt)
        y_cuda = cuda.module.g_a(xt.cuda()).cpu()
    assert _rel_err(y_cuda, y_cpu) < 1e-4


@pytest.mark.parametrize("arch", NON_AR)
def test_train_step_on_card_matches_cpu(arch):
    """The same step, weights and noise on the card and on the CPU: f32
    sums in another order on each device, so the losses agree to 1e-4
    relative and each clipped gradient leaf to 1e-3 of its largest
    value."""
    from lmic_tpu_torch.utils.crosscheck import train_step_agreement

    x = torch.from_numpy(np.random.default_rng(0).random(
        (2, 64, 128, 3), dtype=np.float32)).permute(0, 3, 1, 2)
    loss_err, grad_err, launched = train_step_agreement(
        arch, 1, x, 1024, N=32, M=48)
    assert launched == {k: 6 for k in gdn.LAUNCHES}
    assert loss_err <= 1e-4 and grad_err <= 1e-3, (loss_err, grad_err)


@pytest.mark.parametrize("arch", AR_ARCHS)
def test_ar_train_step_on_card_matches_cpu(arch):
    """An AR arch's training step on the card against the CPU, the same
    weights and noise (the context's too): the losses to 1e-4 relative,
    each clipped gradient leaf to 1e-3 of its largest value; 6 launches of
    each GDN kernel."""
    from lmic_tpu_torch.utils.crosscheck import train_step_agreement

    x = torch.from_numpy(np.random.default_rng(0).random(
        (2, 64, 128, 3), dtype=np.float32)).permute(0, 3, 1, 2)
    loss_err, grad_err, launched = train_step_agreement(
        arch, 1, x, 1024, **_ar_widths(arch))
    assert launched == {k: 6 for k in gdn.LAUNCHES}
    assert loss_err <= 1e-4 and grad_err <= 1e-3, (loss_err, grad_err)


def _ar_widths(arch):
    return {"N": 32} if arch.startswith("cheng") else {"N": 32, "M": 48}


@pytest.mark.parametrize("arch", AR_ARCHS)
def test_ar_codec_on_card(arch):
    """An AR round trip on the card: the decoder recovers exactly the
    encoder's latents, encoding is deterministic, and gdn_fwd runs 3 times
    in g_a for each image and 3 times in g_s for the batch, with no
    backward kernel."""
    codec = zoo.create_model(arch, 1, seed=0, device="cuda",
                             **_ar_widths(arch))
    codec.update()
    x = (np.random.default_rng(0).random((2, 64, 128, 3)) * 255).astype(
        np.uint8)
    with torch.inference_mode():
        ys, z_sym = codec._analyze(x)
        enc = codec._code_y_z(ys, z_sym, keep_y_hat=True)
        dec = codec._decode_y_hat(enc["strings"], enc["shape"])
    assert torch.equal(dec, enc["y_hat_latent"])
    before = dict(gdn.LAUNCHES)
    out = codec.compress(x)
    rec = codec.decompress(out["strings"], out["shape"], u8=True)["x_hat"]
    torch.cuda.synchronize()
    launched = {k: gdn.LAUNCHES[k] - before[k] for k in before}
    assert launched == {k: 3 * x.shape[0] + 3 if k == "gdn_fwd" else 0
                        for k in before}
    assert out["strings"] == enc["strings"]
    assert rec.shape == x.shape and rec.dtype == np.uint8


@pytest.mark.parametrize("arch", AR_ARCHS)
def test_ar_wavefront_step_on_card_matches_cpu(arch):
    """The CUDA wavefront step against the CPU's on the same latents:
    scales and means within 1e-4 of the largest value (f32 sums in another
    order, and each device's own hyper transform); a scale index may flip
    only where a scale sits that close to a bucket edge."""
    from lmic_tpu_torch.utils.crosscheck import wavefront_step_agreement

    cuda, cpu = (zoo.create_model(arch, 1, seed=0, device=d,
                                  **_ar_widths(arch)) for d in ("cuda", "cpu"))
    for c in (cuda, cpu):
        c.update()
    np.testing.assert_array_equal(cuda.gc_state.table.cdf,
                                  cpu.gc_state.table.cdf)
    x = (np.random.default_rng(1).random((1, 64, 128, 3)) * 255).astype(
        np.uint8)
    err, flips, n = wavefront_step_agreement(cuda, cpu, x)
    assert err < 1e-4 and flips <= n * 1e-3, (err, flips, n)


@pytest.mark.parametrize("arch", AR_ARCHS)
def test_ar_create_model_needs_cuda_or_explicit_cpu(arch, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        zoo.create_model(arch, 1, **_ar_widths(arch))
    codec = zoo.create_model(arch, 1, device="cpu", **_ar_widths(arch))
    assert codec.device.type == "cpu"


# the RGB-T pair at N = 32, M = 48: master role -> (master, guide) (H, W)
RGBT_ROLES = {1: ((64, 128), (128, 256)), 3: ((128, 128), (64, 64))}


def _rgbt(role, device):
    from lmic_tpu_torch.utils.serve import load_rgbt_codecs

    pair, _ = load_rgbt_codecs(1, role, seed=0, device=device, N=32, M=48)
    (mH, mW), (gH, gW) = RGBT_ROLES[role]
    rng = np.random.default_rng(role)
    x = (rng.random((1, mH, mW, role)) * 255).astype(np.uint8)
    guide = (rng.random((1, gH, gW, 4 - role)) * 255).astype(np.uint8)
    return pair, x, guide


@pytest.mark.parametrize("role", [1, 3])
def test_rgbt_round_trip_on_card(role):
    """A served round trip of the pair on the card runs gdn_fwd 12 times
    (the guide's g_a and one-pass reconstruct, the master's g_a and g_s)
    and no backward kernel; the guide's reconstruct equals its decompress
    and the master's decoder recovers the encoder's latents, bit for bit;
    encoding is deterministic."""
    from lmic_tpu_torch.models.codec import _symbols_to_host

    (guided, master), x, guide = _rgbt(role, "cuda")
    before = dict(gdn.LAUNCHES)
    g_out = guided.compress(guide, hidden=False, reconstruct=True)
    out = master.compress(x, g_out["x_hat"])
    rec = master.decompress(
        out, {"x_hat": g_out["x_hat"], "hidden": g_out["hidden_dec"]},
        u8=True)["x_hat"]
    torch.cuda.synchronize()
    launched = {k: gdn.LAUNCHES[k] - before[k] for k in before}
    assert launched == {k: 12 if k == "gdn_fwd" else 0 for k in before}
    assert rec.shape == x.shape and rec.dtype == np.uint8
    g_dec = guided.decompress(g_out["strings"], g_out["shape"])
    assert torch.equal(g_dec["x_hat"], g_out["x_hat"])
    for k, v in g_dec["hidden"].items():
        assert torch.equal(g_out["hidden_dec"][k], v)
    with torch.inference_mode():
        g = g_out["x_hat"]
        feat, align, beta, gamma = master.module.features(
            master._pixels(x), g)
        y, z = master.module.analyze_features(feat, align)
        z_sym = _symbols_to_host(
            torch.round(z - master._medians(master.eb_state)))
        enc = master._code_y_z([y], z_sym, keep_y_hat=True)
        dec = master._decode_y_hat(enc["strings"], enc["shape"])
        assert torch.equal(master.module.guided_align_from(g, beta, gamma),
                           align)
    assert torch.equal(dec, enc["y_hat_latent"])
    assert enc["strings"] == out["strings"]
    assert master.compress(x, g_out["x_hat"])["strings"] == out["strings"]


@pytest.mark.parametrize("role", [1, 3])
def test_rgbt_transforms_on_card_match_cpu(role):
    """The pair's transforms stage by stage on the card and on the CPU, on
    the same inputs: f32 sums in another order, within 1e-4 of the largest
    value; the coding tables equal."""
    from lmic_tpu_torch.utils.crosscheck import rgbt_agreement

    pair, x, guide = _rgbt(role, "cuda")
    ref, _, _ = _rgbt(role, "cpu")
    assert rgbt_agreement(pair, ref, x, guide) < 1e-4
    for a, b in zip(pair, ref):
        np.testing.assert_array_equal(a.gc_state.table.cdf,
                                      b.gc_state.table.cdf)


@pytest.mark.parametrize("role", [1, 3])
def test_master_train_step_on_card_matches_cpu(role):
    """The master's step against its frozen guide on the card and on the
    CPU, the same weights and noise: the losses to 1e-4 relative, each
    clipped gradient leaf to 1e-3 of its largest value; gdn_fwd 12 times
    (6 in the guide, which has no backward, 6 in the master), each
    backward kernel 6 times."""
    from lmic_tpu_torch.utils.crosscheck import master_step_agreement

    (mH, mW), (gH, gW) = RGBT_ROLES[role]
    rng = np.random.default_rng(role)
    x = torch.from_numpy(rng.random((2, mH, mW, role), dtype=np.float32))
    guide = torch.from_numpy(rng.random((2, gH, gW, 4 - role),
                                        dtype=np.float32))
    loss_err, grad_err, launched = master_step_agreement(
        1, role, x.permute(0, 3, 1, 2), guide.permute(0, 3, 1, 2), 1024,
        N=32, M=48)
    assert launched == {k: 12 if k == "gdn_fwd" else 6
                        for k in gdn.LAUNCHES}
    assert loss_err <= 1e-4 and grad_err <= 1e-3, (loss_err, grad_err)


def _paired(family, device):
    """A narrow (N = M = 32) `_R` guide codec and `_D` codec of `family`."""
    out = []
    for suffix, channel, seed in (("_R", 3, 0), ("_D", 1, 1)):
        codec = zoo.create_model(family + suffix, 1, seed=seed,
                                 channel=channel, device=device, N=32, M=32)
        codec.update()
        out.append(codec)
    return out


@pytest.mark.parametrize("family", AR_ARCHS)
def test_paired_round_trip_on_card_matches_cpu(family):
    """An `_R` -> `_D` round trip on the card at 128x128 (the smallest
    size whose deepest fusion level holds ESA's 15 pixels) runs gdn_fwd
    15 times (6 in the `_R` compress, whose ga* maps take a second
    analysis pass, 3 in each other leg) and no backward kernel; encoding
    is deterministic and the `_D` decoder recovers its encoder's latents,
    bit for bit; the transforms stage by stage within 1e-4 of the CPU's,
    and the tables equal."""
    from lmic_tpu_torch.models.codec import _symbols_to_host
    from lmic_tpu_torch.utils.crosscheck import paired_agreement

    guide_codec, codec = pair = _paired(family, "cuda")
    rng = np.random.default_rng(7)
    x = (rng.random((1, 128, 128, 1)) * 255).astype(np.uint8)
    guide = (rng.random((1, 128, 128, 3)) * 255).astype(np.uint8)
    before = dict(gdn.LAUNCHES)
    g = guide_codec.compress(guide)
    g_dec = guide_codec.decompress(g["strings"], g["shape"])
    out = codec.compress(x, g["hidden"])
    rec = codec.decompress(out["strings"], out["shape"], g_dec["hidden"],
                           u8=True)["x_hat"]
    torch.cuda.synchronize()
    launched = {k: gdn.LAUNCHES[k] - before[k] for k in before}
    assert launched == {k: 15 if k == "gdn_fwd" else 0 for k in before}
    assert rec.shape == x.shape and rec.dtype == np.uint8
    assert codec.compress(x, g["hidden"])["strings"] == out["strings"]
    with torch.inference_mode():
        y, z = codec.module.analyze_fused(codec._pixels(x), g["hidden"])
        z_sym = _symbols_to_host(
            torch.round(z - codec._medians(codec.eb_state)))
        enc = codec._code_y_z([y], z_sym, keep_y_hat=True)
        dec = codec._decode_y_hat(enc["strings"], enc["shape"])
    assert torch.equal(dec, enc["y_hat_latent"])
    assert enc["strings"] == out["strings"]
    ref = _paired(family, "cpu")
    assert paired_agreement(pair, ref, x, guide) < 1e-4
    for a, b in zip(pair, ref):
        np.testing.assert_array_equal(a.gc_state.table.cdf,
                                      b.gc_state.table.cdf)


def test_video_gop_on_card_matches_cpu():
    """An ssf2020 3-frame 128x128 GOP on the card launches no GDN kernel
    (ssf2020 has none); encoding is deterministic, the whole-GOP encoder
    gives the per-frame one's bytes, the decoder's frames equal the
    encoder's in-loop reconstructions bit for bit, and the transforms and
    the scale-space warp stage by stage within 1e-4 of the CPU's, with
    equal tables."""
    from lmic_tpu_torch.utils.crosscheck import video_agreement

    cuda = zoo.create_video_model(seed=0, device="cuda")
    cpu = zoo.create_video_model(seed=0, device="cpu")
    cuda.update()
    cpu.update()
    x = (np.random.default_rng(8).random((1, 3, 128, 128, 3)) * 255
         ).astype(np.uint8)
    before = dict(gdn.LAUNCHES)
    strings, shapes = cuda.compress(x)
    rec = cuda.decompress(strings, shapes)
    torch.cuda.synchronize()
    assert gdn.LAUNCHES == before
    assert cuda.compress(x) == (strings, shapes)
    assert cuda._compress_chunk_sync(x) == (strings, shapes)
    with torch.inference_mode():
        xt = cuda._frames(x)
        x_ref, _ = cuda.encode_keyframe(xt[:, 0])
        recs = [x_ref]
        for i in (1, 2):
            x_ref, _ = cuda.encode_inter(xt[:, i], x_ref)
            recs.append(x_ref)
    want = torch.stack(recs, 1).permute(0, 1, 3, 4, 2).cpu().numpy()
    np.testing.assert_array_equal(rec, want)
    assert video_agreement(cuda, cpu, x) < 1e-4
    for which, hp in cuda.hp_states.items():
        np.testing.assert_array_equal(hp.eb_state.table.cdf,
                                      cpu.hp_states[which].eb_state.table.cdf)


def test_metrics_on_card_match_cpu():
    """psnr, ssim and ms-ssim (f64 sums) on the card within 1e-6 of the
    CPU's, at an odd size of 5 scales and a small one of fewer."""
    from lmic_tpu_torch.utils import metrics

    rng = np.random.default_rng(2)
    for shape in ((1, 171, 240, 3), (2, 64, 97, 1)):
        x = torch.from_numpy(rng.random(shape, dtype=np.float32))
        y = torch.clamp(x + 0.05 * torch.randn(shape), 0, 1)
        for name in ("psnr", "ssim", "ms_ssim"):
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")  # fewer scales
                got = getattr(metrics, name)(x.cuda(), y.cuda())
                want = getattr(metrics, name)(x, y)
            assert got.is_cuda and abs(float(got) - float(want)) <= 1e-6


def test_raster_round_trip_on_card():
    """mbt2018's raster order (the reference container's) on the card at
    64x64: the decoder recovers exactly the encoder's latents, and
    decompress(order="raster") reads compress(order="raster")."""
    codec = zoo.create_model("mbt2018", 1, seed=0, device="cuda",
                             **_ar_widths("mbt2018"))
    codec.update()
    x = (np.random.default_rng(5).random((1, 64, 64, 3)) * 255).astype(
        np.uint8)
    with torch.inference_mode():
        ys, z_sym = codec._analyze(x)
        enc = codec._code_y_z(ys, z_sym, keep_y_hat=True, order="raster")
        dec = codec._decode_y_hat(enc["strings"], enc["shape"], "raster")
    assert torch.equal(dec, enc["y_hat_latent"])
    out = codec.compress(x, order="raster")
    assert out["strings"] == enc["strings"]
    rec = codec.decompress(out["strings"], out["shape"], order="raster")
    with torch.inference_mode():
        want = codec._synthesize(dec, False)["x_hat"]
    np.testing.assert_array_equal(rec["x_hat"], want)


def _png_free_round_trips(tmp_path):
    """Every container through the array-level cores on the card: (what,
    decoded, the direct decode)."""
    import io

    from lmic_tpu_torch.utils import codec_cli as cc

    rng = np.random.default_rng(6)
    x = rng.random((1, 64, 128, 3), dtype=np.float32)
    out = []
    for arch in ("mbt2018-mean", "mbt2018"):
        codec = zoo.create_model(arch, 1, seed=0, device="cuda",
                                 **_ar_widths("mbt2018"))
        codec.update()
        order = {"order": "raster"} if arch == "mbt2018" else {}
        for ref in (False, True):
            f = io.BytesIO()
            (cc.write_image_ref if ref else cc.write_image)(
                f, x, codec, arch, 1)
            f.seek(0)
            if ref:
                cc.read_uchars(f, 2)
                got = cc.read_image_ref(f, lambda a, q: codec, arch, 1)
                d = codec.compress(x, **order)
                want = codec.decompress(d["strings"], d["shape"], **order)
            else:
                got = cc.read_image(f, lambda a, q: codec)[0]
                d = codec.compress(x)
                want = codec.decompress(d["strings"], d["shape"])
            out.append((f"{arch} ref={ref}", got, want["x_hat"]))
    (guided, master), xm, guide = _rgbt(1, "cuda")
    for ref in (False, True):
        f = io.BytesIO()
        (cc.write_rgbt_ref if ref else cc.write_rgbt)(
            f, xm, guide, guided, master, 1, channel=1)
        f.seek(0)
        if ref:
            cc.read_uchars(f, 2)
            got = cc.read_rgbt_ref(f, lambda ch: guide, lambda ch: guided,
                                   lambda ch: master, channel=1)
        else:
            got = cc.read_rgbt(f, lambda ch: guide, lambda ch: guided,
                               lambda ch: master)
        order = "raster" if ref else "wavefront"
        g = cc._code_guide(guided, guide)
        m = master.compress(xm, g["x_hat"], order=order)
        out.append((f"master ref={ref}", got,
                    master.decompress(m, g, order=order)["x_hat"]))
    return out


def test_every_container_round_trips_on_card(tmp_path):
    """Native and reference files of mbt2018-mean, mbt2018 (raster) and
    the master pair (raster), through the array-level cores on the card,
    decode to the direct decompress; ssf2020's native and reference files
    of a 3-frame 128x128 clip decode to the encoder's clipped in-loop
    frames."""
    from lmic_tpu_torch.datasets.rawvideo import RawVideoSequence
    from lmic_tpu_torch.utils import codec_cli as cc

    for what, got, want in _png_free_round_trips(tmp_path):
        np.testing.assert_array_equal(got, want, err_msg=what)
    rng = np.random.default_rng(7)
    clip = tmp_path / "clip_128x128_30_yuv420.yuv"
    rng.integers(0, 255, 3 * (128 * 128 + 2 * 64 * 64),
                 dtype=np.uint8).tofile(clip)
    codec = zoo.create_video_model(seed=0, device="cuda")
    codec.update()
    seq = RawVideoSequence.from_file(str(clip))
    want = np.concatenate([
        p.ravel() for x_ref, _ in cc.code_frames(codec, seq, 3)
        for p in cc._rgb_to_yuv420_planes(x_ref.permute(0, 2, 3, 1))])
    seq.close()
    for container in ("native", "reference"):
        path = tmp_path / f"{container}.bin"
        cc.encode_video(clip, path, codec, 1, container=container)
        with open(path, "rb") as f:
            cc.read_uchars(f, 2 if container == "reference" else 6)
            reader = (cc.decode_video_ref if container == "reference"
                      else cc.decode_video)
            reader(f, tmp_path / "o.yuv", lambda a, q: codec, 1)
        np.testing.assert_array_equal(
            np.fromfile(tmp_path / "o.yuv", np.uint8), want)


@pytest.mark.parametrize("entropy_estimation", [False, True])
def test_rgbt_eval_launch_counts_on_card(entropy_estimation):
    """`eval_rgbt_pair` runs gdn_fwd 12 times a pair in both modes (the
    real coder: 9 to encode, 3 to decode), `eval_rd_pair` 15 with the real
    coder and 12 estimating; no backward kernel."""
    from lmic_tpu_torch.utils import eval_model

    (guided, master), x, guide = _rgbt(1, "cuda")
    before = dict(gdn.LAUNCHES)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        m = eval_model.eval_rgbt_pair(guided, master, x / 255.0,
                                      guide / 255.0, entropy_estimation)
    torch.cuda.synchronize()
    launched = {k: gdn.LAUNCHES[k] - before[k] for k in before}
    assert launched == {k: 12 if k == "gdn_fwd" else 0 for k in before}
    assert np.isfinite(list(m.values())).all()
    r = zoo.create_model("mbt2018_R", 1, seed=0, channel=3, device="cuda",
                         N=32, M=32)
    d = zoo.create_model("mbt2018_D", 1, seed=1, channel=1, device="cuda",
                         N=32, M=32)
    r.update()
    d.update()
    rng = np.random.default_rng(3)
    xr = rng.random((1, 128, 128, 1), dtype=np.float32)
    gr = rng.random((1, 128, 128, 3), dtype=np.float32)
    before = dict(gdn.LAUNCHES)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        eval_model.eval_rd_pair(r, d, xr, gr, entropy_estimation)
    torch.cuda.synchronize()
    n = 12 if entropy_estimation else 15
    assert {k: gdn.LAUNCHES[k] - before[k] for k in before} == {
        k: n if k == "gdn_fwd" else 0 for k in before}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("rows,C", [(6151, 192), (6144, 128), (1, 16)])
def test_operator_matches_reference(dtype, inverse, rows, C):
    """`torch.ops.lmic_tpu_torch.gdn_fwd` on CUDA tensors launches the
    kernel once (counted) and is held to the plain version at the bars
    above; on their CPU copies it is the plain version."""
    x, beta, gamma = _data(rows, C, dtype)
    n0 = gdn.LAUNCHES["gdn_fwd"]
    got = torch.ops.lmic_tpu_torch.gdn_fwd(x, beta, gamma, inverse)
    torch.cuda.synchronize()
    assert gdn.LAUNCHES["gdn_fwd"] == n0 + 1
    want = gdn.gdn_reference(x, beta, gamma, inverse)
    assert _rel_err(got, want) < TOL[dtype]
    assert torch.equal(got, gdn.gdn_fwd(x, beta, gamma, inverse))
    cpu = [t.cpu() for t in (x, beta, gamma)]
    assert torch.equal(torch.ops.lmic_tpu_torch.gdn_fwd(*cpu, inverse),
                       gdn.gdn_reference(*cpu, inverse))


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("rows", [393_216, 1_572_864])
def test_operator_at_the_batched_synthesis_rows(inverse, rows):
    """f32 `gdn_fwd`, through its operator, at the rows of a batch of 16
    768x512 images decoded at once (the synthesis's IGDN at 393,216 and
    1,572,864 rows, C = 192): equal to the plain version, the same bytes
    on every launch."""
    x, beta, gamma = _data(rows, 192, torch.float32, seed=rows, skew=True)
    n0 = gdn.LAUNCHES["gdn_fwd"]
    got = torch.ops.lmic_tpu_torch.gdn_fwd(x, beta, gamma, inverse)
    torch.cuda.synchronize()
    assert gdn.LAUNCHES["gdn_fwd"] == n0 + 1
    assert torch.equal(got, gdn.gdn_reference(x, beta, gamma, inverse))
    assert torch.equal(got, gdn.gdn_fwd(x, beta, gamma, inverse))


def test_bundle_on_card_matches_the_live_codec(tmp_path):
    """An mbt2018-mean bundle exported on the card codes the live CUDA
    codec's strings and pixels byte for byte, launches the kernel through
    its operator nodes (3 an image to encode, per image, and 3 a batch to
    decode), and is refused on the CPU."""
    from lmic_tpu_torch.utils.aot import (
        export_serving_bundle,
        load_serving_bundle,
    )

    shape = (2, 64, 128, 3)
    live = zoo.create_model("mbt2018-mean", 1, seed=0, device="cuda", N=32,
                            M=48)
    live.update()
    export_serving_bundle(live, str(tmp_path), shape)
    served = load_serving_bundle(str(tmp_path), device="cuda")
    x = (np.random.default_rng(5).random(shape) * 255).astype(np.uint8)
    want = live.compress(x)
    want_rec = live.decompress(want["strings"], want["shape"], u8=True)
    before = dict(gdn.LAUNCHES)
    out = served.compress_async(x)()
    rec = served.decompress_async(out["strings"], out["shape"])()
    torch.cuda.synchronize()
    assert {k: gdn.LAUNCHES[k] - before[k] for k in before} == {
        k: 3 * shape[0] + 3 if k == "gdn_fwd" else 0 for k in before}
    assert out["strings"] == want["strings"]
    np.testing.assert_array_equal(rec["x_hat"], want_rec["x_hat"])
    for name in ("_analyze_u8__one", "_synth_u8__i8", "_synth_u8__i16"):
        program = torch.export.load(str(tmp_path / "fns" / f"{name}.pt2"))
        assert sum(n.target == torch.ops.lmic_tpu_torch.gdn_fwd.default
                   for n in program.graph.nodes) == 3, name
    with pytest.raises(ValueError, match="exported on 'cuda'"):
        load_serving_bundle(str(tmp_path), device="cpu")


@pytest.mark.parametrize("dtype", [None, torch.bfloat16], ids=["f32", "amp"])
def test_remat_step_on_card_matches_the_plain_step(dtype):
    """A --remat step on the card against the plain step, the same
    weights and noise: the losses and each clipped gradient leaf within
    the card's bars (f32 1e-4 / 1e-3, bf16 1e-3 / 2e-2); 12 `gdn_fwd` (each
    GDN again in its block's recompute) and 6 of each backward kernel."""
    from lmic_tpu_torch.utils.crosscheck import remat_step_agreement

    x = torch.from_numpy(np.random.default_rng(0).random(
        (2, 64, 128, 3), dtype=np.float32)).permute(0, 3, 1, 2)
    loss_err, grad_err, launched = remat_step_agreement(
        "mbt2018-mean", 1, x, 1024, dtype=dtype, N=32, M=48)
    assert launched == {k: 12 if k == "gdn_fwd" else 6
                        for k in gdn.LAUNCHES}
    loss_bar, grad_bar = (1e-4, 1e-3) if dtype is None else (1e-3, 2e-2)
    assert loss_err <= loss_bar and grad_err <= grad_bar, (loss_err,
                                                           grad_err)


def test_master_remat_step_on_card_matches_the_plain_step():
    """The master's --remat step against its frozen guide on the card
    against the plain step: the f32 card bars; 18 `gdn_fwd` (the guide's 6
    once, the master's 6 twice) and 6 of each backward kernel."""
    from lmic_tpu_torch.utils.crosscheck import master_step_agreement

    (mH, mW), (gH, gW) = RGBT_ROLES[1]
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.random((2, mH, mW, 1), dtype=np.float32))
    guide = torch.from_numpy(rng.random((2, gH, gW, 3), dtype=np.float32))
    loss_err, grad_err, launched = master_step_agreement(
        1, 1, x.permute(0, 3, 1, 2), guide.permute(0, 3, 1, 2), 1024,
        devices=("cuda", "cuda"), remat=(True, False), N=32, M=48)
    assert launched == {k: 18 if k == "gdn_fwd" else 6
                        for k in gdn.LAUNCHES}
    assert loss_err <= 1e-4 and grad_err <= 1e-3, (loss_err, grad_err)


def test_from_torch_on_card(tmp_path, monkeypatch):
    """A CompressAI-format file of a narrow mbt2018-mean with baked tables,
    finalized by `update_model_cli --from-torch` on the card: its tables
    are the file's bit for bit, and it codes the source's strings with 6
    `gdn_fwd` a round trip."""
    from lmic_tpu_torch.utils import checkpoint as ckpt
    from lmic_tpu_torch.utils import update_model_cli
    from lmic_tpu_torch.utils.crosscheck import (
        reference_table_mismatches,
        write_reference_checkpoint,
    )

    monkeypatch.setitem(zoo.cfgs, "mbt2018-mean", {1: (32, 48)})
    source = zoo.create_model("mbt2018-mean", 1, device="cuda")
    source.update()
    path = str(tmp_path / "mbt2018-mean.pth.tar")
    sd = write_reference_checkpoint(path, source)
    out = update_model_cli.run([path, "-a", "mbt2018-mean", "-q", "1",
                                "-d", str(tmp_path), "--from-torch"])
    final = ckpt.load_updated_model(
        out, zoo.create_model("mbt2018-mean", 1, seed=3, device="cuda"))
    assert reference_table_mismatches(final, sd) == []
    x = (np.random.default_rng(2).random((1, 64, 128, 3)) * 255).astype(
        np.uint8)
    n0 = gdn.LAUNCHES["gdn_fwd"]
    enc = final.compress(x)
    final.decompress(enc["strings"], enc["shape"])
    torch.cuda.synchronize()
    assert gdn.LAUNCHES["gdn_fwd"] == n0 + 6
    assert enc["strings"] == source.compress(x)["strings"]


# -- bf16 matmul precision (ops/precision.py) --------------------------------

def _rounded_case(kind, device):
    """One rounded op of `kind` on `device`, forward and backward, on
    seeded inputs: (output, input gradients)."""
    from lmic_tpu_torch.ops import precision

    g = torch.Generator().manual_seed(21)
    shapes = {"conv2d": ((2, 48, 32, 40), (64, 48, 5, 5)),
              "conv_transpose2d": ((2, 48, 16, 20), (48, 64, 5, 5)),
              "linear": ((8, 64, 96), (80, 96)),
              "matmul": ((4, 3, 64, 32), (4, 3, 32, 64))}[kind]
    a, b = (torch.randn(s, generator=g).to(device).requires_grad_()
            for s in shapes)
    bias = (torch.randn(shapes[1][1 if kind == "conv_transpose2d" else 0],
                        generator=g).to(device).requires_grad_()
            if kind != "matmul" else None)
    args = {"conv2d": (a, b, bias, 2, 2),
            "conv_transpose2d": (a, b, bias, 2, 2, 1),
            "linear": (a, b, bias), "matmul": (a, b)}[kind]
    with precision.matmul_precision("bfloat16"):
        y = getattr(precision, kind)(*args)
    y.backward(torch.randn(y.shape, generator=g).to(device))
    return [y] + [t.grad for t in (a, b, bias) if t is not None]


@pytest.mark.parametrize("kind", ["conv2d", "conv_transpose2d", "linear",
                                  "matmul"])
def test_rounded_ops_on_card_match_the_cpu(kind):
    """Each rounded op, forward and backward, on the card (TF32 on for the
    call: exact products of bf16 operands, f32 sums) against the CPU's f32
    op on the same rounded operands: f32 sums in another order only. The
    TF32 switches are as they were after the call."""
    switches = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
    got = _rounded_case(kind, "cuda")
    assert switches == (torch.backends.cuda.matmul.allow_tf32,
                        torch.backends.cudnn.allow_tf32)
    for a, b in zip(got, _rounded_case(kind, "cpu")):
        assert _rel_err(a.cpu(), b) < TOL[torch.float32]


@pytest.mark.parametrize("dtype", [None, torch.bfloat16], ids=["f32", "amp"])
def test_one_rank_nccl_step_equals_the_plain_step(dtype):
    """Two steps under DistributedDataParallel in a one-rank NCCL group
    against the plain steps, the same weights and noise: the metrics, the
    first step's gradients and the parameters after each step bit for
    bit, and 6 `gdn_fwd` and 6 of each backward kernel a step."""
    from lmic_tpu_torch import parallel
    from lmic_tpu_torch.utils.crosscheck import data_parallel_steps

    x = torch.from_numpy(np.random.default_rng(1).random(
        (4, 64, 128, 3), dtype=np.float32)).permute(0, 3, 1, 2)
    args = ("mbt2018-mean", 1, x, 1024, "cuda")
    plain = data_parallel_steps(*args, dtype=dtype, N=32, M=48)
    with parallel.process_group("nccl"):
        ddp = data_parallel_steps(*args, dtype=dtype, data_parallel=True,
                                  N=32, M=48)
    assert ddp["metrics"] == plain["metrics"]
    assert torch.equal(ddp["grads"], plain["grads"])
    assert ddp["param_sha256"] == plain["param_sha256"]
    assert ddp["launches"] == {k: 12 for k in gdn.LAUNCHES}


def test_timings_and_timed_synchronize_a_cuda_tensor():
    """`Timings.section(sync=)` and `timed` wait for the card: a ~100 ms
    spin kernel queued before them is inside the wall time they read."""
    from lmic_tpu_torch.utils import profiling

    x = torch.ones(4, device="cuda")
    t = profiling.Timings()
    with t.section("spin", sync={"out": [x]}):
        torch.cuda._sleep(200_000_000)  # cycles: ~100 ms at H100 clocks
    _, s = profiling.timed(lambda: (torch.cuda._sleep(200_000_000), x)[1])
    assert t.report()["spin"]["total_s"] > 0.03 and s > 0.03


@pytest.mark.parametrize("inverse", [False, True])
def test_gdn1_on_card_matches_cpu(inverse):
    """GDN1 forward and backward on the card (TF32 off for its product
    whatever the switches say) against the CPU within 1e-5."""
    from lmic_tpu_torch.layers import GDN1

    gen = torch.Generator().manual_seed(3)
    layer = GDN1(192, inverse=inverse)
    with torch.no_grad():
        layer.gamma.add_(torch.rand((192, 192), generator=gen) * 0.1)
    x = torch.randn((4096, 192), generator=gen)
    w = torch.randn((4096, 192), generator=gen)
    matmul = torch.backends.cuda.matmul
    before = matmul.allow_tf32
    outs = []
    try:
        matmul.allow_tf32 = True  # the layer turns it off for its product
        for device in ("cpu", "cuda"):
            layer.zero_grad()
            xd = x.detach().to(device).requires_grad_()  # a leaf on each
            y = layer.to(device)(xd)
            (y * w.to(device)).sum().backward()
            outs.append([t.detach().cpu() for t in
                         (y, xd.grad, layer.beta.grad, layer.gamma.grad)])
        assert matmul.allow_tf32
    finally:
        matmul.allow_tf32 = before
    for name, want, got in zip(("y", "x", "beta", "gamma"), *outs):
        assert _rel_err(got, want) < 1e-5, name


def test_ablate_gdn_launches_nothing(monkeypatch):
    """LMIC_ABLATE_GDN=1: a forward and backward through GDN layers on the
    card launches no GDN kernel; unset, 1 forward and 1 of each backward
    launch a layer, as before."""
    layers = torch.nn.Sequential(GDN(64), GDN(64, inverse=True)).cuda()
    x = torch.randn((2, 64, 16, 16), device="cuda").contiguous(
        memory_format=torch.channels_last).requires_grad_()

    def launches():
        before = dict(gdn.LAUNCHES)
        layers(x).sum().backward()
        torch.cuda.synchronize()
        return {k: gdn.LAUNCHES[k] - before[k] for k in before}

    monkeypatch.setenv("LMIC_ABLATE_GDN", "1")
    assert launches() == {k: 0 for k in gdn.LAUNCHES}
    monkeypatch.delenv("LMIC_ABLATE_GDN")
    assert launches() == {k: 2 for k in gdn.LAUNCHES}


def test_sequence_metrics_on_card_match_cpu(tmp_path):
    """video_bench's sequence metrics of a 3-frame 128x128 pair on the card
    against the CPU: psnr within 1e-4 dB, ms-ssim within 1e-5."""
    from lmic_tpu_torch.datasets.rawvideo import RawVideoSequence
    from lmic_tpu_torch.utils import video_bench

    n = 3 * (128 * 128 + 2 * 64 * 64)
    rng = np.random.default_rng(4)
    ref = rng.integers(0, 256, n, dtype=np.uint8)
    rec = np.clip(ref + rng.integers(-6, 7, n), 0, 255).astype(np.uint8)
    seqs = []
    for name, raw in (("ref", ref), ("rec", rec)):
        (tmp_path / name).mkdir()
        path = tmp_path / name / "clip_128x128_30_yuv420.yuv"
        raw.tofile(path)
        seqs.append(RawVideoSequence.from_file(str(path)))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # fewer MS-SSIM scales below 161
        got, want = (video_bench._sequence_metrics(*seqs, device=d)
                     for d in ("cuda", "cpu"))
    for k, v in want.items():
        assert abs(got[k] - v) < (1e-5 if k == "ms-ssim-rgb" else 1e-4), k
