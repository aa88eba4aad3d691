"""The plain reference against lmic_tpu_torch at a tiny size on the CPU,
and the reference's independence from the program."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import synth, weights
from benchmark.reference import cheng2020_anchor, codec, entropy
from benchmark.reference import mean_scale_hyperprior, rans
from benchmark.reference import train as ref_train

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
ARCHS = [("mbt2018-mean", 7, mean_scale_hyperprior, 16, 24),
         ("cheng2020-anchor", 6, cheng2020_anchor, 16, 16)]


def _program(arch, q, sd, N, M):
    from lmic_tpu_torch import zoo

    return zoo.create_model(arch, q, device="cpu", state_dict=sd, N=N, M=M)


@pytest.mark.parametrize("arch,q,ref,N,M", ARCHS)
def test_training_forward_and_loss_match_the_program(arch, q, ref, N, M):
    from lmic_tpu_torch.utils.train import rate_distortion_loss

    sd = weights.make(ref.Model, N, M, 2 ** 40 + 3, "cpu")
    module = _program(arch, q, sd, N, M).module
    model = ref.Model(N, M)
    model.load_state_dict(sd)
    x = synth.image_pool(2, 64, 64, 5, "cpu").float() / 255
    out = module(x.contiguous(memory_format=torch.channels_last),
                 training=True,
                 generator=torch.Generator().manual_seed(9))
    g = torch.Generator().manual_seed(9)
    noises = [torch.rand(s, generator=g) for s in model.noise_shapes(2, 64, 64)]
    want = model.train_forward(x, noises)
    torch.testing.assert_close(out["x_hat"], want["x_hat"], rtol=1e-4,
                               atol=1e-5)
    for k in ("y", "z"):
        torch.testing.assert_close(out["likelihoods"][k],
                                   want["likelihoods"][k], rtol=1e-4,
                                   atol=1e-6)
    lam = 10240.0
    assert float(rate_distortion_loss(out, x, lam)["loss"].detach()) == pytest.approx(
        float(ref_train.rd_loss(want, x, lam)), rel=1e-5)


def test_tables_equal_the_programs():
    from lmic_tpu_torch.entropy.entropy_models import (
        GaussianConditional, eb_update, get_scale_table)

    sd = weights.make(mean_scale_hyperprior.Model, 16, 24, 77, "cpu")
    program = _program("mbt2018-mean", 7, sd, 16, 24).module
    model = mean_scale_hyperprior.Model(16, 24)
    model.load_state_dict(sd)
    cdf, length, offset, med = model.entropy_bottleneck.table()
    eb = eb_update(program.entropy_bottleneck)
    assert np.array_equal(cdf, eb.table.cdf)
    assert np.array_equal(length, eb.table.cdf_length)
    assert np.array_equal(offset, eb.table.offset)
    assert np.array_equal(med, eb.medians)
    gc = GaussianConditional().update(get_scale_table())
    cdf, length, offset = entropy.gaussian_tables(entropy.scale_table())
    assert np.array_equal(cdf, gc.table.cdf)
    assert np.array_equal(length, gc.table.cdf_length)
    assert np.array_equal(offset, gc.table.offset)


def test_rans_decoder_reads_the_programs_streams():
    from lmic_tpu_torch.entropy import coder

    cdf, length, offset = entropy.gaussian_tables(entropy.scale_table())
    table = coder.CdfTable(cdf, length, offset)
    rng = np.random.default_rng(3)
    rows = rng.integers(0, 64, (5, 3000))
    sym = np.round(rng.normal(0, 1, rows.shape)
                   * entropy.scale_table()[rows] * 2).astype(np.int32)
    sym[:, ::101] += 5000     # escapes above the range
    sym[:, 7::211] -= 70000   # and far below it
    streams = coder.encode_batch(sym, rows, table)
    got = rans.decode(streams, rows, rans.Table(cdf, length, offset))
    assert np.array_equal(got, sym)


def test_codec_round_trip_decodes_and_judges_to_zero():
    sd = weights.make(mean_scale_hyperprior.Model, 16, 24, 123, "cpu")
    program = _program("mbt2018-mean", 7, sd, 16, 24)
    program.update()
    pix = synth.image_pool(2, 128, 192, 8, "cpu")
    x = pix.permute(0, 2, 3, 1).contiguous().numpy()
    out = program.compress(x)
    x_hat = program.decompress(out["strings"], out["shape"], u8=True)["x_hat"]
    model = mean_scale_hyperprior.Model(16, 24)
    model.load_state_dict(sd)
    tables = codec.Tables(model)
    got = codec.decode_and_judge(model, tables, pix, out["strings"],
                                 out["shape"], torch.as_tensor(x_hat))
    assert max(got["sym_ppm"]) == 0 and max(got["pix_ppm"]) == 0
    # one altered pixel value of one image shows in that image alone
    x_bad = x_hat.copy()
    x_bad[1, 5, 5, 0] ^= 1
    got = codec.decode_and_judge(model, tables, pix, out["strings"],
                                 out["shape"], torch.as_tensor(x_bad))
    assert got["pix_ppm"][0] == 0 and got["pix_ppm"][1] > 0


def test_guided_decode_recovers_rows_in_doubt():
    """Where the decoder's own row is wrong but the other candidate is the
    coder's, and where the other candidate is wrong, the decode follows
    the coder's rows exactly; the expected symbols may disagree now and
    then."""
    from lmic_tpu_torch.entropy import coder

    cdf, length, offset = entropy.gaussian_tables(entropy.scale_table())
    rng = np.random.default_rng(1)
    rows = rng.integers(1, 63, (4, 6000))
    sym = np.round(rng.normal(0, 1, rows.shape)
                   * entropy.scale_table()[rows] * 1.2).astype(np.int32)
    sym[:, ::500] += 400
    streams = coder.encode_batch(sym, rows, coder.CdfTable(cdf, length,
                                                          offset))
    mine, alt = rows.copy(), rows.copy()
    flip = rng.random(rows.shape) < 2e-3
    mine[flip] = rows[flip] + rng.choice([-1, 1], flip.sum())
    doubt = (rng.random(rows.shape) < 2e-3) & ~flip
    alt[doubt] = rows[doubt] + 1
    expected = sym.copy()
    expected[rng.random(rows.shape) < 0.02] += 1
    table = rans.Table(cdf, length, offset)
    assert np.array_equal(rans.decode(streams, mine, table, alt, expected),
                          sym)
    assert not np.array_equal(rans.decode(streams, mine, table), sym)


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_reference_imports_nothing_of_the_program():
    ref_dir = os.path.join(REPO, "benchmark", "reference")
    for name in os.listdir(ref_dir):
        if name.endswith(".py"):
            tops = {m.split(".")[0] for m in _imports(os.path.join(ref_dir,
                                                                   name))}
            assert not tops & {"lmic_tpu_torch", "lmic_tpu", "jax", "flax",
                               "jaxlib"}, name
    code = ("import sys; import benchmark.reference.codec, "
            "benchmark.reference.train, benchmark.reference.cheng2020_anchor;"
            " print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'lmic_tpu_torch', 'lmic_tpu', 'jax', 'flax', 'jaxlib'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"
