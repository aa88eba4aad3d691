"""The port's eval path against lmic_tpu's: the colour transforms (the
chroma upsampling as `jax.image.resize` computes it), the metrics (also
against tests/test_ms_ssim_canonical.py's f64 numpy definition),
`ImageFolderTest`, the eval functions of `utils/eval_model.py` and
`utils/video_eval.py` on carried weights and tables (the RGB-T pairs':
tests/test_torch_eval_pairs.py), the video goldens
(tests/expected/eval_video_ssf2020_{1,5}.json, rtol 1e-4), and the eval
CLI's surface."""

import json
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmic_tpu import transforms as jtr
from lmic_tpu.datasets.image import ImageFolderTest as JImageFolderTest
from lmic_tpu.utils import eval_model as jeval
from lmic_tpu.utils import metrics as jmet
from lmic_tpu.utils import video_eval as jvideo
from lmic_tpu_torch import transforms as ttr
from lmic_tpu_torch.datasets import FLIR_TEST_IDS, ImageFolderTest
from lmic_tpu_torch.utils import eval_model
from lmic_tpu_torch.utils import metrics as tmet
from lmic_tpu_torch.utils import video_eval
from test_eval_golden import RGBT_VIDEO_QS, _check_golden, _write_images
from test_ms_ssim_canonical import _pairs, np_ms_ssim, np_ssim
from torch_port_helpers import (  # noqa: F401
    ARCHS,
    MS_SSIM_F32,
    M,
    N,
    carry_tables,
    jax_codec,
    jax_params,
    match_eval,
    one_thread,
    port_codec,
    video_codecs,
)

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# Transforms
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hw", [(8, 8), (7, 9), (5, 12)])
@pytest.mark.parametrize("mode", ["bicubic", "bilinear", "nearest"])
def test_yuv_420_to_444_matches_jax_image_resize(mode, hw):
    """Within 1e-6 of lmic_tpu's `jax.image.resize` upsampling, at even and
    odd sizes; torch's `F.interpolate` bicubic is not that function."""
    H, W = hw
    rng = np.random.default_rng(H * W)
    y = rng.random((2, 2 * H, 2 * W, 1), dtype=np.float32)
    u, v = (rng.random((2, H, W, 1), dtype=np.float32) for _ in range(2))
    want = np.asarray(jtr.yuv_420_to_444(
        tuple(map(jnp.asarray, (y, u, v))), mode=mode))
    got = ttr.YUV420To444(mode)((_t(y), _t(u), _t(v))).numpy()
    assert got.shape == want.shape == (2, 2 * H, 2 * W, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    parts = ttr.yuv_420_to_444((_t(y), _t(u), _t(v)), mode=mode,
                               return_tuple=True)
    np.testing.assert_array_equal(torch.cat(parts, -1).numpy(), got)
    if mode == "bicubic":
        interp = torch.nn.functional.interpolate(
            _t(u).permute(0, 3, 1, 2), scale_factor=2, mode="bicubic")
        assert np.abs(interp.permute(0, 2, 3, 1).numpy()
                      - got[..., 1:2]).max() > 1e-3


@pytest.mark.parametrize("hw", [(16, 24), (9, 11)])
def test_colour_conversions_and_420_pool_match_lmic_tpu(hw):
    rng = np.random.default_rng(sum(hw))
    x = rng.random((2, *hw, 3), dtype=np.float32)
    ycc = ttr.RGB2YCbCr()(_t(x))
    np.testing.assert_allclose(ycc.numpy(), np.asarray(jtr.rgb2ycbcr(x)),
                               atol=1e-6)
    np.testing.assert_allclose(ttr.YCbCr2RGB()(ycc).numpy(),
                               np.asarray(jtr.ycbcr2rgb(np.asarray(ycc))),
                               atol=1e-6)
    np.testing.assert_allclose(ttr.YCbCr2RGB()(ycc).numpy(), x, atol=1e-5)
    for got, want in zip(ttr.YUV444To420()(ycc),
                         jtr.yuv_444_to_420(jnp.asarray(ycc.numpy()))):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    assert repr(ttr.YUV420To444("nearest", True)) == repr(
        jtr.YUV420To444("nearest", True))
    with pytest.raises(ValueError, match="upsampling mode"):
        ttr.yuv_420_to_444((ycc, ycc, ycc), mode="lanczos")


# ---------------------------------------------------------------------------
# Metrics
# ---------------------------------------------------------------------------

CANONICAL_SHAPES = [(1, 161, 161, 3), (2, 176, 200, 3), (1, 192, 256, 1),
                    (1, 171, 240, 3)]


@pytest.mark.parametrize("shape", CANONICAL_SHAPES)
def test_metrics_match_the_definition_and_lmic_tpu(shape):
    """psnr within 1e-5 relative of lmic_tpu's; ssim and ms-ssim within
    1e-6 of the f64 numpy definition (the port sums in f64), and of
    lmic_tpu's f32 values within 1e-6 plus lmic_tpu's own distance from
    the definition (up to 3.0e-6 on the smooth pair: its taps are 3e-8
    off and its variances cancel in f32)."""
    rng = np.random.default_rng(sum(shape))
    for x, y in _pairs(rng, shape):
        np.testing.assert_allclose(float(tmet.psnr(_t(x), _t(y))),
                                   float(jmet.psnr(x, y)), rtol=1e-5)
        for name, oracle in (("ms_ssim", np_ms_ssim), ("ssim", np_ssim)):
            got = float(getattr(tmet, name)(_t(x), _t(y)))
            want = oracle(x, y)
            theirs = float(getattr(jmet, name)(x, y))
            assert abs(got - want) <= 1e-6, (name, got, want)
            assert abs(got - theirs) <= 1e-6 + abs(theirs - want), name


@pytest.mark.parametrize("shape", [(1, 160, 160, 3), (2, 99, 77, 3),
                                   (1, 64, 97, 1)])
def test_ms_ssim_fewer_scales_below_161(shape):
    """At a min side <= 160: fewer scales with renormalized weights and a
    warning, as lmic_tpu; odd sides padded before each pool."""
    rng = np.random.default_rng(3)
    x = rng.random(shape).astype(np.float32)
    y = np.clip(x + rng.normal(0, 0.05, shape), 0, 1).astype(np.float32)
    with pytest.warns(UserWarning, match="160"):
        got = float(tmet.ms_ssim(_t(x), _t(y)))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = float(jmet.ms_ssim(x, y))
    assert abs(got - want) <= 1e-5, (got, want)


# ---------------------------------------------------------------------------
# ImageFolderTest
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("channel", [1, 3])
def test_image_folder_test_matches_lmic_tpu(tmp_path, channel):
    """The fixed FLIR ids pick the same files, and the center crops (RGB
    at twice the crop) are lmic_tpu's arrays exactly."""
    from PIL import Image

    rgb, thermal = tmp_path / "val" / "RGB", tmp_path / "val" / "thermal_8_bit"
    rng = np.random.default_rng(channel)
    for d, mode, size in ((rgb, "RGB", (96, 120)), (thermal, "L", (48, 60))):
        d.mkdir(parents=True)
        for i in ("08865", "09077", "01234"):
            arr = (rng.random((*size, 3 if mode == "RGB" else 1)) * 255
                   ).astype(np.uint8)
            Image.fromarray(arr[..., 0] if mode == "L" else arr).save(
                d / f"FLIR_{i}.png")
    root = thermal if channel == 1 else rgb
    ours = ImageFolderTest(root, crop_size=(32, 48), channel=channel)
    theirs = JImageFolderTest(root, crop_size=(32, 48), channel=channel)
    assert len(ours) == len(theirs) == 2
    assert ours.samples == theirs.samples
    for i in range(2):
        for a, b in zip(ours[i], theirs[i]):
            np.testing.assert_array_equal(a, b)
    assert "08865" in FLIR_TEST_IDS and len(FLIR_TEST_IDS) == 20
    assert len(ImageFolderTest(root, (32, 48), channel, test_ids=[""])) == 3


# ---------------------------------------------------------------------------
# The eval functions on carried weights and tables
# ---------------------------------------------------------------------------

_CODECS = {}


def _codecs(arch):
    if arch not in _CODECS:
        m = N if arch.startswith("cheng") else M
        params = jax_params(arch, n=N, m=m)
        jc = jax_codec(arch, params, N, m)
        _CODECS[arch] = jc, carry_tables(jc, port_codec(arch, params, N, m))
    return _CODECS[arch]




@pytest.mark.parametrize("arch", ARCHS + ("mbt2018",))
def test_eval_image_functions_match_lmic_tpu(arch):
    """On an image padded from 50x70: the real coder's bpp exactly (the
    strings are byte-identical), psnr and ms-ssim within 1e-5 relative;
    the estimate's bpp within 1e-5 relative."""
    jc, pc = _codecs(arch)
    x = np.random.default_rng(7).random((1, 50, 70, 3), dtype=np.float32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # ms-ssim at a min side of 50
        match_eval(eval_model.eval_image_forward(pc, x),
               jeval.eval_image_forward(jc, x), exact_bpp=False)
        match_eval(eval_model.eval_image_codec(pc, x),
               jeval.eval_image_codec(jc, x), exact_bpp=True, timings=True)


# ---------------------------------------------------------------------------
# Video eval
# ---------------------------------------------------------------------------


def _clip(tmp_path, seed=5, frames=3, size=128):
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 255, frames * (size * size + 2 * (size // 2) ** 2),
                       dtype=np.uint8)
    path = tmp_path / f"clip_{size}x{size}_30_yuv420.yuv"
    raw.tofile(path)
    return path


def test_video_frame_conversion_and_metrics_match_lmic_tpu(tmp_path):
    from lmic_tpu.datasets.rawvideo import RawVideoSequence

    seq = RawVideoSequence.from_file(str(_clip(tmp_path, frames=1,
                                               size=64)))
    frame = seq[0]
    got = video_eval.yuv420_frame_to_rgb(frame).numpy()
    np.testing.assert_allclose(got, jvideo.yuv420_frame_to_rgb(frame),
                               atol=1e-6)
    rec = np.clip(got + np.random.default_rng(1).normal(0, 0.05, got.shape),
                  0, 1).astype(np.float32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ours = video_eval.compute_metrics_for_frame(frame, _t(rec))
        theirs = jvideo.compute_metrics_for_frame(frame, rec)
    assert set(ours) == set(theirs)
    for k in theirs:
        np.testing.assert_allclose(ours[k], theirs[k], rtol=1e-5,
                                   atol=MS_SSIM_F32 if "ssim" in k else 0,
                                   err_msg=k)
    padded, padding = video_eval.pad_frames(_t(got[:, 5:, 3:]), 16)
    want_p, want_pad = jvideo.pad_frames(got[:, 5:, 3:], 16)
    assert padding == want_pad
    np.testing.assert_array_equal(padded.numpy(), want_p)
    np.testing.assert_array_equal(
        video_eval.crop_frames(padded, padding).numpy(), got[:, 5:, 3:])
    seq.close()


@pytest.mark.parametrize("entropy_estimation", [False, True])
def test_eval_sequence_matches_lmic_tpu(tmp_path, entropy_estimation):
    """A 3-frame 128x128 clip, one GOP, through the port's ssf2020 on
    converted weights and carried tables: the coded bitrate exactly (the
    GOP's bytes are lmic_tpu's), the estimate and every metric within
    1e-5 relative (ms-ssim plus lmic_tpu's f32 error, MS_SSIM_F32)."""
    from lmic_tpu.datasets.rawvideo import RawVideoSequence as JSeq
    from lmic_tpu_torch.datasets.rawvideo import RawVideoSequence

    jc, pc, _ = video_codecs(0)
    path = str(_clip(tmp_path, seed=8))
    seq, jseq = RawVideoSequence.from_file(path), JSeq.from_file(path)
    # the name's 30 fps sets the rate; lmic_tpu reads the first digits of
    # the whole temporary path instead, so it is handed the name's rate
    assert seq.framerate == 30
    jseq.framerate = seq.framerate
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = video_eval.eval_sequence(pc, seq, 3, None, entropy_estimation)
        want = jvideo.eval_sequence(jc, jseq, 3, None, entropy_estimation)
    seq.close()
    jseq.close()
    assert set(got) == set(want)
    for k in want:
        if k.endswith("_time"):
            continue
        if k == "bitrate" and not entropy_estimation:
            assert got[k] == want[k]
        else:
            np.testing.assert_allclose(
                got[k], want[k], rtol=1e-5,
                atol=MS_SSIM_F32 if "ssim" in k else 0, err_msg=k)
    assert video_eval.aggregate_results([got, got]) == {
        k: float(np.mean([v, v])) for k, v in got.items()}


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("quality", RGBT_VIDEO_QS)
def test_video_eval_golden(tmp_path_factory, tmp_path, quality):
    """lmic-torch-video-eval on the golden's synthetic clip from a training
    checkpoint of lmic_tpu's default-key ssf2020: the reference metric set
    and lmic_tpu's JSON schema (test_eval_golden.py's checks)."""
    ckpt = tmp_path_factory.getbasetemp() / "ssf2020.ckpt"
    if not ckpt.exists():
        import jax

        from lmic_tpu import zoo as jzoo
        from lmic_tpu_torch.zoo.convert import state_dict_from_jax

        # the params do not depend on the init's input size
        jc = jzoo.create_video_model("ssf2020", 1, input_size=(128, 128))
        params = jax.tree.map(np.asarray, jc.variables["params"])
        torch.save({"params": state_dict_from_jax("ssf2020", params)}, ckpt)
    clip = _clip(tmp_path)
    outdir = tmp_path / "out"
    video_eval.main(["-d", str(clip), "--gop", "3", "-q", str(quality),
                     "-o", str(outdir), "--checkpoint", str(ckpt),
                     "--device", "cpu"])
    with open(outdir / "ssf2020-mse-ans.json") as f:
        doc = json.load(f)
    assert doc["name"] == "ssf2020-mse"
    assert doc["description"] == "Inference (ans)"
    assert doc["results"]["q"] == [f"ssf2020-mse-{quality}-ans"]
    for comp in "yuv":
        assert len(doc["results"][f"psnr-{comp}"]) == 1
    with open(outdir / f"{clip.stem}-ssf2020-mse-{quality}-ans.json") as f:
        seq_doc = json.load(f)
    assert set(seq_doc) == {"source", "name", "description", "results"}
    results = {k: v[0] for k, v in doc["results"].items() if k != "q"}
    # the rate rests on the port's own tables, which may drift from
    # lmic_tpu's by an ulp (ROADMAP C); lmic_tpu's golden test
    # sanity-checks it the same way
    assert results.pop("bitrate") > 0
    _check_golden(results, f"eval_video_ssf2020_{quality}.json")
    video_eval.main(["-d", str(clip), "--gop", "3", "-q", str(quality),
                     "-o", str(outdir), "--checkpoint", str(ckpt),
                     "--device", "cpu", "--entropy-estimation"])
    with open(outdir / "ssf2020-mse-entropy-estimation.json") as f:
        ee = json.load(f)
    assert ee["results"]["q"] == [
        f"ssf2020-mse-{quality}-entropy-estimation"]


# ---------------------------------------------------------------------------
# The CLI's surface
# ---------------------------------------------------------------------------


def test_eval_main_output_and_warm_redo(tmp_path, monkeypatch):
    """`--output` appends one summary a run; the real coder's first image
    is coded twice (the recorded times leave out the first launches);
    `--half` codes and decodes under the bf16 matmul precision, other
    numbers than f32's."""
    from lmic_tpu_torch import zoo as tzoo

    monkeypatch.setitem(tzoo.cfgs, "mbt2018-mean", {1: (N, M)})
    d = tmp_path / "images"
    _write_images(d, ["a.png", "b.png"], size=(64, 64))
    calls = []
    codec_fn = eval_model.eval_image_codec
    monkeypatch.setattr(eval_model, "eval_image_codec",
                        lambda c, x: calls.append(1) or codec_fn(c, x))
    out = tmp_path / "r.json"
    argv = ["--arch", "mbt2018-mean", "-q", "1", "-d", str(d), "--device",
            "cpu", "--output", str(out)]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        eval_model.main(argv)
        eval_model.main(argv + ["--entropy-estimation"])
    assert len(calls) == 3
    with open(out) as f:
        docs = json.load(f)
    assert [d["description"] for d in docs] == [
        "q=1 rans", "q=1 entropy-estimation"]
    assert set(docs[0]["results"]) == {"psnr", "ms-ssim", "bpp",
                                       "encoding_time", "decoding_time"}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        eval_model.main(argv + ["--half"])
    assert len(calls) == 6
    with open(out) as f:
        half = json.load(f)[-1]["results"]
    assert half["bpp"] > 0 and np.isfinite(half["psnr"])
    assert (half["bpp"], half["psnr"]) != (docs[0]["results"]["bpp"],
                                           docs[0]["results"]["psnr"])
