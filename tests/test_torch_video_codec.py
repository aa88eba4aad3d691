"""The port's ssf2020 codec against lmic_tpu's on the CPU, on the same
weights and carried tables: byte-identical strings for a 3-frame 128x128
GOP, decoded frames within 1e-5 of lmic_tpu's, the decoder equal to the
encoder's in-loop reconstructions, the whole-GOP paths equal to the
per-frame ones, uint8 and float input, multi-sequence batches, the
geometry guard, symbols outside int8, and the deployment checkpoint."""

import copy

import jax
import numpy as np
import pytest
import torch

from lmic_tpu import parallel as jparallel
from lmic_tpu.models.video import ScaleSpaceFlowCodec as JaxVideoCodec
from lmic_tpu_torch import parallel
from lmic_tpu_torch import zoo as tzoo
from lmic_tpu_torch.utils import checkpoint as ckpt
from lmic_tpu_torch.utils import update_model_cli
from lmic_tpu_torch.zoo.convert import state_dict_from_jax
from torch_port_helpers import (
    VIDEO_GOP,
    carry_video_tables,
    pixels,
    video_codecs,
)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def codecs():
    return video_codecs(0)


def _frame_streams(strings):
    """Per frame part (keyframe; motion, residual), its byte strings."""
    out = []
    for fs in strings:
        for group in ([fs["motion"], fs["residual"]]
                      if isinstance(fs, dict) else [fs]):
            out.append([bytes(s) for g in group for s in g])
    return out


def _rel(a, b):
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("seed", [0, 1])
def test_strings_byte_identical_to_lmic_tpu(codecs, seed):
    """Strings and shapes equal lmic_tpu's; each decoded frame within 1e-5
    of lmic_tpu's, relative to the frame's largest value."""
    jc, pc, _ = codecs
    x = pixels(VIDEO_GOP, seed=seed)
    got, got_shapes = pc.compress(x)
    want, want_shapes = jc.compress(x)
    assert got_shapes == want_shapes
    assert _frame_streams(got) == _frame_streams(want)
    assert len(got) == 3 and sum(map(len, _frame_streams(got))) == 10
    rec, ref = pc.decompress(got, got_shapes), jc.decompress(want,
                                                             want_shapes)
    assert rec.shape == ref.shape == VIDEO_GOP and rec.dtype == np.float32
    for t in range(3):
        assert _rel(rec[:, t], ref[:, t]) < 1e-5, t


def test_decoder_equals_encoder_reconstructions(codecs):
    """The per-frame encoder's in-loop frames equal the per-frame decoder's
    and the whole-GOP decoder's, exactly."""
    _, pc, _ = codecs
    x = pixels(VIDEO_GOP, seed=5)
    with torch.inference_mode():
        xt = pc._frames(x)
        enc_ref, key = pc.encode_keyframe(xt[:, 0])
        dec_ref = pc.decode_keyframe(key["strings"], key["shape"])
        assert torch.equal(enc_ref, dec_ref)
        recs, strings, shapes = [enc_ref], [key["strings"]], [key["shape"]]
        for i in (1, 2):
            enc_ref, out = pc.encode_inter(xt[:, i], enc_ref)
            dec_ref = pc.decode_inter(dec_ref, out["strings"], out["shape"])
            assert torch.equal(enc_ref, dec_ref), i
            recs.append(enc_ref)
            strings.append(out["strings"])
            shapes.append(out["shape"])
    want = torch.stack(recs, 1).permute(0, 1, 3, 4, 2).numpy()
    np.testing.assert_array_equal(pc.decompress(strings, shapes), want)


def test_gop_paths_equal_per_frame_paths(codecs):
    """One fetch a GOP gives the per-frame loop's bytes; the two decoders
    give the same frames, as floats and as uint8."""
    _, pc, _ = codecs
    x = pixels(VIDEO_GOP, seed=6)
    s_gop, sh_gop = pc.compress(x)
    s_sync, sh_sync = pc._compress_chunk_sync(x)
    assert s_gop == s_sync and sh_gop == sh_sync
    for u8 in (False, True):
        np.testing.assert_array_equal(
            pc._decompress_chunk(s_gop, sh_gop, u8),
            pc._decompress_chunk_sync(s_gop, sh_gop, u8))
    assert set(pc.stats) >= {
        "enc_device_ms", "enc_fetch_ms", "enc_rans_ms", "dec_z_rans_ms",
        "dec_idx_fetch_ms", "dec_y_rans_ms", "dec_device_ms",
        "dec_fetch_ms"}


def test_u8_and_f32_give_the_same_strings(codecs):
    _, pc, _ = codecs
    u8 = pixels(VIDEO_GOP, seed=7)
    s_u8, sh_u8 = pc.compress(u8)
    s_f32, sh_f32 = pc.compress(u8.astype(np.float32) / 255.0)
    assert s_u8 == s_f32 and sh_u8 == sh_f32
    rec_u8 = pc.decompress(s_u8, sh_u8, u8=True)
    assert rec_u8.dtype == np.uint8
    np.testing.assert_array_equal(rec_u8, np.round(np.clip(
        pc.decompress(s_u8, sh_u8), 0.0, 1.0) * 255.0).astype(np.uint8))


def test_two_sequences_equal_two_single_calls(codecs):
    _, pc, _ = codecs
    x = np.concatenate([pixels(VIDEO_GOP, seed=8),
                        pixels(VIDEO_GOP, seed=9)])
    strings, shapes = pc.compress(x)
    parts = [pc.compress(x[i:i + 1]) for i in range(2)]
    for t in range(3):
        for a, b, c in zip(_frame_streams(strings[t:t + 1]),
                           _frame_streams(parts[0][0][t:t + 1]),
                           _frame_streams(parts[1][0][t:t + 1])):
            assert a == [b[0], c[0], b[1], c[1]]  # [y_0, y_1, z_0, z_1]
    assert shapes == parts[0][1]
    np.testing.assert_array_equal(
        pc.decompress(strings, shapes, u8=True),
        np.concatenate([pc.decompress(*p, u8=True) for p in parts]))


def test_sequences_fan_out_over_a_mesh(codecs):
    """`shard_codec` over two CPU entries runs each sequence's chain on
    its own entry: the strings and frames of one device, through the
    synchronous and the async pair, and the strings of lmic_tpu's codec
    sharded over a two-device mesh (tests/test_video_model.py:91, 114)."""
    jc, pc, _ = codecs
    x = np.concatenate([pixels(VIDEO_GOP, seed=10),
                        pixels(VIDEO_GOP, seed=11)])
    strings, shapes = pc.compress(x)
    fan = parallel.shard_codec(copy.copy(pc),
                               parallel.make_mesh(2, device="cpu"))
    assert fan._fanout_devices == [torch.device("cpu")] * 2
    assert fan.compress(x) == (strings, shapes)
    assert fan.compress_async(x)() == (strings, shapes)
    want = pc.decompress(strings, shapes, u8=True)
    np.testing.assert_array_equal(fan.decompress(strings, shapes, u8=True),
                                  want)
    np.testing.assert_array_equal(
        fan.decompress_async(strings, shapes, u8=True)(), want)
    jfan = jparallel.shard_codec(copy.copy(jc), jparallel.make_mesh(2))
    assert jfan.compress(x) == (strings, shapes)


def test_frames_not_multiples_of_128_are_refused(codecs):
    _, pc, _ = codecs
    for shape in ((1, 2, 96, 128, 3), (1, 2, 128, 96, 3)):
        with pytest.raises(ValueError, match="multiples of 128"):
            pc.compress(np.zeros(shape, np.uint8))
    with pytest.raises(ValueError, match=r"\(B, T, H, W, 3\)"):
        pc.compress(np.zeros((2, 128, 128, 3), np.uint8))
    with pytest.raises(RuntimeError, match="update"):
        tzoo.create_video_model(device="cpu").compress(
            np.zeros((1, 2, 128, 128, 3), np.uint8))


@pytest.mark.parametrize("path", [("img_encoder", "Conv_3"),
                                  ("img_hyperprior", "hyper_encoder",
                                   "Conv_2")],
                         ids=["y", "z"])
def test_symbols_outside_int8_give_lmic_tpus_strings(codecs, path):
    """A bias of +200 on one channel of the keyframe's y (or z) puts its
    symbols outside int8, where lmic_tpu narrows y to int16 (or takes its
    float path for z); the strings are still lmic_tpu's."""
    jc0, _, params = codecs
    params = jax.tree.map(np.copy, params)
    node = params
    for k in path:
        node = node[k]
    node["Conv_0"]["bias"][0] += 200.0
    jc = JaxVideoCodec(jc0.module, {"params": params})
    jc.update(force=True)
    pc = carry_video_tables(jc, tzoo.create_video_model(
        device="cpu", state_dict=state_dict_from_jax("ssf2020", params)))
    x = pixels(VIDEO_GOP, seed=2)
    with torch.inference_mode():
        hp = pc.hp_states["img"]
        _, (z_sym, _, y_sym) = hp.device_part(
            pc.module.img_encode(pc._frames(x)[:, 0]))
    big = y_sym if path[0] == "img_encoder" else z_sym
    assert big.abs().max().item() > 127
    got, got_shapes = pc.compress(x)
    want, want_shapes = jc.compress(x)
    assert got_shapes == want_shapes
    assert _frame_streams(got) == _frame_streams(want)
    np.testing.assert_array_equal(pc.decompress(got, got_shapes),
                                  pc._decompress_chunk_sync(got, got_shapes))


def test_checkpoint_round_trip_gives_identical_strings(codecs, tmp_path):
    """update_model_cli -a ssf2020 finalizes a training checkpoint with
    the three sub-codecs' tables under `hp_states`; a codec of another
    seed that loads it codes byte-identical strings."""
    _, pc, _ = codecs
    train = tmp_path / "train.ckpt"
    torch.save({"params": pc.module.state_dict()}, train)
    path = update_model_cli.run([str(train), "-a", "ssf2020", "-d",
                                 str(tmp_path), "--device", "cpu"])
    blob = torch.load(path, weights_only=True)
    assert set(blob["hp_states"]) == {"img", "motion", "res"}
    assert "eb_state" not in blob
    loaded = ckpt.load_updated_model(
        path, tzoo.create_video_model(seed=3, device="cpu"))
    fresh = tzoo.create_video_model(device="cpu", state_dict=blob["params"])
    fresh.update()
    for which, hp in loaded.hp_states.items():
        want = fresh.hp_states[which]
        np.testing.assert_array_equal(hp.eb_state.table.cdf,
                                      want.eb_state.table.cdf)
        np.testing.assert_array_equal(hp.eb_state.medians,
                                      want.eb_state.medians)
        np.testing.assert_array_equal(hp.gc_state.scale_table,
                                      want.gc_state.scale_table)
    x = pixels(VIDEO_GOP, seed=10)
    got = loaded.compress(x)
    assert got == fresh.compress(x)
    np.testing.assert_array_equal(loaded.decompress(*got),
                                  fresh.decompress(*got))
