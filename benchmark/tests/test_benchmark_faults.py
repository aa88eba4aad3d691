"""A run with the timed path broken underneath comes out not correct: the
faults each cell can have, planted in lmic_tpu_torch on the CPU at a tiny
size and judged against the cells' own limits (benchmark/limits/)."""

import numpy as np
import pytest
import torch

from test_benchmark_harness import CELLS, run_cell
from cpu_cells import tiny_root

TRAIN = [CELLS[0], CELLS[2]]
CODEC = CELLS[1]


def _unchanged(monkeypatch):
    """A step that returns its state unchanged (forward and backward run,
    no optimizer steps)."""
    from lmic_tpu_torch.utils import train

    def update(state, optimizer, loss_fn):
        loss, metrics = loss_fn()
        loss.backward()
        return state, metrics

    monkeypatch.setattr(train, "train_update", update)


def _wrap_step(monkeypatch, change):
    from lmic_tpu_torch.utils import train

    make = train.make_train_step

    def make_broken(*a, **k):
        step = make(*a, **k)
        return lambda state, batch, gen=None: step(state, change(batch), gen)

    monkeypatch.setattr(train, "make_train_step", make_broken)


def _half(monkeypatch):
    """Half of the batch left out, the mean taken over the rest."""
    _wrap_step(monkeypatch, lambda x: x[:x.shape[0] // 2])


def _altered(monkeypatch):
    """One row of every batch altered where the step reads it."""
    _wrap_step(monkeypatch, lambda x: torch.cat([1 - x[:1], x[1:]]))


@pytest.mark.parametrize("fault", [_unchanged, _half, _altered])
@pytest.mark.parametrize("cell", TRAIN)
def test_training_faults_are_not_correct(cell, fault, tmp_path, monkeypatch):
    root = tiny_root(tmp_path)
    sound, _ = run_cell(root, cell, 0, monkeypatch)
    assert sound["correct"]
    fault(monkeypatch)
    line, _ = run_cell(root, cell, 0, monkeypatch)
    assert not line["correct"], line["checks"]


def _stale(monkeypatch):
    """Every batch answered with the previous batch's strings (the state
    of the coder left as the last call left it)."""
    from lmic_tpu_torch.models.codec import HyperpriorCodec

    real, last = HyperpriorCodec.compress_async, []

    def stale(self, x):
        out = real(self, x)()
        prev = last[-1] if last else out
        last.append(out)
        return lambda: prev

    monkeypatch.setattr(HyperpriorCodec, "compress_async", stale)


def _half_batch(monkeypatch):
    """Half of each batch left out of the encode."""
    from lmic_tpu_torch.models.codec import HyperpriorCodec

    real = HyperpriorCodec.compress_async
    monkeypatch.setattr(HyperpriorCodec, "compress_async",
                        lambda self, x: real(self, x[:x.shape[0] // 2]))


def _altered_answer(monkeypatch):
    """One image's decoded pixels altered where they are produced."""
    from lmic_tpu_torch.models.codec import HyperpriorCodec

    real = HyperpriorCodec.decompress_async

    def altered(self, strings, shape):
        fin = real(self, strings, shape)

        def finalize():
            out = fin()
            x = out["x_hat"].copy()
            x[0] = np.clip(x[0].astype(np.int16) + 8, 0, 255).astype(np.uint8)
            return {"x_hat": x}

        return finalize

    monkeypatch.setattr(HyperpriorCodec, "decompress_async", altered)


@pytest.mark.parametrize("fault", [_stale, _half_batch, _altered_answer])
def test_codec_faults_are_not_correct(fault, tmp_path, monkeypatch):
    root = tiny_root(tmp_path)
    sound, _ = run_cell(root, CODEC, 0, monkeypatch)
    assert sound["correct"]
    fault(monkeypatch)
    line, _ = run_cell(root, CODEC, 0, monkeypatch)
    assert not line["correct"], line["checks"]
