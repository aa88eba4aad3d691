"""Shared set-up of the lmic_tpu_torch parity tests: the same weights and
coding tables in the JAX package and in the port, made from a seed."""

import functools

import jax
import numpy as np
import torch

from lmic_tpu import zoo as jzoo
from lmic_tpu_torch import zoo as tzoo
from lmic_tpu_torch.zoo.convert import (
    coding_state_from_numpy,
    state_dict_from_jax,
)

ARCHS = ("bmshj2018-factorized", "bmshj2018-hyperprior", "mbt2018-mean")
N, M = 16, 24
IMAGE = (2, 64, 128, 3)  # H, W multiples of 64 (the hyperprior factor)


def pixels(shape=IMAGE, seed=0):
    return (np.random.default_rng(seed).random(shape) * 255).astype(np.uint8)


def _perturb_gammas(tree, rng):
    """Push every GDN gamma in `tree` off the diagonal, also those nested
    in blocks (cheng2020), in the tree's order."""
    for node in tree.values():
        if not isinstance(node, dict):
            continue
        if "gamma" in node:
            node["gamma"] = (node["gamma"] + rng.uniform(
                0, 0.05, node["gamma"].shape)).astype(np.float32)
        else:
            _perturb_gammas(node, rng)


def jax_params(arch, seed=0, n=N, m=M, channel=3, input_size=IMAGE[1:3]):
    """lmic_tpu init for `arch` at n/m, as numpy, with GDN gammas pushed
    off the diagonal (so the channel mixing is exercised) and the
    bottleneck medians moved off zero (so they matter in the symbols).
    `channel` is the image's channel count (the master's modality for
    the RGB-T master, whose init also traces its guide at `input_size`)."""
    codec = jzoo.create_model(arch, 1, key=jax.random.key(seed),
                              input_size=input_size, N=n, M=m,
                              channel=channel)
    params = jax.tree.map(np.asarray, codec.variables["params"])
    rng = np.random.default_rng(seed)
    for seq in ("g_a_net", "g_s_net"):
        _perturb_gammas(params[seq], rng)
    q = params["entropy_bottleneck"]["quantiles"].copy()
    q[:, :, 1] += rng.uniform(-0.3, 0.3, q.shape[0])[:, None]
    params["entropy_bottleneck"]["quantiles"] = q.astype(np.float32)
    return params


def jax_codec(arch, params, n=N, m=M, channel=3):
    codec = jzoo.create_model(arch, 1, variables={"params": params},
                              N=n, M=m, channel=channel)
    codec.update(force=True)
    return codec


def port_codec(arch, params, n=N, m=M, channel=3):
    return tzoo.create_model(arch, 1, device="cpu", N=n, M=m,
                             channel=channel,
                             state_dict=state_dict_from_jax(arch, params))


# the RGB-T pair at test widths; the master's role -> (master (H, W), guide
# (H, W)): channel 1 codes a thermal master with an RGB guide at 2x, channel
# 3 an RGB master with a thermal guide at half (its factor is 128)
RGBT_N, RGBT_M = 32, 48
RGBT_GEOMETRY = {1: ((64, 64), (128, 128)), 3: ((128, 128), (64, 64))}
# the subtrees of the pair's own modules, whose biases and LayerNorm scales
# init to constants: perturbed, so a swapped or dropped leaf shows
_RGBT_OWN = ("sp_aligner", "ch_aligner", "fencoder", "fdecoder")


def _perturb_leaves(tree, rng, own=False):
    for k, node in tree.items():
        if isinstance(node, dict):
            _perturb_leaves(node, rng, own or k.startswith(_RGBT_OWN))
        elif own and k in ("bias", "scale"):
            tree[k] = (node + rng.uniform(-0.1, 0.1, node.shape)).astype(
                np.float32)


@functools.lru_cache(maxsize=None)
def rgbt_pair(role):
    """lmic_tpu's guided and master codecs for a master of `role` channels
    at RGBT_N/RGBT_M from seeds, their params, and the port's codecs on the
    converted weights with the tables carried across:
    (guided (jc, pc, params), master (jc, pc, params)). Shared by the
    tests; do not change them."""
    out = []
    for arch, channel, size, seed in (("guided", 4 - role, (64, 64), 0),
                                      ("master", role,
                                       RGBT_GEOMETRY[role][0], 1)):
        params = jax_params(arch, seed, RGBT_N, RGBT_M, channel, size)
        _perturb_leaves(params, np.random.default_rng(seed + 10))
        jc = jax_codec(arch, params, RGBT_N, RGBT_M, channel)
        pc = carry_tables(jc, port_codec(arch, params, RGBT_N, RGBT_M,
                                         channel))
        out.append((jc, pc, params))
    return tuple(out)


def carry_tables(jc, pc):
    """Install the JAX codec's coding tables on the port codec."""
    def table(t):
        return {"cdf": t.cdf, "cdf_length": t.cdf_length, "offset": t.offset}

    gc = None
    if jc.gc_state is not None:
        gc = dict(table(jc.gc_state.table),
                  scale_table=jc.gc_state.scale_table)
    return coding_state_from_numpy(
        pc, eb=dict(table(jc.eb_state.table), medians=jc.eb_state.medians),
        gc=gc,
    )


def table_drift(got, want):
    """How far two CdfTables of one geometry are apart: (rows that differ,
    share of entries that differ, largest entry difference)."""
    diff = np.abs(got.cdf.astype(np.int64) - want.cdf)
    return (int((diff != 0).any(1).sum()), float((diff != 0).mean()),
            int(diff.max()))


def nchw(a):
    """NHWC numpy -> NCHW channels_last torch tensor."""
    return torch.from_numpy(np.array(a)).permute(0, 3, 1, 2)


def nhwc(t):
    return t.permute(0, 2, 3, 1).detach().numpy()


if __name__ == "__main__":
    # the port's own update() tables against lmic_tpu's, per arch:
    #   JAX_PLATFORMS=cpu PYTHONPATH=.:tests python tests/torch_port_helpers.py
    for arch in ARCHS:
        params = jax_params(arch)
        jc, pc = jax_codec(arch, params), port_codec(arch, params)
        pc.update()
        for name in ("eb_state", "gc_state"):
            want = getattr(jc, name)
            if want is not None:
                rows, share, worst = table_drift(getattr(pc, name).table,
                                                 want.table)
                print(f"{arch} {name}: {rows} of {len(want.table.cdf)} rows, "
                      f"{share:.4%} of entries, max |diff| {worst}")
