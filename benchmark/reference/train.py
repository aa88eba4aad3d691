"""The reference training step and the numbers that decide a training
cell's `correct`.

The step is CompressAI's examples/train.py with the fork's objective:
loss = lambda * MSE(x_hat, x) + bpp (bpp = sum(-log2 likelihood) over the
batch's pixels), plus the bottleneck's aux loss; one backward; the main
gradients (every parameter but `quantiles`) clipped to global norm 1.0
(g / norm * 1.0 when norm >= 1, optax's rule); Adam (0.9, 0.999, 1e-8)
at lr 1e-4 on them and at lr 1e-3 on the quantiles.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Sequence

import torch

B1, B2, EPS = 0.9, 0.999, 1e-8


def rd_loss(out, x, lmbda):
    B, _, H, W = x.shape
    bpp = sum(torch.log(l).sum() for l in out["likelihoods"].values()) / (
        -math.log(2.0) * B * H * W)
    mse = torch.mean((out["x_hat"] - x) ** 2)
    return lmbda * mse + bpp


def follow(model, params: Dict[str, torch.Tensor], batches: Sequence,
           noises: Sequence, lmbda: float, lr: float, aux_lr: float,
           clip: float) -> Dict:
    """Three (or len(batches)) steps from `params`: the RD loss of each
    step, the first step's clipped gradients, the parameters after the
    last step."""
    model.load_state_dict(params)
    if next(model.parameters()).is_cuda:
        model.to(memory_format=torch.channels_last)
    named = dict(model.named_parameters())
    m = {k: torch.zeros_like(p) for k, p in named.items()}
    v = {k: torch.zeros_like(p) for k, p in named.items()}
    losses, first = [], None
    for t, (x, noise) in enumerate(zip(batches, noises), start=1):
        if not x.is_cuda:
            # torch's CPU weight gradient of a strided 1x1 conv of a
            # 3-channel channels_last input corrupts the heap
            x = x.contiguous()
        for p in named.values():
            p.grad = None
        out = model.train_forward(x, noise)
        rd = rd_loss(out, x, lmbda)
        (rd + model.entropy_bottleneck.aux_loss()).backward()
        losses.append(float(rd.detach()))
        main = [k for k in named if not k.endswith("quantiles")]
        with torch.no_grad():
            norm = torch.sqrt(sum((named[k].grad ** 2).sum() for k in main))
            if float(norm) >= clip:
                for k in main:
                    named[k].grad.mul_(clip / norm)
            grads = {k: p.grad.detach().clone() for k, p in named.items()}
            if first is None:
                first = grads
            for k, p in named.items():
                g = grads[k]
                m[k].mul_(B1).add_(g, alpha=1 - B1)
                v[k].mul_(B2).addcmul_(g, g, value=1 - B2)
                step = aux_lr if k.endswith("quantiles") else lr
                mhat = m[k] / (1 - B1 ** t)
                vhat = v[k] / (1 - B2 ** t)
                p.sub_(step * mhat / (vhat.sqrt() + EPS))
    return {"losses": losses, "grads": first,
            "params": {k: p.detach().clone() for k, p in named.items()}}


def _norm(t):
    return float(torch.linalg.vector_norm(t.double()))


def worst_leaf(prog: Dict[str, float], ref: Dict[str, float],
               leaves: List[str]) -> float:
    """max over `leaves` of |prog - ref| / max(ref, the median leaf's ref):
    the gap between two norms of a leaf, against that leaf's norm or the
    median leaf's, whichever is larger."""
    med = statistics.median(ref[k] for k in leaves)
    return max(abs(prog[k] - ref[k]) / max(ref[k], med) for k in leaves)


def readings(prog: Dict, ref: Dict, p0: Dict[str, torch.Tensor]) -> Dict:
    """The three numbers compared: `loss_gap`, the largest relative gap of
    a step's RD loss; `grad_gap`, the worst leaf of the first step's
    clipped gradient norms; `change_gap`, the worst leaf of the norms of
    the parameters' change over the steps, leaving out the leaves whose
    reference gradient is below a thousandth of the median leaf's (they
    move under Adam by round-off alone). Also the leaves left out."""
    loss_gap = max(abs(a - b) / abs(b)
                   for a, b in zip(prog["losses"], ref["losses"]))
    keys = sorted(ref["grads"])
    g_ref = {k: _norm(ref["grads"][k]) for k in keys}
    g_prog = {k: _norm(prog["grads"][k]) for k in keys}
    grad_gap = worst_leaf(g_prog, g_ref, keys)
    med = statistics.median(g_ref.values())
    moved = [k for k in keys if g_ref[k] >= 1e-3 * med]
    d_ref = {k: _norm(ref["params"][k] - p0[k]) for k in moved}
    d_prog = {k: _norm(prog["params"][k] - p0[k]) for k in moved}
    gaps = {k: abs(d_prog[k] - d_ref[k]) / max(d_ref[k], statistics.median(
        d_ref.values())) for k in moved}
    g_gaps = {k: abs(g_prog[k] - g_ref[k]) / max(g_ref[k], med)
              for k in keys}
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "change_gap": worst_leaf(d_prog, d_ref, moved),
            "change_gap_median": statistics.median(gaps.values()),
            "grad_gap_median": statistics.median(g_gaps.values()),
            "worst_change_leaf": max(gaps, key=gaps.get),
            "worst_grad_leaf": max(g_gaps, key=g_gaps.get),
            "left_out": [k for k in keys if k not in moved]}
