"""Seeded weights of a reference model, made on the device in a few large
draws, as a state dict under CompressAI's names that both the reference
and lmic_tpu_torch load.

- conv and transposed-conv kernels: LeCun normal (variance 1 / fan in,
  fan in = input channels x kernel taps), truncated at two standard
  deviations; biases U(-0.01, 0.01);
- GDN: beta = 1 + U(0, 0.5), gamma = 0.1 I + U(0, 0.002) off the diagonal
  (a dense gamma, so the kernels' channel product does real work), both
  stored sqrt-reparametrized;
- the bottleneck: CompressAI's initial matrices plus N(0, 0.05), biases
  U(-0.5, 0.5), factors N(0, 0.05), quantiles (-10, median, 10) with the
  median U(-0.5, 0.5).
"""

from __future__ import annotations

import math
from typing import Dict

import torch
from torch import nn

from benchmark.reference.entropy import EntropyBottleneck
from benchmark.reference.layers import GDN, nonnegative_init


def _leaves(model: nn.Module):
    """(name, shape, rule) of every parameter, in state-dict order."""
    owner = {}
    for mname, mod in model.named_modules():
        for pname, _ in mod.named_parameters(recurse=False):
            owner[f"{mname}.{pname}" if mname else pname] = mod
    out = []
    for name, p in model.named_parameters():
        mod = owner[name]
        leaf = name.rsplit(".", 1)[-1]
        if isinstance(mod, GDN):
            rule = "gdn_" + leaf
        elif isinstance(mod, EntropyBottleneck):
            rule = "eb_" + leaf.rstrip("0123456789").lstrip("_")
        elif isinstance(mod, nn.ConvTranspose2d) and leaf == "weight":
            rule = "deconv"
        elif isinstance(mod, nn.Conv2d) and leaf == "weight":
            rule = "conv"
        elif leaf == "bias":
            rule = "bias"
        else:
            raise ValueError(f"no weight rule for {name}")
        out.append((name, tuple(p.shape), rule))
    return out


@torch.no_grad()
def make(model_cls, N: int, M: int, seed: int, device) -> Dict[str, torch.Tensor]:
    """The state dict of `model_cls(N, M)` drawn from `seed` on `device`."""
    with torch.device("meta"):
        model = model_cls(N, M)
    leaves = _leaves(model)
    total = sum(math.prod(s) for _, s, _ in leaves)
    gen = torch.Generator(device=device).manual_seed(seed)
    normal = torch.randn(total, generator=gen, device=device)
    uniform = torch.rand(total, generator=gen, device=device)
    sd, at = {}, 0
    for name, shape, rule in leaves:
        n = math.prod(shape)
        z = normal[at:at + n].view(shape)
        u = uniform[at:at + n].view(shape)
        at += n
        if rule in ("conv", "deconv"):
            fan_in = shape[1 if rule == "conv" else 0] * shape[2] * shape[3]
            w = z.clamp(-2, 2) * (1.0 / fan_in) ** 0.5 / 0.8796256610342398
        elif rule == "bias":
            w = (u - 0.5) * 0.02
        elif rule == "gdn_beta":
            w = nonnegative_init(1.0 + 0.5 * u)
        elif rule == "gdn_gamma":
            eye = torch.eye(shape[0], device=device)
            w = nonnegative_init(0.1 * eye + 0.002 * u * (1 - eye))
        elif rule == "eb_matrix":
            init = math.log(math.expm1(1 / 10 ** (1 / 5) / shape[1]))
            w = init + 0.05 * z
        elif rule == "eb_bias":
            w = u - 0.5
        elif rule == "eb_factor":
            w = 0.05 * z
        elif rule == "eb_quantiles":
            w = torch.stack([torch.full_like(u[:, :, 0], -10.0),
                             u[:, :, 1] - 0.5,
                             torch.full_like(u[:, :, 0], 10.0)], -1)
        else:
            raise ValueError(rule)
        sd[name] = w.contiguous()
    return sd
