"""Model zoo for the ported image codecs.

Counterpart of lmic_tpu/zoo/__init__.py:48-189 (reference
compressai/zoo/image.py:189-246) for the three non-autoregressive
architectures, the autoregressive family (mbt2018, cheng2020-anchor,
cheng2020-attn), the RGB-T pair (`guided`, `master`) and the paired
RGB-T archs (`mbt2018_R`/`_D`, `cheng2020-anchor_R`/`_D`,
`cheng2020-attn_R`/`_D`), and the video zoo (ssf2020,
`create_video_model`, lmic_tpu/zoo/__init__.py:192-215). `create_model`
builds the module on the CPU from a seed, so the same seed gives the same
weights on every device, then hands it to the codec wrapper on `device`
(CUDA unless told otherwise).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from lmic_tpu_torch import default_device
from lmic_tpu_torch.models.codec import (
    CompressionCodec,
    FactorizedPriorCodec,
    HyperpriorCodec,
)
from lmic_tpu_torch.models.cheng import Cheng2020Anchor, Cheng2020Attention
from lmic_tpu_torch.models.image import (
    FactorizedPrior,
    MeanScaleHyperprior,
    ScaleHyperprior,
)
from lmic_tpu_torch.models.joint import (
    JointARCodec,
    JointAutoregressiveHierarchicalPriors,
)
from lmic_tpu_torch.models.rgbt import (
    GuidedCodec,
    GuidedCompresser,
    MasterCodec,
    MasterCompresser,
    WindowCrossAttention,
)
from lmic_tpu_torch.models.rgbt_joint import (
    Cheng2020Anchor_D,
    Cheng2020Anchor_R,
    Cheng2020Attention_D,
    Cheng2020Attention_R,
    FusedARCodec,
    JointAutoregressiveHierarchicalPriors_D,
    JointAutoregressiveHierarchicalPriors_R,
)
from lmic_tpu_torch.models.video import ScaleSpaceFlow, ScaleSpaceFlowCodec

# quality -> (N, M), or (N,) for the families with M = N (reference
# zoo/image.py:189-246)
cfgs: Dict[str, Dict[int, Tuple[int, ...]]] = {
    # the RGB-T pair: N = M = 192 at every quality of the fork's lambda
    # table (lmic_tpu/zoo/__init__.py:50-53)
    "guided": {q: (192, 192) for q in range(1, 8)},
    "master": {q: (192, 192) for q in range(1, 8)},
    "bmshj2018-factorized": {
        **{q: (128, 192) for q in range(1, 6)},
        **{q: (192, 320) for q in range(6, 9)},
    },
    "bmshj2018-hyperprior": {
        **{q: (128, 192) for q in range(1, 6)},
        **{q: (192, 320) for q in range(6, 9)},
    },
    "mbt2018-mean": {
        **{q: (128, 192) for q in range(1, 5)},
        **{q: (192, 320) for q in range(5, 9)},
    },
    "mbt2018": {
        **{q: (192, 192) for q in range(1, 5)},
        **{q: (192, 320) for q in range(5, 9)},
    },
    "cheng2020-anchor": {
        **{q: (128,) for q in range(1, 4)},
        **{q: (192,) for q in range(4, 7)},
    },
    "cheng2020-attn": {
        **{q: (128,) for q in range(1, 4)},
        **{q: (192,) for q in range(4, 7)},
    },
    # the paired RGB-T archs: the reference's class defaults N = M = 192
    # across the lambda table (lmic_tpu/zoo/__init__.py:77-83)
    "mbt2018_R": {q: (192, 192) for q in range(1, 8)},
    "mbt2018_D": {q: (192, 192) for q in range(1, 8)},
    "cheng2020-anchor_R": {q: (192,) for q in range(1, 8)},
    "cheng2020-anchor_D": {q: (192,) for q in range(1, 8)},
    "cheng2020-attn_R": {q: (192,) for q in range(1, 8)},
    "cheng2020-attn_D": {q: (192,) for q in range(1, 8)},
}

# architecture -> (module class, codec wrapper class)
model_architectures: Dict[str, Tuple[Any, Any]] = {
    "bmshj2018-factorized": (FactorizedPrior, FactorizedPriorCodec),
    "bmshj2018-hyperprior": (ScaleHyperprior, HyperpriorCodec),
    "mbt2018-mean": (MeanScaleHyperprior, HyperpriorCodec),
    "mbt2018": (JointAutoregressiveHierarchicalPriors, JointARCodec),
    "cheng2020-anchor": (Cheng2020Anchor, JointARCodec),
    "cheng2020-attn": (Cheng2020Attention, JointARCodec),
    "guided": (GuidedCompresser, GuidedCodec),
    "master": (MasterCompresser, MasterCodec),
    "mbt2018_R": (JointAutoregressiveHierarchicalPriors_R, GuidedCodec),
    "mbt2018_D": (JointAutoregressiveHierarchicalPriors_D, FusedARCodec),
    "cheng2020-anchor_R": (Cheng2020Anchor_R, GuidedCodec),
    "cheng2020-anchor_D": (Cheng2020Anchor_D, FusedARCodec),
    "cheng2020-attn_R": (Cheng2020Attention_R, GuidedCodec),
    "cheng2020-attn_D": (Cheng2020Attention_D, FusedARCodec),
}


def make_module(architecture: str, quality: int, channel: int = 3,
                generator: Optional[torch.Generator] = None,
                dtype: Optional[torch.dtype] = None, **kwargs):
    """Build the module for an architecture/quality; `N=`/`M=` override
    the quality table's widths (parity tests use narrow models); `dtype`
    is the activation compute dtype (torch.bfloat16 for AMP training,
    None for f32 and for every codec wire). `channel` is the image's
    channel count, for the master its modality (1: a thermal master with a
    3-channel guide at 2x; 3: the roles swapped); the guided and `_R`
    archs also take `first_stride=` (default 2), the first conv's
    stride."""
    if architecture not in model_architectures:
        raise ValueError(f'Invalid architecture name "{architecture}"')
    if quality not in cfgs[architecture]:
        raise ValueError(f'Invalid quality value "{quality}"')
    widths = cfgs[architecture][quality]
    N = kwargs.pop("N", widths[0])
    # the single-width families (cheng2020) take M = N (waseda.py:63)
    M = kwargs.pop("M", widths[1] if len(widths) == 2 else N)
    extra = {}
    if ((architecture == "guided" or architecture.endswith("_R"))
            and "first_stride" in kwargs):
        extra["first_stride"] = kwargs.pop("first_stride")
    if kwargs:
        raise TypeError(f"unexpected arguments {sorted(kwargs)}")
    module_cls, _ = model_architectures[architecture]
    return module_cls(N=N, M=M, channel=channel, generator=generator,
                      dtype=dtype, **extra)


@torch.no_grad()
def _init_params(module: nn.Module, generator: torch.Generator):
    """lmic_tpu's (flax's) initialisation, drawn from `generator`:
    LeCun-normal conv and dense kernels (variance 1/fan_in, truncated at
    two standard deviations) and zero biases, and the attention bias
    tables truncated normal at 0.02. It keeps activations at unit scale,
    so random-weight codecs code non-trivial latents."""
    for m in module.modules():
        if isinstance(m, WindowCrossAttention):
            nn.init.trunc_normal_(m.relative_position_bias_table, std=0.02,
                                  a=-0.04, b=0.04, generator=generator)
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            w = m.weight
            fan_in = w[0].numel()  # (O, I, kh, kw): I*kh*kw; (O, I): I
            if isinstance(m, nn.ConvTranspose2d):  # (I, O, kh, kw)
                fan_in = w.shape[0] * w[0, 0].numel()
            # flax divides by the truncated normal's std at [-2, 2]
            std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
            nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                                  generator=generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)


def create_model(architecture: str, quality: int, seed: int = 0,
                 channel: int = 3, device=None, state_dict=None,
                 dtype: Optional[torch.dtype] = None,
                 **kwargs) -> CompressionCodec:
    """Construct the module with weights drawn from `seed` (or loaded from
    a `state_dict` with CompressAI key names) and wrap it in its codec on
    `device`. Raises without a GPU unless `device="cpu"` is given. The
    weights do not depend on `dtype`."""
    device = default_device(device)
    generator = torch.Generator().manual_seed(seed)
    module = make_module(architecture, quality, channel=channel,
                         generator=generator, dtype=dtype, **kwargs)
    _, codec_cls = model_architectures[architecture]
    _init_params(module, generator)
    if state_dict is not None:
        module.load_state_dict(state_dict)
    return codec_cls(module, device)


video_architectures: Dict[str, Tuple[Any, Any]] = {
    "ssf2020": (ScaleSpaceFlow, ScaleSpaceFlowCodec),
}


def create_video_model(architecture: str = "ssf2020", quality: int = 1,
                       seed: int = 0, device=None, state_dict=None
                       ) -> ScaleSpaceFlowCodec:
    """The video codec with weights drawn from `seed` (or loaded from a
    `state_dict` with CompressAI key names) on `device`. ssf2020 has one
    width (192 latent, 128 mid planes) at every quality, as in lmic_tpu,
    so `quality` selects nothing."""
    if architecture not in video_architectures:
        raise ValueError(f'Invalid architecture name "{architecture}"')
    device = default_device(device)
    generator = torch.Generator().manual_seed(seed)
    module_cls, codec_cls = video_architectures[architecture]
    module = module_cls(generator=generator)
    _init_params(module, generator)
    if state_dict is not None:
        module.load_state_dict(state_dict)
    return codec_cls(module, device)


def video_models():
    return dict(video_architectures)
