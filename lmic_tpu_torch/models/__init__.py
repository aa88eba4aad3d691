from lmic_tpu_torch.models.codec import (  # noqa: F401
    CompressionCodec,
    FactorizedPriorCodec,
    HyperpriorCodec,
)
from lmic_tpu_torch.models.image import (  # noqa: F401
    FactorizedPrior,
    MeanScaleHyperprior,
    ScaleHyperprior,
)
