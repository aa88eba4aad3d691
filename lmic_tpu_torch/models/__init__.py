from lmic_tpu_torch.models.cheng import (  # noqa: F401
    Cheng2020Anchor,
    Cheng2020Attention,
)
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
from lmic_tpu_torch.models.joint import (  # noqa: F401
    JointARCodec,
    JointAutoregressiveHierarchicalPriors,
)
from lmic_tpu_torch.models.rgbt import (  # noqa: F401
    GuidedCodec,
    GuidedCompresser,
    MasterCodec,
    MasterCompresser,
)
from lmic_tpu_torch.models.rgbt_joint import (  # noqa: F401
    Cheng2020Anchor_D,
    Cheng2020Anchor_R,
    Cheng2020Attention_D,
    Cheng2020Attention_R,
    FusedARCodec,
    JointAutoregressiveHierarchicalPriors_D,
    JointAutoregressiveHierarchicalPriors_R,
)
from lmic_tpu_torch.models.video import (  # noqa: F401
    ScaleSpaceFlow,
    ScaleSpaceFlowCodec,
)
