from lmic_tpu_torch.entropy.entropy_models import (  # noqa: F401
    EBState,
    EntropyBottleneck,
    GaussianConditional,
    GCState,
    eb_update,
    get_scale_table,
)
