from lmic_tpu_torch.ops.math import (  # noqa: F401
    LowerBound,
    NonNegativeParametrizer,
    from_amp,
    lower_bound,
    ste_round,
)
from lmic_tpu_torch.ops.gdn import gdn_core, gdn_reference  # noqa: F401
