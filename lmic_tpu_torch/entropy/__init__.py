from lmic_tpu_torch.entropy.coder import (  # noqa: F401
    BufferedRansEncoder,
    CdfTable,
    RansDecoder,
    decode_with_indexes,
    encode_with_indexes,
)
from lmic_tpu_torch.entropy.entropy_models import (  # noqa: F401
    EBState,
    EntropyBottleneck,
    GaussianConditional,
    GCState,
    eb_update,
    get_scale_table,
)
