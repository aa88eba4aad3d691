from lmic_tpu_torch.layers.layers import GDN, Conv, Deconv  # noqa: F401
