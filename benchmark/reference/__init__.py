"""Plain PyTorch and NumPy reference of the benchmarked models.

It imports nothing of lmic_tpu_torch (nor jax, flax or lmic_tpu). It
follows CompressAI's published models (compressai/models/google.py,
waseda.py; compressai/entropy_models/entropy_models.py) and CompressAI's
rANS stream format (ryg_rans rans64, 16-bit precision, 4-bit bypass).
Its parameter names are CompressAI's, so one state dict made by the
harness loads into the reference and into the program alike.
"""
