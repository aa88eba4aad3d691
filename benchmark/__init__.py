"""The benchmark of lmic_tpu_torch on an NVIDIA H100: the harness
(`run.py`), its yardstick (traffic generation, operation and byte counts,
peaks, trace reduction) and the plain reference that decides `correct`.
Nothing here imports jax, flax or lmic_tpu."""
