"""The benchmark of qoi_tpu_torch on one CUDA card (see run.py, harness.py).

It measures the port (`qoi_tpu_torch`) and imports neither JAX nor the
JAX package `qoi_tpu`.
"""
