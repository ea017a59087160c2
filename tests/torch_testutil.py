"""Helpers shared by the qoi_tpu_torch CPU tests."""
import numpy as np
import torch

from qoi_tpu.utils import testimages


def as_u32(x):
    """JAX array or torch tensor -> numpy, integers as int64 u32 values
    (the port's int32 kernel planes are bit patterns)."""
    a = x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    if a.dtype == bool:
        return a
    return a.astype(np.int64) & 0xFFFFFFFF


def assert_same(jax_val, torch_val):
    np.testing.assert_array_equal(as_u32(jax_val), as_u32(torch_val))


def to_torch(a):
    return torch.from_numpy(np.array(a))


def e2e_cases():
    """(name, channels) of the end-to-end corpus: the edge-case suite for
    3 and 4 channels plus noise, palette and alpha_toggle."""
    cases = [(name, ch) for ch in (3, 4)
             for name in sorted(testimages.edge_case_suite(ch))]
    return cases + [("noise", 4), ("palette", 3), ("alpha_toggle", 4)]


def e2e_image(name, ch):
    extra = {"noise": lambda: testimages.noise(61, 23, ch, seed=4),
             "palette": lambda: testimages.palette(90, 31, ch, colors=11),
             "alpha_toggle": lambda: testimages.alpha_toggle(70, 19)}
    if name in extra:
        return extra[name]()
    return testimages.edge_case_suite(ch)[name]
