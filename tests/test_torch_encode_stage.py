"""qoi_tpu_torch fused encode staging (kernels/encode_stage.py) vs the JAX
package's Pallas kernel in interpret mode, on the CPU (the plain twin).
The same numpy pixels go to both; staging bytes (including the zeroed
bytes at or past each length) and lengths must be exactly equal. Cases
follow tests/test_kernels.py, at the JAX kernel's 1024-pixel block."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from qoi_tpu.kernels import encode_stage as jstage
from qoi_tpu_torch import format as fmt
from qoi_tpu_torch import oracle
from qoi_tpu_torch.kernels import encode_stage as tstage
from qoi_tpu_torch.kernels import pack as tpack
from qoi_tpu_torch.models import pipeline as tpipe
from qoi_tpu_torch.utils import testimages
from torch_testutil import to_torch


def _padded(img, cap=None):
    h, w, ch = img.shape
    px4 = tpipe.force_rgba(img, fmt.StreamDesc(w, h, ch))
    n = px4.shape[0]
    cap = cap or -(-n // 1024) * 1024
    out = np.zeros((cap, 4), np.uint8)
    out[:n] = px4
    return out, n


def _check(img, cap=None, last_pos=None):
    padded, n = _padded(img, cap)
    want_s, want_l = jstage.encode_stage_pallas(
        jnp.asarray(padded), n, last_pos=last_pos, interpret=True)
    got_s, got_l = tstage.encode_stage_pallas(to_torch(padded), n,
                                              last_pos=last_pos)
    assert got_s.dtype == torch.uint8 and got_s.shape == (len(padded), 6)
    assert got_l.dtype == torch.int32 and got_l.shape == (len(padded), 1)
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    return got_s, got_l, n


@pytest.mark.parametrize("name", ["gradient", "palette", "mixed", "flat_70px",
                                  "noise_small", "runs_caps", "seed_run",
                                  "wraparound", "alpha_toggle"])
def test_fused_staging_edge_cases(name):
    _check(testimages.edge_case_suite(4)[name])


def test_fused_staging_rgb():
    _check(testimages.mixed(64, 20, 3))


def test_fused_staging_multiblock_runs():
    """Runs crossing the 1024-pixel blocks exercise the run carry."""
    _check(testimages.flat(300, 8, 4))


def test_fused_staging_table_carry():
    """Palette repeats crossing blocks exercise the table carry."""
    _check(testimages.palette(300, 8, 4, colors=9, seed=5))


def test_fused_staging_padding_tail():
    """A ragged pixel count: padding up to the block, then a whole block
    of padding."""
    _check(testimages.noise(97, 5, 4, seed=8), cap=2048)


@pytest.mark.parametrize("last_pos", [-1, 700, 1500, 2399])
def test_fused_staging_last_pos(last_pos):
    """last_pos away from n_valid - 1: the end-of-stream run emission
    moves, and the run carry is cut at every block start after the block
    holding last_pos (all of them for -1)."""
    _check(testimages.runs_with_caps(120, 20, 4), cap=3072,
           last_pos=last_pos)


def test_fused_staging_equals_byte_planes_and_packs_to_the_oracle():
    """Within each length the twin's staging is encode_stage_chunks'
    byte planes; packed by compact_bytes6_pack it is the oracle's
    stream."""
    img = testimages.mixed(96, 40, 4, seed=3)
    stag, lens, n = _check(img, cap=4096)
    padded, _ = _padded(img, 4096)
    ch = tpipe.encode_stage_chunks(to_torch(padded), n, form="bytes")
    np.testing.assert_array_equal(lens[:, 0].numpy(), ch.lens.numpy())
    keep = np.arange(6)[None, :] < ch.lens.numpy()[:, None]
    np.testing.assert_array_equal(
        stag.numpy(), np.where(keep, ch.staging.T.numpy(), 0))
    buf, tot = tpack.compact_bytes6_pack(stag.T.contiguous(), lens[:, 0],
                                         4096 * 6)
    desc = fmt.StreamDesc(96, 40, 4)
    if oracle.available():
        assert (fmt.pack_header(desc) + buf[: int(tot)].numpy().tobytes()
                + fmt.TRAILER) == oracle.encode(img, desc)
