"""qoi_tpu_torch as a package: it imports no JAX, builds nothing at
import, picks devices explicitly (no silent CPU fallback) and converts the
JAX encoder carry exactly."""
import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import qoi_tpu_torch
from qoi_tpu.models import pipeline as jpipe
from qoi_tpu.utils import testimages
from qoi_tpu_torch.kernels import _build
from qoi_tpu_torch.kernels import block_maps as tbm
from qoi_tpu_torch.kernels import expand as texpand
from qoi_tpu_torch.kernels import slide as tslide
from qoi_tpu_torch.models import pipeline as tpipe

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "qoi_tpu_torch"

#: the numpy-only leaves of the JAX package the port may share
ALLOWED_QOI_TPU = ("qoi_tpu.format", "qoi_tpu.oracle", "qoi_tpu.config",
                   "qoi_tpu.utils.testimages")


def _imported_names(path):
    """Fully qualified names a file imports (`from a import b` -> a.b)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.update(f"{node.module}.{a.name}" for a in node.names)
    return names


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT))
    for p in [*PKG.rglob("*.py"), ROOT / "chip_smoke.py"]))
def test_no_jax_import(path):
    """No module of the port, nor the chip smoke script, imports jax or a
    JAX-dependent part of qoi_tpu."""
    for name in _imported_names(ROOT / path):
        top = name.split(".")[0]
        assert top != "jax", f"{path} imports {name}"
        if top == "qoi_tpu":
            assert any(name == a or name.startswith(a + ".")
                       for a in ALLOWED_QOI_TPU), f"{path} imports {name}"


def test_import_and_roundtrip_with_jax_blocked():
    """With jax made unimportable, every module of the port imports and a
    tiny encode -> decode runs on the CPU."""
    code = """
import sys
sys.modules["jax"] = None
import numpy as np
import qoi_tpu_torch
from qoi_tpu_torch.models import pipeline, decode_v3, buckets
from qoi_tpu_torch.ops import scans, table, compact, fsm
from qoi_tpu_torch.kernels import slide, expand, block_maps, _build
from qoi_tpu.utils import testimages
img = testimages.mixed(23, 9, 4)
s = qoi_tpu_torch.encode(img, device="cpu")
px, desc = qoi_tpu_torch.decode(s, device="cpu")
assert np.array_equal(px, img), "roundtrip mismatch"
assert _build._lib is None, "the CPU path must not build kernels"
assert "jax" not in {m.split(".")[0] for m, v in sys.modules.items() if v}
print("ok")
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_cuda_default_raises_without_a_card():
    """The facade defaults to "cuda" and raises on a machine without a
    card instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    img = testimages.noise(5, 3, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        qoi_tpu_torch.encode(img)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        qoi_tpu_torch.decode(qoi_tpu_torch.encode(img, device="cpu"),
                             device="cuda")


@pytest.mark.parametrize("kernel", ["slide", "expand", "block_maps"])
def test_wrappers_refuse_non_cpu_tensors_without_fallback(kernel):
    """A tensor that is not on the CPU goes to the kernel or raises: here
    a 'meta' tensor must raise instead of taking the plain twin."""
    z = torch.zeros((4, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="kernel needs CUDA"):
        if kernel == "slide":
            tslide.slide_val(z, z)
        elif kernel == "expand":
            texpand.expand_px(z[0], z[0], 16)
        else:
            tbm.block_maps(z, z, z)


def test_wrappers_check_shapes():
    z = torch.zeros((4, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        tslide.slide_val(z, z[:2])
    with pytest.raises(ValueError):
        texpand.expand_px(z[0], z[0, :3], 16)
    with pytest.raises(ValueError):
        tbm.block_maps(z, z, z[:, :2])


def test_launch_counts_start_at_zero_and_reset():
    _build.reset_launches()
    assert set(_build.launches) == {"slide_val", "expand_px", "block_maps"}
    assert all(v == 0 for v in _build.launches.values())


def test_carry_from_numpy_round_trips():
    """carry_from_numpy turns the JAX EncoderCarry, fetched as numpy, into
    the port's carry; carry_to_numpy gives back exactly the JAX arrays."""
    img = testimages.palette_alpha(40, 20)
    px4 = tpipe.force_rgba(img, qoi_tpu_torch.StreamDesc(40, 20, 4))
    rng = np.random.default_rng(2)
    tbl = rng.integers(0, 1 << 32, 64, dtype=np.uint64).astype(np.uint32)
    wr = rng.random(64) < 0.5
    jcarry = jpipe.encode_stage_chunks(
        jnp.asarray(px4), jnp.int32(px4.shape[0] - 17),
        prev_in=jnp.asarray(np.array([1, 2, 3, 4], np.uint8)),
        run_in=jnp.int32(5), table_in=(jnp.asarray(tbl), jnp.asarray(wr)),
        contains_last=jnp.bool_(False), form="words").carry
    as_np = tuple(np.asarray(x) for x in jcarry)
    port = tpipe.carry_from_numpy(as_np, torch.device("cpu"))
    assert port.table.dtype == torch.int64
    assert port.prev_px.dtype == torch.uint8
    back = tpipe.carry_to_numpy(port)
    for a, b in zip(as_np, back):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
