"""qoi_tpu_torch as a package: it imports neither JAX nor qoi_tpu, its
copies of the numpy leaves agree with the originals, it builds nothing at
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
from qoi_tpu import config as jconfig
from qoi_tpu import format as jfmt
from qoi_tpu import oracle as joracle
from qoi_tpu.models import pipeline as jpipe
from qoi_tpu.utils import testimages as jtestimages
from qoi_tpu_torch import config as tconfig
from qoi_tpu_torch import format as tfmt
from qoi_tpu_torch import oracle as toracle
from qoi_tpu_torch.kernels import _build
from qoi_tpu_torch.kernels import block_maps as tbm
from qoi_tpu_torch.kernels import compact_words as tcw
from qoi_tpu_torch.kernels import encode_stage as tstage
from qoi_tpu_torch.kernels import expand as texpand
from qoi_tpu_torch.kernels import numeric_scan as tns
from qoi_tpu_torch.kernels import pack as tpack
from qoi_tpu_torch.kernels import scan_codec as tscan
from qoi_tpu_torch.kernels import slide as tslide
from qoi_tpu_torch.models import pipeline as tpipe
from qoi_tpu_torch.utils import testimages

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "qoi_tpu_torch"


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
    """No module of the port, nor the chip smoke script, imports jax or
    any module of qoi_tpu."""
    for name in _imported_names(ROOT / path):
        top = name.split(".")[0]
        assert top not in ("jax", "qoi_tpu"), f"{path} imports {name}"


def test_import_and_roundtrip_with_jax_blocked():
    """With jax made unimportable, every module of the port imports and a
    tiny encode -> decode runs on the CPU."""
    code = """
import sys
sys.modules["jax"] = None
sys.modules["qoi_tpu"] = None
import numpy as np
import qoi_tpu_torch
from qoi_tpu_torch import (config, format, oracle, io, cli, corpus, bench,
                           headline, abperf)
from qoi_tpu_torch.models import (pipeline, decode_v3, decode_pipeline,
                                  decode_v2, streamed, scan_codec, batch)
from qoi_tpu_torch.utils import profiling
from qoi_tpu_torch.ops import scans, table, compact, fsm, link
from qoi_tpu_torch.kernels import (slide, expand, block_maps, pack,
                                   encode_stage, scan_codec, numeric_scan,
                                   _build)
from qoi_tpu_torch.parallel import (sharding, tiled, tiled_decode, dryrun,
                                    launch)
from qoi_tpu_torch.utils import testimages, make_corpus, fuzzcases
img = testimages.mixed(23, 9, 4)
s = qoi_tpu_torch.encode(img, device="cpu")
px, desc = qoi_tpu_torch.decode(s, device="cpu")
assert np.array_equal(px, img), "roundtrip mismatch"
assert _build._lib is None, "the CPU path must not build kernels"
tops = {m.split(".")[0] for m, v in sys.modules.items() if v}
assert not tops & {"jax", "qoi_tpu"}, tops
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


def test_surfaces_import_and_run_with_pil_blocked(tmp_path):
    """With PIL made unimportable (the card's machine has none), io, cli,
    corpus, bench, models.batch and utils.profiling import, and the CLI,
    the corpus job and the bench run on .qoi inputs and --nopng."""
    code = f"""
import sys
sys.modules["PIL"] = None
import numpy as np
from qoi_tpu_torch import cli, corpus, bench, io, oracle
from qoi_tpu_torch.models import batch
from qoi_tpu_torch.utils import profiling, testimages
img = testimages.mixed(23, 9, 4)
src = {str(tmp_path / "a.qoi")!r}
open(src, "wb").write(oracle.encode(img, io.image_desc(img)))
assert cli.main([src, {str(tmp_path / "b.qoi")!r}, "--verify",
                 "--device", "cpu"]) == 0
c = corpus.run_job({str(tmp_path)!r}, oracle_verify=True, device="cpu",
                   progress=lambda m: None)
assert c.images == 2 and c.verify_failures == 0
assert bench.main(["1", "--synthetic", "small", "--nopng", "--onlytotals",
                   "--device", "cpu"]) == 0
assert "PIL" not in {{m.split(".")[0] for m, v in sys.modules.items() if v}}
print("ok")
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "ok"


@pytest.fixture()
def one_rank_group():
    """A gloo process group of this process alone, torn down after."""
    import socket

    import torch.distributed as dist

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0)
    yield
    dist.destroy_process_group()


def _call_surface(name, tmp_path):
    """Call one user surface with its default device."""
    from qoi_tpu_torch import bench, cli, corpus, io
    from qoi_tpu_torch.models import batch
    from qoi_tpu_torch.utils import profiling

    img = testimages.mixed(12, 5, 4)
    desc = io.image_desc(img)
    stream = toracle.encode(img, desc)
    src = tmp_path / "a.qoi"
    src.write_bytes(stream)
    calls = {
        "io.write": lambda: io.write(tmp_path / "b.qoi", img, desc),
        "io.read": lambda: io.read(src),
        "io.read(engine=oracle)": lambda: io.read(src, engine="oracle"),
        "encode(engine=scan)": lambda: qoi_tpu_torch.encode(img,
                                                            engine="scan"),
        "encode_batch": lambda: batch.encode_batch([img]),
        "decode_batch": lambda: batch.decode_batch([stream]),
        "run_job": lambda: corpus.run_job(tmp_path, progress=lambda m: None),
        "corpus.main": lambda: corpus.main([str(tmp_path)]),
        "cli.main": lambda: cli.main([str(src), str(tmp_path / "c.qoi")]),
        "bench.main": lambda: bench.main(["1", "--synthetic", "small",
                                          "--nopng"]),
        "profiling.trace": lambda: profiling.trace(tmp_path).__enter__(),
        "profiling.device_sync_time": lambda: profiling.device_sync_time(
            lambda: None),
    }
    if name.startswith(("parallel.", "bench --scaling")):
        from qoi_tpu_torch.parallel import (dryrun, sharding, tiled,
                                            tiled_decode)

        cpu_mesh = sharding.make_mesh(1, 1, device="cpu")
        calls = {
            "parallel.make_mesh": lambda: sharding.make_mesh(1, 1),
            "parallel.encode_tiled": lambda: tiled.encode_tiled(
                img, desc, cpu_mesh),
            "parallel.decode_tiled": lambda: tiled_decode.decode_tiled(
                stream, cpu_mesh),
            "parallel.dryrun_multichip": lambda: dryrun.dryrun_multichip(1),
            "bench --scaling": lambda: bench.main(["1", "--scaling"]),
        }
    return calls[name]()


@pytest.mark.parametrize("name", [
    "io.write", "io.read", "io.read(engine=oracle)", "encode(engine=scan)",
    "encode_batch", "decode_batch", "run_job", "corpus.main", "cli.main",
    "bench.main", "profiling.trace", "profiling.device_sync_time"])
def test_surfaces_default_to_cuda_and_raise_without_a_card(name, tmp_path):
    """Every user surface defaults to "cuda" and raises on a machine
    without a card instead of running on the CPU, whatever the engine."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _call_surface(name, tmp_path)


@pytest.mark.parametrize("name", [
    "parallel.make_mesh", "parallel.encode_tiled", "parallel.decode_tiled",
    "parallel.dryrun_multichip", "bench --scaling"])
def test_parallel_defaults_to_cuda_and_raises_without_a_card(
        name, tmp_path, one_rank_group):
    """The sequence-parallel entry points, inside a process group, default
    to "cuda" and raise on a machine without a card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _call_surface(name, tmp_path)


def test_mesh_config_needs_a_process_group():
    """EngineConfig(mesh=...) is accepted and routes to the
    sequence-parallel codec, which raises without a process group (a
    mesh never falls back to one rank); make_mesh refuses a group of the
    wrong size."""
    from qoi_tpu_torch.config import EngineConfig
    from qoi_tpu_torch.parallel import sharding

    img = testimages.mixed(9, 4, 4)
    with pytest.raises(RuntimeError, match="process group"):
        qoi_tpu_torch.encode(img, device="cpu",
                             config=EngineConfig(mesh=(1, 2)))
    with pytest.raises(RuntimeError, match="process group"):
        sharding.make_mesh(1, 1, device="cpu")


def test_make_mesh_is_made_once_per_group(one_rank_group, monkeypatch):
    """make_mesh returns one mesh for each shape and device of a process
    group and creates no process group after the first call; a default
    group brought up anew gets a mesh of its own."""
    import socket

    import torch.distributed as dist

    from qoi_tpu_torch.parallel import sharding

    made = []
    real = dist.new_group
    monkeypatch.setattr(dist, "new_group",
                        lambda *a, **k: made.append(1) or real(*a, **k))
    mesh = sharding.make_mesh(1, 1, device="cpu")
    assert len(made) == 3
    assert sharding.make_mesh(1, 1, device="cpu") is mesh
    assert sharding.mesh_over([0], 1, 1, "cpu") is mesh and len(made) == 3
    dist.destroy_process_group()
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0)
    again = sharding.make_mesh(1, 1, device="cpu")
    assert again is not mesh and len(made) == 6


def test_make_mesh_checks_the_world_size(one_rank_group):
    from qoi_tpu_torch.parallel import sharding

    with pytest.raises(ValueError, match="2 ranks"):
        sharding.make_mesh(1, 2, device="cpu")
    mesh = sharding.make_mesh(1, 1, device="cpu")
    assert mesh.shape == {"data": 1, "seq": 1}
    assert (mesh.seq.index, mesh.seq.size, mesh.device.type) == (0, 1, "cpu")


@pytest.mark.parametrize("kernel", ["slide", "expand", "block_maps",
                                    "slide_val2", "place_words",
                                    "encode_stage", "encode_stage_words",
                                    "encode_scan", "decode_scan",
                                    "numeric_scan", "compact_words"])
def test_wrappers_refuse_non_cpu_tensors_without_fallback(kernel):
    """A tensor that is not on the CPU goes to the kernel or raises: here
    a 'meta' tensor must raise instead of taking the plain twin."""
    z = torch.zeros((4, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="kernel needs CUDA"):
        if kernel == "slide":
            tslide.slide_val(z, z)
        elif kernel == "expand":
            texpand.expand_px(z[0], z[0], 16)
        elif kernel == "block_maps":
            tbm.block_maps(z, z, z)
        elif kernel == "slide_val2":
            tslide.slide_val2(z, z, z)
        elif kernel == "place_words":
            tpack.place_words(z[0], z[0], z[0], 16)
        elif kernel == "encode_scan":
            tscan.encode_scan(z[0])
        elif kernel == "decode_scan":
            tscan.decode_scan(z[0].view(torch.uint8), 4, 4,
                              torch.zeros(65, dtype=torch.int32,
                                          device="meta"))
        elif kernel == "numeric_scan":
            tns.numeric_scan(z, z, z, torch.zeros((65, 8), dtype=torch.int32,
                                                  device="meta"))
        elif kernel == "compact_words":
            tcw.compact_words(z[0], z[0], z[0], 48)
        elif kernel == "encode_stage_words":
            tstage.encode_stage_words(
                torch.zeros((1000, 4), dtype=torch.uint8, device="meta"), 9)
        else:
            tstage.encode_stage_pallas(
                torch.zeros((1024, 4), dtype=torch.uint8, device="meta"), 9)


def test_wrappers_check_shapes():
    z = torch.zeros((4, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        tslide.slide_val(z, z[:2])
    with pytest.raises(ValueError):
        texpand.expand_px(z[0], z[0, :3], 16)
    with pytest.raises(ValueError):
        tbm.block_maps(z, z, z[:, :2])
    with pytest.raises(ValueError):
        tslide.slide_val2(z, z, z[:2])
    with pytest.raises(ValueError):
        tpack.place_words(z[0], z[0, :3], z[0], 16)
    with pytest.raises(ValueError):     # N not a multiple of the block
        tstage.encode_stage_pallas(torch.zeros((1000, 4), dtype=torch.uint8), 9)
    with pytest.raises(ValueError):     # not (N, 4)
        tstage.encode_stage_pallas(torch.zeros((1024, 3), dtype=torch.uint8), 9)
    with pytest.raises(ValueError):
        tscan.encode_scan(z)
    with pytest.raises(ValueError):
        tscan.decode_scan(z[0].view(torch.uint8), 4, 4, z[0])
    with pytest.raises(ValueError):
        tns.numeric_scan(z, z, z, z)


def test_launch_counts_start_at_zero_and_reset():
    _build.reset_launches()
    assert set(_build.launches) == {"slide_val", "expand_px", "block_maps",
                                    "slide_val2", "place_words",
                                    "encode_stage", "encode_stage_words",
                                    "encode_stage_planes",
                                    "encode_scan", "decode_scan",
                                    "numeric_scan",
                                    "fsm_scan", "fsm_starts", "initial_scan",
                                    "initial_w_scan", "anch_scan",
                                    "resolve_scan", "compact_words"}
    assert all(v == 0 for v in _build.launches.values())


def test_config_copy_matches_the_original():
    """The port's config.py: the same fields, defaults and validation."""
    fields = [(f.name, f.default) for f in
              tconfig.EngineConfig.__dataclass_fields__.values()]
    assert fields == [(f.name, f.default) for f in
                      jconfig.EngineConfig.__dataclass_fields__.values()]
    assert tconfig.DEFAULT == tconfig.EngineConfig()
    assert tconfig.DEFAULT.stream_tile_px == 1 << 22
    assert tconfig.DEFAULT.decode_max_iters == 12
    assert tconfig.DEFAULT.bucket_floor == 256
    for bad in (dict(engine="gpu"), dict(table_block=0),
                dict(table_block=128), dict(bucket_floor=0),
                dict(stream_tile_px=1), dict(mesh=(0, 2))):
        for mod in (tconfig, jconfig):
            with pytest.raises(ValueError):
                mod.EngineConfig(**bad).validate()
    tconfig.EngineConfig(mesh=(2, 4), engine="scan").validate()


def test_format_copy_matches_the_original():
    """The port's format.py: the same constants, hash, and header
    pack/unpack (and the same rejections) on random descriptors."""
    for name in ("OP_INDEX", "OP_DIFF", "OP_LUMA", "OP_RUN", "OP_RGB",
                 "OP_RGBA", "MASK_2", "MAGIC", "HEADER_SIZE", "TRAILER_SIZE",
                 "TRAILER", "RUN_CAP", "PIXELS_MAX", "SRGB", "LINEAR",
                 "HASH_MULTIPLIERS", "SEED_PIXEL"):
        assert getattr(tfmt, name) == getattr(jfmt, name), name
    rng = np.random.default_rng(4)
    for r, g, b, a in rng.integers(0, 256, (200, 4)):
        assert tfmt.hash_rgba(r, g, b, a) == jfmt.hash_rgba(r, g, b, a)
    for _ in range(100):
        w, h = (int(x) for x in rng.integers(1, 5000, 2))
        ch, cs = int(rng.choice([3, 4])), int(rng.integers(0, 2))
        hdr = jfmt.pack_header(jfmt.StreamDesc(w, h, ch, cs))
        assert tfmt.pack_header(tfmt.StreamDesc(w, h, ch, cs)) == hdr
        desc = tfmt.unpack_header(hdr + tfmt.TRAILER)
        assert (desc.width, desc.height, desc.channels, desc.colorspace) \
            == (w, h, ch, cs)
        assert desc.max_stream_bytes() == jfmt.unpack_header(
            hdr + jfmt.TRAILER).max_stream_bytes()
    for bad in (tfmt.StreamDesc(0, 5, 4), tfmt.StreamDesc(5, 5, 2),
                tfmt.StreamDesc(3, 133333333, 4)):
        with pytest.raises(ValueError):
            tfmt.pack_header(bad)
    with pytest.raises(ValueError, match="bad magic"):
        tfmt.unpack_header(b"qoiX" + bytes(18))


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_testimages_copy_matches_the_original(seed):
    """Every generator of the port's testimages gives the original's
    pixels."""
    for ch in (3, 4):
        pairs = [(testimages.noise(19, 7, ch, seed),
                  jtestimages.noise(19, 7, ch, seed)),
                 (testimages.flat(9, 4, ch), jtestimages.flat(9, 4, ch)),
                 (testimages.gradient(33, 5, ch),
                  jtestimages.gradient(33, 5, ch)),
                 (testimages.palette(21, 6, ch, colors=5, seed=seed),
                  jtestimages.palette(21, 6, ch, colors=5, seed=seed)),
                 (testimages.runs_with_caps(130, 2, ch),
                  jtestimages.runs_with_caps(130, 2, ch)),
                 (testimages.seed_run_start(8, 6, ch),
                  jtestimages.seed_run_start(8, 6, ch)),
                 (testimages.wraparound(12, 3, ch),
                  jtestimages.wraparound(12, 3, ch)),
                 (testimages.mixed(41, 9, ch, seed),
                  jtestimages.mixed(41, 9, ch, seed)),
                 (testimages.photo(41, 9, ch, seed),
                  jtestimages.photo(41, 9, ch, seed)),
                 (testimages.palette_collide(30, 7, ch, seed=seed),
                  jtestimages.palette_collide(30, 7, ch, seed=seed))]
        for (name, a), b in zip(sorted(testimages.edge_case_suite(ch)
                                       .items()),
                                sorted(jtestimages.edge_case_suite(ch)
                                       .items())):
            assert name == b[0]
            pairs.append((a, b[1]))
        for a, b in pairs:
            assert a.dtype == b.dtype and np.array_equal(a, b)
    for a, b in ((testimages.alpha_toggle(15, 4, seed),
                  jtestimages.alpha_toggle(15, 4, seed)),
                 (testimages.palette_alpha(15, 4, seed=seed),
                  jtestimages.palette_alpha(15, 4, seed=seed))):
        assert np.array_equal(a, b)
    assert [n for n, _ in testimages.bench_suite()] == \
        [n for n, _ in jtestimages.bench_suite()]


def test_oracle_copy_matches_the_original():
    """The port's oracle binds the same cpp/ library: equal bytes and
    pixels."""
    if not (toracle.available() and joracle.available()):
        pytest.skip("the C++ oracle (cpp/, make) is not built")
    img = testimages.mixed(37, 11, 4, seed=2)
    desc = tfmt.StreamDesc(37, 11, 4)
    stream = toracle.encode(img, desc)
    assert stream == joracle.encode(img, jfmt.StreamDesc(37, 11, 4))
    for ch in (0, 3, 4):
        px, d = toracle.decode(stream, ch)
        jpx, jd = joracle.decode(stream, ch)
        assert np.array_equal(px, jpx)
        assert (d.width, d.height, d.channels) == \
            (jd.width, jd.height, jd.channels)


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
