"""qoi_tpu_torch's streamed encode and decode on the CPU (the kernels'
plain twins), against the C++ oracle, the source pixels and, at one tiny
size, the JAX package's streamed encode. Exact equality everywhere."""
import numpy as np
import pytest
import torch

import qoi_tpu_torch
from qoi_tpu import format as jfmt
from qoi_tpu.models import streamed as jstreamed
from qoi_tpu.utils import testimages
from qoi_tpu_torch import format as fmt
from qoi_tpu_torch import oracle
from qoi_tpu_torch.config import EngineConfig
from qoi_tpu_torch.kernels import _build
from qoi_tpu_torch.models import streamed
from torch_testutil import oracle_built

pytestmark = pytest.mark.usefixtures("oracle_built")

CPU = torch.device("cpu")


def _desc(img):
    h, w, ch = img.shape
    return fmt.StreamDesc(w, h, ch)


def _check_encode(img, tile_px):
    assert streamed.encode(img, _desc(img), CPU, tile_px=tile_px) \
        == oracle.encode(img, _desc(img))


@pytest.mark.parametrize("tile_px", [256, 1024])
def test_streamed_encode_mixed(tile_px):
    _check_encode(testimages.mixed(100, 40, 4), tile_px)


@pytest.mark.parametrize("case", ["run_across_tiles", "run_cap_aligned",
                                  "table_reuse", "odd_rgb", "noise_ragged",
                                  "single_tile"])
def test_streamed_encode_carries(case):
    img, tile = {
        # one 2560-px run over 10 tiles
        "run_across_tiles": (testimages.flat(64, 40, 4), 256),
        # tiles end on run-cap flushes
        "run_cap_aligned": (testimages.flat(62 * 4, 2, 4), 62 * 4),
        "table_reuse": (testimages.palette(128, 20, 4, colors=7, seed=9),
                        256),
        "odd_rgb": (testimages.gradient(97, 13, 3), 256),
        "noise_ragged": (testimages.noise(301, 3, 4, seed=4), 512),
        "single_tile": (testimages.mixed(50, 20, 3), 1 << 22),
    }[case]
    _check_encode(img, tile)


def test_streamed_encode_matches_jax_streamed():
    img = testimages.mixed(60, 30, 4, seed=2)
    jdesc = jfmt.StreamDesc(60, 30, 4)
    assert streamed.encode(img, _desc(img), CPU, tile_px=512) \
        == jstreamed.encode(img, jdesc, tile_px=512)


def test_streamed_encode_capacity_at_format_max():
    """The device buffer holds the true worst case, 5 B/px, at the
    largest legal image (400 Mpx, qoi.h:329-332), plus one tile's 6t
    staging; its offsets are Python ints, past 2^31 included."""
    n = 399974400  # 25600 x 15624, the widest-legal 400 Mpx shape
    t = 1 << 22
    cap = streamed._encode_capacity(n, t)
    assert cap == 5 * -(-n // t) * t + 6 * t
    assert cap >= 5 * n + 6 * t
    # the last tile's write starts at most at 5 B/px of the tiles before
    assert 5 * (-(-n // t) - 1) * t + 6 * t <= cap


def test_streamed_encode_producer_failure_raises(monkeypatch):
    """A failure while filling a tile raises in the caller at once (no
    producer thread to wait on)."""
    orig = streamed._fill_tile

    def failing(host, flat, k, t):
        if k == 2:
            raise RuntimeError("tile source failed")
        orig(host, flat, k, t)

    monkeypatch.setattr(streamed, "_fill_tile", failing)
    img = testimages.mixed(64, 40, 4)
    with pytest.raises(RuntimeError, match="tile source failed"):
        streamed.encode(img, _desc(img), CPU, tile_px=256)


def _check_decode(img, tile_bytes, channels=0, max_rounds=12):
    stream = oracle.encode(img, _desc(img))
    got, desc = streamed.decode(stream, channels, CPU,
                                tile_bytes=tile_bytes, max_rounds=max_rounds)
    want, _ = oracle.decode(stream, channels)
    assert desc == _desc(img)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("tile_bytes", [1024, 2048])
def test_streamed_decode_multi_tile(tile_bytes):
    _check_decode(testimages.photo(120, 80, 4, seed=7), tile_bytes)


@pytest.mark.parametrize("case", ["rgb", "runs_cross_tiles", "table_reuse"])
def test_streamed_decode_carries(case):
    img, tile = {"rgb": (testimages.mixed(100, 60, 3, seed=5), 2048),
                 # one tile emits far more pixels than bytes
                 "runs_cross_tiles": (testimages.flat(500, 40, 4), 1024),
                 "table_reuse": (testimages.palette(128, 60, 4, colors=7,
                                                    seed=9), 1024)}[case]
    _check_decode(img, tile)


def test_streamed_decode_channel_forcing():
    _check_decode(testimages.photo(80, 50, 4), 2048, channels=3)
    _check_decode(testimages.mixed(80, 50, 3), 2048, channels=4)


def test_streamed_decode_truncated_stream():
    stream = oracle.encode(testimages.photo(100, 60, 4),
                           fmt.StreamDesc(100, 60, 4))
    trunc = stream[: len(stream) // 2]
    np.testing.assert_array_equal(
        streamed.decode(trunc, 0, CPU, tile_bytes=2048)[0],
        oracle.decode(trunc)[0])


def test_streamed_decode_repairs_non_canonical_tiles():
    """max_rounds=1 leaves alpha-varying tiles unconverged: from the first
    one on, the host loop decodes each tile by the fixpoint or, failing
    that, by the sequential scan, chaining the entry state exactly."""
    _check_decode(testimages.mixed(110, 70, 4, seed=2), 2048, max_rounds=1)


def test_streamed_decode_adversarial_takes_the_scan(monkeypatch):
    calls = []
    orig = streamed.scan_codec._decode_scan

    def spy(*args):
        calls.append(args[1])
        return orig(*args)

    monkeypatch.setattr(streamed.scan_codec, "_decode_scan", spy)
    w, h = 64, 64
    data = fmt.pack_header(fmt.StreamDesc(w, h, 4)) + b"\x05" * (w * h) \
        + fmt.TRAILER
    got, _ = streamed.decode(data, 0, CPU, tile_bytes=1024)
    np.testing.assert_array_equal(got, oracle.decode(data)[0])
    assert len(calls) >= 4


@pytest.mark.parametrize("claim", ["more_pixels", "fewer_pixels"])
def test_streamed_decode_header_inconsistent_with_bytes(claim):
    """A header whose pixel count disagrees with the chunks: more pixels
    repeat the last one (truncation), fewer drop the rest."""
    img = testimages.mixed(64, 40, 4, seed=3)
    body = oracle.encode(img, _desc(img))[fmt.HEADER_SIZE:]
    h = 60 if claim == "more_pixels" else 20
    data = fmt.pack_header(fmt.StreamDesc(64, h, 4)) + body
    np.testing.assert_array_equal(
        streamed.decode(data, 0, CPU, tile_bytes=1024)[0],
        oracle.decode(data)[0])


def test_streamed_decode_walks_each_tile_once(monkeypatch):
    """A tile that does not converge runs its fixpoint once, then the scan
    over that tile's own pixels: the scans' pixel counts add up to the
    image, and there is one fixpoint a tile."""
    cores, scans = [], []
    orig_core = streamed.decode_v3._decode_core
    orig_scan = streamed.scan_codec._decode_scan

    def core_spy(*args):
        cores.append(args[1])
        return orig_core(*args)

    def scan_spy(*args):
        scans.append(args[1])
        return orig_scan(*args)

    monkeypatch.setattr(streamed.decode_v3, "_decode_core", core_spy)
    monkeypatch.setattr(streamed.scan_codec, "_decode_scan", scan_spy)
    w, h = 64, 64
    data = fmt.pack_header(fmt.StreamDesc(w, h, 4)) + b"\x05" * (w * h) \
        + fmt.TRAILER
    got, _ = streamed.decode(data, 0, CPU, tile_bytes=1024)
    np.testing.assert_array_equal(got, oracle.decode(data)[0])
    # one byte a pixel: each tile's pixels are its consumed bytes
    assert scans == cores and sum(scans) == w * h


def test_pack65_round_trips():
    rng = np.random.default_rng(3)
    e65 = torch.from_numpy(rng.integers(0, 1 << 32, 65, dtype=np.uint64)
                           .astype(np.int64))
    px, table = streamed._unpack65(e65)
    assert px.dtype == torch.uint8 and table.shape == (64, 4)
    packed = e65.numpy().astype(np.uint32)
    np.testing.assert_array_equal(
        px.numpy(), packed[:1].view(np.uint8))
    np.testing.assert_array_equal(
        table.numpy(), packed[1:].view(np.uint8).reshape(64, 4))
    assert torch.equal(streamed._pack65(px, table), e65)


@pytest.mark.parametrize("direction", ["encode", "decode"])
def test_facade_routes_large_images_to_streamed(monkeypatch, direction):
    """Above STREAM_THRESHOLD_PX the facade streams tile by tile, with the
    config's tile size."""
    img = testimages.photo(120, 80, 4, seed=13)
    stream = oracle.encode(img, _desc(img))
    seen = []
    orig_enc, orig_dec = streamed.encode, streamed.decode
    monkeypatch.setattr(streamed, "encode",
                        lambda *a, **k: seen.append(k) or orig_enc(*a, **k))
    monkeypatch.setattr(streamed, "decode",
                        lambda *a, **k: seen.append(k) or orig_dec(*a, **k))
    monkeypatch.setattr(qoi_tpu_torch, "STREAM_THRESHOLD_PX", 1000)
    cfg = EngineConfig(stream_tile_px=1024)
    _build.reset_launches()
    if direction == "encode":
        assert qoi_tpu_torch.encode(img, device="cpu", config=cfg) == stream
    else:
        out, _ = qoi_tpu_torch.decode(stream, device="cpu", config=cfg)
        np.testing.assert_array_equal(out, img)
    assert seen == [{"config": cfg}]
    assert _build._lib is None or sum(_build.launches.values()) == 0


def test_facade_still_refuses_images_past_the_format_cap():
    with pytest.raises(ValueError):
        qoi_tpu_torch.encode(np.zeros((1, 1, 4), np.uint8),
                             fmt.StreamDesc(3, 133333333, 4), device="cpu")
    hdr = b"qoif" + (25600).to_bytes(4, "big") + (15625).to_bytes(4, "big")
    with pytest.raises(ValueError):
        qoi_tpu_torch.decode(hdr + bytes([4, 0]) + fmt.TRAILER, device="cpu")


@pytest.mark.parametrize("field", [dict(engine="scan"), dict(engine="oracle"),
                                   dict(verify=True), dict(table_block=32),
                                   dict(mesh=(1, 1))])
def test_facade_refuses_unported_config_fields(field):
    """The facade ignores no EngineConfig field: mesh routes to the
    sequence-parallel codec, which refuses to run outside a process group
    (in one it runs, tests/test_torch_tiled_encode.py), and the scan and
    oracle engines, verify (checked by io.write/read) and table_block
    (no effect on the sort-based table) give the oracle's bytes and the
    source pixels."""
    img = testimages.mixed(16, 8, 4)
    cfg = EngineConfig(**field)
    stream = oracle.encode(img, _desc(img))
    if "mesh" in field:
        with pytest.raises(RuntimeError, match="process group"):
            qoi_tpu_torch.encode(img, device="cpu", config=cfg)
        with pytest.raises(RuntimeError, match="process group"):
            qoi_tpu_torch.decode(stream, device="cpu", config=cfg)
        return
    assert qoi_tpu_torch.encode(img, device="cpu", config=cfg) == stream
    out, _ = qoi_tpu_torch.decode(stream, device="cpu", config=cfg)
    np.testing.assert_array_equal(out, img)
