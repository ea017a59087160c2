"""qoi_tpu_torch's user surfaces on the CPU against the JAX package and the
C++ oracle: the facade's engine resolution, io.write/read and the PNG
bridge, the converter CLI, the qoibench-style harness and the profiling
helpers. Equality is exact: equal bytes and equal pixels."""
import json

import numpy as np
import pytest

import qoi_tpu_torch
from qoi_tpu import cli as jcli
from qoi_tpu import io as jio
from qoi_tpu.utils import profiling as jprofiling
from qoi_tpu_torch import bench, cli
from qoi_tpu_torch import io as tio
from qoi_tpu_torch import oracle
from qoi_tpu_torch.config import EngineConfig
from qoi_tpu_torch.utils import profiling, testimages

CPU = "cpu"
ENGINES = ["tpu", "scan", "oracle"]

#: one image shape for every JAX call of this file (one compile each)
W, H = 40, 24


def _img(ch=4, seed=5):
    return testimages.mixed(W, H, ch, seed=seed)


def _jdesc(img):
    from qoi_tpu import format as jfmt

    h, w, ch = img.shape
    return jfmt.StreamDesc(w, h, ch)


@pytest.mark.parametrize("engine", ENGINES)
def test_write_read_match_jax_and_oracle(tmp_path, engine):
    img = _img()
    desc = tio.image_desc(img)
    want = oracle.encode(img, desc)
    n = tio.write(tmp_path / "t.qoi", img, desc, engine=engine, device=CPU)
    jio.write(tmp_path / "j.qoi", img, _jdesc(img), engine=engine)
    assert n == len(want)
    assert (tmp_path / "t.qoi").read_bytes() == want
    assert (tmp_path / "j.qoi").read_bytes() == want
    for channels in (0, 3):
        back, d = tio.read(tmp_path / "t.qoi", channels, engine=engine,
                           device=CPU)
        jback, _ = jio.read(tmp_path / "t.qoi", channels, engine=engine)
        np.testing.assert_array_equal(back, jback)
        np.testing.assert_array_equal(back, oracle.decode(want, channels)[0])
        assert (d.width, d.height, d.channels) == (W, H, 4)


@pytest.mark.parametrize("engine", ENGINES)
def test_facade_engine_names_and_configs(engine):
    """A name, an EngineConfig as `engine`, and a name over `config=` all
    resolve to the same codec, equal to the oracle."""
    img = _img(3, seed=6)
    want = oracle.encode(img, tio.image_desc(img))
    for kw in (dict(engine=engine), dict(engine=EngineConfig(engine=engine)),
               dict(engine=engine, config=EngineConfig(decode_max_iters=5)),
               dict(config=EngineConfig(engine=engine))):
        assert qoi_tpu_torch.encode(img, device=CPU, **kw) == want, kw
        back, desc = qoi_tpu_torch.decode(want, device=CPU, **kw)
        np.testing.assert_array_equal(back, img)
        assert desc.channels == 3


def test_engine_resolution():
    c = EngineConfig(engine="scan", verify=True)
    assert tio._as_config("oracle") == EngineConfig(engine="oracle")
    assert tio._as_config(c) is c
    assert tio._as_config("tpu", c) is c
    assert tio._as_config("scan", c) is c
    assert tio._as_config("oracle", EngineConfig(verify=True)) == \
        EngineConfig(engine="oracle", verify=True)
    with pytest.raises(ValueError, match="not both"):
        tio._as_config(c, EngineConfig())
    with pytest.raises(ValueError, match="disagree"):
        tio._as_config("oracle", c)
    with pytest.raises(ValueError, match="unknown engine"):
        tio._as_config("gpu")
    with pytest.raises(ValueError, match="not both"):
        qoi_tpu_torch.encode(_img(), engine=c, config=c, device=CPU)


def test_scan_engine_runs_the_sequential_codec(monkeypatch):
    """engine="scan" resolves to models/scan_codec on the device asked."""
    from qoi_tpu_torch.models import scan_codec

    seen = []
    enc, dec = scan_codec.encode, scan_codec.decode
    monkeypatch.setattr(scan_codec, "encode",
                        lambda *a: seen.append("enc") or enc(*a))
    monkeypatch.setattr(scan_codec, "decode",
                        lambda *a: seen.append("dec") or dec(*a))
    img = _img()
    stream = qoi_tpu_torch.encode(img, engine="scan", device=CPU)
    qoi_tpu_torch.decode(stream, engine="scan", device=CPU)
    assert seen == ["enc", "dec"]


def test_table_block_has_no_effect():
    """table_block is the JAX brute-force table's width; the port's
    sort-based table gives the oracle's bytes at any width."""
    img = testimages.mixed(56, 40, 4, seed=5)
    want = oracle.encode(img, tio.image_desc(img))
    for tb in (1, 32, 127):
        cfg = EngineConfig(table_block=tb)
        assert qoi_tpu_torch.encode(img, device=CPU, config=cfg) == want


def test_mesh_is_refused(tmp_path):
    """Outside a process group of mesh[0]*mesh[1] ranks a mesh config is
    refused; inside one it runs the sequence-parallel codec
    (tests/test_torch_tiled_encode.py)."""
    img = _img()
    cfg = EngineConfig(mesh=(1, 2))
    with pytest.raises(RuntimeError, match="process group"):
        tio.write(tmp_path / "m.qoi", img, tio.image_desc(img), engine=cfg,
                  device=CPU)
    with pytest.raises(RuntimeError, match="process group"):
        qoi_tpu_torch.encode(img, engine=cfg, device=CPU)
    assert not (tmp_path / "m.qoi").exists()


def test_png_roundtrip(tmp_path):
    img = testimages.gradient(33, 21, 3)
    tio.save_png(tmp_path / "x.png", img)
    np.testing.assert_array_equal(tio.load_png(tmp_path / "x.png"), img)
    np.testing.assert_array_equal(jio.load_png(tmp_path / "x.png"), img)
    jio.save_png(tmp_path / "y.png", img)
    assert (tmp_path / "x.png").read_bytes() == \
        (tmp_path / "y.png").read_bytes()


def test_load_png_forces_non_rgb_to_rgba(tmp_path):
    from PIL import Image

    gray = np.arange(35, dtype=np.uint8).reshape(5, 7)
    Image.fromarray(gray, "L").save(tmp_path / "g.png")
    got = tio.load_png(tmp_path / "g.png")
    assert got.shape == (5, 7, 4)
    np.testing.assert_array_equal(got, jio.load_png(tmp_path / "g.png"))


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("ch", [3, 4])
def test_cli_png_to_qoi_to_png_and_qoi_to_qoi(tmp_path, engine, ch):
    """PNG -> QOI -> PNG and QOI -> QOI, verified: the same files as the
    JAX CLI's and the oracle's bytes."""
    img = _img(ch)
    src = tmp_path / "a.png"
    tio.save_png(src, img)
    want = oracle.encode(img, tio.image_desc(img))
    common = ["--verify", "--engine", engine]
    assert cli.main([str(src), str(tmp_path / "t.qoi"), *common,
                     "--device", CPU]) == 0
    assert jcli.main([str(src), str(tmp_path / "j.qoi"), *common]) == 0
    assert (tmp_path / "t.qoi").read_bytes() == want
    assert (tmp_path / "j.qoi").read_bytes() == want
    assert cli.main([str(tmp_path / "t.qoi"), str(tmp_path / "t.png"),
                     *common, "--device", CPU]) == 0
    np.testing.assert_array_equal(tio.load_png(tmp_path / "t.png"), img)
    assert cli.main([str(tmp_path / "t.qoi"), str(tmp_path / "tt.qoi"),
                     *common, "--device", CPU, "--max-rounds", "3",
                     "--bucket-floor", "64"]) == 0
    assert (tmp_path / "tt.qoi").read_bytes() == want


def test_cli_rejects_unknown_suffix(tmp_path):
    for a, b in (("a.bmp", "b.qoi"), ("a.qoi", "b.jpg")):
        with pytest.raises(SystemExit):
            cli.main([str(tmp_path / a), str(tmp_path / b), "--device", CPU])


def test_verify_catches_an_encode_mismatch(tmp_path, monkeypatch, capsys):
    img = _img()
    src = tmp_path / "a.png"
    tio.save_png(src, img)
    real = oracle.encode
    monkeypatch.setattr(oracle, "encode",
                        lambda px, d: b"x" + real(px, d)[1:])
    with pytest.raises(AssertionError, match="encode mismatch"):
        tio.write(tmp_path / "v.qoi", img, tio.image_desc(img),
                  engine=EngineConfig(verify=True), device=CPU)
    assert cli.main([str(src), str(tmp_path / "b.qoi"), "--verify",
                     "--device", CPU]) == 1
    assert "VERIFY FAILED" in capsys.readouterr().err
    # without --verify, and with the oracle engine, nothing is compared
    assert cli.main([str(src), str(tmp_path / "c.qoi"), "--device",
                     CPU]) == 0
    assert cli.main([str(src), str(tmp_path / "d.qoi"), "--verify",
                     "--engine", "oracle", "--device", CPU]) == 0


def test_verify_catches_a_decode_mismatch(tmp_path, monkeypatch, capsys):
    img = _img()
    stream = oracle.encode(img, tio.image_desc(img))
    (tmp_path / "a.qoi").write_bytes(stream)
    real = oracle.decode

    def wrong(data, ch=0):
        px, d = real(data, ch)
        return px ^ 1, d

    monkeypatch.setattr(oracle, "decode", wrong)
    with pytest.raises(AssertionError, match="decode mismatch"):
        tio.read(tmp_path / "a.qoi", engine=EngineConfig(engine="scan",
                                                         verify=True),
                 device=CPU)
    assert cli.main([str(tmp_path / "a.qoi"), str(tmp_path / "b.png"),
                     "--verify", "--device", CPU]) == 1
    assert "VERIFY FAILED" in capsys.readouterr().err


def _bench_json(out):
    return json.loads([ln for ln in out.splitlines()
                       if ln.startswith("{")][-1])


def test_bench_synthetic_matches_jax(capsys):
    """The synthetic suite through both harnesses: equal sizes and rates
    of the port's row, the JAX row and the oracle's."""
    from qoi_tpu import bench as jbench

    args = ["1", "--synthetic", "small", "--onlytotals", "--nopng", "--json"]
    assert bench.main(args + ["--device", CPU]) == 0
    out = capsys.readouterr().out
    assert "Grand total for 2 images" in out and "qoi-torch" in out
    got = _bench_json(out)
    assert jbench.main(args) == 0
    want = _bench_json(capsys.readouterr().out)
    assert got["images"] == want["images"] == 2 and got["device"] == CPU
    for key in ("size_kb", "rate"):
        assert got["qoi-torch"][key] == want["qoi-tpu"][key] == \
            got["qoi-cpp"][key]
    assert set(got) == {"qoi-torch", "qoi-cpp", "images", "device"}


def test_bench_directory_with_png_row(tmp_path, capsys):
    tio.save_png(tmp_path / "one.png", testimages.noise(20, 15, 4, seed=1))
    sub = tmp_path / "sub"
    sub.mkdir()
    tio.save_png(sub / "two.png", testimages.gradient(16, 16, 3))
    assert bench.main(["1", str(tmp_path), "--device", CPU]) == 0
    out = capsys.readouterr().out
    assert "2 images" in out and "png-pil" in out and "## " in out
    assert bench.main(["1", str(tmp_path), "--onlytotals", "--nopng",
                       "--norecurse", "--noverify", "--nowarmup",
                       "--device", CPU]) == 0
    assert "1 images" in capsys.readouterr().out


def test_bench_refuses(tmp_path):
    for argv in (["1", "--scaling", "--device", CPU],
                 ["0", "--synthetic", "--device", CPU],
                 ["1", "--device", CPU],
                 ["1", str(tmp_path), "--device", CPU]):
        with pytest.raises(SystemExit):
            bench.main(argv)


def test_bench_scaling_in_a_two_rank_group():
    """bench --scaling inside a gloo group of two ranks, on a 160x96 photo
    (`bench.main(scaling_shape=)`): rank 0 prints the sweep over 1 and 2 shards
    with the JAX sweep's JSON keys, says that the ranks share one device,
    and rank 1 prints nothing."""
    import torch_parallel_tasks as tasks
    from qoi_tpu_torch.parallel.launch import RankPool

    with RankPool(2, device="cpu", timeout_s=120) as pool:
        (rc0, out0), (rc1, out1) = pool.run(
            tasks.bench_scaling, ["1", "--scaling", "--json", "--device",
                                  CPU], (160, 96))
    assert rc0 == rc1 == 0 and out1 == []
    summary = json.loads(out0[-1])
    assert set(summary) == {"encode_mpps", "encode_eff", "decode_mpps",
                            "decode_eff"}
    assert set(summary["encode_mpps"]) == {"1", "2"}
    assert summary["encode_eff"]["1"] == summary["decode_eff"]["1"] == 1.0
    assert all(v > 0 for v in summary["decode_mpps"].values())
    assert any("share one device" in line for line in out0)
    assert "160x96" in out0[0]


def test_bench_verification_gate(monkeypatch):
    """A wrong encode stops the harness before any timing."""
    real = qoi_tpu_torch.encode
    monkeypatch.setattr(qoi_tpu_torch, "encode",
                        lambda *a, **k: b"x" + real(*a, **k)[1:])
    with pytest.raises(SystemExit, match="VERIFY"):
        bench.main(["1", "--synthetic", "small", "--nopng", "--device",
                    CPU])


@pytest.mark.parametrize("n_px,ch,rate", [(1, 3, 0.45), (3840 * 2160, 4, 0.3),
                                          (10_000, 3, 1.25)])
def test_sol_models_match_jax(n_px, ch, rate):
    for name in ("encode_sol_model", "decode_sol_model"):
        got = getattr(profiling, name)(n_px, ch, rate, bw=819e9)
        assert got == getattr(jprofiling, name)(n_px, ch, rate, bw=819e9)
        at_h100 = getattr(profiling, name)(n_px, ch, rate)
        assert at_h100["sol_seconds"] == got["bytes_moved"] / 3.35e12


def test_scaling_efficiency_matches_jax():
    mpps = {1: 10.0, 2: 19.0, 4: 30.0}
    assert profiling.scaling_efficiency(mpps) == \
        jprofiling.scaling_efficiency(mpps)
    with pytest.raises(ValueError):
        profiling.scaling_efficiency({1: 0.0})


def test_trace_annotate_and_sync_time_on_cpu(tmp_path):
    with profiling.trace(tmp_path / "tr", device=CPU):
        with profiling.annotate("qoi_region"):
            qoi_tpu_torch.encode(_img(), device=CPU)
    trace = json.loads((tmp_path / "tr" / "trace.json").read_text())
    assert any(ev.get("name") == "qoi_region"
               for ev in trace["traceEvents"])
    t = profiling.device_sync_time(lambda: qoi_tpu_torch.encode(
        _img(), device=CPU), reps=2, device=CPU)
    assert 0 < t < 60
