"""qoi_tpu_torch.corpus on the CPU against qoi_tpu.corpus: the counters of
a job, sharding, checkpoint/resume (a checkpoint written by either
package resumes in the other), and the counters' all_reduce across two
gloo processes through `corpus.main(--coordinator ...)`."""
import json
import pathlib
import socket
import subprocess
import sys
import textwrap

import pytest

from qoi_tpu import corpus as jcorpus
from qoi_tpu_torch import corpus
from qoi_tpu_torch import io as tio
from qoi_tpu_torch import oracle
from qoi_tpu_torch.utils import testimages

REPO = pathlib.Path(__file__).resolve().parent.parent
CPU = "cpu"
QUIET = dict(progress=lambda m: None)
#: every field but the two timers
EXACT = ("images", "pixels", "raw_bytes", "qoi_bytes", "verify_failures")


@pytest.fixture()
def small_corpus(tmp_path):
    """Four PNGs (one nested) and one .qoi stream."""
    root = tmp_path / "corpus"
    (root / "sub").mkdir(parents=True)
    imgs = [
        testimages.noise(20, 12, 4, seed=1),
        testimages.gradient(24, 16, 3),
        testimages.palette(16, 16, 4, seed=2),
        testimages.mixed(18, 14, 3),
    ]
    for i, im in enumerate(imgs):
        tio.save_png(root / ("sub" if i == 3 else ".") / f"img{i}.png", im)
    q = testimages.mixed(21, 11, 4, seed=7)
    (root / "z.qoi").write_bytes(oracle.encode(q, tio.image_desc(q)))
    return root, imgs + [q]


def _exact(c):
    return {k: getattr(c, k) for k in EXACT}


def test_job_counters_match_jax(small_corpus):
    root, imgs = small_corpus
    c = corpus.run_job(root, "roundtrip", oracle_verify=True, device=CPU,
                       **QUIET)
    assert c.images == len(imgs) and c.verify_failures == 0
    assert c.pixels == sum(im.shape[0] * im.shape[1] for im in imgs)
    assert c.raw_bytes == sum(im.size for im in imgs)
    assert c.qoi_bytes == sum(len(oracle.encode(im, tio.image_desc(im)))
                              for im in imgs)
    s = c.summary()
    assert s["encode_mpps"] > 0 and s["decode_mpps"] > 0
    j = jcorpus.run_job(root, "roundtrip", oracle_verify=True, **QUIET)
    assert _exact(c) == _exact(j)
    assert set(c.to_json()) == set(j.to_json())


def test_job_counts_failures(small_corpus, monkeypatch):
    """A wrong stream counts as an oracle mismatch and, decoded to other
    pixels, as a failed roundtrip."""
    import qoi_tpu_torch

    root, imgs = small_corpus
    real = qoi_tpu_torch.encode
    monkeypatch.setattr(qoi_tpu_torch, "encode",
                        lambda px, d, **k: real(px ^ 1, d, **k))
    msgs = []
    c = corpus.run_job(root, "roundtrip", oracle_verify=True, device=CPU,
                       progress=msgs.append)
    assert c.verify_failures == 2 * len(imgs)
    assert sum(m.startswith("ORACLE ENCODE MISMATCH") for m in msgs) == \
        len(imgs)


def test_sharding_partitions_files(small_corpus):
    root, imgs = small_corpus
    files = [corpus.shard_files(root, s, 2) for s in (0, 1)]
    assert sorted(files[0] + files[1]) == sorted(
        corpus.shard_files(root, 0, 1))
    assert files == [jcorpus.shard_files(root, s, 2) for s in (0, 1)]
    c = [corpus.run_job(root, "encode", shard=s, num_shards=2, device=CPU,
                        **QUIET) for s in (0, 1)]
    assert (c[0].images, c[1].images) == (3, 2)
    assert c[0].pixels + c[1].pixels == sum(im.shape[0] * im.shape[1]
                                            for im in imgs)
    assert c[0].decode_ns == 0


class Crash(Exception):
    pass


def _crash_at(k):
    def progress(msg):
        if msg.startswith(f"checkpoint @ {k}/"):
            raise Crash
    return progress


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_checkpoint_resume(small_corpus, tmp_path, writer):
    """A job stopped after its 2nd image resumes from the checkpoint, in
    the port, whichever package wrote it; the totals equal an
    uninterrupted job's."""
    root, imgs = small_corpus
    ck = tmp_path / "job.json"
    with pytest.raises(Crash):
        if writer == "port":
            corpus.run_job(root, "roundtrip", checkpoint_path=ck,
                           checkpoint_every=1, progress=_crash_at(2),
                           device=CPU)
        else:
            jcorpus.run_job(root, "roundtrip", checkpoint_path=ck,
                            checkpoint_every=1, progress=_crash_at(2))
    saved = json.loads(ck.read_text())
    assert saved["cursor"] == 2
    assert set(saved) == {"cursor", "counters", "shard", "num_shards"}
    resumed = corpus.run_job(root, "roundtrip", checkpoint_path=ck,
                             device=CPU, **QUIET)
    full = corpus.run_job(root, "roundtrip", device=CPU, **QUIET)
    assert _exact(resumed) == _exact(full)
    assert json.loads(ck.read_text())["cursor"] == len(imgs)


def test_port_checkpoint_resumes_in_jax(small_corpus, tmp_path):
    root, imgs = small_corpus
    ck = tmp_path / "job.json"
    with pytest.raises(Crash):
        corpus.run_job(root, "encode", checkpoint_path=ck,
                       checkpoint_every=1, progress=_crash_at(3), device=CPU)
    resumed = jcorpus.run_job(root, "encode", checkpoint_path=ck, **QUIET)
    assert resumed.images == len(imgs)
    assert _exact(resumed) == _exact(
        corpus.run_job(root, "encode", device=CPU, **QUIET))


def test_checkpoint_shard_mismatch_rejected(small_corpus, tmp_path):
    root, _ = small_corpus
    ck = tmp_path / "job.json"
    corpus.run_job(root, "encode", checkpoint_path=ck, shard=0, num_shards=2,
                   device=CPU, **QUIET)
    with pytest.raises(ValueError, match="checkpoint is for shard 0/2"):
        corpus.run_job(root, "encode", checkpoint_path=ck, shard=1,
                       num_shards=2, device=CPU, **QUIET)


def test_main_single_process(small_corpus, capsys):
    root, imgs = small_corpus
    assert corpus.main([str(root), "--oracle-verify", "--device", CPU]) == 0
    s = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert s["images"] == len(imgs) and s["verify_failures"] == 0
    assert corpus.allreduce_counters(corpus.Counters(images=3)).images == 3
    with pytest.raises(SystemExit):
        corpus.main([str(root), "--coordinator", "localhost:1"])


_RANK_SCRIPT = textwrap.dedent("""
    import json, sys
    sys.path.insert(0, {repo!r})
    from qoi_tpu_torch import corpus

    coordinator, pid, mode = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    if mode == "main":
        sys.exit(corpus.main([{root!r}, "--coordinator", coordinator,
                              "--num-processes", "2", "--process-id",
                              str(pid), "--oracle-verify", "--device",
                              "cpu"]))
    import torch.distributed as dist
    corpus.init_distributed(coordinator, 2, pid)
    big = corpus.Counters(images=1, pixels=(1 << 40) + pid,
                          raw_bytes=(1 << 62) // 4, qoi_bytes=7 + pid,
                          encode_ns=float(3 << 33), decode_ns=5.0,
                          verify_failures=pid)
    print(json.dumps(corpus.allreduce_counters(big).to_json()))
    dist.destroy_process_group()
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _two_processes(tmp_path, root, mode):
    """Run the rank script as ranks 0 and 1; returns their stdouts."""
    script = tmp_path / "rank.py"
    script.write_text(_RANK_SCRIPT.format(repo=str(REPO), root=str(root)))
    coordinator = f"127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, str(script), coordinator, str(pid), mode],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for pid in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, f"rc={p.returncode}\n{err[-2000:]}"
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def test_two_process_corpus_main(small_corpus, tmp_path):
    """corpus.main with --coordinator on two gloo processes: each rank
    takes its shard and both print the whole corpus's totals."""
    root, imgs = small_corpus
    outs = _two_processes(tmp_path, root, "main")
    n_px = sum(im.shape[0] * im.shape[1] for im in imgs)
    for out in outs:
        s = json.loads(out.strip().splitlines()[-1])
        assert s["images"] == len(imgs) and s["verify_failures"] == 0
        assert s["mpixels"] == pytest.approx(n_px / 1e6)


def test_two_process_allreduce_is_exact(tmp_path):
    """Counters past 2^32 (and an int64 near its top) sum exactly."""
    outs = _two_processes(tmp_path, tmp_path, "allreduce")
    want = dict(images=2, pixels=(2 << 40) + 1, raw_bytes=(1 << 62) // 2,
                qoi_bytes=15, encode_ns=float(6 << 33), decode_ns=10.0,
                verify_failures=1)
    for out in outs:
        assert json.loads(out.strip().splitlines()[-1]) == want
