"""qoi_tpu_torch.models.batch on the CPU against the C++ oracle and the JAX
package's qoi_tpu.models.batch: mixed shapes and channels, per-stream
failure isolation, a non-canonical stream inside a group, channel
forcing and sub-groups under the device-memory budget. Equality is exact:
equal bytes and equal pixels."""
import numpy as np
import pytest

from qoi_tpu.models import batch as jbatch
from qoi_tpu_torch import format as fmt
from qoi_tpu_torch import oracle
from qoi_tpu_torch.models import batch, decode_pipeline, decode_v3
from qoi_tpu_torch.utils import testimages

CPU = "cpu"


def _desc(img):
    h, w, ch = img.shape
    return fmt.StreamDesc(w, h, ch)


def _bucket(stream):
    """The (byte, pixel) bucket a stream groups by."""
    return (decode_pipeline.bucket_size_fine(len(stream) - fmt.HEADER_SIZE),
            decode_pipeline.bucket_size(fmt.unpack_header(stream).num_pixels))


def _mixed_images():
    """The five mixed-shape images of tests/test_batch.py."""
    return [
        testimages.noise(17, 13, 4, seed=1),
        testimages.gradient(64, 32, 3),
        testimages.flat(62, 1, 4),
        testimages.palette(33, 21, 4, seed=2),
        testimages.mixed(40, 40, 3),
    ]


def _one_group_images():
    """Four images whose streams share one (byte, pixel) bucket, so the
    JAX batch decode compiles one program."""
    return [
        testimages.noise(8, 8, 4, seed=1),
        testimages.mixed(16, 9, 3, seed=2),
        testimages.palette(20, 12, 4, seed=2),
        testimages.mixed(14, 14, 4, seed=4),
    ]


def _noncanonical():
    """INDEX reads of never-written slots: the device fixpoint cannot
    certify it, so it takes the certified fallback (v1)."""
    body = bytes([fmt.OP_INDEX | 5, fmt.OP_INDEX | 0, fmt.OP_RGB, 9, 9, 9,
                  fmt.OP_RUN | 2] + [fmt.OP_RGBA, 1, 2, 3, 77] * 19)
    return fmt.pack_header(fmt.StreamDesc(9, 7, 4)) + body + fmt.TRAILER


def test_encode_batch_matches_oracle():
    imgs = _mixed_images()
    streams = batch.encode_batch(imgs, device=CPU)
    for img, s in zip(imgs, streams):
        assert s == oracle.encode(img, _desc(img))


def test_encode_batch_takes_explicit_descs():
    img = testimages.mixed(21, 5, 4, seed=9)
    desc = fmt.StreamDesc(21, 5, 4, fmt.LINEAR)
    (s,) = batch.encode_batch([img.reshape(-1, 4)], [desc], device=CPU)
    assert s == oracle.encode(img, desc)


def test_decode_batch_roundtrip():
    imgs = _mixed_images()
    streams = [oracle.encode(im, _desc(im)) for im in imgs]
    for img, (out, desc, err) in zip(imgs, batch.decode_batch(streams,
                                                              device=CPU)):
        assert err is None
        assert (desc.width, desc.height, desc.channels) == \
            (img.shape[1], img.shape[0], img.shape[2])
        np.testing.assert_array_equal(out, img)


def test_decode_batch_isolates_bad_streams():
    good = testimages.gradient(20, 10, 4)
    stream = oracle.encode(good, _desc(good))
    bad = b"nope" + stream[4:]
    results = batch.decode_batch([stream, bad, b"short", stream], device=CPU)
    assert results[0][2] is None and results[3][2] is None
    np.testing.assert_array_equal(results[0][0], good)
    np.testing.assert_array_equal(results[3][0], good)
    assert results[1][:2] == (None, None) and "magic" in results[1][2]
    assert results[2][:2] == (None, None) and "short" in results[2][2]


def _watch(monkeypatch, module):
    """Record the streams `module.decode` is called with."""
    seen = []
    orig = module.decode
    monkeypatch.setattr(module, "decode",
                        lambda data, *a: seen.append(data) or orig(data, *a))
    return seen


def test_decode_batch_noncanonical_in_group(monkeypatch):
    """A non-canonical stream rides in a group next to canonical ones of
    the same buckets and alone goes to the v1 decoder, as in the JAX
    batch; everything matches the oracle."""
    good = testimages.gradient(16, 4, 4)
    s1 = oracle.encode(good, _desc(good))
    s2 = _noncanonical()
    assert len({_bucket(s) for s in (s1, s2)}) == 1
    seen = _watch(monkeypatch, decode_pipeline)
    results = batch.decode_batch([s1, s2, s1], device=CPU)
    assert seen == [s2]
    for (out, desc, err), stream in zip(results, [s1, s2, s1]):
        assert err is None
        want, _ = oracle.decode(stream)
        np.testing.assert_array_equal(out, want)


def test_decode_batch_unconverged_v1_goes_to_the_scan(monkeypatch):
    """A stream on which v1 does not converge either (capped at one
    iteration here) goes on to the sequential decoder, exact."""
    from qoi_tpu_torch.models import scan_codec

    s = _noncanonical()
    monkeypatch.setattr(decode_pipeline, "_MAX_FIXPOINT_ITERS", 1)
    seen_v1 = _watch(monkeypatch, decode_pipeline)
    seen_scan = _watch(monkeypatch, scan_codec)
    (out, _, err), = batch.decode_batch([s], device=CPU)
    assert err is None and seen_v1 == [s] and seen_scan == [s]
    np.testing.assert_array_equal(out, oracle.decode(s)[0])


@pytest.mark.parametrize("channels", [3, 4])
def test_decode_batch_channel_forcing(channels):
    imgs = [testimages.mixed(30, 20, 4), testimages.gradient(30, 20, 3)]
    streams = [oracle.encode(im, _desc(im)) for im in imgs]
    for (out, desc, err), s in zip(
            batch.decode_batch(streams + [_noncanonical()], channels=channels,
                               device=CPU), streams + [_noncanonical()]):
        assert err is None
        np.testing.assert_array_equal(out, oracle.decode(s, channels)[0])


def test_decode_batch_rejects_bad_channels():
    with pytest.raises(ValueError):
        batch.decode_batch([], channels=2, device=CPU)


def test_groups_cut_under_the_budget(monkeypatch):
    """A budget below one row's bytes runs every row as its own
    sub-group, with the same bytes and pixels."""
    imgs = _mixed_images() + [testimages.noise(17, 13, 4, seed=2)]
    want = [oracle.encode(im, _desc(im)) for im in imgs]
    assert batch._sub_groups([1, 2, 3], 1 << 20) == [[1, 2, 3]]
    monkeypatch.setattr(batch, "GROUP_BUDGET_BYTES", 2048 * 3)
    assert batch._sub_groups([1, 2, 3, 4], 2048) == [[1, 2, 3], [4]]
    monkeypatch.setattr(batch, "GROUP_BUDGET_BYTES", 1)
    assert batch._sub_groups([1, 2], 2048) == [[1], [2]]
    assert batch.encode_batch(imgs, device=CPU) == want
    for img, (out, _, err) in zip(imgs, batch.decode_batch(want,
                                                           device=CPU)):
        assert err is None
        np.testing.assert_array_equal(out, img)


def test_batch_matches_the_jax_batch():
    """One small batch through both packages: equal streams, and equal
    per-stream results of the decode (pixels, descriptor fields, the
    error's presence) with a bad stream and channel forcing."""
    from qoi_tpu import format as jfmt

    imgs = _one_group_images()
    streams = batch.encode_batch(imgs, device=CPU)
    jdescs = [jfmt.StreamDesc(im.shape[1], im.shape[0], im.shape[2])
              for im in imgs]
    assert streams == jbatch.encode_batch(imgs, jdescs)
    assert len({_bucket(s) for s in streams}) == 1  # one JAX program
    batch_in = streams + [b"nope" + streams[0][4:]]
    for channels in (0, 3):
        got = batch.decode_batch(batch_in, channels, device=CPU)
        want = jbatch.decode_batch(batch_in, channels)
        for (g, gd, ge), (w, wd, we) in zip(got, want):
            assert (ge is None) == (we is None)
            if we is None:
                np.testing.assert_array_equal(g, w)
                assert (gd.width, gd.height, gd.channels) == \
                    (wd.width, wd.height, wd.channels)
