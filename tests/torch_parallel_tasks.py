"""Functions the sequence-parallel tests run on every rank of a local gloo
group (qoi_tpu_torch.parallel.launch.RankPool). They import numpy, torch
and the port only, so a spawned rank imports no JAX. Each returns plain
numpy arrays and Python values for the test process to compare."""
import numpy as np
import torch
import torch.distributed as dist

from qoi_tpu_torch import format as fmt
from qoi_tpu_torch.parallel import dryrun, sharding, tiled, tiled_decode

CPU = "cpu"


def _mesh(data=1, seq=None):
    return sharding.make_mesh(data, seq or dist.get_world_size() // data,
                              device=CPU)


def _desc(img):
    h, w, ch = img.shape
    return fmt.StreamDesc(w, h, ch)


def encode(img):
    """The whole stream, and this rank's tile step outputs (bufs, total,
    offset): the JAX `_encode_tiled_device`'s shard."""
    ax = _mesh().seq
    stream = tiled.encode_tiled(img, _desc(img), _mesh(), device=CPU)
    tile, n = tiled.shard_pixels(img, _desc(img), ax, CPU)
    out = tiled._tile_step(tile, n, ax)
    return stream, out.buf.numpy(), out.total, out.offset


def decode(stream, channels=0, shards=False):
    """The decoded image, and with `shards` this rank's chunk-level
    outputs and pixel slice (the JAX `_decode_tiled_device` and
    `_decode_expand_device` shards)."""
    img, desc = tiled_decode.decode_tiled(stream, _mesh(), channels,
                                          device=CPU)
    if not shards:
        return img, (desc.width, desc.height, desc.channels)
    ax = _mesh().seq
    local, clen, cap = tiled_decode.shard_bytes(stream, ax, CPU)
    out = tiled_decode._tile_step(local, clen, ax)
    px32, conv = tiled_decode._decode_expand_device(local, clen, ax, cap)
    return img, dict(px=out.px.numpy(), npix=out.npix.numpy(),
                     pix_off=out.pix_off.numpy(), nloc=out.nloc,
                     conv=out.conv, px32=px32.numpy(), conv_expand=conv)


def run_dryrun(n):
    return dryrun.dryrun_multichip(n, device=CPU)


def io_roundtrip(img, mesh_shape, path):
    """io.write/read and the facade with EngineConfig(mesh=mesh_shape):
    the stream, the facade's stream and the image read back."""
    import qoi_tpu_torch
    from qoi_tpu_torch import io
    from qoi_tpu_torch.config import EngineConfig

    cfg = EngineConfig(mesh=mesh_shape)
    p = f"{path}.{dist.get_rank()}.qoi"
    io.write(p, img, _desc(img), engine=cfg, device=CPU)
    back, _ = io.read(p, engine=cfg, device=CPU)
    facade = qoi_tpu_torch.encode(img, config=cfg, device=CPU)
    with open(p, "rb") as f:
        return f.read(), facade, back


def bench_scaling(argv, shape):
    """bench.main's return code and output lines on this rank, the sweep's
    image of `shape` (the JAX sweep's 1024x512 photo is seconds a decode
    on a CPU)."""
    import contextlib
    import io

    from qoi_tpu_torch import bench

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = bench.main(argv, scaling_shape=shape)
    return rc, buf.getvalue().splitlines()


def mesh_layout(data, seq):
    """This rank's (data index, seq index, seq ranks, data ranks)."""
    m = sharding.make_mesh(data, seq, device=CPU)
    return m.data.index, m.seq.index, m.seq.ranks, m.data.ranks


def stats_after_decode(stream):
    """The mesh counters of one decode."""
    m = _mesh()
    m.stats.reset()
    tiled_decode.decode_tiled(stream, m, device=CPU)
    return m.stats.as_dict()


def collectives(n):
    """Each collective of an Axis on a small int64 tensor."""
    ax = _mesh().seq
    x = torch.arange(n * ax.size, dtype=torch.int64) + 100 * ax.index
    return (ax.all_gather(x[:n]).numpy(), ax.all_reduce(x).numpy(),
            ax.reduce_scatter(x).numpy())


def facade_groups(img, mesh_shape):
    """The process groups that each of two facade encodes with
    EngineConfig(mesh=mesh_shape) creates, and whether both see one
    mesh."""
    import qoi_tpu_torch
    from qoi_tpu_torch.config import EngineConfig

    cfg = EngineConfig(mesh=mesh_shape)
    real, made = dist.new_group, []

    def counting(*a, **k):
        made.append(1)
        return real(*a, **k)

    dist.new_group = counting
    try:
        counts, streams = [], []
        for _ in range(2):
            made.clear()
            streams.append(qoi_tpu_torch.encode(img, config=cfg, device=CPU))
            counts.append(len(made))
    finally:
        dist.new_group = real
    same = sharding.make_mesh(*mesh_shape, device=CPU) \
        is sharding.make_mesh(*mesh_shape, device=CPU)
    return counts, streams[0] == streams[1], same


def noop():
    return np.int64(dist.get_rank())


def decode_capped(stream, rounds):
    """decode_tiled with the sharded fixpoint capped at `rounds`: the
    image, the fixpoint's convergence and whether v1 was reached."""
    from qoi_tpu_torch.models import decode_pipeline

    ax = _mesh().seq
    local, clen, cap = tiled_decode.shard_bytes(stream, ax, CPU)
    reached, real_v1 = [], decode_pipeline.decode
    saved = tiled_decode._MAX_ITERS
    tiled_decode._MAX_ITERS = rounds
    tiled_decode.dp.decode = lambda *a: reached.append(1) or real_v1(*a)
    try:
        conv = tiled_decode._tile_step(local, clen, ax).conv
        img, _ = tiled_decode.decode_tiled(stream, _mesh(), device=CPU)
    finally:
        tiled_decode._MAX_ITERS = saved
        tiled_decode.dp.decode = real_v1
    return img, conv, bool(reached)


def roundtrip_on_card(img, stream):
    """On this rank's card: encode_tiled and decode_tiled of one frame
    against the given oracle stream, the sharded fixpoint's convergence,
    this rank's kernel launches and the mesh's counters."""
    from qoi_tpu_torch.kernels import _build

    mesh = sharding.make_mesh(1, dist.get_world_size(), device="cuda")
    mesh.stats.reset()
    _build.reset_launches()
    got = tiled.encode_tiled(img, _desc(img), mesh)
    back, _ = tiled_decode.decode_tiled(stream, mesh)
    local, clen, cap = tiled_decode.shard_bytes(stream, mesh.seq,
                                                mesh.device)
    _, conv = tiled_decode._decode_expand_device(local, clen, mesh.seq, cap)
    return (got == stream, np.array_equal(back, img), conv,
            dict(_build.launches), mesh.stats.as_dict())
