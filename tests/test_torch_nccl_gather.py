"""The final gathers of the sequence-parallel codec by backend: NCCL takes
only CUDA tensors, so under it `Axis.gather_to_host` hands the collective
the tensor on the rank's device; under gloo it hands it a host tensor.

The CPU tests patch the backend query and allocate nothing on a card. The
`gpu` test runs encode_tiled / decode_tiled on a one-rank NCCL group (one
card holds it); run it on the GPU machine with:

    python -m pytest --noconftest -m gpu -q tests/test_torch_nccl_gather.py
"""
import socket

import pytest
import torch
import torch.distributed as dist

from qoi_tpu_torch import format as fmt
from qoi_tpu_torch import oracle
from qoi_tpu_torch.parallel import sharding
from qoi_tpu_torch.utils import testimages


def _port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


@pytest.mark.parametrize("backend,want", [("nccl", "cuda"),
                                          ("gloo", "cpu")])
def test_collective_device_by_backend(monkeypatch, backend, want):
    """NCCL keeps the rank's device, gloo the host; a torch.device names
    the card without touching it."""
    seen = []
    monkeypatch.setattr(dist, "get_backend",
                        lambda group=None: seen.append(group) or backend)
    group = object()
    dev = sharding.collective_device(group, torch.device("cuda", 0))
    assert dev.type == want and seen == [group]
    if want == "cuda":
        assert dev == torch.device("cuda", 0)


@pytest.mark.parametrize("backend", ["nccl", "gloo"])
def test_gather_to_host_hands_the_backend_its_device(monkeypatch, backend):
    """gather_to_host moves t to collective_device's answer for the axis's
    group, gathers it there and returns the gathered rows on the host."""
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{_port()}",
                            world_size=1, rank=0)
    try:
        ax = sharding.Axis("seq", [0], dist.group.WORLD, sharding.Stats())
        monkeypatch.setattr(dist, "get_backend", lambda group=None: backend)
        given = []
        real = ax.all_gather
        monkeypatch.setattr(ax, "all_gather",
                            lambda t: given.append(t.device) or real(t))
        t = torch.arange(6, dtype=torch.int32)
        out = ax.gather_to_host(t)
        assert given == [t.device]      # the CPU is this rank's device
        assert out.device.type == "cpu" and torch.equal(out, t[None])
        assert ax.stats.collectives == 1
    finally:
        dist.destroy_process_group()


@pytest.mark.gpu
def test_tiled_codec_on_one_rank_nccl_group():
    """encode_tiled and decode_tiled on a one-rank NCCL group, a 1024x512
    mixed frame: the oracle's bytes and the source pixels, the gathers
    handed CUDA tensors."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from qoi_tpu_torch.parallel import tiled, tiled_decode

    img = testimages.mixed(1024, 512, 4, seed=3)
    desc = fmt.StreamDesc(1024, 512, 4)
    stream = oracle.encode(img, desc)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{_port()}",
                            world_size=1, rank=0,
                            device_id=torch.device("cuda", 0))
    try:
        mesh = sharding.make_mesh(1, 1, device="cuda")
        assert sharding.collective_device(
            mesh.seq.group, mesh.device) == torch.device("cuda", 0)
        assert tiled.encode_tiled(img, desc, mesh) == stream
        px, got = tiled_decode.decode_tiled(stream, mesh)
        assert got == desc and (px == img).all()
    finally:
        dist.destroy_process_group()
