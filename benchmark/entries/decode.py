"""Entry `decode`: one stream a request through the port's device decode.

Set-up encodes each frame with the reference encoder and keeps the
stream's chunk bytes on the device, padded to the program's bucket size
as its facade pads them (a texture or data loader decoding into device
memory). The request runs `decode_v3.decode_group` on that one stream
and ends when its pixels are on the device and its converged flag on the
host. The answer is the pixels, compared with the source frame: the
reference stream encodes that frame losslessly.
"""
from __future__ import annotations

import torch

from benchmark import reference
from benchmark.entry import Result


def prepare(cfg, frames, device):
    from qoi_tpu_torch.models import decode_pipeline, decode_v3  # the program
    n = cfg["width"] * cfg["height"]
    bodies, clens = [], []
    for px in frames:
        chunks = reference.encode_body(px)
        clen = chunks.shape[0]
        m = decode_pipeline.bucket_size_fine(clen + len(reference.TRAILER))
        data = torch.zeros((1, m), dtype=torch.uint8, device=px.device)
        data[0, :clen] = chunks
        data[0, clen:clen + len(reference.TRAILER)] = torch.tensor(
            list(reference.TRAILER), dtype=torch.uint8)
        bodies.append(data)
        clens.append(clen)
        del chunks
    return {"decode_v3": decode_v3, "px": frames, "n": n, "data": bodies,
            "clen": clens, "npc": decode_pipeline.bucket_size(n),
            "cuda": torch.device(device).type == "cuda"}


def request(state, k) -> Result:
    out, conv, rounds = state["decode_v3"].decode_group(
        state["data"][k], [state["clen"][k]], state["npc"])
    if state["cuda"]:
        torch.cuda.synchronize()
    return Result(out, bool(conv[0]), {"rounds": int(rounds[0])},
                  state["clen"][k] + 4 * state["n"])


def control_output(state, k):
    """The source frame at 7 bits a channel, in the program's output form."""
    px = reference.seven_bit(state["px"][k]).view(torch.int32).reshape(-1)
    out = torch.zeros((1, state["npc"]), dtype=torch.int32, device=px.device)
    out[0, :px.shape[0]] = px
    return out


def check(state, samples):
    """{name: (value, limit)}: pixels that differ from the source frame."""
    n = state["n"]
    off = 0
    for k, out in samples:
        want = state["px"][k].view(torch.int32).reshape(-1)
        off += int((out[0, :n] != want).sum())
    return {"px_off": (off, 0)}
