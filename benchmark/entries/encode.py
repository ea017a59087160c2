"""Entry `encode`: one frame a request through the port's device encode.

The frame is already on the device (a capture pipeline's frame): the
request runs `pipeline.encode_device_wordsum` and ends when the stream's
length is on the host. The answer is the stream's bytes up to that
length, compared with the reference encoder's.
"""
from __future__ import annotations

import torch

from benchmark import reference
from benchmark.entry import Result


def prepare(cfg, frames, device):
    from qoi_tpu_torch.models import pipeline  # the program
    return {"pipeline": pipeline, "px": frames,
            "n": cfg["width"] * cfg["height"]}


def request(state, k) -> Result:
    words, total = state["pipeline"].encode_device_wordsum(
        state["px"][k], state["n"])
    tot = int(total)
    return Result((words, tot), True, {}, 4 * state["n"] + tot)


def control_output(state, k):
    """The reference at 7 bits a channel, in the program's output form."""
    body = reference.encode_body(reference.seven_bit(state["px"][k]))
    tot = body.shape[0]
    buf = torch.zeros(-(-tot // 4) * 4, dtype=torch.uint8, device=body.device)
    buf[:tot] = body
    return buf.view(torch.int32), tot


def check(state, samples):
    """{name: (value, limit)}: bytes that differ from the reference's
    stream (a length difference counts each missing or extra byte)."""
    bodies = {}
    off = 0
    for k, (words, tot) in samples:
        if k not in bodies:
            bodies[k] = reference.encode_body(state["px"][k])
        want = bodies[k]
        got = words.view(torch.uint8)[:tot]
        common = min(tot, want.shape[0])
        off += int((got[:common] != want[:common]).sum())
        off += abs(tot - want.shape[0])
    return {"bytes_off": (off, 0)}
