"""Batched encode/decode: many independent streams on one device (port
of qoi_tpu/models/batch.py).

Each image is its own seed-state stream (exactly a standalone
reference-compatible file), so there is no cross-stream carry. Images
are grouped by their power-of-two pixel bucket (streams by their byte and
pixel buckets), a group uploads in one copy and its rows run one after
another on the device. Invalid streams are flagged per stream and the
batch goes on.

Device memory: a group's resident buffers (its upload and its outputs)
stay within GROUP_BUDGET_BYTES; a larger group is cut into consecutive
sub-groups. On top of that the device holds the working set of one
image at a time: 4.251 GiB for the decode of a 3840x2160 frame on an
H100 (measured by chip_smoke.py, PERF.md), less for its encode. A 4K
frame's row holds 80 MiB (encode: 4 B of pixels and 6 B of stream words
a pixel of its 2^23-pixel bucket) or about 80 MiB (decode: the padded
stream, ~15 MiB for a photo or mixed frame, and twice the 4-byte pixel
plane), so 32 4K frames, about 2.5 GiB, run as one group.
"""
from __future__ import annotations

import collections
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import format as fmt
from . import decode_pipeline, decode_v3, pipeline

#: bytes of a group's resident device buffers (upload and outputs)
GROUP_BUDGET_BYTES = 4 << 30


def _sub_groups(idxs: List[int], row_bytes: int) -> List[List[int]]:
    """Cut a group's rows into runs of at most GROUP_BUDGET_BYTES."""
    per = max(1, GROUP_BUDGET_BYTES // row_bytes)
    return [idxs[k:k + per] for k in range(0, len(idxs), per)]


def encode_batch(images: Sequence[np.ndarray],
                 descs: Optional[Sequence[fmt.StreamDesc]] = None,
                 device="cuda") -> List[bytes]:
    """Encode a batch of images (each (h, w, 3|4) uint8) on `device`;
    returns one reference-compatible stream per image, byte-identical to
    encoding each alone. A group uploads in one copy; each row runs
    `pipeline.encode_device_wordsum` (the compact_words kernel on the card);
    one fetch brings the group's totals, then each stream's words."""
    from .. import _device

    dev = _device(device)
    if descs is None:
        descs = [fmt.StreamDesc(im.shape[1], im.shape[0], im.shape[2])
                 for im in images]
    groups: Dict[int, List[int]] = collections.defaultdict(list)
    for i, d in enumerate(descs):
        d.validate()
        groups[decode_pipeline.bucket_size(d.num_pixels)].append(i)

    out: List[bytes] = [b""] * len(images)
    for bucket, idxs in sorted(groups.items()):
        for sub in _sub_groups(idxs, 10 * bucket):
            px = np.zeros((len(sub), bucket, 4), np.uint8)
            nv = []
            for row, i in enumerate(sub):
                flat = pipeline.force_rgba(images[i], descs[i])
                px[row, : flat.shape[0]] = flat
                nv.append(flat.shape[0])
            px_dev = torch.from_numpy(px).to(dev)
            devouts = [pipeline.encode_device_wordsum(px_dev[row], nv[row])
                       for row in range(len(sub))]
            tots = torch.stack([t for _, t in devouts]).cpu().tolist()
            for row, i in enumerate(sub):
                words, tot = devouts[row][0], tots[row]
                body = words[: -(-tot // 4)].cpu().numpy().view(np.uint8)
                out[i] = (fmt.pack_header(descs[i]) + body[:tot].tobytes()
                          + fmt.TRAILER)
    return out


def decode_batch(streams: Sequence[bytes], channels: int = 0,
                 device="cuda") -> List[Tuple[Optional[np.ndarray],
                                               Optional[fmt.StreamDesc],
                                               Optional[str]]]:
    """Decode a batch of QOI streams on `device`. Returns per-stream
    (pixels, desc, error): invalid streams get (None, None, message) and
    the rest of the batch proceeds. Streams group by (byte bucket, pixel
    bucket) and run `decode_v3.decode_group` (the block_maps and expand
    kernels on the card); a stream whose fixpoint does not converge goes
    to the v1 decoder, `decode_pipeline.decode` (which falls back to the
    sequential one), as in the JAX package."""
    from .. import _device

    dev = _device(device)
    if channels not in (0, 3, 4):
        raise ValueError(f"channels must be 0, 3 or 4, got {channels}")

    parsed: List[Optional[fmt.StreamDesc]] = []
    results: List[Tuple] = []
    for s in streams:
        try:
            parsed.append(fmt.unpack_header(s))
            results.append((None, None, None))
        except ValueError as e:
            parsed.append(None)
            results.append((None, None, str(e)))

    groups: Dict[Tuple[int, int], List[int]] = collections.defaultdict(list)
    for i, d in enumerate(parsed):
        if d is not None:
            cap = decode_pipeline.bucket_size_fine(
                len(streams[i]) - fmt.HEADER_SIZE)
            npc = decode_pipeline.bucket_size(d.num_pixels)
            groups[(cap, npc)].append(i)

    for (cap, npc), idxs in sorted(groups.items()):
        for sub in _sub_groups(idxs, cap + 8 * npc):
            data = np.zeros((len(sub), cap), np.uint8)
            clens = []
            for row, i in enumerate(sub):
                body = np.frombuffer(streams[i], np.uint8)[fmt.HEADER_SIZE:]
                data[row, : body.shape[0]] = body
                clens.append(len(streams[i]) - fmt.HEADER_SIZE
                             - fmt.TRAILER_SIZE)
            px32, conv, _ = decode_v3.decode_group(
                torch.from_numpy(data).to(dev), clens, npc)
            px32 = px32.cpu().numpy()  # (B, npc) packed pixels
            for row, i in enumerate(sub):
                d = parsed[i]
                if conv[row]:
                    out_ch = channels if channels else d.channels
                    img = decode_v3.unpack_px32(px32[row])[
                        : d.num_pixels, :out_ch].reshape(
                        d.height, d.width, out_ch)
                else:  # non-canonical stream: the certified fallback
                    img, _ = decode_pipeline.decode(streams[i], channels,
                                                    dev)
                results[i] = (img, d, None)
    return results
