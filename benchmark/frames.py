"""Synthetic RGBA frames of the benchmark, made on the device from a seed.

A copy of the port's `utils.testimages.mixed` and `photo` classes,
rewritten in torch so that a 4K frame is made on the card in a few large
calls. It imports nothing of the program.

The frame has four vertical regions, a quarter of the width each:
gradient | flat | 8-colour palette | noise. `alpha="varying"` keeps the
palette's and the noise's random alpha (capture layers); `alpha="opaque"`
forces alpha to 255 everywhere (photo and texture assets).

The palette is the original's: eight colours drawn uniformly at random.
Chances in that draw change the work: two colours in one QOI hash slot (a
third of random palettes) evict each other from the index, which lengthens
the stream, and, with varying alpha, some palettes whose colours share
alphas (three colours of one alpha, always) need a third round of the
decode's fixpoint. So that every seed does the same work, a frame's
palette is drawn at random within a class, and the configuration fixes
the classes of the pool's frames (`palette_classes`):

- "distinct": eight hash slots and, with varying alpha, eight alphas;
- "slot_pair": exactly one pair of colours shares a hash slot, and with
  varying alpha the alphas are distinct;
- "alpha_triple" (varying alpha only): exactly three colours share one
  alpha, the other five alphas are distinct, and so are the slots.
"""
from __future__ import annotations

import hashlib

import torch

FLAT = (40, 80, 120, 255)
PALETTE_COLORS = 8
ALPHAS = ("varying", "opaque")
#: per-colour multiplicities, sorted, of the hash slots and of the alphas
PALETTE_CLASSES = {
    "distinct": ((1,) * 8, (1,) * 8),
    "slot_pair": ((2, 2) + (1,) * 6, (1,) * 8),
    "alpha_triple": ((1,) * 8, (3, 3, 3) + (1,) * 5),
}
DRAW_BLOCK = 4096  # palettes drawn at once


def qoi_hash(px: torch.Tensor) -> torch.Tensor:
    """(..., 4) pixels -> (...,) int64 QOI index slots (r*3+g*5+b*7+a*11)%64."""
    p = px.to(torch.int64)
    return (p[..., 0] * 3 + p[..., 1] * 5 + p[..., 2] * 7
            + p[..., 3] * 11) % 64


def frame_seed(seed: int, k: int) -> int:
    """The seed of the pool's k-th frame, derived from the run's seed (any
    whole number) as a 63-bit integer."""
    digest = hashlib.sha256(f"{seed}:{k}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def _multiplicities(v: torch.Tensor) -> torch.Tensor:
    """(B, 8) values -> (B, 8) each one's count in its row, sorted down."""
    return (v[:, :, None] == v[:, None, :]).sum(-1).sort(-1,
                                                         descending=True)[0]


def palette(seed: int, alpha: str, kind: str = "distinct") -> torch.Tensor:
    """(8, 4) uint8 random colours of the class `kind`, drawn on the host
    (the same on every device): the first of the seed's uniformly drawn
    palettes that is of the class."""
    if kind not in PALETTE_CLASSES or (kind == "alpha_triple"
                                       and alpha == "opaque"):
        raise ValueError(f"no palette class {kind!r} with {alpha} alpha")
    want_slots, want_alphas = (torch.tensor(w) for w in PALETTE_CLASSES[kind])
    g = torch.Generator().manual_seed(seed)
    while True:
        pals = torch.randint(0, 256, (DRAW_BLOCK, PALETTE_COLORS, 4),
                             generator=g, dtype=torch.int64)
        if alpha == "opaque":
            pals[..., 3] = 255
        ok = (_multiplicities(qoi_hash(pals)) == want_slots).all(-1)
        if alpha != "opaque":
            ok &= (_multiplicities(pals[..., 3]) == want_alphas).all(-1)
        hit = ok.nonzero()
        if hit.numel():
            return pals[int(hit[0, 0])].to(torch.uint8)


def frame(width: int, height: int, seed: int, alpha: str = "varying",
          device="cpu", kind: str = "distinct") -> torch.Tensor:
    """One frame as (height * width, 4) uint8 RGBA on `device`, its
    palette of the class `kind`."""
    if alpha not in ALPHAS:
        raise ValueError(f"alpha must be one of {ALPHAS}, got {alpha!r}")
    dev = torch.device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.arange(width, device=dev)[None, :]
    y = torch.arange(height, device=dev)[:, None]
    region = (x * 4 // max(width, 1)).expand(height, width)

    grad = torch.stack(torch.broadcast_tensors(
        (x + y) % 256, x % 256, y % 256, torch.full_like(x, 255)), dim=-1)
    flat = torch.tensor(FLAT, device=dev).expand(height, width, 4)
    pal = palette(seed, alpha, kind).to(dev)
    pal_px = pal[torch.randint(0, PALETTE_COLORS, (height, width),
                               generator=g, device=dev)]
    noise = torch.randint(0, 256, (height, width, 4), generator=g,
                          device=dev, dtype=torch.uint8)

    r = region[..., None]
    out = torch.where(r == 0, grad.to(torch.uint8),
          torch.where(r == 1, flat.to(torch.uint8),
          torch.where(r == 2, pal_px, noise)))
    if alpha == "opaque":
        out[..., 3] = 255
    return out.reshape(-1, 4).contiguous()
