"""Synthetic image generators exercising every QOI op family.

Shared by the test suite (SURVEY.md §4 edge-case list) and the benchmark
harness. Each generator returns a (height, width, channels) uint8 array.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


def noise(w: int, h: int, ch: int, seed: int = 0) -> np.ndarray:
    """Uncompressible noise: stresses OP_RGB/OP_RGBA literals."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, size=(h, w, ch), dtype=np.uint8)


def flat(w: int, h: int, ch: int, value: Tuple[int, ...] = (40, 80, 120, 255)) -> np.ndarray:
    """Single color: stresses OP_RUN chaining (62-cap flushes)."""
    img = np.empty((h, w, ch), dtype=np.uint8)
    img[:] = np.array(value[:ch], dtype=np.uint8)
    return img


def gradient(w: int, h: int, ch: int) -> np.ndarray:
    """Smooth ramps: stresses OP_DIFF / OP_LUMA, including wraparound."""
    x = np.arange(w, dtype=np.int32)[None, :]
    y = np.arange(h, dtype=np.int32)[:, None]
    img = np.zeros((h, w, ch), dtype=np.uint8)
    img[..., 0] = ((x + y) % 256).astype(np.uint8)
    img[..., 1] = (x % 256).astype(np.uint8)
    img[..., 2] = (y % 256).astype(np.uint8)
    if ch == 4:
        img[..., 3] = 255
    return img


def palette(w: int, h: int, ch: int, colors: int = 6, seed: int = 1) -> np.ndarray:
    """Few repeated colors: stresses OP_INDEX hits and hash collisions."""
    rng = np.random.default_rng(seed)
    pal = rng.integers(0, 256, size=(colors, ch), dtype=np.uint8)
    idx = rng.integers(0, colors, size=(h, w))
    return pal[idx]


def alpha_toggle(w: int, h: int, seed: int = 2) -> np.ndarray:
    """RGBA with frequent alpha changes: stresses OP_RGBA."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 4, size=(h, w, 4), dtype=np.uint8)
    img[..., 3] = np.where(rng.integers(0, 3, size=(h, w)) == 0, 128, 255).astype(np.uint8)
    return img


def runs_with_caps(w: int, h: int, ch: int) -> np.ndarray:
    """Runs of lengths straddling the 62-cap: 61/62/63/124 pixels."""
    img = flat(w, h, ch)
    flatv = img.reshape(-1, ch)
    pos = 0
    for run_len in (61, 62, 63, 124, 1, 2):
        pos += run_len
        if pos >= flatv.shape[0]:
            break
        flatv[pos] = (pos * 37) % 256
    return flatv.reshape(h, w, ch)


def seed_run_start(w: int, h: int, ch: int) -> np.ndarray:
    """Image starting with the seed pixel (0,0,0,255): the run begins at
    pixel 0 without a table write (SURVEY.md §2.2 note)."""
    img = np.zeros((h, w, ch), dtype=np.uint8)
    if ch == 4:
        img[..., 3] = 255
    img[h // 2:, :, 0] = 200
    return img


def wraparound(w: int, h: int, ch: int) -> np.ndarray:
    """Black→white→black transitions: mod-256 DIFF deltas (+1/-1 wrap)."""
    img = np.zeros((h, w, ch), dtype=np.uint8)
    img[:, 1::2, :3] = 255
    if ch == 4:
        img[..., 3] = 255
    return img


def mixed(w: int, h: int, ch: int, seed: int = 3) -> np.ndarray:
    """Four vertical regions: gradient | flat | palette bands | noise —
    exercises every op family in one image (mirrors cpp/qoibench_cpp.cpp)."""
    region = (np.arange(w) * 4 // max(w, 1))[None, :, None]  # 0..3 by column
    layers = np.stack(
        [gradient(w, h, ch), flat(w, h, ch), palette(w, h, ch, colors=8, seed=seed),
         noise(w, h, ch, seed=seed)]
    )
    return np.choose(np.broadcast_to(region, (h, w, ch)), layers).astype(np.uint8)


def edge_case_suite(ch: int = 4) -> Dict[str, np.ndarray]:
    """The SURVEY.md §4 handcrafted edge-case corpus."""
    cases: Dict[str, np.ndarray] = {
        "1x1": noise(1, 1, ch),
        "1xN": gradient(64, 1, ch),
        "Nx1": gradient(1, 64, ch),
        "noise_small": noise(17, 13, ch),
        "flat_70px": flat(70, 1, ch),
        "flat_62px": flat(62, 1, ch),
        "flat_63px": flat(63, 1, ch),
        "flat_124px": flat(124, 1, ch),
        "gradient": gradient(101, 33, ch),
        "palette": palette(200, 10, ch),
        "runs_caps": runs_with_caps(130, 3, ch),
        "seed_run": seed_run_start(16, 16, ch),
        "wraparound": wraparound(32, 4, ch),
        "mixed": mixed(97, 29, ch),
    }
    if ch == 4:
        cases["alpha_toggle"] = alpha_toggle(50, 3)
    return cases


def bench_suite(scale: int = 1) -> List[Tuple[str, np.ndarray]]:
    """Benchmark images at sizes mirroring BASELINE.json configs."""
    return [
        ("256x256_rgb", mixed(256 * scale, 256 * scale, 3)),
        ("1080p_rgba", mixed(1920, 1080, 4)),
        ("4k_rgba", mixed(3840, 2160, 4)),
    ]


def photo(w: int, h: int, ch: int, seed: int = 3) -> np.ndarray:
    """The `mixed` four-region content with CONSTANT alpha (255) — the
    canonical photo/texture class (qoi_benchmark_suite images carry a
    constant alpha plane). Streams of this class have exact written-slot
    estimates, so the parallel decoder converges in one fixpoint round;
    `mixed`'s varying alpha needs one correction round (measured round 3:
    2 rounds at 4K); `palette_alpha` is the class that truly cannot
    converge and exercises the sequential fallback ladder."""
    img = mixed(w, h, ch, seed=seed).copy()
    if ch == 4:
        img[..., 3] = 255
    return img


def palette_collide(w: int, h: int, ch: int, colors: int = 24,
                    seed: int = 11, slot: int = 17) -> np.ndarray:
    """Hash-collision-dense palette: every color hashes to the SAME
    table slot ((3r+5g+7b+11a) % 64 == slot, reference qoi.h:92), so
    OP_INDEX can only ever hit the most recent color — the table
    degenerates to one entry and the encoder emits literal/DIFF chunks
    for everything else. Exercises last-writer replay correctness under
    maximal slot contention (encode table stage + decode w-estimate)."""
    rng = np.random.default_rng(seed)
    pal = rng.integers(0, 256, size=(colors, 4), dtype=np.uint8)
    if ch == 3:
        pal[:, 3] = 255
    # fix the hash by shifting g: adding dg to g shifts h by 5*dg
    # (mod 64); 5 is invertible mod 64, and a mod-256 wrap of g changes
    # 5*g by a multiple of 1280 ≡ 0 (mod 64), so the fix is exact
    h0 = (3 * pal[:, 0].astype(np.int64) + 5 * pal[:, 1]
          + 7 * pal[:, 2] + 11 * pal[:, 3]) % 64
    dg = ((slot - h0) * pow(5, -1, 64)) % 64
    pal[:, 1] = ((pal[:, 1].astype(np.int64) + dg) % 256).astype(np.uint8)
    hh = (3 * pal[:, 0].astype(np.int64) + 5 * pal[:, 1]
          + 7 * pal[:, 2] + 11 * pal[:, 3]) % 64
    assert (hh == slot).all()
    idx = rng.integers(0, colors, size=(h, w))
    return pal[idx][..., :ch]


def palette_alpha(w: int, h: int, colors: int = 40, seed: int = 7) -> np.ndarray:
    """The decode fixpoint's TRUE adversarial class (measured round 3):
    many palette colors with RANDOM ALPHAS. Nearly every chunk is an
    INDEX loading an unknown alpha, so the written-slot estimate is
    wrong about once per ~7 stream bytes and the fixpoint's exact prefix
    can never catch up (1 Mpx: ~277k initial mismatches, stalls at
    ~464k). Dense INDEX-alpha coupling is inherently sequential — this
    class rides the fallback ladder by design, like the reference's
    sequential loop (qoi.h:540)."""
    rng = np.random.default_rng(seed)
    pal = rng.integers(0, 256, size=(colors, 4), dtype=np.uint8)
    return pal[rng.integers(0, colors, size=(h, w))]
