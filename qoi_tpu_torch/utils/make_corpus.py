"""The synthetic conformance corpus as .qoi files (the port's counterpart
of tools/make_corpus.py), with neither JAX nor PIL.

The same specs as tools/make_corpus.py's `_full_specs` (303 images,
179.9 Mpx: the photo class at fifteen sizes, photo_rgba, icons, screens,
hash-collision palettes, the palette_alpha class that rides the decode
ladder, ~5 B/px noise, 1xN and Nx1 up to 16384, and members on both sides
of the 16 Mpx streaming switch) and `_small_specs` (32 images), in the
same order, from the same generators and arguments of utils/testimages.
Names keep their folders, with .qoi for .png. Each spec is a
(relative name, thunk) pair: the image is made when the thunk is called,
so a caller holds one image at a time. `build` writes each image as the
C++ oracle encodes it.

    python -m qoi_tpu_torch.utils.make_corpus DIR            # full, 303
    python -m qoi_tpu_torch.utils.make_corpus DIR --small    # 32
"""
from __future__ import annotations

import functools
import pathlib
import sys
from typing import Callable, Iterator, Tuple

import numpy as np

from .. import oracle
from ..io import image_desc
from . import testimages as t

Spec = Tuple[str, Callable[[], np.ndarray]]


def _spec(name: str, fn, *args, **kwargs) -> Spec:
    return name, functools.partial(fn, *args, **kwargs)


def small_specs() -> Iterator[Spec]:
    """The 32-image corpus (tools/make_corpus.py `_small_specs`)."""
    for i, (w, h) in enumerate([(640, 480), (800, 600), (1024, 768),
                                (1920, 1080), (333, 777), (64, 64)]):
        yield _spec(f"photo/photo_{w}x{h}.qoi", t.photo, w, h, 3, seed=i)
        yield _spec(f"photo/photo_{w}x{h}_rgba.qoi", t.photo, w, h, 4,
                    seed=i + 50)
    for i, s in enumerate([16, 32, 48, 64, 128]):
        yield _spec(f"icons/icon_{s}.qoi", t.mixed, s, s, 4, seed=i)
        yield _spec(f"icons/alpha_{s}.qoi", t.alpha_toggle, s, s, seed=i)
    for i, (w, h) in enumerate([(1280, 720), (640, 400)]):
        yield _spec(f"screens/flat_{w}x{h}.qoi", t.flat, w, h, 3)
        yield _spec(f"screens/palette_{w}x{h}.qoi", t.palette, w, h, 3,
                    colors=12, seed=i)
        yield _spec(f"screens/gradient_{w}x{h}.qoi", t.gradient, w, h, 3)
    yield _spec("hard/noise_512.qoi", t.noise, 512, 512, 4, seed=9)
    yield _spec("hard/wrap_256.qoi", t.wraparound, 256, 64, 4)
    yield _spec("hard/tall_1xN.qoi", t.gradient, 1, 4096, 3)
    yield _spec("hard/wide_Nx1.qoi", t.gradient, 4096, 1, 3)


def full_specs() -> Iterator[Spec]:
    """The 303-image corpus (tools/make_corpus.py `_full_specs`)."""
    photo_sizes = [(160, 120), (320, 240), (400, 300), (512, 384),
                   (640, 480), (735, 551), (800, 600), (1024, 768),
                   (1111, 763), (1280, 960), (1600, 1200), (1920, 1080),
                   (257, 1023), (1023, 257), (96, 96)]
    for i, (w, h) in enumerate(photo_sizes):
        for s in range(10):
            yield _spec(f"photo/photo_{w}x{h}_s{s}.qoi", t.photo, w, h, 3,
                        seed=16 * i + s)
    for i, (w, h) in enumerate(photo_sizes[:10]):
        for s in range(4):
            yield _spec(f"photo_rgba/photo_{w}x{h}_s{s}.qoi", t.photo,
                        w, h, 4, seed=100 + 16 * i + s)
    for i, sz in enumerate([16, 32, 48, 64, 128, 192, 256]):
        for s in range(3):
            yield _spec(f"icons/icon_{sz}_s{s}.qoi", t.mixed, sz, sz, 4,
                        seed=8 * i + s)
        yield _spec(f"icons/alpha_{sz}.qoi", t.alpha_toggle, sz, sz, seed=i)
    for i, (w, h) in enumerate([(1280, 720), (1024, 600), (800, 480),
                                (640, 400), (1920, 1080), (360, 740),
                                (273, 414), (2048, 128), (555, 555),
                                (1366, 768)]):
        yield _spec(f"screens/flat_{w}x{h}.qoi", t.flat, w, h, 3)
        yield _spec(f"screens/palette_{w}x{h}.qoi", t.palette, w, h, 3,
                    colors=8 + 4 * i, seed=i)
        yield _spec(f"screens/gradient_{w}x{h}.qoi", t.gradient, w, h, 3)
        yield _spec(f"screens/mixed_{w}x{h}.qoi", t.mixed, w, h, 3,
                    seed=200 + i)
    for i, slot in enumerate([0, 17, 63]):
        for ch in (3, 4):
            yield _spec(f"hard/collide_s{slot}_{ch}ch.qoi",
                        t.palette_collide, 512, 256, ch, colors=24,
                        seed=300 + i, slot=slot)
    for i in range(4):
        yield _spec(f"hard/collide_dense_{i}.qoi", t.palette_collide,
                    777, 333, 4, colors=64, seed=310 + i, slot=i * 13 % 64)
    for i in range(6):
        yield _spec(f"hard/palette_alpha_{i}.qoi", t.palette_alpha,
                    256 + 64 * i, 200, colors=16 + 8 * i, seed=400 + i)
    for i, (w, h) in enumerate([(512, 512), (333, 777), (1024, 512)]):
        yield _spec(f"hard/noise_rgb_{w}x{h}.qoi", t.noise, w, h, 3,
                    seed=500 + i)
        yield _spec(f"hard/noise_rgba_{w}x{h}.qoi", t.noise, w, h, 4,
                    seed=510 + i)
    for n in (1, 7, 64, 333, 4096, 16384):
        yield _spec(f"aspect/wide_{n}x1.qoi", t.gradient, n, 1, 3)
        yield _spec(f"aspect/tall_1x{n}.qoi", t.gradient, 1, n, 3)
    yield _spec("aspect/wide_noise_8192x2.qoi", t.noise, 8192, 2, 4, 600)
    yield _spec("aspect/tall_palette_3x30000.qoi", t.palette, 3, 30000, 3,
                colors=11, seed=601)
    yield _spec("big/photo_5120x3200_rgb.qoi", t.photo, 5120, 3200, 3,
                seed=700)                                    # 16.38 Mpx
    yield _spec("big/mixed_4800x3600_rgba.qoi", t.mixed, 4800, 3600, 4,
                seed=701)                                    # 17.28 Mpx
    yield _spec("big/photo_3840x2160_rgba.qoi", t.photo, 3840, 2160, 4,
                seed=702)                                    # 8.29 Mpx
    yield _spec("hard/wrap_256.qoi", t.wraparound, 256, 64, 4)
    yield _spec("hard/wrap_rgb.qoi", t.wraparound, 640, 31, 3)
    yield _spec("hard/runs_caps.qoi", t.runs_with_caps, 130, 30, 4)
    yield _spec("hard/runs_caps_rgb.qoi", t.runs_with_caps, 260, 15, 3)
    yield _spec("hard/seed_run.qoi", t.seed_run_start, 128, 128, 4)
    yield _spec("hard/seed_run_rgb.qoi", t.seed_run_start, 64, 256, 3)


def build(root, small: bool = False) -> int:
    """Write every image of the corpus under `root` as the oracle's
    stream; print the total Mpx and return the image count."""
    root = pathlib.Path(root)
    mpx = count = 0
    for rel, make in (small_specs() if small else full_specs()):
        img = make()
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_bytes(oracle.encode(img, image_desc(img)))
        mpx += img.shape[0] * img.shape[1]
        count += 1
    print(f"total {mpx / 1e6:.1f} Mpx")
    return count


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    args = [a for a in argv if a != "--small"]
    if len(args) != 1:
        print("usage: python -m qoi_tpu_torch.utils.make_corpus DIR "
              "[--small]", file=sys.stderr)
        return 2
    n = build(args[0], small="--small" in argv)
    print(f"{n} .qoi streams under {args[0]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
