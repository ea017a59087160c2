"""The import guard: nothing the run or the reference loads is the JAX
stack or the JAX package, compared by whole top-level names."""
import json
import pathlib
import subprocess
import sys

from benchmark import guard

ROOT = pathlib.Path(__file__).resolve().parents[2]


def _python(code: str) -> dict:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


PRELUDE = f"""
import json, sys
sys.path.insert(0, {str(ROOT)!r})
from benchmark import guard
sys.meta_path.insert(0, guard.Blocker())
"""


def test_whole_top_level_names():
    names = ["qoi_tpu_torch", "qoi_tpu_torch.models.decode_v3", "qoi_tpu",
             "qoi_tpu.ops", "jax", "jax.numpy", "jaxlib", "jaxtyping",
             "flax", "flaxen", "torch"]
    assert guard.forbidden(names) == ["flax", "jax", "jax.numpy", "jaxlib",
                                      "qoi_tpu", "qoi_tpu.ops"]


def test_every_run_module_loads_with_jax_blocked():
    # a whole run of each cell, traced and not, at a small size on the
    # CPU, then the control's readings: every module they load
    r = _python(PRELUDE + """
from benchmark import control, harness
small = {"width": 64, "height": 48}
ok = []
for w in [c["name"] for c in harness.load_benchmark()["workloads"]]:
    for trace in (0, 1):
        res, _ = harness.run_cell(w, 3, 0.2, trace, device="cpu",
                                  overrides=small)
        ok.append(res["correct"])
    control.readings(w, 3, "cpu", overrides=small)
import benchmark.run
print(json.dumps({"forbidden": guard.loaded_forbidden(), "ok": ok,
                  "port": "qoi_tpu_torch" in sys.modules}))
""")
    assert r["forbidden"] == []
    assert r["port"] and all(r["ok"])


def test_reference_loads_nothing_of_the_port():
    r = _python(PRELUDE + """
from benchmark import frames, reference
px = frames.frame(40, 20, 1, "varying")
reference.encode(reference.seven_bit(px), 40, 20)
print(json.dumps({"mods": sorted(m for m in sys.modules
                                 if m.split(".")[0].startswith("qoi_tpu"))}))
""")
    assert r["mods"] == []
    for name in ("reference.py", "frames.py"):
        src = (ROOT / "benchmark" / name).read_text()
        assert "qoi_tpu" not in src.replace("qoi_benchmark_suite", "")
        assert "oracle" not in src and "cpp" not in src
