"""The runner fails without a card, loads nothing of JAX, and reads nothing
of the JAX-era benchmark records."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from slam_bench import manifest

HERE = manifest.HERE
JAX_ERA = ("benchmarks/", "bench.py", "BENCH_r0", "MULTICHIP_r0", "BASELINE.")


def test_runner_fails_without_a_card():
    proc = subprocess.run([sys.executable, "-m", "slam_bench.run", "--workload",
                           manifest.benchmark()["workloads"][0]["name"], "--seed", "3000000000",
                           "--seconds", "10", "--trace", "0"],
                          cwd=manifest.ROOT, capture_output=True, text=True, timeout=300,
                          env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": "",
                               "HOME": str(manifest.ROOT / "build")})
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "CUDA device" in proc.stderr


def test_nothing_loaded_is_jax():
    code = ("import sys, importlib, pathlib\n"
            "from slam_bench import manifest, run, check, readings\n"
            "from slam_bench.reference import network, step\n"
            "for w in manifest.benchmark()['workloads']:\n"
            "    c = manifest.cell(w['name']); manifest.entry(c.traffic['entry'])\n"
            "    [manifest.reader(m['name']) for m in c.per_layer]\n"
            "import mast3r_slam_torch.slam, mast3r_slam_torch.tracker, mast3r_slam_torch.ops.build\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=manifest.ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "mast3r_slam_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "mast3r_slam_tpu"}


def _strings_and_imports(path: Path):
    tree = ast.parse(path.read_text())
    docs = {id(n.body[0].value) for n in ast.walk(tree)
            if isinstance(n, (ast.Module, ast.FunctionDef, ast.ClassDef)) and n.body
            and isinstance(n.body[0], ast.Expr) and isinstance(n.body[0].value, ast.Constant)}
    for n in ast.walk(tree):
        if isinstance(n, ast.Import):
            yield from (("import", a.name) for a in n.names)
        elif isinstance(n, ast.ImportFrom) and n.module:
            yield "import", n.module
        elif isinstance(n, ast.Constant) and isinstance(n.value, str) and id(n) not in docs:
            yield "string", n.value


@pytest.mark.parametrize("path", sorted(p for p in HERE.rglob("*.py") if "tests" not in p.parts),
                         ids=lambda p: str(p.relative_to(HERE)))
def test_no_source_reads_the_jax_era_records(path):
    for kind, value in _strings_and_imports(path):
        if kind == "import":
            assert value.split(".")[0] not in ("benchmarks", "bench", "jax", "jaxlib", "flax",
                                               "mast3r_slam_tpu"), value
        else:
            assert not any(k in value for k in JAX_ERA), value


def test_no_data_file_names_the_jax_era_records():
    for path in HERE.rglob("*.json"):
        text = path.read_text()
        assert not any(k in text for k in JAX_ERA), path
