"""Nothing the benchmark runs imports JAX or the JAX package (whose
top-level name ``gsplat_tpu`` the port's ``gsplat_tpu_torch`` only starts
with), nor reads that package's benchmark files; the reference imports
nothing of the port."""
import ast
import os
import subprocess
import sys

from conftest import ROOT

PKG = os.path.join(ROOT, "splatbench")
FORBIDDEN = {"jax", "jaxlib", "flax", "gsplat_tpu"}


def _sources(sub=""):
    for d, _, files in os.walk(os.path.join(PKG, sub)):
        if "_cache" in d:
            continue
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _top_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_source_imports_jax_or_the_jax_package():
    for path in _sources():
        assert not (_top_imports(path) & FORBIDDEN), path


def test_reference_imports_nothing_of_the_port():
    for path in _sources("reference"):
        assert "gsplat_tpu_torch" not in _top_imports(path), path


def test_no_source_reads_the_jax_package_benchmark_files():
    names = ["bench" + ".py", "BENCH_", "BASE" + "LINE", "MULTI" + "CHIP_"]
    for path in _sources():
        if os.sep + "tests" + os.sep in path:
            continue
        with open(path) as f:
            text = f.read()
        assert not any(n in text for n in names), path


def test_what_a_run_imports_loads_no_jax():
    code = (
        "import splatbench.run, splatbench.harness.bench as b\n"
        "from splatbench.harness import calibrate, train, view\n"
        "import gsplat_tpu_torch.train.trainer, gsplat_tpu_torch.renderer\n"
        "import gsplat_tpu_torch.viz.network_gui, gsplat_tpu_torch.config\n"
        "import gsplat_tpu_torch.models.gaussians\n"
        "import gsplat_tpu_torch.core.cameras\n"
        "print(b.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
