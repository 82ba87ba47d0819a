"""Nothing the benchmark runs imports JAX, flax or the JAX package
(top-level names compared whole: ``repro_torch`` is not ``repro``), and
the reference imports nothing of the system under test either."""
import ast
import subprocess
import sys

import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _modules(sub=""):
    root = harness.HERE / sub
    return [p for p in root.rglob("*.py") if "tests" not in p.parts]


def test_no_module_imports_jax_or_the_jax_package():
    files = _modules()
    assert len(files) > 20
    for path in files:
        bad = FORBIDDEN & set(_imports(path))
        assert not bad, (path, bad)


def test_the_reference_imports_nothing_of_the_system():
    for path in _modules("reference"):
        bad = (FORBIDDEN | {"repro_torch"}) & set(_imports(path))
        assert not bad, (path, bad)


def test_forbidden_names_are_compared_whole():
    assert harness.forbidden_modules({"repro_torch.core": 1, "jaxtyping": 1,
                                      "reprox": 1}) == []
    assert harness.forbidden_modules({"repro.core": 1, "jax.numpy": 1}) == [
        "jax", "repro"]


def test_a_run_loads_no_forbidden_module():
    code = f"""
import sys
sys.path[:0] = [{str(harness.HERE)!r}, {str(harness.HERE / 'tests')!r},
                {str(harness.ROOT / 'src')!r}]
from cpu_run import IRIS, cpu_run
import harness
r, line = cpu_run("iris16-k8192-online", seconds=0.5, **IRIS)
assert line["correct"], line
print(harness.forbidden_modules())
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
