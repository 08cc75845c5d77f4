"""Nothing the benchmark runs loads JAX or the JAX package; the reference
takes nothing of the port."""
import ast
import os
import subprocess
import sys

from portbench import harness, manifest

SOURCES = sorted(p for p in manifest.HERE.rglob("*.py") if "tests" not in p.parts)


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def test_no_source_imports_jax_or_the_jax_package():
    for path in SOURCES:
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & set(harness.FORBIDDEN), path


def test_only_port_imports_the_port():
    for path in SOURCES:
        tops = {name.split(".")[0] for name in _imports(path)}
        assert ("repro_torch" in tops) == (path.name == "port.py"), path


def test_a_run_loads_no_forbidden_module():
    root = manifest.ROOT
    code = ("import runpy, sys; sys.argv = ['x']; "
            "m = runpy.run_path('portbench/run.py', run_name='not_main'); "
            "import portbench.harness, portbench.readings, portbench.port; "
            "[portbench.manifest.reader(n) for n in "
            "[m['name'] for m in portbench.manifest.load()['per_layer']]]; "
            "print(sorted({n.split('.')[0] for n in sys.modules}))")
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    out = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in loaded and "torch" in loaded
    assert not loaded & set(harness.FORBIDDEN)


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torchish", sys)
    monkeypatch.setitem(sys.modules, "jaxlike.sub", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.deploy", sys)
    assert harness.forbidden_modules() == ["repro"]


def test_run_refuses_without_a_card():
    root = manifest.ROOT
    env = dict(os.environ, PYTHONPATH="", CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "cnn_a.offline_b1024", "--seed", "3", "--seconds", "1"],
                         cwd=root, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA card" in out.stderr
