"""The port's four examples (``examples/torch_*.py``, the counterparts of the
JAX package's ``examples/*.py``), each ``main`` run on the CPU with
``--device cpu`` at its smallest arguments (the kernels run their plain
versions), and the guard that none of them imports jax or the JAX
package.  Without ``--device`` an example asks for the card and raises
when there is none.
"""
import importlib.util
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
ARGS = {"torch_quickstart": [],
        "torch_serve_lm": [],
        "torch_train_cnn_a": ["--steps", "2", "--retrain-steps", "2", "--batch", "8",
                              "--eval", "16"],
        "torch_train_lm": ["--reduced", "--steps", "2", "--batch", "2", "--seq", "16",
                           "--grad-compress-M", "2"]}


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the suite runs beside other workers, and CPU
    convolutions with every core per process slow each other by 50x."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _load(name: str):
    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _args(name: str, tmp_path) -> list:
    extra = ["--checkpoint-dir", str(tmp_path / "ckpt")] if name == "torch_train_lm" else []
    return [*ARGS[name], *extra]


def test_quickstart_runs_on_the_cpu(capsys):
    _load("torch_quickstart").main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "M=4: ||W-What||^2" in out and "binary_matmul on cpu (plain version" in out
    assert "max |err|: 0.00e+00" in out         # the plain version against itself
    assert "total:" in out and "schedule [1, 2, 2, 2, 2]" in out


def test_serve_lm_runs_on_the_cpu(capsys):
    out = _load("torch_serve_lm").main(["--device", "cpu"])
    for reqs in out.values():
        assert all(r.done and len(r.out_tokens) == 8 for r in reqs)
    assert capsys.readouterr().out.count("bulk prefill passes") == 2


def test_train_cnn_a_runs_on_the_cpu(tmp_path):
    out = _load("torch_train_cnn_a").main([*_args("torch_train_cnn_a", tmp_path),
                                           "--device", "cpu"])
    assert all(0.0 <= out[k] <= 1.0 for k in ("acc_fp", "acc_bin", "acc_rt", "acc_deploy"))
    assert out["drift"] < 1e-3


def test_train_lm_runs_on_the_cpu(tmp_path):
    report = _load("torch_train_lm").main([*_args("torch_train_lm", tmp_path),
                                           "--device", "cpu"])
    assert report.steps_run == 2 and len(report.losses) == 2
    assert (tmp_path / "ckpt").is_dir()


@pytest.mark.parametrize("name", list(ARGS))
def test_example_defaults_to_the_card(monkeypatch, tmp_path, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match=r"torch\.cuda\.is_available\(\) is False"):
        _load(name).main(_args(name, tmp_path))


def test_examples_import_neither_jax_nor_the_reference():
    paths = sorted((ROOT / "examples").glob("torch_*.py"))
    assert [p.stem for p in paths] == sorted(ARGS)
    code = ("import importlib.util, sys\n"
            "for p in sys.argv[1:]:\n"
            "    s = importlib.util.spec_from_file_location('ex', p)\n"
            "    s.loader.exec_module(importlib.util.module_from_spec(s))\n"
            "bad = [m for m in sys.modules if m in ('jax', 'repro')"
            " or m.startswith(('jax.', 'repro.'))]\n"
            "print(bad); sys.exit(1 if bad else 0)")
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    proc = subprocess.run([sys.executable, "-c", code, *map(str, paths)], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    for path in paths:
        text = path.read_text()
        for bad in ("import repro.", "from repro.", "from repro import", "import jax"):
            assert bad not in text, f"{path} contains {bad!r}"
