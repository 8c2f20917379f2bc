"""The PyTorch port stands alone.

``import repro_torch`` (every module of it) leaves JAX and the JAX package
out of ``sys.modules``; no file of the port, nor ``chip_smoke.py`` or
``tools/``, imports ``jax`` or ``repro``; the kernel wrappers hold no
fallback route and call no finished attention kernel; ``chip_smoke.py``
refuses to run without a card; and the serving launcher runs end to end on
the CPU when asked to.
"""

import ast
import json
import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN_ROOTS = {"jax", "jaxlib", "repro"}


def _port_files():
    return (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
            + sorted((ROOT / "tools").glob("*.py")))


def _imported_roots(tree: ast.AST):
    """Top-level package of every import, including ``importlib.import_module``
    and ``__import__`` calls on a literal name."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and node.args and \
                isinstance(node.args[0], ast.Constant) and \
                isinstance(node.args[0].value, str):
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else getattr(fn, "id", "")
            if name in ("import_module", "__import__"):
                yield node.args[0].value.split(".")[0]


def test_no_port_file_imports_jax_or_repro():
    bad = []
    for path in _port_files():
        tree = ast.parse(path.read_text(), filename=str(path))
        bad += [f"{path.relative_to(ROOT)}: {root}" for root in _imported_roots(tree)
                if root in FORBIDDEN_ROOTS]
    assert bad == []


def test_importing_every_port_module_leaves_jax_out():
    code = (
        "import json, pkgutil, importlib, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(json.dumps({'bad': bad, 'n': sum(n.startswith('repro_torch') for n in sys.modules)}))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bad"] == []
    assert res["n"] > 20                      # every subpackage was reached


def test_kernel_wrappers_have_no_fallback_or_library_kernel():
    """A CUDA tensor launches the kernel or raises: no ``try`` in a kernel
    module, and no SDPA, cuDNN or ``torch.compile`` anywhere in the port."""
    for path in sorted((PORT / "kernels").glob("*.py")):
        tree = ast.parse(path.read_text())
        assert not any(isinstance(n, ast.Try) for n in ast.walk(tree)), path.name
    for path in sorted(PORT.rglob("*.py")):
        tree = ast.parse(path.read_text())
        for n in ast.walk(tree):
            if isinstance(n, ast.Attribute):
                assert n.attr not in ("scaled_dot_product_attention", "cudnn"), path.name
                assert not (n.attr == "compile" and isinstance(n.value, ast.Name)
                            and n.value.id == "torch"), path.name


def test_chip_smoke_refuses_without_a_card_or_a_checkout(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py would run for real")
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"),
                        (tmp_path, shutil.copy(ROOT / "chip_smoke.py", tmp_path))):
        out = subprocess.run([sys.executable, str(script)], cwd=cwd, capture_output=True,
                             text=True, timeout=120, env=dict(os.environ, PYTHONPATH=""))
        assert out.returncode != 0
        assert '"ok"' not in out.stdout


def test_serve_launcher_runs_on_cpu(capsys):
    from repro_torch.launch import serve

    serve.main(["--arch", "llama3-8b", "--smoke", "--device", "cpu", "--requests", "3",
                "--slots", "2", "--max-new-tokens", "4", "--prompt-len", "32",
                "--shared-prefix", "16"])
    out = capsys.readouterr().out
    assert "kv_layout=paged device=cpu" in out
    assert out.count("finish=length") == 3
    assert "3 done" in out


@pytest.mark.parametrize("flags", [["--kv-dtype", "int8"], ["--mesh", "2"],
                                   ["--host-pool-bytes", "4096"]])
def test_serve_launcher_rejects_unported_options(flags):
    from repro_torch.launch import serve

    with pytest.raises(NotImplementedError, match="ROADMAP"):
        serve.main(["--arch", "llama3-8b", "--smoke", "--device", "cpu", *flags])
