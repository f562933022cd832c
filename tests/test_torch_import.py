"""The port stands alone: no module of ``repro_torch``, and not
``chip_smoke.py``, imports jax or anything of the JAX package ``repro``."""
import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
PKG = os.path.join(ROOT, "src", "repro_torch")


def _port_modules() -> list[str]:
    mods = []
    for dirpath, dirnames, filenames in os.walk(PKG):
        dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
        for f in sorted(filenames):
            if not f.endswith(".py"):
                continue
            rel = os.path.relpath(os.path.join(dirpath, f),
                                  os.path.join(ROOT, "src"))[:-3]
            parts = rel.split(os.sep)
            if parts[-1] == "__init__":
                parts = parts[:-1]
            mods.append(".".join(parts))
    return mods


def _scanned_files() -> list[str]:
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, filenames in os.walk(PKG):
        files += [os.path.join(dirpath, f) for f in filenames
                  if f.endswith(".py")]
    return sorted(files)


def test_importing_every_port_module_loads_no_jax():
    mods = _port_modules()
    assert "repro_torch.launch.serve" in mods and len(mods) > 20
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'repro' or m.startswith('repro.'))\n"
        "print('BAD', bad)\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "BAD []" in proc.stdout, proc.stdout


@pytest.mark.parametrize("path", _scanned_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_repro_import_in_source(path):
    tree = ast.parse(open(path, encoding="utf-8").read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "repro"), (
                f"{os.path.relpath(path, ROOT)}:{node.lineno} imports {name}")


def test_port_is_lint_clean_against_the_reference_protocols():
    """swarmlint over the port alone, with the reference modules that
    define the ``Transport`` protocol and the schedule registry in scope:
    the port's ``InProcessTransport`` is held to the whole protocol surface
    (a full ``src`` scan sees the reference's class of the same name
    first), its key literals stay in its ``keys.py``, and it has no
    pickle or eval."""
    from repro.analysis import ALL_RULES
    from repro.analysis.framework import load_paths, run_rules

    modules = load_paths([PKG,
                          os.path.join(ROOT, "src/repro/api/transport.py"),
                          os.path.join(ROOT, "src/repro/core/pipeline.py")],
                         root=ROOT)
    findings = run_rules(modules, [rule() for rule in ALL_RULES])
    assert not findings, "\n".join(f.render() for f in findings)
