"""Packaging smoke tests — the framework must install and import outside
the repo root (reference install metadata:
``/root/reference/Project.toml:1-14``)."""
import os
import subprocess
import sys

import pytest

# the package itself supports 3.10; only this test module needs tomllib
tomllib = pytest.importorskip("tomllib", reason="stdlib tomllib (3.11+)")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pyproject():
    with open(os.path.join(ROOT, "pyproject.toml"), "rb") as f:
        return tomllib.load(f)


@pytest.mark.smoke
def test_pyproject_metadata_well_formed():
    meta = _pyproject()
    proj = meta["project"]
    assert proj["name"] == "differentialdynamicprogramming-jl-tpu"
    import differentialdynamicprogramming_jl_tpu as pkg
    assert proj["version"] == pkg.__version__
    assert any(d.startswith("jax") for d in proj["dependencies"])
    # every console script must point at an importable attribute
    import importlib
    for target in proj.get("scripts", {}).values():
        mod, _, attr = target.partition(":")
        assert hasattr(importlib.import_module(mod), attr), target


@pytest.mark.smoke
def test_demos_cli_entry():
    from differentialdynamicprogramming_jl_tpu.demos import main
    assert main(["--help"]) == 0
    assert main(["no-such-demo"]) == 2


def test_wheel_builds_and_imports_from_temp_cwd(tmp_path):
    """Build a wheel (no network: --no-build-isolation) and import the
    package from a scratch cwd off an installed-style sys.path entry —
    the 'works outside /root/repo' guarantee."""
    r = subprocess.run(
        [sys.executable, "-m", "pip", "wheel", ROOT, "--no-deps",
         "--no-build-isolation", "-w", str(tmp_path)],
        capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    wheels = list(tmp_path.glob("differentialdynamicprogramming*.whl"))
    assert len(wheels) == 1, list(tmp_path.iterdir())
    # unpack the wheel and import from it in a clean subprocess whose cwd
    # is NOT the repo root and whose sys.path contains only the unpacked
    # wheel ahead of the stdlib (editable-install shadowing excluded by
    # deleting the repo path entries).
    import zipfile
    unpack = tmp_path / "site"
    with zipfile.ZipFile(wheels[0]) as z:
        z.extractall(unpack)
    code = (
        "import sys; "
        f"sys.path = [p for p in sys.path if not p.startswith({ROOT!r})]; "
        f"sys.path.insert(0, {str(unpack)!r}); "
        "import differentialdynamicprogramming_jl_tpu as d; "
        f"assert d.__file__.startswith({str(unpack)!r}), d.__file__; "
        "print(d.__version__)")
    r2 = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                        capture_output=True, text=True, timeout=300)
    assert r2.returncode == 0, r2.stderr[-2000:]
    assert r2.stdout.strip() == "0.1.0"
