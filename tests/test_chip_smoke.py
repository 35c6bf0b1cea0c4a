"""chip_smoke.py must refuse to run without a GPU: a non-zero exit code and
no result line, both in the checkout and alone in a directory."""
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _run(cwd, *args):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "chip_smoke.py", *args], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


@pytest.mark.parametrize("args", [(), ("--four",)])
def test_fails_without_gpu(args):
    out = _run(ROOT, *args)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "no GPU" in out.stderr


def test_fails_alone_in_a_directory(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _run(tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
