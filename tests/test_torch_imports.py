"""The port stands alone: no jax, nothing of the reference package, and no
quiet move to the CPU."""
from __future__ import annotations

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_port_file_imports_jax_or_the_reference():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 15
    bad = {str(f.relative_to(REPO)): sorted(set(_imported_roots(f))
                                            & set(FORBIDDEN))
           for f in files}
    assert {f: m for f, m in bad.items() if m} == {}


def test_importing_the_port_loads_neither_jax_nor_the_reference():
    code = (
        "import pkgutil, sys, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):"
        "\n    __import__(m.name)\n"
        "import repro_torch.launch.cnn_serve, repro_torch.launch.serve\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "for m in ('perfmodel.calibration', 'kernels.pool.ops', "
        "'kernels.transpose.ops', 'configs.paper_table1', "
        "'perfmodel.traffic', 'kernels.conv.backward', "
        "'kernels.pool.backward', 'kernels.matmul.ops', "
        "'kernels.flash_attention.ops', 'kernels.crossentropy.ops', "
        "'configs.registry', 'configs.qwen2_7b', 'configs.gemma2_27b', "
        "'configs.whisper_base', 'runtime.resilience', "
        "'runtime.fault_tolerance', 'checkpoint.checkpointer', "
        "'distributed.cnn_mesh', 'models.layers', 'models.transformer', "
        "'models.registry', 'models.convert', 'train.steps', "
        "'launch.serve'):\n"
        "    assert 'repro_torch.' + m in sys.modules, m\n"
        "print(len([m for m in sys.modules if m.startswith('repro_torch')]))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=str(REPO), timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert int(out.stdout.split()[-1]) > 15


def test_server_without_a_card_raises_instead_of_using_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.launch.cnn_serve import CNNServer
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CNNServer()
