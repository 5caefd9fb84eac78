"""The port stands alone: no JAX and nothing of the reference package in
``src/repro_torch/`` or ``chip_smoke.py``; its entry points raise on a
CUDA device when there is no card; its kernel module imports without
``nvcc``."""
import ast
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]


def imported_modules(path: pathlib.Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_and_no_reference_imports(path):
    for name in imported_modules(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path}: {name}"


def test_port_imports_without_jax_or_reference():
    """Every port module imports in a process where importing JAX or the
    reference package fails."""
    modules = [".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
               for p in PORT_FILES[:-1]]
    code = ("import sys\n"
            "for m in ('jax', 'repro'): sys.modules[m] = None\n"
            "import importlib\n"
            f"for m in {modules!r}: importlib.import_module(m)\n")
    subprocess.run([sys.executable, "-c", code], check=True,
                   cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"),
                                  "PATH": "/usr/bin:/bin"})


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")


def test_entry_points_raise_without_a_card(no_card):
    from repro_torch.configs import get_config
    from repro_torch.launch import serve, train
    from repro_torch.models.transformer import (DenseLM, HybridLM, MambaLM,
                                                build_model)
    cfg = get_config("smollm-135m").reduced()
    ssm = get_config("mamba2-1.3b").reduced()
    hybrid = get_config("zamba2-2.7b").reduced()
    for make in (lambda: DenseLM(cfg), lambda: build_model(cfg),
                 lambda: MambaLM(ssm), lambda: build_model(ssm),
                 lambda: HybridLM(hybrid), lambda: build_model(hybrid),
                 lambda: serve.main(["--reduced", "--requests", "1"]),
                 lambda: train.main(["--reduced", "--steps", "1",
                                     "--ckpt-every", "0"])):
        with pytest.raises(RuntimeError, match="cuda"):
            make()


def test_kernel_build_needs_nvcc(monkeypatch, tmp_path):
    from repro_torch.kernels import (build, decode_attention, flash_attention,
                                     ssd_scan)
    assert decode_attention.decode_attention.launches >= 0
    assert ssd_scan.ssd_scan_fwd.launches >= 0
    assert flash_attention.flash_attention_fwd.launches >= 0
    assert flash_attention.flash_attention_bwd.launches >= 0
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc()
