"""The port stands alone: no module of pt2tpu_torch/, no line of
chip_smoke.py and no line of tests/torch_tp_worker.py (what each rank of the
tensor-parallel tests runs) imports JAX or the JAX package, and the package imports on a
machine without CUDA, nvcc or triton.

The check is an AST scan, not a look at sys.modules: the test process (and
this container's interpreter start-up) imports jax before any test runs."""

import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "pt2tpu")


def _port_files():
    # chip_smoke.py and the helper each rank of the tensor-parallel tests runs
    out = [os.path.join(ROOT, "chip_smoke.py"), os.path.join(ROOT, "tests", "torch_tp_worker.py")]
    for d, _, files in os.walk(os.path.join(ROOT, "pt2tpu_torch")):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in FORBIDDEN  # "pt2tpu_torch" is its own top-level name


def _imports(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node.lineno, a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module
        elif (
            isinstance(node, ast.Call)
            and getattr(node.func, "attr", getattr(node.func, "id", "")) in
            ("import_module", "__import__")
            and node.args
            and isinstance(node.args[0], ast.Constant)
            and isinstance(node.args[0].value, str)
        ):
            yield node.lineno, node.args[0].value


def test_scan_covers_the_port():
    files = _port_files()
    assert os.path.exists(files[0]) and len(files) > 10


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_reference_import(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    bad = [(ln, m) for ln, m in _imports(tree) if _forbidden(m)]
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


def test_forbidden_rule():
    assert _forbidden("jax.numpy") and _forbidden("pt2tpu.core.packing")
    assert not _forbidden("pt2tpu_torch.core") and not _forbidden("torch")


def test_import_needs_no_cuda_or_triton():
    code = (
        "import sys, torch\n"
        "import pt2tpu_torch, pt2tpu_torch.cli, pt2tpu_torch.ops.kernels.ternary\n"
        "import pt2tpu_torch.serve, pt2tpu_torch.ops.kernels.attention\n"
        "import pt2tpu_torch.parallel, pt2tpu_torch.utils.profiling, pt2tpu_torch.utils.debug\n"
        "assert 'triton' not in sys.modules\n"
        "assert not torch.cuda.is_initialized()\n"
        "print('ok')\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    """Without the CUDA toolkit the build raises; nothing falls back."""
    from pt2tpu_torch.ops.kernels import _build

    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))  # no bin/nvcc there
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "kernels"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build("ternary_matmul")


def test_quantizer_modules_import_without_cuda():
    """The quantizer, data and metrics modules import on a machine without
    a GPU and initialise nothing of CUDA."""
    code = (
        "import sys, torch\n"
        "import pt2tpu_torch.core.ternary, pt2tpu_torch.core.ssr, pt2tpu_torch.quant\n"
        "import pt2tpu_torch.quant.pipeline, pt2tpu_torch.data, pt2tpu_torch.utils.metrics\n"
        "assert 'triton' not in sys.modules and 'jax' not in sys.modules\n"
        "assert not torch.cuda.is_initialized()\n"
        "print('ok')\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")
