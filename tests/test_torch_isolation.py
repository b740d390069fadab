"""The port stands alone: no JAX and nothing of ``repro`` inside it, its
entry points refuse to fall back to the CPU, and its kernel wrappers
never hand a non-CPU request to the plain version."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.configs.registry import get_reduced
from repro_torch.core.engine import InferenceEngine
from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels import ops
from repro_torch.models import transformer as T

ROOT = Path(__file__).resolve().parents[1]
PKG = Path(repro_torch.__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_imports_no_jax_and_nothing_of_repro():
    files = _port_files()
    assert len(files) > 20
    bad = [(f.relative_to(ROOT), m) for f in files
           for m in _imported_roots(f) if m in FORBIDDEN]
    assert bad == []


def test_every_module_imports_without_jax():
    mods = [".".join(("repro_torch",) + p.relative_to(PKG).with_suffix("")
                     .parts).removesuffix(".__init__")
            for p in sorted(PKG.rglob("*.py"))]
    code = ("import sys, importlib\n"
            "for name in ('jax', 'jaxlib', 'repro'):\n"
            "    sys.modules[name] = None\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_engine_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    cfg = get_reduced("unimo-text")
    params = T.init_params(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceEngine(cfg, params)


def _decode_inputs(device):
    P, page, H, D = 4, 8, 2, 16

    def z(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)
    return (z(2, 1, H, D), z(P, page, H, D), z(P, page, H, D),
            z(P, page, dtype=torch.int32), z(2, 2, dtype=torch.int32),
            z(2, 1, dtype=torch.int32))


@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_kernel_wrappers_refuse_non_cuda_tensors(device):
    """A non-CPU tensor that is not on the card goes to the CUDA wrapper
    through ``ops`` and raises; the wrapper itself refuses CPU tensors.
    Neither returns the plain result, and no launch is counted."""
    before = DA.launch_counts()
    args = _decode_inputs(device)
    kw = dict(window=None, scale=0.25)
    meta = torch.zeros((3, 4), dtype=torch.int32, device=device)
    with pytest.raises(ValueError, match="CUDA tensors"):
        if device == "meta":
            ops.paged_decode_attention(*args, **kw)
        else:
            DA.paged_decode_attention(*args, **kw)
    q = args[0].reshape(1, 2, *args[0].shape[2:])
    packed = (q, *args[1:5], args[5].reshape(1, 2))
    with pytest.raises(ValueError, match="CUDA tensors"):
        if device == "meta":
            ops.paged_packed_attention(
                *packed, torch.zeros(2, dtype=torch.int32, device=device),
                meta, **kw)
        else:
            DA.paged_packed_attention(*packed, meta, **kw)
    assert DA.launch_counts() == before


def test_cpu_dispatch_uses_the_plain_version():
    args = _decode_inputs("cpu")
    out = ops.paged_decode_attention(*args, window=None, scale=0.25)
    ref = DA.paged_decode_attention_ref(*args, window=None, scale=0.25)
    np.testing.assert_array_equal(out.numpy(), ref.numpy())
    assert DA.launch_counts() == {"paged_decode_attention": 0,
                                  "paged_packed_attention": 0}
