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
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops
from repro_torch.kernels import quant_matmul as QM
from repro_torch.kernels import ref
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
    names = {f.relative_to(PKG).as_posix() for f in files if PKG in f.parents}
    assert {"kernels/quant_matmul.py", "configs/qwen3_4b.py",
            "kernels/decode_attention.py", "core/precision.py",
            "kernels/flash_attention.py", "core/speculative.py",
            "training/optimizer.py", "training/train_loop.py",
            "training/checkpoint.py", "launch/train.py",
            "data/pipeline.py"} <= names
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


@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_flash_backward_wrapper_refuses_non_cuda_tensors(device):
    """The flash backward wrapper raises for a non-CUDA tensor, and the
    forward wrapper does so with ``return_lse`` too; no launch."""
    z = torch.zeros(2, 3, 2, 16, device=device)
    pos = torch.zeros(2, 3, dtype=torch.int32, device=device)
    lse = torch.zeros(2, 2, 3, device=device)
    with pytest.raises(ValueError, match="CUDA tensors"):
        FA.flash_attention_bwd(z, z, z, pos, pos, z, lse, z, window=None,
                               scale=0.25)
    with pytest.raises(ValueError, match="CUDA tensors"):
        FA.flash_attention(z, z, z, pos, pos, window=None, scale=0.25,
                           return_lse=True)
    assert _no_launches()


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


def _no_launches():
    return all(n == 0 for n in ops.launch_counts().values())


def test_cpu_dispatch_uses_the_plain_version():
    args = _decode_inputs("cpu")
    out = ops.paged_decode_attention(*args, window=None, scale=0.25)
    ref_out = DA.paged_decode_attention_ref(*args, window=None, scale=0.25)
    np.testing.assert_array_equal(out.numpy(), ref_out.numpy())
    assert _no_launches()


def test_cpu_dispatch_of_int8_paths_uses_the_plain_versions():
    """Int8 pools and int8 weight records on the CPU go to the plain
    versions (no launch is counted) and give their exact results."""
    rng = np.random.default_rng(0)
    q, kp, vp, ppos, bt, qp = _decode_inputs("cpu")
    q = torch.from_numpy(rng.normal(size=q.shape).astype(np.float32))
    codes = torch.from_numpy(rng.integers(-127, 128, size=kp.shape).astype(
        np.int8))
    sc = torch.rand(kp.shape[:3])
    ppos[0, :3] = torch.arange(3)
    qp[:] = 2
    kw = dict(window=None, scale=0.25, k_scale=sc, v_scale=sc)
    out = ops.paged_decode_attention(q, codes, codes, ppos, bt, qp, **kw)
    np.testing.assert_array_equal(
        out.numpy(), ref.paged_decode_attention_ref(
            q, codes, codes, ppos, bt, qp, **kw).numpy())
    sid = torch.zeros(2, dtype=torch.int32)
    meta = torch.zeros((3, 4), dtype=torch.int32)
    out = ops.paged_packed_attention(q.reshape(1, 2, *q.shape[2:]), codes,
                                     codes, ppos, bt, qp.reshape(1, 2), sid,
                                     meta, **kw)
    assert out.shape == (1, 2) + q.shape[2:] and out.abs().sum() > 0
    x = torch.randn(3, 16)
    w = torch.randint(-127, 128, (16, 8), dtype=torch.int8)
    s = torch.rand(8)
    np.testing.assert_array_equal(ops.quant_matmul(x, w, s).numpy(),
                                  ((x @ w.float()) * s).numpy())
    assert _no_launches()


@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_int8_kernel_wrappers_refuse_non_cuda_tensors(device):
    """The q8 attention wrappers and quant_matmul raise for a non-CUDA
    tensor, through ``ops`` (meta) or called directly (CPU), and count
    no launch."""
    q, kp, vp, ppos, bt, qp = _decode_inputs(device)
    codes = kp.to(torch.int8)
    sc = torch.zeros(kp.shape[:3], device=device)
    kw = dict(window=None, scale=0.25)
    x = torch.zeros(3, 16, device=device)
    w = torch.zeros(16, 8, dtype=torch.int8, device=device)
    s = torch.zeros(8, device=device)
    with pytest.raises(ValueError, match="CUDA tensors"):
        if device == "meta":
            ops.paged_decode_attention(q, codes, codes, ppos, bt, qp,
                                       k_scale=sc, v_scale=sc, **kw)
        else:
            DA.paged_decode_attention_q8(q, codes, sc, codes, sc, ppos, bt,
                                         qp, **kw)
    with pytest.raises(ValueError, match="CUDA tensors"):
        if device == "meta":
            ops.quant_matmul(x, w, s)
        else:
            QM.quant_matmul(x, w, s)
    assert _no_launches()


@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_mixed_and_flash_wrappers_refuse_non_cuda_tensors(device):
    """The mixed attention wrappers (both pool types) and the flash wrapper
    raise for a non-CUDA tensor, through ``ops`` (meta) or called
    directly (CPU), and count no launch."""
    q, kp, vp, ppos, bt, _ = _decode_inputs(device)
    q = q.reshape(1, 2, *q.shape[2:]).expand(2, 2, *q.shape[2:])
    qp = torch.zeros(2, 2, dtype=torch.int32, device=device)
    codes = kp.to(torch.int8)
    sc = torch.zeros(kp.shape[:3], device=device)
    kw = dict(window=None, scale=0.25)
    with pytest.raises(ValueError, match="CUDA tensors"):
        if device == "meta":
            ops.paged_mixed_attention(q, kp, vp, ppos, bt, qp, **kw)
        else:
            DA.paged_mixed_attention(q, kp, vp, ppos, bt, qp, **kw)
    with pytest.raises(ValueError, match="CUDA tensors"):
        if device == "meta":
            ops.paged_mixed_attention(q, codes, codes, ppos, bt, qp,
                                      k_scale=sc, v_scale=sc, **kw)
        else:
            DA.paged_mixed_attention_q8(q, codes, sc, codes, sc, ppos, bt,
                                        qp, **kw)
    k = torch.zeros(2, 3, 2, 16, device=device)
    kpos = torch.zeros(2, 3, dtype=torch.int32, device=device)
    with pytest.raises(ValueError, match="CUDA tensors"):
        if device == "meta":
            ops.flash_attention(q, k, k, qp, kpos, **kw)
        else:
            FA.flash_attention(q, k, k, qp, kpos, **kw)
    assert _no_launches()


def test_cpu_dispatch_of_mixed_and_flash_uses_the_plain_versions():
    rng = np.random.default_rng(1)
    q, kp, vp, ppos, bt, _ = _decode_inputs("cpu")
    q = torch.from_numpy(rng.normal(size=(2, 3, 2, 16)).astype(np.float32))
    kp = torch.from_numpy(rng.normal(size=kp.shape).astype(np.float32))
    ppos[0, :5] = torch.arange(5)
    qp = torch.tensor([[2, 3, 4], [-1, -1, -1]], dtype=torch.int32)
    out = ops.paged_mixed_attention(q, kp, kp, ppos, bt, qp, window=None,
                                    scale=0.25)
    np.testing.assert_array_equal(out.numpy(), ref.paged_mixed_attention_ref(
        q, kp, kp, ppos, bt, qp, window=None, scale=0.25).numpy())
    assert out[0].abs().sum() > 0 and not out[1].any()
    k = torch.from_numpy(rng.normal(size=(2, 3, 2, 16)).astype(np.float32))
    out = ops.flash_attention(q, k, k, qp, qp, window=None, scale=0.25)
    np.testing.assert_array_equal(out.numpy(), ref.flash_attention_ref(
        q, k, k, qp, qp, window=None, scale=0.25).numpy())
    assert _no_launches()


@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_mlstm_rmsnorm_and_dense_decode_wrappers_refuse_non_cuda(device):
    """The three wrappers of this kind raise for a non-CUDA tensor,
    through ``ops`` (meta) or called directly (CPU), and count no
    launch."""
    from repro_torch.kernels import mlstm_chunk as MC
    from repro_torch.kernels import rmsnorm as RN

    def z(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)
    seq, gates = z(1, 4, 2, 8), z(1, 4, 2)
    state = {"C": z(1, 2, 8, 8), "n": z(1, 2, 8), "m": z(1, 2)}
    q, k = z(2, 1, 4, 16), z(2, 5, 2, 16)
    kp, qp = z(2, 5, dtype=torch.int32), z(2, 1, dtype=torch.int32)
    calls = [(ops.mlstm_chunked, MC.mlstm_chunked,
              (seq, seq, seq, gates, gates, state), {}),
             (ops.rmsnorm, RN.fused_rmsnorm, (z(3, 16), z(16)), {}),
             (ops.decode_attention, DA.decode_attention, (q, k, k, kp, qp),
              dict(window=None, scale=0.25))]
    for via_ops, direct, args, kw in calls:
        with pytest.raises(ValueError, match="CUDA tensors"):
            (via_ops if device == "meta" else direct)(*args, **kw)
    assert _no_launches()
