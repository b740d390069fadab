"""The port's int8 weights (``weights_dtype="int8"``) against the
reference.

``quantize_weights`` is bit-equal to the reference's on equal input (the
same fp32 division and round-half-to-even), and ``compress_weights``
reports the same byte counts.  Its ``n_quantized`` counts one record per
layer and weight where the reference counts one per stacked pattern
position (a record there holds every repeat of the stack).  The plain
``quant_matmul_ref`` sums the same fp32 products as the reference's
Pallas kernel (interpret mode) in another order: 1e-5 of the output's
largest magnitude.

Int8-weight serve streams are held against the reference's int8-weight
streams, not against fp32: the two storage modes give different greedy
streams in either package.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_reduced as j_get_reduced
from repro.core import precision as JP
from repro.kernels import quant_matmul as JQM
from repro.models import transformer as JT
from repro_torch import bridge
from repro_torch.configs.registry import get_reduced
from repro_torch.core import precision as PR
from repro_torch.core.precision import FP32
from repro_torch.kernels import ops
from repro_torch.kernels import ref as REF
from test_torch_qwen3 import model, serve_both  # noqa: F401

W8 = dataclasses.replace(FP32, weights_dtype="int8")
J_W8 = dataclasses.replace(JP.FP32, weights_dtype="int8")


@pytest.mark.parametrize("shape", [(64, 48), (2, 33, 7)])
def test_quantize_weights_bit_equal_to_reference(shape):
    rng = np.random.default_rng(0)
    w = rng.normal(size=shape).astype(np.float32)
    w[..., 3] = 0.0                                   # an all-zero column
    w[..., 1] *= 1e-3
    rec = PR.quantize_weights(torch.from_numpy(w))
    jrec = JP.quantize_weights(jnp.asarray(w))
    assert rec["q"].dtype == torch.int8 and rec["q"].is_contiguous()
    for k in ("q", "s"):
        np.testing.assert_array_equal(rec[k].numpy(), np.asarray(jrec[k]))
    assert (rec["s"][..., 3] == 0).all()
    np.testing.assert_array_equal(
        PR.dequantize_weights(rec).numpy(),
        np.asarray(JP.dequantize_weights(jrec)))
    # a transposed view quantizes to contiguous codes all the same
    t = PR.quantize_weights(torch.from_numpy(w).transpose(-1, -2))
    assert t["q"].is_contiguous()


@pytest.mark.parametrize("arch,mode", [("qwen3-4b", "int8"),
                                       ("unimo-text", "int8"),
                                       ("qwen3-4b", "bf16"),
                                       ("qwen3-4b", "auto")])
def test_compress_weights_matches_reference(arch, mode):
    jcfg = j_get_reduced(arch)
    jparams = JT.init_params(jax.random.PRNGKey(1), jcfg, JP.FP32)
    params = bridge.params_from_jax(jax.tree.map(np.asarray, jparams))
    jnew, jstats = JP.compress_weights(
        jparams, dataclasses.replace(JP.FP32, weights_dtype=mode))
    new, stats = PR.compress_weights(
        params, dataclasses.replace(FP32, weights_dtype=mode))
    for k in ("weights_dtype", "weight_bytes", "weight_bytes_dense",
              "weight_bytes_saved"):
        assert stats[k] == jstats[k], k
    # a tied head gets its int8 copy only under "int8"
    n_layers = get_reduced(arch).num_layers
    per_layer = 7 if arch == "qwen3-4b" else 6
    head = int(mode == "int8")
    assert jstats["n_quantized"] == (0 if mode == "auto"
                                     else per_layer + head)
    assert stats["n_quantized"] == (0 if mode == "auto"
                                    else per_layer * n_layers + head)
    if mode != "int8":
        return
    # the same records, layer by layer, and the tied head's (d, V) copy
    mine = bridge.params_from_jax(jax.tree.map(np.asarray, jnew))
    assert set(new["embed"]) == set(params["embed"]) | {"head_q8"}
    assert tuple(new["embed"]["head_q8"]["q"].shape) == (
        jcfg.d_model, jcfg.vocab_size)
    for a, b in zip(new["layers"], mine["layers"]):
        for blk in ("attn", "ffn"):
            for k, rec in a[blk].items():
                if PR.is_quantized_weight(rec):
                    for f in ("q", "s"):
                        np.testing.assert_array_equal(
                            rec[f].numpy(), b[blk][k][f].numpy())
    for f in ("q", "s"):
        np.testing.assert_array_equal(new["embed"]["head_q8"][f].numpy(),
                                      mine["embed"]["head_q8"][f].numpy())
    # the caller's tree is left as it was
    assert not PR.is_quantized_weight(params["layers"][0]["attn"]["wq"])


@pytest.mark.parametrize("lead,K,N", [((4,), 256, 128), ((3,), 100, 130),
                                      ((2, 3), 64, 48), ((1, 1), 33, 300)])
def test_quant_matmul_ref_matches_reference_kernel(lead, K, N):
    rng = np.random.default_rng(K + N)
    x = rng.normal(size=lead + (K,)).astype(np.float32)
    q = rng.integers(-127, 128, size=(K, N)).astype(np.int8)
    s = rng.uniform(0, 0.02, size=N).astype(np.float32)
    ours = ops.quant_matmul(torch.from_numpy(x), torch.from_numpy(q),
                            torch.from_numpy(s))
    ref = np.asarray(JQM.quant_matmul(jnp.asarray(x), jnp.asarray(q),
                                      jnp.asarray(s), interpret=True))
    assert ours.dtype == torch.float32 and ours.shape == ref.shape
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())
    np.testing.assert_array_equal(
        ours.numpy(), REF.quant_matmul_ref(torch.from_numpy(x),
                                           torch.from_numpy(q),
                                           torch.from_numpy(s)).numpy())


@pytest.mark.parametrize("kind,kv_dtype", [("mixed", "auto"),
                                           ("shared", "int8")])
def test_int8_weight_streams_match_reference(model, kind, kv_dtype):  # noqa: F811,E501
    """Reduced qwen3-4b with int8 weights (on the shared-prefix trace with
    int8 pools too) in both packages: the greedy streams are equal token
    for token, and the run reports the compressed weight bytes."""
    ref, ours, m = serve_both(
        model, dataclasses.replace(W8, kv_dtype=kv_dtype),
        dataclasses.replace(J_W8, kv_dtype=kv_dtype), kind)
    assert m.weight_dtype == "int8" and m.weight_bytes_saved > 0
    assert m.kv_dtype == kv_dtype
    assert ours == ref
