"""Precision policy (the port's counterpart of ``repro.core.precision``).

A policy is three dtypes — ``param_dtype`` (weight storage),
``compute_dtype`` (activations and matmuls) and ``output_dtype``
(logits, fp32 for a stable softmax) — plus two storage axes for serving,
``kv_dtype`` and ``weights_dtype``.  The port serves ``kv_dtype`` at the
compute dtype ("auto", "bf16", "fp16") and ``weights_dtype="auto"``;
the int8 storage modes are later slices of the port and raise here.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

KV_DTYPES = ("auto", "bf16", "fp16", "int8")
WEIGHTS_DTYPES = ("auto", "bf16", "fp16", "int8")


def kv_store_dtype(kv_dtype: str, compute_dtype) -> torch.dtype:
    """Resolve a ``Policy.kv_dtype`` name to the paged pool's storage
    dtype."""
    if kv_dtype not in KV_DTYPES:
        raise ValueError(f"unknown kv_dtype {kv_dtype!r}; "
                         f"one of {list(KV_DTYPES)}")
    if kv_dtype == "int8":
        raise NotImplementedError(
            "kv_dtype='int8' (quantized KV pages) is not ported yet")
    return {"auto": compute_dtype, "bf16": torch.bfloat16,
            "fp16": torch.float16}[kv_dtype]


def _tensor_bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def compress_weights(params, policy: "Policy"):
    """Apply ``policy.weights_dtype`` to the dense serve-path weights.

    Only ``"auto"`` is ported: the parameters pass through unchanged and
    ``stats`` reports the serve-path matmul bytes under the same keys as
    the reference (attention qkv/out, dense FFN, tied unembedding).
    """
    wd = policy.weights_dtype
    if wd not in WEIGHTS_DTYPES:
        raise ValueError(f"unknown weights_dtype {wd!r}; "
                         f"one of {list(WEIGHTS_DTYPES)}")
    if wd != "auto":
        raise NotImplementedError(
            f"weights_dtype={wd!r} is not ported yet (only 'auto')")
    dense = sum(_tensor_bytes(w)
                for layer in params["layers"]
                for block in ("attn", "ffn")
                for w in layer[block].values())
    dense += _tensor_bytes(params["embed"]["tokens"])
    return params, {"weights_dtype": wd, "weight_bytes": dense,
                    "weight_bytes_dense": dense, "weight_bytes_saved": 0,
                    "n_quantized": 0}


def map_params(fn, tree):
    """Apply ``fn`` to every tensor of a (nested dict / list) param tree."""
    if isinstance(tree, dict):
        return {k: map_params(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_params(fn, v) for v in tree]
    return fn(tree)


@dataclass(frozen=True)
class Policy:
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32
    output_dtype: torch.dtype = torch.float32
    kv_dtype: str = "auto"
    weights_dtype: str = "auto"

    def cast_params(self, params):
        """Cast a parameter tree's floating tensors to ``param_dtype``."""
        return map_params(
            lambda p: p.to(self.param_dtype) if p.is_floating_point() else p,
            params)

    def output_cast(self, x):
        return x.to(self.output_dtype)

    def kv_cache_dtype(self) -> torch.dtype:
        return kv_store_dtype(self.kv_dtype, self.compute_dtype)


FP32 = Policy()
BF16 = Policy(torch.bfloat16, torch.bfloat16, torch.float32)
FP16 = Policy(torch.float16, torch.float16, torch.float32)

_POLICIES = {"fp32": FP32, "bf16": BF16, "fp16": FP16}


def get_policy(name: str) -> Policy:
    try:
        return _POLICIES[name]
    except KeyError:
        raise ValueError(f"unknown policy {name!r}; one of {list(_POLICIES)}")
