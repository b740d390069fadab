"""Precision policy (the port's counterpart of ``repro.core.precision``).

A policy is three dtypes — ``param_dtype`` (weight storage),
``compute_dtype`` (activations and matmuls) and ``output_dtype``
(logits, fp32 for a stable softmax) — plus two storage axes for serving.
``MIXED`` ("mixed") is the training policy: fp32 master weights, bf16
compute, fp32 logits (the reference's ``MIXED_TRAIN``).  The serving
axes:

  * ``kv_dtype`` — "auto" (= compute dtype), "bf16", "fp16" or "int8".
    int8 stores the paged K/V pages as int8 codes with per-entry,
    per-kv-head fp32 absmax scales in parallel scale pools
    (``kv_cache.quantize_kv``); the dense per-slot cache of
    ``generate_batch`` has no scale pools and keeps the compute dtype
    (:meth:`Policy.kv_cache_dtype`).
  * ``weights_dtype`` — storage of the dense serve-path matmul weights
    (attention qkv/out projections, dense FFNs, the unembedding head).
    "auto" keeps ``param_dtype``; "int8" quantizes each weight at load
    into int8 codes + per-output-channel fp32 absmax scales
    (:func:`quantize_weights`), and matmuls against such a record go to
    ``kernels.ops.quant_matmul``.  Tied-embedding models get a separate
    int8 copy of the transposed table for the unembedding (``head_q8``);
    the gather table itself stays full precision.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

KV_DTYPES = ("auto", "bf16", "fp16", "int8")
WEIGHTS_DTYPES = ("auto", "bf16", "fp16", "int8")


def kv_store_dtype(kv_dtype: str, compute_dtype, *,
                   allow_int8: bool = True) -> torch.dtype:
    """Resolve a ``Policy.kv_dtype`` name to the cache storage dtype.
    ``allow_int8=False`` is the dense per-slot cache, which has no scale
    pools beside it: int8 there falls back to the compute dtype."""
    if kv_dtype not in KV_DTYPES:
        raise ValueError(f"unknown kv_dtype {kv_dtype!r}; "
                         f"one of {list(KV_DTYPES)}")
    return {"auto": compute_dtype, "bf16": torch.bfloat16,
            "fp16": torch.float16,
            "int8": torch.int8 if allow_int8 else compute_dtype}[kv_dtype]


# Shared with the KV pool's scheme: symmetric absmax, full [-127, 127]
# code range (never -128, keeping |q| * s <= absmax exactly).
W8_QMAX = 127.0


def weights_store_dtype(weights_dtype: str, param_dtype) -> torch.dtype:
    """Resolve a ``Policy.weights_dtype`` name to the weight storage
    dtype."""
    if weights_dtype not in WEIGHTS_DTYPES:
        raise ValueError(f"unknown weights_dtype {weights_dtype!r}; "
                         f"one of {list(WEIGHTS_DTYPES)}")
    return {"auto": param_dtype, "bf16": torch.bfloat16,
            "fp16": torch.float16, "int8": torch.int8}[weights_dtype]


def quantize_weights(w):
    """Quantize one dense weight ``w`` (..., in, out) to an int8 record
    ``{"q": int8 (..., in, out), "s": fp32 (..., out)}`` with
    per-output-channel absmax scales (``s = absmax / 127`` over the input
    dim; codes round half to even).  All-zero columns get scale 0."""
    wf = w.float()
    scale = wf.abs().amax(-2) / W8_QMAX
    q = torch.round(wf / scale.clamp_min(1e-30)[..., None, :])
    # contiguous: the kernel reads q row-major, whatever w's strides were
    return {"q": q.clamp(-W8_QMAX, W8_QMAX).to(torch.int8).contiguous(),
            "s": scale.contiguous()}


def dequantize_weights(rec, dtype=torch.float32):
    """Inverse of :func:`quantize_weights` (up to the rounding error)."""
    return (rec["q"].float() * rec["s"][..., None, :]).to(dtype)


def is_quantized_weight(w) -> bool:
    """True for the ``{"q", "s"}`` records :func:`quantize_weights` makes."""
    return isinstance(w, dict) and set(w) == {"q", "s"}


def _tensor_bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def weight_record_bytes(w) -> int:
    """Storage bytes of one serve-path weight (tensor or int8 record)."""
    if is_quantized_weight(w):
        return _tensor_bytes(w["q"]) + _tensor_bytes(w["s"])
    return _tensor_bytes(w)


# Dense serve-path matmul weights, identified structurally: an attention
# dict carries all four projections, a dense FFN dict carries wi + wo
# (and wg for gated activations).
_ATTN_KEYS = ("wq", "wk", "wv", "wo")
_FFN_KEYS = ("wi", "wg", "wo")


def _walk_serve_weights(node):
    """Yield (dict, key) for every dense serve-path matmul weight."""
    if isinstance(node, (tuple, list)):
        for v in node:
            yield from _walk_serve_weights(v)
        return
    if not isinstance(node, dict):
        return
    if all(k in node for k in _ATTN_KEYS):
        for k in _ATTN_KEYS:
            yield node, k
    elif "wi" in node and "wo" in node and "router" not in node:
        for k in _FFN_KEYS:
            if k in node:
                yield node, k
    for v in node.values():
        yield from _walk_serve_weights(v)


def compress_weights(params, policy: "Policy"):
    """Apply ``policy.weights_dtype`` to the dense serve-path weights.

    Returns ``(params, stats)``.  For "int8" each weight is replaced (in
    a copied tree) by its :func:`quantize_weights` record, and a tied
    model gets ``embed["head_q8"]``, the record of the transposed (d, V)
    table, for the unembedding; "bf16"/"fp16" cast the same weights;
    "auto" is a no-op.  ``stats``: ``weight_bytes`` (bytes those matmuls
    read after compression), ``weight_bytes_dense`` (before),
    ``weight_bytes_saved``, ``n_quantized`` (records made, one per layer
    and weight, plus the head) and ``weights_dtype``.  Call after
    :meth:`Policy.cast_params`.
    """
    wd = policy.weights_dtype
    if wd not in WEIGHTS_DTYPES:
        raise ValueError(f"unknown weights_dtype {wd!r}; "
                         f"one of {list(WEIGHTS_DTYPES)}")
    embed = params["embed"]
    head = embed.get("head")
    tied = embed["tokens"] if head is None else None

    def serve_bytes(tree, head_w):
        return sum(weight_record_bytes(d[k])
                   for d, k in _walk_serve_weights(tree)) \
            + weight_record_bytes(head_w)

    dense = serve_bytes(params, head if head is not None else tied)
    if wd == "auto":
        return params, {"weights_dtype": wd, "weight_bytes": dense,
                        "weight_bytes_dense": dense,
                        "weight_bytes_saved": 0, "n_quantized": 0}
    if wd == "int8":
        transform = quantize_weights
    else:
        store = weights_store_dtype(wd, policy.param_dtype)
        transform = lambda w: w.to(store)   # noqa: E731

    new = map_params(lambda t: t, params)     # fresh containers
    n_q = 0
    for d, k in _walk_serve_weights(new):
        d[k] = transform(d[k])
        n_q += 1
    if head is not None:
        new["embed"]["head"] = transform(head)
        n_q += 1
        head_w = new["embed"]["head"]
    elif wd == "int8":
        new["embed"]["head_q8"] = quantize_weights(tied.float().T)
        n_q += 1
        head_w = new["embed"]["head_q8"]
    else:
        head_w = tied
    comp = serve_bytes(new, head_w)
    return new, {"weights_dtype": wd, "weight_bytes": comp,
                 "weight_bytes_dense": dense,
                 "weight_bytes_saved": dense - comp, "n_quantized": n_q}


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

    def kv_cache_dtype(self, *, dense: bool = False) -> torch.dtype:
        """Storage dtype of KV caches under this policy; ``dense=True``
        (per-slot caches without scale pools) maps int8 back to the
        compute dtype, since only the paged pool stores int8."""
        return kv_store_dtype(self.kv_dtype, self.compute_dtype,
                              allow_int8=not dense)


FP32 = Policy()
BF16 = Policy(torch.bfloat16, torch.bfloat16, torch.float32)
FP16 = Policy(torch.float16, torch.float16, torch.float32)
MIXED = Policy(torch.float32, torch.bfloat16, torch.float32)

_POLICIES = {"fp32": FP32, "bf16": BF16, "fp16": FP16, "mixed": MIXED}


def get_policy(name: str) -> Policy:
    try:
        return _POLICIES[name]
    except KeyError:
        raise ValueError(f"unknown policy {name!r}; one of {list(_POLICIES)}")
