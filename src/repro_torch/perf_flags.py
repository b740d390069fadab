"""Perf-experiment switches, the port's own copy of ``repro.perf_flags``.

Flags live in the ``REPRO_PERF_OPTS`` environment variable
(comma-separated, ``key`` or ``key=value``) and are read at each call,
so a caller may change them between calls:

  attn_bf16       attention scores / PV from half-precision inputs with
                  fp32 accumulation, no fp32 copy of the KV cache (on by
                  default; ``REPRO_PERF_OPTS=""`` turns it off:
                  ``layers.attention_ref`` and MLA's absorbed decode then
                  attend over fp32 copies, as the reference does)
  moe_ragged      MoE dispatch as grouped products over expert-sorted
                  tokens (``moe.moe_apply_ragged``: no capacity, no
                  drops) instead of the capacity path
  tp_attn_guard   attention weights replicated when the head count does
                  not divide the mesh's model axis
                  (``sharding.partition.param_pspecs``)
  seq_parallel    the embedded activations' sequence over the model axis
                  of the current mesh (``transformer._maybe_seq_parallel``
                  -> ``sharding.spmd.seq_parallel``)
  bf16_params, factored_opt, grad_accum=N
                  the dry run's train target for archs above
                  ``launch.specs.LOW_MEM_OPT_THRESHOLD``: bf16 parameter
                  storage, factored second moments, N microbatches
                  (``launch.specs.make_target``)
  coll_bf16       parsed only: the reference documents it and reads it
                  nowhere

``REPRO_PERF_OPTS`` unset means the defaults (``attn_bf16``); set to
``""`` it means none at all, the paper-faithful baseline.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

# the reference's defaults: attn_bf16 is the paper-faithful choice
# (attention in half precision with fp32 accumulation)
_DEFAULTS_ON = ("attn_bf16",)


def _parse() -> Dict[str, str]:
    raw = os.environ.get("REPRO_PERF_OPTS")
    out = {k: "1" for k in _DEFAULTS_ON}
    if raw is None:
        return out
    if raw.strip() == "":
        return {}                     # explicit empty = pure baseline
    out = {}
    for part in raw.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" in part:
            k, v = part.split("=", 1)
            out[k] = v
        else:
            out[part] = "1"
    return out


def flag(name: str) -> bool:
    return name in _parse()


def flag_value(name: str, default: Optional[str] = None) -> Optional[str]:
    return _parse().get(name, default)


def active() -> Dict[str, str]:
    return _parse()
