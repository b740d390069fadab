"""Checkpoints of the port's own trees (the counterpart of
``repro.training.checkpoint``): parameters and, optionally, the AdamW
state (full or factored), path-keyed in one ``.npz`` (``p:<path>`` for a
parameter, ``o:step``, ``o:mu/<path>``, ``o:nu/<path>`` or
``o:nu/<path>/r`` and ``/c`` for the optimizer), and a ``.meta.json``
beside it.  numpy has no bf16, so bf16 leaves are stored as fp32, which
holds every bf16 value exactly and restores bit for bit into the
template's dtype.
"""
from __future__ import annotations

import json
import os
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch.training.optimizer import AdamWState, flatten, \
    unflatten_like


def _np(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _opt_flat(state: AdamWState) -> dict:
    out = {"step": np.asarray(state.step, np.int64)}
    if state.mu is not None:
        out.update({f"mu/{k}": _np(v) for k, v in state.mu.items()})
    for k, v in state.nu.items():
        if isinstance(v, dict):
            out.update({f"nu/{k}/{s}": _np(x) for s, x in v.items()})
        else:
            out[f"nu/{k}"] = _np(v)
    return out


def save(path: str, params: Any, opt_state: Optional[AdamWState] = None,
         meta: Optional[dict] = None) -> None:
    """Write ``params`` (and ``opt_state``) to ``path`` (``.npz``
    appended by numpy where missing) and ``meta`` to
    ``path + ".meta.json"``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    blob = {f"p:{k}": _np(v) for k, v in flatten(params).items()}
    if opt_state is not None:
        blob.update({f"o:{k}": v for k, v in _opt_flat(opt_state).items()})
    np.savez(path, **blob)
    if meta is not None:
        with open(path + ".meta.json", "w") as f:
            json.dump(meta, f, indent=2, default=str)


def restore(path: str, params_template: Any,
            opt_template: Optional[AdamWState] = None) -> Tuple[Any, Any]:
    """New trees shaped like the templates, each leaf at its template's
    dtype and device; a stored shape that differs from the template's
    raises ValueError."""
    data = np.load(path if path.endswith(".npz") else path + ".npz")

    def get(key, like: torch.Tensor) -> torch.Tensor:
        arr = data[key]
        if arr.shape != tuple(like.shape):
            raise ValueError(f"{key}: stored shape {arr.shape}, template "
                             f"{tuple(like.shape)}")
        return torch.from_numpy(np.array(arr)).to(like.device, like.dtype)

    params = unflatten_like(params_template, {
        k: get(f"p:{k}", v) for k, v in flatten(params_template).items()})
    if opt_template is None:
        return params, None
    o = opt_template
    mu = None if o.mu is None else {k: get(f"o:mu/{k}", v)
                                     for k, v in o.mu.items()}
    nu = {k: ({s: get(f"o:nu/{k}/{s}", x) for s, x in v.items()}
              if isinstance(v, dict) else get(f"o:nu/{k}", v))
          for k, v in o.nu.items()}
    return params, AdamWState(int(data["o:step"]), mu, nu, o.groups)
