"""Input shapes and step targets per (arch x input shape) on a mesh (the
port's counterpart of ``repro.launch.specs``).

:func:`make_target` builds a step and its distributed arguments: the
parameters (``models.transformer.init_params``), the optimizer state
(``training.optimizer.init_state``), the cache (``init_cache``) and the
batch, each laid out by ``sharding.partition``'s rules as DTensors.
Under ``FakeTensorMode`` (the dry run) they are fake tensors and nothing
is allocated, the counterpart of the reference's ``ShapeDtypeStruct``s;
otherwise they are real tensors on the mesh's device, parameters drawn
from seed 0 and inputs from seed 1 (the card's check against the
unmeshed step).  The eager step updates its arguments in place, which
plays the part of the reference's buffer donation.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from repro_torch import perf_flags
from repro_torch.configs.base import ModelConfig
from repro_torch.core.precision import BF16, MIXED
from repro_torch.models import transformer as T
from repro_torch.sharding import partition as SH
from repro_torch.training import optimizer as OPT
from repro_torch.training.train_loop import make_train_step

INPUT_SHAPES = {
    "train_4k": {"kind": "train", "seq": 4096, "batch": 256},
    "prefill_32k": {"kind": "prefill", "seq": 32768, "batch": 32},
    "decode_32k": {"kind": "decode", "seq": 32768, "batch": 128},
    "long_500k": {"kind": "decode", "seq": 524288, "batch": 1},
}

# archs whose optimizer moments are bf16 in the dry run (memory), and
# which the bf16_params / factored_opt / grad_accum flags act on
LOW_MEM_OPT_THRESHOLD = 1e11


@dataclass
class LoweringTarget:
    """A step and its distributed arguments: ``fn(*args)`` runs it."""
    fn: Callable
    args: tuple
    static_meta: dict = None


def _meshed(fn):
    """``fn`` with plain tensors it makes (positions, index arrays) taken
    as replicated beside the DTensors."""
    @functools.wraps(fn)
    def run(*args):
        from torch.distributed.tensor.experimental import \
            implicit_replication
        with implicit_replication():
            return fn(*args)
    return run


PARAM_SEED, INPUT_SEED = 0, 1


def _gen(mesh, seed: int) -> torch.Generator:
    return torch.Generator(device=mesh.device_type).manual_seed(seed)


def params_struct(cfg: ModelConfig, mesh, policy, fsdp: bool):
    """(the parameters as DTensors, their spec tree)."""
    params = T.init_params(_gen(mesh, PARAM_SEED), cfg, policy=policy)
    specs = SH.param_pspecs(params, cfg, fsdp=fsdp, mesh=mesh)
    return SH.with_sharding(params, specs, mesh), specs


def use_fsdp(cfg: ModelConfig) -> bool:
    return cfg.param_counts()["total"] > 2e10


def _shape_info(shape_name: str, info: Optional[dict]) -> dict:
    return dict(info) if info is not None else dict(
        INPUT_SHAPES[shape_name])


def input_specs(cfg: ModelConfig, shape_name: str, mesh, *,
                info: Optional[dict] = None) -> dict:
    """The batch inputs for the input shape, distributed: tokens over
    the batch axes (``batch_pspec``), lengths replicated.  Prompts fill
    their rows, and a decode step's new token follows a prompt of the
    input shape's sequence length."""
    info = _shape_info(shape_name, info)
    B, S, kind = info["batch"], info["seq"], info["kind"]
    dev = mesh.device_type
    gen = _gen(mesh, INPUT_SEED)

    def put(t, spec):
        return SH.with_sharding({"t": t}, {"t": spec}, mesh)["t"]

    def tokens(seq):
        shape = (B, seq) + ((cfg.num_codebooks,) if cfg.num_codebooks
                            else ())
        t = torch.randint(0, cfg.vocab_size, shape, generator=gen,
                          dtype=torch.int32, device=dev)
        return put(t, SH.batch_pspec(mesh, B, extra_dims=len(shape) - 1))

    bspec1 = SH.batch_pspec(mesh, B, extra_dims=1)
    if kind == "train":
        text_S = S - cfg.num_prefix_embeds
        batch = {"tokens": tokens(text_S), "labels": tokens(text_S),
                 "loss_mask": put(torch.ones(B, text_S, device=dev),
                                  bspec1)}
        if cfg.num_prefix_embeds:
            batch["prefix_embeds"] = put(torch.randn(
                B, cfg.num_prefix_embeds, cfg.d_model, generator=gen,
                device=dev).to(torch.bfloat16),
                SH.batch_pspec(mesh, B, extra_dims=2))
        return batch
    lengths = put(torch.full((B,), S, dtype=torch.int32, device=dev),
                  SH.P())
    return {"tokens": tokens(S if kind == "prefill" else 1),
            "lengths": lengths}


def cache_specs(cfg: ModelConfig, B: int, max_len: int, mesh,
                dtype=torch.bfloat16):
    """The dense cache (``init_cache``) for B rows up to ``max_len``, as
    DTensors laid out by ``cache_pspecs``."""
    cache = T.init_cache(cfg, B, max_len, dtype, device=mesh.device_type)
    return SH.with_sharding(cache, SH.cache_pspecs(cache, mesh, B), mesh)


def opt_state_struct(params_global, pspecs, cfg: ModelConfig, mesh, *,
                     moment_dtype, factored: bool) -> OPT.AdamWState:
    """AdamW's state for the (undistributed) parameters, distributed
    like them: mu and nu take each parameter's spec, factored statistics
    ``optimizer.factored_nu_pspecs``."""
    st = OPT.init_state(params_global, moment_dtype=moment_dtype,
                        factored=factored, model_cfg=cfg)
    flat = SH.flat_specs(pspecs)
    if factored:
        nu = SH.with_sharding(
            st.nu, OPT.factored_nu_pspecs(pspecs, params_global, cfg), mesh)
        return OPT.AdamWState(st.step, None, nu, st.groups)
    return OPT.AdamWState(st.step, SH.with_sharding(st.mu, flat, mesh),
                          SH.with_sharding(st.nu, flat, mesh))


def make_target(cfg: ModelConfig, shape_name: str, mesh,
                fsdp: Optional[bool] = None, *, info: Optional[dict] = None,
                params=None, cache=None) -> LoweringTarget:
    """The (step, distributed arguments) pair for one combo.  ``info``
    replaces the input shape's entry of :data:`INPUT_SHAPES` (kind, seq,
    batch); ``params`` / ``cache`` reuse distributed trees of an earlier
    target (a decode step after a prefill) instead of drawing new ones."""
    info = _shape_info(shape_name, info)
    B, S, kind = info["batch"], info["seq"], info["kind"]
    fsdp = use_fsdp(cfg) if fsdp is None else fsdp
    meta = {"arch": cfg.name, "shape": shape_name, "kind": kind,
            "batch": B, "seq": S, "fsdp": fsdp}

    if kind == "train":
        low_mem = cfg.param_counts()["total"] > LOW_MEM_OPT_THRESHOLD
        policy = MIXED
        if low_mem and perf_flags.flag("bf16_params"):
            policy = BF16          # bf16 parameter storage for >100B archs
        factored = low_mem and perf_flags.flag("factored_opt")
        accum = int(perf_flags.flag_value("grad_accum", "1")) \
            if low_mem else 1
        return train_target(cfg, mesh, info, policy=policy,
                            factored=factored, grad_accum=accum,
                            moment_dtype=(torch.bfloat16 if low_mem
                                          else torch.float32),
                            fsdp=fsdp,
                            meta={**meta, "low_mem_opt": low_mem})

    policy = BF16
    if params is None:
        params, _ = params_struct(cfg, mesh, policy, fsdp)
    max_len = S
    if cache is None:
        cache = cache_specs(cfg, B, max_len, mesh, policy.compute_dtype)
    ins = input_specs(cfg, shape_name, mesh, info=info)

    if kind == "prefill":
        def prefill_fn(params, tokens, lengths, cache):
            return T.forward_prefill(params, cfg, tokens, lengths, cache,
                                     policy=policy, max_len=max_len,
                                     last_only=True)
        return LoweringTarget(
            fn=_meshed(prefill_fn),
            args=(params, ins["tokens"], ins["lengths"], cache),
            static_meta=meta)

    def decode_fn(params, tokens, cache, lengths):
        return T.forward_decode(params, cfg, tokens, cache, lengths,
                                policy=policy, max_len=max_len)
    return LoweringTarget(
        fn=_meshed(decode_fn),
        args=(params, ins["tokens"], cache, ins["lengths"]),
        static_meta=meta)


def train_target(cfg: ModelConfig, mesh, info: dict, *, policy, factored,
                 grad_accum: int, moment_dtype, fsdp: bool,
                 meta: Optional[dict] = None) -> LoweringTarget:
    """A train step (``make_train_step`` with remat and ``grad_accum``
    microbatches) and its distributed parameters, optimizer state and
    batch; :func:`make_target` sets the switches from the perf flags."""
    params = T.init_params(_gen(mesh, PARAM_SEED), cfg, policy=policy)
    pspecs = SH.param_pspecs(params, cfg, fsdp=fsdp, mesh=mesh)
    ostate = opt_state_struct(params, pspecs, cfg, mesh,
                              moment_dtype=moment_dtype, factored=factored)
    params = SH.with_sharding(params, pspecs, mesh)
    batch = input_specs(cfg, "train", mesh, info=info)
    step = make_train_step(cfg, OPT.AdamWConfig(factored=factored),
                           policy=policy, remat=True, grad_accum=grad_accum)
    meta = dict(meta or {})
    meta.update(factored=factored, grad_accum=grad_accum,
                perf_opts=perf_flags.active())
    return LoweringTarget(fn=_meshed(step), args=(params, ostate, batch),
                          static_meta=meta)
