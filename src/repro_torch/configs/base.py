"""Model/config system (the port's copy of ``repro.configs.base``).

A model is described by a :class:`ModelConfig`, which is a sequence of
*stacks*.  Each stack is a repeating *pattern* of :class:`LayerSpec`s; the
port runs the layers one after another in the order
``for stack: for repeat: for pattern position`` (see
:func:`layer_specs`), the same order the reference scans them in.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Iterator, Optional, Sequence, Tuple

# ---------------------------------------------------------------------------
# Layer specification
# ---------------------------------------------------------------------------

# mixer kinds
ATTN = "attn"          # softmax attention (GQA), optional sliding window
MLA = "mla"            # DeepSeek multi-head latent attention
MLSTM = "mlstm"        # xLSTM matrix-memory block
SLSTM = "slstm"        # xLSTM scalar-memory block
HYBRID = "hybrid"      # Hymba parallel attention + SSM heads

# ffn kinds
DENSE_FFN = "dense"
MOE_FFN = "moe"
NO_FFN = "none"        # xLSTM blocks carry their own projection; no FFN


@dataclass(frozen=True)
class LayerSpec:
    """One layer position inside a stack pattern."""

    mixer: str = ATTN
    ffn: str = DENSE_FFN
    window: Optional[int] = None  # sliding-window size; None = global attention

    def __post_init__(self):
        assert self.mixer in (ATTN, MLA, MLSTM, SLSTM, HYBRID), self.mixer
        assert self.ffn in (DENSE_FFN, MOE_FFN, NO_FFN), self.ffn


@dataclass(frozen=True)
class Stack:
    """``repeats`` x ``pattern`` layers."""

    pattern: Tuple[LayerSpec, ...]
    repeats: int

    @property
    def num_layers(self) -> int:
        return len(self.pattern) * self.repeats


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 8
    top_k: int = 2
    num_shared_experts: int = 0
    d_ff_expert: int = 0            # per-expert FFN width
    capacity_factor: float = 1.25
    router_aux_coef: float = 1e-2


@dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    state_size: int = 16
    conv_size: int = 4
    expand: int = 2                 # d_inner = expand * d_model (per-SSM-branch)
    num_ssm_heads: int = 0          # hybrid: SSM heads in parallel with attn heads


@dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"           # dense | moe | ssm | hybrid | vlm | audio
    source: str = ""                # citation for the assigned config

    d_model: int = 512
    num_heads: int = 8
    num_kv_heads: int = 8
    head_dim: int = 0               # 0 -> d_model // num_heads
    d_ff: int = 2048
    vocab_size: int = 32000
    stacks: Tuple[Stack, ...] = ()

    # attention details
    qk_norm: bool = False
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    rope_theta: float = 10000.0
    rope_theta_local: Optional[float] = None  # windowed layers' own theta
    pos_emb: str = "rope"           # rope | learned | sinusoidal | none
    max_seq_len: int = 1 << 19      # for learned positions / rope tables
    attn_scale: Optional[float] = None        # None -> 1/sqrt(head_dim)

    # block structure
    norm: str = "rmsnorm"           # rmsnorm | layernorm
    activation: str = "swiglu"      # swiglu | geglu | gelu
    sandwich_norm: bool = False     # a post-norm after mixer and FFN too
    tie_embeddings: bool = True
    embed_scale: bool = False

    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None

    # multimodal stub frontend: prefix embeddings prepended to the text
    # (vlm: image patches) and parallel codec streams (audio: musicgen 4)
    num_prefix_embeds: int = 0
    num_codebooks: int = 0

    # DeepSeek multi-token prediction
    mtp: bool = False

    # long-context: window applied to *global* layers when serving >
    # native_context tokens
    long_context_override: Optional[int] = None
    native_context: int = 1 << 17

    def __post_init__(self):
        if not self.stacks:
            object.__setattr__(
                self, "stacks", (Stack((LayerSpec(),), 2),))

    # -- derived ------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def num_layers(self) -> int:
        return sum(s.num_layers for s in self.stacks)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # -- parameter count (the dry run's model flops, use_fsdp) --------------
    def param_counts(self) -> dict:
        """{'total': N, 'active': N_active, 'embed': ...}, the reference's
        formula with its approximations (the mLSTM and sLSTM lines)."""
        d, hd = self.d_model, self.resolved_head_dim
        nq, nkv = self.num_heads, self.num_kv_heads
        embed = self.vocab_size * d
        if not self.tie_embeddings:
            embed *= 2
        if self.pos_emb == "learned":
            embed += self.max_seq_len * d
        if self.num_codebooks:
            embed += self.num_codebooks * self.vocab_size * d

        def attn_params():
            return d * (nq * hd) + 2 * d * (nkv * hd) + (nq * hd) * d

        def mla_params():
            m = self.mla
            p = d * m.q_lora_rank
            p += m.q_lora_rank * nq * (m.nope_head_dim + m.rope_head_dim)
            p += d * (m.kv_lora_rank + m.rope_head_dim)
            p += m.kv_lora_rank * nq * (m.nope_head_dim + m.v_head_dim)
            p += nq * m.v_head_dim * d
            return p

        def ffn_params(width):
            mult = 3 if self.activation in ("swiglu", "geglu") else 2
            return mult * d * width

        def ssm_inner():
            s = self.ssm
            di = s.expand * d
            # in-proj (x, z), conv, dt/B/C proj, out-proj
            return (2 * d * di + s.conv_size * di
                    + di * (2 * s.state_size + 1) + di * d)

        total = active = embed
        for st in self.stacks:
            for spec in st.pattern:
                lt = 0
                if spec.mixer == ATTN:
                    lt = attn_params()
                elif spec.mixer == MLA:
                    lt = mla_params()
                elif spec.mixer == MLSTM:
                    di = 2 * d
                    lt = 2 * d * di + di * d + 3 * d * di  # approx
                elif spec.mixer == SLSTM:
                    lt = 8 * d * d    # 4 gates x (W + R), approx
                elif spec.mixer == HYBRID:
                    lt = attn_params() + ssm_inner()
                la = lt
                if spec.ffn == DENSE_FFN:
                    lt += ffn_params(self.d_ff)
                    la += ffn_params(self.d_ff)
                elif spec.ffn == MOE_FFN:
                    m = self.moe
                    router = d * m.num_experts
                    shared = m.num_shared_experts * ffn_params(m.d_ff_expert)
                    lt += (router + shared
                           + m.num_experts * ffn_params(m.d_ff_expert))
                    la += router + shared + m.top_k * ffn_params(
                        m.d_ff_expert)
                lt += 2 * d                                  # norms
                la += 2 * d
                total += lt * st.repeats
                active += la * st.repeats
        return {"total": total, "active": active, "embed": embed}


def layer_specs(cfg: ModelConfig) -> Iterator[LayerSpec]:
    """Every layer's spec in execution order (stack, repeat, position)."""
    for stack in cfg.stacks:
        for _ in range(stack.repeats):
            yield from stack.pattern


def uniform_stack(n_layers: int, spec: LayerSpec) -> Tuple[Stack, ...]:
    return (Stack((spec,), n_layers),)


def patterned_stacks(n_layers: int,
                     pattern: Sequence[LayerSpec]) -> Tuple[Stack, ...]:
    """Repeat ``pattern`` as many whole times as fits; the remainder
    becomes a second stack of single-layer repeats (a prefix of the
    pattern)."""
    reps, rem = divmod(n_layers, len(pattern))
    stacks = [Stack(tuple(pattern), reps)] if reps else []
    stacks.extend(Stack((pattern[i],), 1) for i in range(rem))
    return tuple(stacks)
