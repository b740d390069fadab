"""qwen3-moe-235b-a22b [moe] — 94L d_model=4096 64H (GQA kv=4)
d_ff=1536(expert) vocab=151936, MoE 128e top-8, qk-norm.
[hf:Qwen/Qwen3-30B-A3B]"""
from repro_torch.configs.base import (MOE_FFN, LayerSpec, ModelConfig,
                                      MoEConfig, uniform_stack)

ARCH = "qwen3-moe-235b-a22b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH, family="moe", source="hf:Qwen/Qwen3-30B-A3B",
        d_model=4096, num_heads=64, num_kv_heads=4, head_dim=128,
        d_ff=0, vocab_size=151936,
        stacks=uniform_stack(94, LayerSpec(ffn=MOE_FFN)),
        moe=MoEConfig(num_experts=128, top_k=8, num_shared_experts=0,
                      d_ff_expert=1536, capacity_factor=1.25),
        qk_norm=True, rope_theta=1e6, activation="swiglu", norm="rmsnorm",
        tie_embeddings=False, native_context=32768,
        long_context_override=8192,   # beyond-paper SWA variant for 500k
    )


def reduced() -> ModelConfig:
    return config().replace(
        d_model=256, num_heads=8, num_kv_heads=2, head_dim=32,
        vocab_size=512, stacks=uniform_stack(2, LayerSpec(ffn=MOE_FFN)),
        moe=MoEConfig(num_experts=4, top_k=2, num_shared_experts=0,
                      d_ff_expert=128, capacity_factor=1.5),
        native_context=256, long_context_override=None)
