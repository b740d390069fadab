"""deepseek-v3-671b [moe] — 61L d_model=7168 128H d_ff=2048(expert)
vocab=129280, MoE 256e top-8, MLA, 1 shared + 256 routed, MTP.
[arXiv:2412.19437]

First 3 layers are dense (d_ff=18432) with MLA attention; the remaining 58
are MLA + 256-expert top-8 sigmoid-routed MoE with one shared expert.
"""
from repro_torch.configs.base import (DENSE_FFN, MLA, MOE_FFN, LayerSpec,
                                      MLAConfig, ModelConfig, MoEConfig,
                                      Stack)

ARCH = "deepseek-v3-671b"


def config() -> ModelConfig:
    dense = LayerSpec(mixer=MLA, ffn=DENSE_FFN)
    moe = LayerSpec(mixer=MLA, ffn=MOE_FFN)
    return ModelConfig(
        name=ARCH, family="moe", source="arXiv:2412.19437",
        d_model=7168, num_heads=128, num_kv_heads=128, head_dim=192,
        d_ff=18432, vocab_size=129280,
        stacks=(Stack((dense,), 3), Stack((moe,), 58)),
        mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512, rope_head_dim=64,
                      nope_head_dim=128, v_head_dim=128),
        moe=MoEConfig(num_experts=256, top_k=8, num_shared_experts=1,
                      d_ff_expert=2048, capacity_factor=1.25),
        mtp=True, rope_theta=10000.0, activation="swiglu", norm="rmsnorm",
        tie_embeddings=False, native_context=131072,
        long_context_override=8192,   # beyond-paper SWA variant for 500k
    )


def reduced() -> ModelConfig:
    dense = LayerSpec(mixer=MLA, ffn=DENSE_FFN)
    moe = LayerSpec(mixer=MLA, ffn=MOE_FFN)
    return config().replace(
        d_model=256, num_heads=4, num_kv_heads=4, head_dim=48, d_ff=512,
        vocab_size=512,
        stacks=(Stack((dense,), 1), Stack((moe,), 1)),
        mla=MLAConfig(q_lora_rank=64, kv_lora_rank=32, rope_head_dim=16,
                      nope_head_dim=32, v_head_dim=32),
        moe=MoEConfig(num_experts=4, top_k=2, num_shared_experts=1,
                      d_ff_expert=128, capacity_factor=1.5),
        native_context=256, long_context_override=None)
