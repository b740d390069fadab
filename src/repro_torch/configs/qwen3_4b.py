"""qwen3-4b [dense] — 36L d_model=2560 32H (GQA kv=8) d_ff=9728
vocab=151936; qk_norm, GQA.  [hf:Qwen/Qwen3-8B]"""
from repro_torch.configs.base import LayerSpec, ModelConfig, uniform_stack

ARCH = "qwen3-4b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH, family="dense", source="hf:Qwen/Qwen3-8B",
        d_model=2560, num_heads=32, num_kv_heads=8, head_dim=128,
        d_ff=9728, vocab_size=151936,
        stacks=uniform_stack(36, LayerSpec()),
        qk_norm=True, rope_theta=1e6, activation="swiglu", norm="rmsnorm",
        tie_embeddings=True, native_context=32768,
        long_context_override=8192,   # beyond-paper SWA variant for 500k
    )


def reduced() -> ModelConfig:
    return config().replace(
        d_model=256, num_heads=8, num_kv_heads=2, head_dim=32, d_ff=512,
        vocab_size=512, stacks=uniform_stack(2, LayerSpec()),
        native_context=256, long_context_override=None)
