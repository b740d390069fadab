"""phi3-mini-3.8b [dense] — 32L d_model=3072 32H (GQA kv=32) d_ff=8192
vocab=32064; RoPE SwiGLU GQA, untied unembedding head.
[arXiv:2404.14219]"""
from repro_torch.configs.base import LayerSpec, ModelConfig, uniform_stack

ARCH = "phi3-mini-3.8b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH, family="dense", source="arXiv:2404.14219",
        d_model=3072, num_heads=32, num_kv_heads=32, head_dim=96,
        d_ff=8192, vocab_size=32064,
        stacks=uniform_stack(32, LayerSpec()),
        rope_theta=10000.0, activation="swiglu", norm="rmsnorm",
        tie_embeddings=False, native_context=4096,
        long_context_override=8192,   # beyond-paper SWA variant for 500k
    )


def reduced() -> ModelConfig:
    return config().replace(
        d_model=256, num_heads=4, num_kv_heads=4, head_dim=64, d_ff=512,
        vocab_size=512, stacks=uniform_stack(2, LayerSpec()),
        native_context=256, long_context_override=None)
