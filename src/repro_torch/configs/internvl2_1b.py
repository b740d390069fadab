"""internvl2-1b [vlm] — 24L d_model=896 14H (GQA kv=2) d_ff=4864
vocab=151655; InternViT vision encoder + Qwen2-0.5B-family LM backbone.
[arXiv:2404.16821]

The InternViT encoder + MLP projector is a stub: callers pass 256
precomputed patch embeddings of width d_model (``prefix_embeds``), which
are prepended to the text tokens.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig, uniform_stack

ARCH = "internvl2-1b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH, family="vlm", source="arXiv:2404.16821",
        d_model=896, num_heads=14, num_kv_heads=2, head_dim=64,
        d_ff=4864, vocab_size=151655, num_prefix_embeds=256,
        stacks=uniform_stack(24, LayerSpec()),
        rope_theta=1e6, activation="swiglu", norm="rmsnorm",
        tie_embeddings=True, native_context=32768,
        long_context_override=8192,   # beyond-paper SWA variant for 500k
    )


def reduced() -> ModelConfig:
    return config().replace(
        d_model=128, num_heads=4, num_kv_heads=2, head_dim=32, d_ff=256,
        vocab_size=512, num_prefix_embeds=16,
        stacks=uniform_stack(2, LayerSpec()),
        native_context=256, long_context_override=None)
