"""musicgen-medium [audio] — 48L d_model=1536 24H (kv=24) d_ff=6144
vocab=2048; decoder-only over EnCodec tokens (4 codebooks, delay pattern
handled at the data level).  [arXiv:2306.05284]

The EnCodec conv codec frontend is a stub: callers pass token ids per
codebook, (B, S, C); conditioning is unconditional (MusicGen's text-free
mode).  Sinusoidal positions as in the paper.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig, uniform_stack

ARCH = "musicgen-medium"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH, family="audio", source="arXiv:2306.05284",
        d_model=1536, num_heads=24, num_kv_heads=24, head_dim=64,
        d_ff=6144, vocab_size=2048, num_codebooks=4,
        stacks=uniform_stack(48, LayerSpec()),
        activation="gelu", norm="layernorm", pos_emb="sinusoidal",
        tie_embeddings=True, native_context=16384,
        long_context_override=8192,   # beyond-paper SWA variant for 500k
    )


def reduced() -> ModelConfig:
    return config().replace(
        d_model=192, num_heads=6, num_kv_heads=6, head_dim=32, d_ff=384,
        vocab_size=256, num_codebooks=2,
        stacks=uniform_stack(2, LayerSpec()),
        native_context=256, long_context_override=None)
