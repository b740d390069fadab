"""gemma3-27b [dense] — 62L d_model=5376 32H (GQA kv=16) d_ff=21504
vocab=262144; 5:1 local(1024):global, 128k context, dual RoPE theta,
qk-norm, sandwich norms, GeGLU.  [hf:google/gemma-3-1b-pt]"""
from repro_torch.configs.base import LayerSpec, ModelConfig, patterned_stacks

ARCH = "gemma3-27b"

_PATTERN = tuple([LayerSpec(window=1024)] * 5 + [LayerSpec(window=None)])


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH, family="dense", source="hf:google/gemma-3-1b-pt",
        d_model=5376, num_heads=32, num_kv_heads=16, head_dim=128,
        d_ff=21504, vocab_size=262144,
        stacks=patterned_stacks(62, _PATTERN),
        qk_norm=True, sandwich_norm=True, embed_scale=True,
        rope_theta=1e6, rope_theta_local=10000.0,
        activation="geglu", norm="rmsnorm", tie_embeddings=True,
        native_context=131072,
    )


def reduced() -> ModelConfig:
    pattern = tuple([LayerSpec(window=64)] * 1 + [LayerSpec(window=None)])
    return config().replace(
        d_model=256, num_heads=4, num_kv_heads=2, head_dim=64, d_ff=512,
        vocab_size=512, stacks=patterned_stacks(2, pattern),
        native_context=256)
