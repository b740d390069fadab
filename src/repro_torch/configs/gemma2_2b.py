"""gemma2-2b [dense] — 26L d_model=2304 8H (GQA kv=4) d_ff=9216
vocab=256000; alternating local(4096)/global attention, logit softcaps,
sandwich norms, GeGLU.  [arXiv:2408.00118]"""
from repro_torch.configs.base import LayerSpec, ModelConfig, patterned_stacks

ARCH = "gemma2-2b"

_PATTERN = (LayerSpec(window=4096), LayerSpec(window=None))


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH, family="dense", source="arXiv:2408.00118",
        d_model=2304, num_heads=8, num_kv_heads=4, head_dim=256,
        d_ff=9216, vocab_size=256000,
        stacks=patterned_stacks(26, _PATTERN),
        attn_softcap=50.0, final_softcap=30.0,
        sandwich_norm=True, embed_scale=True,
        attn_scale=256 ** -0.5,       # query_pre_attn_scalar = 256
        rope_theta=10000.0, activation="geglu", norm="rmsnorm",
        tie_embeddings=True, native_context=8192,
    )


def reduced() -> ModelConfig:
    pattern = (LayerSpec(window=64), LayerSpec(window=None))
    return config().replace(
        d_model=256, num_heads=4, num_kv_heads=2, head_dim=64, d_ff=512,
        vocab_size=512, stacks=patterned_stacks(2, pattern),
        attn_scale=None, native_context=256)
