"""unimo-text — the paper's own model (§3.1): 24-layer transformer,
learned position embeddings (512 x 1024), vocab 12800.
[paper: AIGC Inference Performance Optimization Competition solution]"""
from repro_torch.configs.base import LayerSpec, ModelConfig, uniform_stack

ARCH = "unimo-text"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH, family="dense", source="paper §3.1 (UNIMO-text)",
        d_model=1024, num_heads=16, num_kv_heads=16, head_dim=64,
        d_ff=4096, vocab_size=12800,
        stacks=uniform_stack(24, LayerSpec()),
        pos_emb="learned", max_seq_len=512,
        activation="gelu", norm="layernorm", tie_embeddings=True,
        native_context=512,
    )


def reduced() -> ModelConfig:
    return config().replace(
        d_model=256, num_heads=4, num_kv_heads=4, head_dim=64, d_ff=512,
        vocab_size=1600, stacks=uniform_stack(2, LayerSpec()),
        max_seq_len=128, native_context=128)
