"""hymba-1.5b [hybrid] — 32L d_model=1600 25H (GQA kv=5) d_ff=5504
vocab=32001, ssm_state=16; parallel attn+mamba heads.  [arXiv:2411.13676]

Layer layout follows the paper's 3-global-attention pattern (first /
middle / last layers global, the rest sliding-window 1024), every layer a
parallel attention+SSM hybrid.
"""
from repro_torch.configs.base import (HYBRID, LayerSpec, ModelConfig,
                                      SSMConfig, Stack)

ARCH = "hymba-1.5b"

_G = LayerSpec(mixer=HYBRID, window=None)
_W = LayerSpec(mixer=HYBRID, window=1024)


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH, family="hybrid", source="arXiv:2411.13676",
        d_model=1600, num_heads=25, num_kv_heads=5, head_dim=64,
        d_ff=5504, vocab_size=32001,
        stacks=(Stack((_G,), 1), Stack((_W,), 14), Stack((_G,), 1),
                Stack((_W,), 15), Stack((_G,), 1)),
        ssm=SSMConfig(state_size=16, conv_size=4, expand=2, num_ssm_heads=25),
        activation="swiglu", norm="rmsnorm", tie_embeddings=True,
        native_context=8192,
    )


def reduced() -> ModelConfig:
    return config().replace(
        d_model=160, num_heads=5, num_kv_heads=1, head_dim=32, d_ff=320,
        vocab_size=512,
        stacks=(Stack((_G,), 1), Stack((LayerSpec(mixer=HYBRID, window=64),),
                                       1)),
        ssm=SSMConfig(state_size=8, conv_size=4, expand=2, num_ssm_heads=5),
        native_context=256)
