"""xlstm-125m [ssm] — 12L d_model=768 4H d_ff=0 vocab=50304; alternating
mLSTM + sLSTM blocks (1:1), attention-free.  [arXiv:2405.04517]

Blocks carry their own up/down projections (d_ff=0 -> no separate FFN);
the mLSTM runs at twice the model width, so its head dim is
2 x 768 / 4 = 384.  Recurrent state takes the place of the KV cache:
O(1) memory per stream.
"""
from repro_torch.configs.base import (MLSTM, NO_FFN, SLSTM, LayerSpec,
                                      ModelConfig, patterned_stacks)

ARCH = "xlstm-125m"

_PATTERN = (LayerSpec(mixer=MLSTM, ffn=NO_FFN),
            LayerSpec(mixer=SLSTM, ffn=NO_FFN))


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH, family="ssm", source="arXiv:2405.04517",
        d_model=768, num_heads=4, num_kv_heads=4, d_ff=0, vocab_size=50304,
        stacks=patterned_stacks(12, _PATTERN),
        norm="layernorm", pos_emb="none", tie_embeddings=True,
        native_context=1 << 20,
    )


def reduced() -> ModelConfig:
    return config().replace(
        d_model=128, num_heads=2, num_kv_heads=2, vocab_size=512,
        stacks=patterned_stacks(2, _PATTERN), native_context=1 << 20)
