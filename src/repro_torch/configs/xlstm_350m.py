"""xlstm-350m — sLSTM + mLSTM blocks (7:1 mLSTM:sLSTM), no FFN (d_ff=0;
blocks carry their own up/down projections). [arXiv:2405.04517]

No softmax attention: across sequence partitions the blocks hand their
recurrent state from one partition to the next
(``repro_torch.core.handoff``); the mLSTM's (d_k × d_v) memory does not
grow with N.
"""
from repro_torch.configs.base import ModelConfig, SSMCfg

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    norm_type="layernorm",
    tie_embeddings=True,
    ssm=SSMCfg(state_size=16, slstm_every=8, mlstm_heads=4,
               proj_factor=2.0, chunk=128),
    source="arXiv:2405.04517",
)
