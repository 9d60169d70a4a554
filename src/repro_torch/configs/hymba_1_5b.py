"""hymba-1.5b — hybrid blocks with PARALLEL attention + mamba heads fused by
learned mean; [arXiv:2411.13676; hf]. ssm_state=16."""
from repro_torch.configs.base import ModelConfig, SSMCfg

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,
    rope_theta=10000.0,
    tie_embeddings=True,
    ssm=SSMCfg(state_size=16, conv_width=4, expand=2, chunk=128),
    source="arXiv:2411.13676",
)
