"""deepseek-moe-16b — fine-grained MoE: 64 routed top-6 + 2 shared experts.
[arXiv:2401.06066; hf]"""
from repro_torch.configs.base import ModelConfig, MoECfg

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,               # expert hidden dim
    vocab_size=102400,
    tie_embeddings=False,
    rope_theta=10000.0,
    moe=MoECfg(n_experts=64, top_k=6, n_shared=2, d_ff_expert=1408,
               first_dense_layers=1, d_ff_dense=10944),
    source="arXiv:2401.06066",
)
