"""deepseek-v2-236b — MLA attention + fine-grained MoE (160 routed top-6,
2 shared). [arXiv:2405.04434; hf]"""
from repro_torch.configs.base import MLACfg, ModelConfig, MoECfg

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,          # MLA: latent cache, kv heads = q heads post-expand
    head_dim=192,            # qk_nope (128) + qk_rope (64)
    d_ff=1536,               # expert hidden dim (assigned spec)
    vocab_size=102400,
    tie_embeddings=False,
    rope_theta=10000.0,
    mla=MLACfg(kv_lora_rank=512, q_lora_rank=1536,
               qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128),
    moe=MoECfg(n_experts=160, top_k=6, n_shared=2, d_ff_expert=1536,
               first_dense_layers=1, d_ff_dense=12288),
    source="arXiv:2405.04434",
)
