"""ViT-B/16 — the paper's own workload (224×224×3 CIFAR-10 inputs, N=197
tokens incl. CLS). Bidirectional encoder; the PRISM/Voltage tables in
EXPERIMENTS.md §Paper-validation run on this config. [arXiv:2010.11929]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="vit-base-16",
    family="vit",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab_size=10,            # classifier head classes (CIFAR-10)
    causal=False,
    norm_type="layernorm",
    act="gelu",
    rope_theta=0.0,           # learned absolute positions, no RoPE
    tie_embeddings=False,
    source="arXiv:2010.11929",
)

N_TOKENS = 197                # 14×14 patches + CLS
