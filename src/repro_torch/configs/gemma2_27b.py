"""gemma2-27b — local/global alternating attention + logit softcaps.

[arXiv:2408.00118; hf] — sliding window 4096 on local layers, attn softcap
50.0, final softcap 30.0, post-norms, GeGLU, query scale 1/sqrt(d/ n_heads).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b",
    family="dense",
    n_layers=46,
    d_model=4608,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=36864,
    vocab_size=256000,
    local_global=True,
    window=4096,
    attn_softcap=50.0,
    final_softcap=30.0,
    post_norms=True,
    act="gelu_tanh",
    embed_scale=True,
    tie_embeddings=True,
    query_scale=(4608 / 32) ** -0.5,   # query_pre_attn_scalar = d_model/n_heads
    kv_quant=True,   # decode_32k cache 1.5 TB bf16 globally; int8 halves it
    rope_theta=10000.0,
    source="arXiv:2408.00118",
)
