"""qwen1.5-32b — dense GQA decoder with QKV bias. [hf:Qwen/Qwen1.5-*; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=40,
    d_ff=27392,
    vocab_size=152064,
    qkv_bias=True,
    kv_quant=True,   # decode_32k cache = 5.5 TB bf16 globally; int8 halves it

    rope_theta=1_000_000.0,
    tie_embeddings=False,
    source="hf:Qwen/Qwen1.5-32B",
)
