"""llama-3.2-vision-11b — llama3 decoder with cross-attention image layers
every 5th layer; the vision tower is a STUB (``input_specs()`` supplies
projected patch embeddings). [hf:meta-llama/Llama-3.2-11B-Vision]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=128256,
    rope_theta=500_000.0,
    tie_embeddings=False,
    cross_attn_every=5,      # layers 4, 9, 14, ... attend to image tokens
    image_tokens=1601,
    source="hf:meta-llama/Llama-3.2-11B-Vision",
)
