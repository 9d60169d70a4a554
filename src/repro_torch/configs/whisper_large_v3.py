"""whisper-large-v3 — encoder-decoder backbone; the conv frontend is a
STUB (``input_specs()`` supplies precomputed frame embeddings).
[arXiv:2212.04356]

The 32 layers are the decoder's depth; whisper-large has a matching
32-layer audio encoder over a fixed 1500-frame (30 s) mel window.  The
encoder's self-attention is bidirectional; the decoder is causal with
cross-attention to the encoder memory, whose exchange PRISM compresses.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="audio",
    n_layers=32,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    vocab_size=51866,
    norm_type="layernorm",
    act="gelu",
    rope_theta=10000.0,      # NB: whisper uses learned/sinusoidal absolute
                             # positions; the backbone keeps RoPE, as the
                             # JAX package's config does
    tie_embeddings=True,
    encoder_layers=32,
    encoder_seq=1500,
    source="arXiv:2212.04356",
)
