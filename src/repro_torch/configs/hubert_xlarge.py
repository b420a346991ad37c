"""hubert-xlarge [audio] — encoder-only transformer, wav2vec2 arch
[arXiv:2106.07447; unverified].

48L, d_model=1280, 16 heads, d_ff=5120, vocab=504 (target cluster codebook).
The conv waveform feature extractor is not modelled: the inputs are
precomputed frame features (``frames``, frontend_dim wide), projected by
``frontend_proj``. Encoder-only: no decode.
"""
from repro_torch.configs.base import ArchConfig, register

HUBERT_XLARGE = register(ArchConfig(
    name="hubert-xlarge",
    family="audio",
    num_layers=48,
    d_model=1280,
    num_heads=16,
    num_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    vocab_size=504,
    attention="full",
    causal=False,
    ffn_kind="gelu",
    norm_kind="layernorm",
    position="none",
    tie_embeddings=False,
    frontend="audio",
    frontend_dim=512,
    supports_decode=False,
    subquadratic=False,
))
