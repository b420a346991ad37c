"""qwen2-0.5b [dense] — GQA with QKV bias [arXiv:2407.10671; hf].

24L, d_model=896, 14 heads (GQA kv=2), d_ff=4864, vocab=151936.
"""
from repro_torch.configs.base import ArchConfig, register

QWEN2_0_5B = register(ArchConfig(
    name="qwen2-0.5b",
    family="dense",
    num_layers=24,
    d_model=896,
    num_heads=14,
    num_kv_heads=2,
    head_dim=64,
    d_ff=4864,
    vocab_size=151936,
    attention="full",
    qkv_bias=True,
    causal=True,
    ffn_kind="glu",
    norm_kind="rmsnorm",
    position="rope",
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    supports_decode=True,
    subquadratic=False,
))
