"""deepseek-coder-33b [dense] — llama-arch code model [arXiv:2401.14196; hf].

62L, d_model=7168, 56 heads (GQA kv=8), d_ff=19200, vocab=32256.
Full attention: decode pages every layer's KV cache.
"""
from repro_torch.configs.base import ArchConfig, register

DEEPSEEK_CODER_33B = register(ArchConfig(
    name="deepseek-coder-33b",
    family="dense",
    num_layers=62,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=19200,
    vocab_size=32256,
    attention="full",
    causal=True,
    ffn_kind="glu",
    norm_kind="rmsnorm",
    position="rope",
    rope_theta=100_000.0,
    tie_embeddings=False,
    supports_decode=True,
    subquadratic=False,
))
