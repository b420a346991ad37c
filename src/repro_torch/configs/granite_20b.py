"""granite-20b [dense] — llama-arch code model, MQA [arXiv:2405.04324; hf].

52L, d_model=6144, 48 heads (GQA kv=1 => MQA), d_ff=24576, vocab=49152.
"""
from repro_torch.configs.base import ArchConfig, register

GRANITE_20B = register(ArchConfig(
    name="granite-20b",
    family="dense",
    num_layers=52,
    d_model=6144,
    num_heads=48,
    num_kv_heads=1,
    head_dim=128,
    d_ff=24576,
    vocab_size=49152,
    attention="full",
    causal=True,
    ffn_kind="glu",
    norm_kind="rmsnorm",
    position="rope",
    rope_theta=10_000.0,
    tie_embeddings=False,
    supports_decode=True,
    subquadratic=False,
))
