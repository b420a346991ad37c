"""BERT-base (L12_H768) — the paper's own evaluation model (Devlin et al.).

Encoder-only, learned positions + segment embeddings, pre-LN layers (the JAX
package's documented deviation, kept so the two packages agree), GELU FFN.
"""
from repro_torch.configs.base import ArchConfig, register

BERT_BASE = register(ArchConfig(
    name="bert-base",
    family="bert",
    num_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    head_dim=64,
    d_ff=3072,
    vocab_size=21128,            # bert-base-chinese vocab (paper uses CLUE)
    attention="full",
    causal=False,
    ffn_kind="gelu",
    norm_kind="layernorm",
    position="learned",
    max_position=512,
    rope_theta=0.0,
    tie_embeddings=False,
    num_segments=2,
    supports_decode=False,
    subquadratic=False,
))
