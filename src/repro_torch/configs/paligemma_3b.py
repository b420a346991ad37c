"""paligemma-3b [vlm] — SigLIP vision front-end + gemma backbone
[arXiv:2407.07726; hf].

Backbone: 18L, d_model=2048, 8 heads (MQA kv=1), d_ff=16384, vocab=257216.
The SigLIP encoder is not modelled: the inputs carry precomputed patch
embeddings (``prefix_embeds``, 256 prefix tokens, bidirectional prefix-LM
attention over the image region).
"""
from repro_torch.configs.base import ArchConfig, register

PALIGEMMA_3B = register(ArchConfig(
    name="paligemma-3b",
    family="vlm",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=257216,
    attention="full",
    causal=True,
    ffn_kind="glu",
    norm_kind="rmsnorm",
    position="rope",
    rope_theta=10_000.0,
    tie_embeddings=True,
    emb_scale_by_sqrt_dim=True,
    frontend="vision",
    num_prefix_embeds=256,
    frontend_dim=1152,
    supports_decode=True,
    subquadratic=False,
))
