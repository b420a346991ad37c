"""gemma2-2b [dense] — local+global alternating attention, logit softcaps
[arXiv:2408.00118; hf].

26L, d_model=2304, 8 heads (GQA kv=4), d_ff=9216, vocab=256000, head_dim=256.
Local layers keep a dense ring of min(sliding_window, max_len) positions in
decode; the global (full-attention) layers take the paged pool.
"""
from repro_torch.configs.base import ArchConfig, register

GEMMA2_2B = register(ArchConfig(
    name="gemma2-2b",
    family="dense",
    num_layers=26,
    d_model=2304,
    num_heads=8,
    num_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab_size=256000,
    attention="local_global",
    pattern=("attn_local", "attn_global"),
    sliding_window=4096,
    attn_softcap=50.0,
    final_softcap=30.0,
    causal=True,
    ffn_kind="glu",
    norm_kind="rmsnorm",
    position="rope",
    rope_theta=10_000.0,
    tie_embeddings=True,
    emb_scale_by_sqrt_dim=True,
    supports_decode=True,
    subquadratic=False,
))
