"""mixtral-8x22b [moe] — 8 experts top-2, sliding-window attention
[arXiv:2401.04088; hf].

56L, d_model=6144, 48 heads (GQA kv=8), d_ff_expert=16384, vocab=32768.
Every layer is ``attn_local``: decode keeps a dense ring of
min(sliding_window, max_len) positions per layer.
"""
from repro_torch.configs.base import ArchConfig, MoEConfig, register

MIXTRAL_8X22B = register(ArchConfig(
    name="mixtral-8x22b",
    family="moe",
    num_layers=56,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=32768,
    attention="sliding",
    pattern=("attn_local",),
    sliding_window=4096,
    causal=True,
    moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=16384,
                  num_shared=0, first_dense=0, capacity_factor=1.25),
    ffn_kind="glu",
    norm_kind="rmsnorm",
    position="rope",
    rope_theta=1_000_000.0,
    tie_embeddings=False,
    supports_decode=True,
    subquadratic=True,
))
