"""recurrentgemma-9b [hybrid] — RG-LRU + local attention, 1 attention per
2 recurrent blocks (Griffin) [arXiv:2402.19427; unverified].

38L, d_model=4096, 16 heads (MQA kv=1), d_ff=12288, vocab=256000.
Bounded local window + O(1) recurrent state => long_500k RUNS.
"""
from repro_torch.configs.base import ArchConfig, register

RECURRENTGEMMA_9B = register(ArchConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    num_layers=38,               # 12 full (rglru,rglru,attn) periods + 2 rglru
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    attention="sliding",
    pattern=("rglru", "rglru", "attn_local"),
    sliding_window=2048,
    causal=True,
    ffn_kind="glu",
    norm_kind="rmsnorm",
    position="rope",
    rope_theta=10_000.0,
    rnn_width=4096,
    conv_width=4,
    tie_embeddings=True,
    emb_scale_by_sqrt_dim=True,
    supports_decode=True,
    subquadratic=True,
))
