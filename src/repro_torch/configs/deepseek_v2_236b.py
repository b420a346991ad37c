"""deepseek-v2-236b [moe] — MLA kv_lora=512, 2 shared + 160 routed top-6
[arXiv:2405.04434; hf].

60L, d_model=5120, 128 heads, d_ff_expert=1536, vocab=102400. First layer is
dense FFN (d_ff=12288), remaining 59 are MoE.
"""
from repro_torch.configs.base import ArchConfig, MLAConfig, MoEConfig, register

DEEPSEEK_V2_236B = register(ArchConfig(
    name="deepseek-v2-236b",
    family="moe",
    num_layers=60,
    d_model=5120,
    num_heads=128,
    num_kv_heads=128,
    head_dim=128,
    d_ff=12288,
    vocab_size=102400,
    attention="full",
    causal=True,
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536,
                  qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128),
    moe=MoEConfig(num_experts=160, top_k=6, d_ff_expert=1536,
                  num_shared=2, first_dense=1, capacity_factor=1.25),
    ffn_kind="glu",
    norm_kind="rmsnorm",
    position="rope",
    rope_theta=10_000.0,
    tie_embeddings=False,
    supports_decode=True,
    subquadratic=False,
))
