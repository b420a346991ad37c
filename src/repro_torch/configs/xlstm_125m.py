"""xlstm-125m [ssm] — sLSTM + mLSTM blocks [arXiv:2405.04517; unverified].

12L, d_model=768, 4 heads, no separate FFN (d_ff=0: the xLSTM block embeds
its own up/down projection, proj_factor=2). Pattern choice (alternating
mLSTM/sLSTM) is ours — the source is tier-unverified; documented in
DESIGN.md. Attention-free => FULLY_QUANT ≡ QUANT_FFN_ONLY and long_500k RUNS
(O(1) recurrent state).
"""
from repro_torch.configs.base import ArchConfig, register

XLSTM_125M = register(ArchConfig(
    name="xlstm-125m",
    family="ssm",
    num_layers=12,
    d_model=768,
    num_heads=4,
    num_kv_heads=4,
    head_dim=192,                # d_model / num_heads in the projected space
    d_ff=0,
    vocab_size=50304,
    attention="none",
    pattern=("mlstm", "slstm"),
    causal=True,
    ffn_kind="none",
    norm_kind="layernorm",
    position="none",
    proj_factor=2.0,
    conv_width=4,
    tie_embeddings=True,
    supports_decode=True,
    subquadratic=True,
))
