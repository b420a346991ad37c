"""Architecture configuration schema + registry (port of ``repro.configs.base``).

The dataclasses are field-for-field copies of the JAX package's, so a config
built here compares equal, field by field, to its JAX twin. Every config of
the JAX package is registered (``ARCH_IDS`` in :mod:`repro_torch.configs`):
the attention archs and the two recurrent ones, recurrentgemma-9b (RG-LRU
beside local attention) and xlstm-125m (mLSTM and sLSTM blocks).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared: int = 0
    first_dense: int = 0
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (deepseek-v2)."""
    kv_lora_rank: int
    q_lora_rank: int
    qk_nope_dim: int
    qk_rope_dim: int
    v_head_dim: int


@dataclasses.dataclass(frozen=True)
class BlockKind:
    """Static identity of one layer's body; contiguous equal-kind runs form
    one execution group."""
    body: str                    # 'attn' | 'rglru' | 'mlstm' | 'slstm'
    local: bool = False          # sliding-window / local-attention mask
    moe: bool = False            # FFN group is a mixture-of-experts

    def __str__(self):
        tags = [self.body]
        if self.local:
            tags.append("local")
        if self.moe:
            tags.append("moe")
        return "+".join(tags)


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense|moe|vlm|ssm|audio|hybrid|bert
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    # --- attention ---
    attention: str = "full"      # full|sliding|local_global|none
    sliding_window: int = 4096
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    qkv_bias: bool = False
    causal: bool = True          # False => encoder-only (bidirectional)
    mla: Optional[MLAConfig] = None
    moe: Optional[MoEConfig] = None
    # --- ffn / norms / positions ---
    ffn_kind: str = "glu"        # glu|gelu|none
    norm_kind: str = "rmsnorm"   # rmsnorm|layernorm
    position: str = "rope"       # rope|learned|none
    rope_theta: float = 10_000.0
    max_position: int = 524_288  # learned-position table size cap
    tie_embeddings: bool = True
    emb_scale_by_sqrt_dim: bool = False
    # --- hybrid / ssm block pattern (cycled over layers) ---
    pattern: tuple[str, ...] = ("attn",)
    # --- ssm extras ---
    rnn_width: int = 0
    conv_width: int = 4
    proj_factor: float = 2.0
    # --- modality frontend stubs ---
    frontend: Optional[str] = None        # 'vision'|'audio'|None
    num_prefix_embeds: int = 0
    frontend_dim: int = 0
    # --- bert extras ---
    num_segments: int = 0        # >0 => add segment embeddings (BERT)
    # --- capability flags ---
    supports_decode: bool = True
    subquadratic: bool = False

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    def layer_kinds(self) -> tuple[BlockKind, ...]:
        """Expand ``pattern`` over ``num_layers`` into per-layer BlockKinds,
        applying MoE placement (``moe.first_dense`` leading layers dense)."""
        kinds = []
        for i in range(self.num_layers):
            p = self.pattern[i % len(self.pattern)]
            if p in ("attn", "attn_global"):
                k = BlockKind("attn", local=False)
            elif p == "attn_local":
                k = BlockKind("attn", local=True)
            elif p in ("rglru", "mlstm", "slstm"):
                k = BlockKind(p)
            else:
                raise ValueError(f"unknown pattern entry {p!r}")
            if self.moe is not None and k.body == "attn":
                if i >= self.moe.first_dense:
                    k = dataclasses.replace(k, moe=True)
            kinds.append(k)
        return tuple(kinds)

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ArchConfig":
        """Smoke-test variant: same family/pattern semantics, tiny dims."""
        kw: dict = dict(
            num_layers=min(self.num_layers, 4 * max(1, len(self.pattern) // 2)),
            d_model=64,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 2) or 1,
            head_dim=16,
            d_ff=128 if self.d_ff else 0,
            vocab_size=128,
            sliding_window=8,
            max_position=512,
            rnn_width=64 if self.rnn_width else 0,
            num_prefix_embeds=4 if self.num_prefix_embeds else 0,
            frontend_dim=32 if self.frontend_dim else 0,
        )
        if self.moe is not None:
            kw["moe"] = dataclasses.replace(
                self.moe, num_experts=4, top_k=2, d_ff_expert=32,
                num_shared=min(self.moe.num_shared, 1),
                first_dense=min(self.moe.first_dense, 1))
        if self.mla is not None:
            kw["mla"] = MLAConfig(kv_lora_rank=32, q_lora_rank=32,
                                  qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16)
        n = kw["num_layers"]
        if len(self.pattern) > 1:
            n = max(n, len(self.pattern))
            n -= n % len(self.pattern)
            kw["num_layers"] = n
        return self.replace(**kw)


_REGISTRY: dict[str, ArchConfig] = {}

# config modules of the ported slices (import side-effect registration),
# in the JAX package's order
_MODULES = ("bert_base", "deepseek_coder_33b", "qwen2_0_5b", "gemma2_2b",
            "granite_20b", "deepseek_v2_236b", "mixtral_8x22b",
            "paligemma_3b", "xlstm_125m", "hubert_xlarge",
            "recurrentgemma_9b")


def register(cfg: ArchConfig) -> ArchConfig:
    if cfg.name in _REGISTRY:
        raise KeyError(f"duplicate arch id {cfg.name!r}")
    _REGISTRY[cfg.name] = cfg
    return cfg


def load_all() -> None:
    """Import every ported config module (each registers its config)."""
    for m in _MODULES:
        importlib.import_module(f"repro_torch.configs.{m}")


def get_config(name: str) -> ArchConfig:
    load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def all_configs() -> dict[str, ArchConfig]:
    load_all()
    return dict(_REGISTRY)
