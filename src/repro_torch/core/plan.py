"""PrecisionPlan — the declarative, serializable precision API (port of
``repro.core.plan``).

A plan is an immutable tree ``PrecisionPlan -> LayerPlan -> QuantSpec``:
per layer, per GEMM block (``qkv`` / ``attn_out`` / ``ffn_in`` /
``ffn_out``), a :class:`QuantSpec` names the weight scheme, the activation
scheme and the calibrator. Schemas v1-v4 load; ``fingerprint()`` is the
sha256 of the canonical JSON form and is byte-identical to the JAX
package's for the same plan, so both packages key caches and artifacts on
one identity. ``PlanSet`` (input-adaptive plans) arrives with the adaptive
slice.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Mapping, Optional, Union

from repro_torch.core.calibration import CALIBRATORS
from repro_torch.core.precision import EncoderPolicy, LayerMode

SCHEMA_VERSION = 4

WEIGHT_SCHEMES = ("float", "int8_per_channel", "int8_per_tensor")
ACT_SCHEMES = ("float", "int8_per_tensor", "int8_per_token")
KV_CACHE_SCHEMES = ("float", "int8_per_head", "int8_per_token")
SOFTMAX_SCHEMES = ("float", "uint8")
NORM_SCHEMES = ("float", "int8")
BLOCKS = ("qkv", "attn_out", "ffn_in", "ffn_out")
# schema v4: named block families beyond the fixed 4-GEMM encoder layer
BLOCK_FAMILIES = ("experts", "router", "shared_ffn")
FAMILY_ALIASES = {
    "recurrence_gates": "ffn_in",
    "recurrence_out": "ffn_out",
    "conv_stem": "ffn_in",
}
FLOAT_DTYPES = ("float32", "bfloat16", "float16")


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    """Numeric scheme of one GEMM block: weight + activation + calibrator.
    ``weight == 'float'`` iff ``act == 'float'`` (GEMMs are float or W8A8)."""

    weight: str = "float"
    act: str = "float"
    calibrator: str = "minmax"

    def __post_init__(self):
        if self.weight not in WEIGHT_SCHEMES:
            raise ValueError(f"weight scheme {self.weight!r} not in "
                             f"{WEIGHT_SCHEMES}")
        if self.act not in ACT_SCHEMES:
            raise ValueError(f"act scheme {self.act!r} not in {ACT_SCHEMES}")
        if (self.weight == "float") != (self.act == "float"):
            raise ValueError(
                f"weight={self.weight!r} with act={self.act!r}: the GEMM "
                f"substrate is float or W8A8; quantize both or neither")
        if self.calibrator not in CALIBRATORS:
            raise ValueError(f"unknown calibrator {self.calibrator!r}; "
                             f"have {tuple(sorted(CALIBRATORS))}")

    @property
    def quantized(self) -> bool:
        return self.weight != "float"

    @property
    def static_acts(self) -> bool:
        return self.act == "int8_per_tensor"

    def to_dict(self) -> dict:
        return {"weight": self.weight, "act": self.act,
                "calibrator": self.calibrator}

    @classmethod
    def from_dict(cls, d: Mapping) -> "QuantSpec":
        extra = set(d) - {"weight", "act", "calibrator"}
        if extra:
            raise ValueError(f"unknown QuantSpec fields {sorted(extra)}")
        return cls(**dict(d))


FLOAT_SPEC = QuantSpec()
INT8_SPEC = QuantSpec(weight="int8_per_channel", act="int8_per_tensor")


@dataclasses.dataclass(frozen=True)
class LayerPlan:
    """Per-block QuantSpecs for one layer, plus the KV-cache scheme (v2),
    the inter-kernel dataflow schemes (v3) and the block families (v4)."""

    qkv: QuantSpec = FLOAT_SPEC
    attn_out: QuantSpec = FLOAT_SPEC
    ffn_in: QuantSpec = FLOAT_SPEC
    ffn_out: QuantSpec = FLOAT_SPEC
    kv_cache: str = "float"
    softmax: str = "float"
    norm: str = "float"
    experts: Optional[QuantSpec] = None
    router: Optional[QuantSpec] = None
    shared_ffn: Optional[QuantSpec] = None

    def __post_init__(self):
        for fam in BLOCK_FAMILIES:
            v = getattr(self, fam)
            if v is not None and not isinstance(v, QuantSpec):
                raise TypeError(f"family {fam!r} must be a QuantSpec or "
                                f"None, got {type(v).__name__}")
        if self.router is not None and self.router.quantized:
            raise ValueError(
                f"family 'router' must stay float: the MoE gate projection "
                f"decides dispatch and does not survive int8 (got weight="
                f"{self.router.weight!r}/act={self.router.act!r})")
        if self.experts is not None and self.experts.quantized:
            if self.experts.weight != "int8_per_channel":
                raise ValueError(
                    f"family 'experts' quantizes with per-expert "
                    f"per-channel scales (shape (E, 1, F)); weight scheme "
                    f"must be 'int8_per_channel', got "
                    f"{self.experts.weight!r}")
        if self.kv_cache not in KV_CACHE_SCHEMES:
            raise ValueError(f"kv_cache scheme {self.kv_cache!r} not in "
                             f"{KV_CACHE_SCHEMES}")
        if self.softmax not in SOFTMAX_SCHEMES:
            raise ValueError(f"softmax scheme {self.softmax!r} not in "
                             f"{SOFTMAX_SCHEMES}")
        if self.norm not in NORM_SCHEMES:
            raise ValueError(f"norm scheme {self.norm!r} not in "
                             f"{NORM_SCHEMES}")
        if self.softmax == "uint8" and not (self.qkv.quantized
                                            or self.kv_cache != "float"):
            raise ValueError(
                "softmax='uint8' quantizes the attention probabilities for "
                "an int8 P·V matmul; the layer must quantize 'qkv' (encoder "
                "bmms) or its kv_cache (decode)")
        if self.norm == "int8":
            for b in ("attn_out", "ffn_in"):
                s = self.spec(b)
                if not (s.quantized and s.static_acts):
                    raise ValueError(
                        f"norm='int8' carries the attn→norm→ffn boundary in "
                        f"int8 under calibrated static scales; block {b!r} "
                        f"is weight={s.weight!r}/act={s.act!r} (needs int8 "
                        f"weight + act='int8_per_tensor')")

    def spec(self, block: str) -> QuantSpec:
        block = FAMILY_ALIASES.get(block, block)
        if block in BLOCK_FAMILIES:
            fam = getattr(self, block)
            if fam is not None:
                return fam
            return FLOAT_SPEC if block == "router" else self.ffn_in
        if block not in BLOCKS:
            raise KeyError(
                f"unknown block {block!r}; have blocks {BLOCKS}, families "
                f"{BLOCK_FAMILIES}, aliases {tuple(sorted(FAMILY_ALIASES))}")
        return getattr(self, block)

    @property
    def has_families(self) -> bool:
        return any(getattr(self, fam) is not None for fam in BLOCK_FAMILIES)

    @property
    def quant_mha(self) -> bool:
        return self.qkv.quantized or self.attn_out.quantized

    @property
    def quant_ffn(self) -> bool:
        if self.experts is not None and self.experts.quantized:
            return True
        if self.shared_ffn is not None and self.shared_ffn.quantized:
            return True
        return self.ffn_in.quantized or self.ffn_out.quantized

    @property
    def mode(self) -> LayerMode:
        """Nearest point on the paper's per-layer mode lattice."""
        if self.quant_mha:
            return LayerMode.FULLY_QUANT
        if self.quant_ffn:
            return LayerMode.QUANT_FFN_ONLY
        return LayerMode.FLOAT

    def to_dict(self) -> dict:
        d = {b: self.spec(b).to_dict() for b in BLOCKS}
        # non-GEMM fields are omitted at their defaults, so the canonical
        # (fingerprinted) form only carries the newest field a plan uses
        if self.kv_cache != "float":
            d["kv_cache"] = self.kv_cache
        if self.softmax != "float":
            d["softmax"] = self.softmax
        if self.norm != "float":
            d["norm"] = self.norm
        for fam in BLOCK_FAMILIES:
            v = getattr(self, fam)
            if v is not None:
                d[fam] = v.to_dict()
        return d

    @classmethod
    def from_dict(cls, d: Mapping, *, arch_family: Optional[str] = None
                  ) -> "LayerPlan":
        known = set(BLOCKS) | set(BLOCK_FAMILIES) | set(FAMILY_ALIASES) \
            | {"kv_cache", "softmax", "norm"}
        extra = set(d) - known
        if extra:
            arch = (f" (config architecture family: {arch_family!r})"
                    if arch_family else "")
            raise ValueError(
                f"unknown blocks {sorted(extra)}; accepted blocks are "
                f"{BLOCKS}, block families {BLOCK_FAMILIES}, family "
                f"aliases {tuple(sorted(FAMILY_ALIASES))}, and layer "
                f"fields ('kv_cache', 'softmax', 'norm'){arch}")
        kw = {b: QuantSpec.from_dict(d[b]) for b in BLOCKS if b in d}
        for alias, target in FAMILY_ALIASES.items():
            if alias in d:
                if target in d:
                    raise ValueError(
                        f"alias {alias!r} resolves to block {target!r}, "
                        f"which the plan also sets explicitly")
                kw[target] = QuantSpec.from_dict(d[alias])
        for fam in BLOCK_FAMILIES:
            if fam in d:
                kw[fam] = QuantSpec.from_dict(d[fam])
        for field in ("kv_cache", "softmax", "norm"):
            if field in d:
                kw[field] = d[field]
        return cls(**kw)

    @classmethod
    def for_mode(cls, mode: LayerMode, *, dynamic_acts: bool = False,
                 calibrator: str = "minmax", softmax: str = "float",
                 norm: str = "float") -> "LayerPlan":
        """The paper's per-layer modes as block plans; ``softmax``/``norm``
        add the schema-v3 dataflow schemes (validated against the mode —
        e.g. ``softmax='uint8'`` needs ``quant_mha``)."""
        act = "int8_per_token" if dynamic_acts else "int8_per_tensor"
        q = QuantSpec(weight="int8_per_channel", act=act,
                      calibrator=calibrator)
        return cls(qkv=q if mode.quant_mha else FLOAT_SPEC,
                   attn_out=q if mode.quant_mha else FLOAT_SPEC,
                   ffn_in=q if mode.quant_ffn else FLOAT_SPEC,
                   ffn_out=q if mode.quant_ffn else FLOAT_SPEC,
                   softmax=softmax, norm=norm)

    def with_kv(self, kv_cache: str) -> "LayerPlan":
        """Same GEMM blocks, different KV-cache scheme (schema v2)."""
        return dataclasses.replace(self, kv_cache=kv_cache)

    def with_dataflow(self, *, softmax: Optional[str] = None,
                      norm: Optional[str] = None) -> "LayerPlan":
        """Same GEMM blocks, different inter-kernel dataflow schemes."""
        kw = {}
        if softmax is not None:
            kw["softmax"] = softmax
        if norm is not None:
            kw["norm"] = norm
        return dataclasses.replace(self, **kw) if kw else self


FLOAT_LAYER = LayerPlan()


@dataclasses.dataclass(frozen=True)
class PrecisionPlan:
    """Immutable per-layer, per-block precision description of one model."""

    layers: tuple[LayerPlan, ...]
    float_dtype: str = "bfloat16"

    def __post_init__(self):
        object.__setattr__(self, "layers", tuple(self.layers))
        if self.float_dtype not in FLOAT_DTYPES:
            raise ValueError(f"float_dtype {self.float_dtype!r} not in "
                             f"{FLOAT_DTYPES}")

    @property
    def num_layers(self) -> int:
        return len(self.layers)

    def bmm_quantized(self, layer_idx: int) -> bool:
        """Whether the attention score/value batched matmuls of layer
        ``layer_idx`` run int8 — they belong to the qkv block."""
        return self.layers[layer_idx].qkv.quantized

    @property
    def kv_schemes(self) -> tuple:
        """Per-layer KV-cache schemes (what ``init_caches`` consumes)."""
        return tuple(lp.kv_cache for lp in self.layers)

    @property
    def num_quant_kv(self) -> int:
        return sum(lp.kv_cache != "float" for lp in self.layers)

    def softmax_scheme(self, layer_idx: int) -> str:
        """The softmax dataflow scheme of layer ``layer_idx`` (schema v3)."""
        return self.layers[layer_idx].softmax

    def group_boundaries(self) -> list[tuple[int, int, LayerMode]]:
        """Contiguous runs of *identical* LayerPlans: [(start, stop, mode)]."""
        runs: list[tuple[int, int, LayerMode]] = []
        start = 0
        for i in range(1, self.num_layers + 1):
            if i == self.num_layers or self.layers[i] != self.layers[start]:
                runs.append((start, i, self.layers[start].mode))
                start = i
        return runs

    def describe(self) -> str:
        n = self.num_layers
        mha = sum(lp.quant_mha for lp in self.layers)
        ffn = sum(lp.quant_ffn for lp in self.layers)
        return (f"plan MHA {mha}/{n} FFN {ffn}/{n} [{self.float_dtype}] "
                f"#{self.fingerprint()[:12]}")

    @staticmethod
    def full_float(num_layers: int,
                   float_dtype: str = "bfloat16") -> "PrecisionPlan":
        return PrecisionPlan((FLOAT_LAYER,) * num_layers, float_dtype)

    @staticmethod
    def uniform(num_layers: int, layer: LayerPlan,
                float_dtype: str = "bfloat16") -> "PrecisionPlan":
        return PrecisionPlan((layer,) * num_layers, float_dtype)

    # -- serialization ------------------------------------------------------
    def to_dict(self) -> dict:
        # the canonical form carries the minimal schema version that can
        # express the plan, so older plans keep their fingerprints
        if any(lp.has_families for lp in self.layers):
            version = 4
        elif any(lp.softmax != "float" or lp.norm != "float"
                 for lp in self.layers):
            version = 3
        elif any(lp.kv_cache != "float" for lp in self.layers):
            version = 2
        else:
            version = 1
        return {"schema_version": version,
                "float_dtype": self.float_dtype,
                "layers": [lp.to_dict() for lp in self.layers]}

    @classmethod
    def from_dict(cls, d: Mapping, *,
                  arch_family: Optional[str] = None) -> "PrecisionPlan":
        version = d.get("schema_version")
        if version not in (1, 2, 3, SCHEMA_VERSION):
            raise ValueError(f"plan schema_version {version!r} not in "
                             f"(1, 2, 3, {SCHEMA_VERSION})")
        layer_dicts = [lp for lp in d.get("layers") or ()
                       if isinstance(lp, Mapping)]
        if version == 1 and any("kv_cache" in lp for lp in layer_dicts):
            raise ValueError("'kv_cache' is a schema v2 field; this plan "
                             "declares schema_version 1")
        if version < 3 and any("softmax" in lp or "norm" in lp
                               for lp in layer_dicts):
            raise ValueError("'softmax'/'norm' are schema v3 fields; this "
                             f"plan declares schema_version {version}")
        fam_keys = set(BLOCK_FAMILIES) | set(FAMILY_ALIASES)
        if version < 4 and any(fam_keys & set(lp) for lp in layer_dicts):
            used = sorted(set().union(*(fam_keys & set(lp)
                                        for lp in layer_dicts)))
            raise ValueError(
                f"block families {used} are schema v4 fields; this plan "
                f"declares schema_version {version}")
        extra = set(d) - {"schema_version", "float_dtype", "layers"}
        if extra:
            raise ValueError(f"unknown plan fields {sorted(extra)}")
        layers = d.get("layers")
        if not isinstance(layers, (list, tuple)) or not layers:
            raise ValueError("plan needs a non-empty 'layers' list")
        return cls(tuple(LayerPlan.from_dict(lp, arch_family=arch_family)
                         for lp in layers),
                   d.get("float_dtype", "bfloat16"))

    def to_json(self, indent: Optional[int] = 1) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "PrecisionPlan":
        return cls.from_dict(json.loads(text))

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            f.write(self.to_json() + "\n")
        return path

    @classmethod
    def load(cls, path: str) -> "PrecisionPlan":
        with open(path) as f:
            return cls.from_json(f.read())

    def fingerprint(self) -> str:
        """sha256 over the canonical (sorted-key, whitespace-free) JSON."""
        canon = json.dumps(self.to_dict(), sort_keys=True,
                           separators=(",", ":"))
        return hashlib.sha256(canon.encode("utf-8")).hexdigest()


def plan_from_policy(policy: EncoderPolicy, *, dynamic_acts: bool = False,
                     calibrator: str = "minmax") -> PrecisionPlan:
    """Lossless EncoderPolicy -> PrecisionPlan conversion: each layer's mode
    as its block plan (:meth:`LayerPlan.for_mode`)."""
    return PrecisionPlan(
        tuple(LayerPlan.for_mode(m, dynamic_acts=dynamic_acts,
                                 calibrator=calibrator)
              for m in policy.modes),
        policy.float_dtype)


def as_plan(precision: Union[PrecisionPlan, EncoderPolicy], *,
            dynamic_acts: bool = False,
            calibrator: str = "minmax") -> PrecisionPlan:
    """Coerce either precision description to a PrecisionPlan."""
    if isinstance(precision, PrecisionPlan):
        return precision
    if isinstance(precision, EncoderPolicy):
        return plan_from_policy(precision, dynamic_acts=dynamic_acts,
                                calibrator=calibrator)
    raise TypeError(f"expected PrecisionPlan or EncoderPolicy, got "
                    f"{type(precision).__name__}")
