"""PrecisionPlan — the declarative, serializable precision API (port of
``repro.core.plan``).

A plan is an immutable tree ``PrecisionPlan -> LayerPlan -> QuantSpec``:
per layer, per GEMM block (``qkv`` / ``attn_out`` / ``ffn_in`` /
``ffn_out``), a :class:`QuantSpec` names the weight scheme, the activation
scheme and the calibrator. Schemas v1-v4 load; ``fingerprint()`` is the
sha256 of the canonical JSON form and is byte-identical to the JAX
package's for the same plan, so both packages key caches and artifacts on
one identity. :class:`PlanSet` holds K plans keyed by traffic cluster: its
schema, fingerprint and JSON are here (``plan_lint`` checks planset files);
:mod:`repro_torch.adaptive` routes requests over one.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import warnings
from typing import Mapping, Optional, Sequence, Union

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

    def with_families(self, *, experts: Optional[QuantSpec] = None,
                      router: Optional[QuantSpec] = None,
                      shared_ffn: Optional[QuantSpec] = None) -> "LayerPlan":
        """Same GEMM blocks, with schema-v4 block families set (only the
        families passed are changed; pass ``FLOAT_SPEC`` to pin one float)."""
        kw = {}
        if experts is not None:
            kw["experts"] = experts
        if router is not None:
            kw["router"] = router
        if shared_ffn is not None:
            kw["shared_ffn"] = shared_ffn
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

    @property
    def modes(self) -> tuple[LayerMode, ...]:
        return tuple(lp.mode for lp in self.layers)

    @property
    def num_quant_ffn(self) -> int:
        return sum(lp.quant_ffn for lp in self.layers)

    @property
    def num_quant_mha(self) -> int:
        return sum(lp.quant_mha for lp in self.layers)

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

    @property
    def softmax_schemes(self) -> tuple:
        """Per-layer softmax dataflow schemes (schema v3)."""
        return tuple(lp.softmax for lp in self.layers)

    @property
    def norm_schemes(self) -> tuple:
        """Per-layer norm dataflow schemes (schema v3)."""
        return tuple(lp.norm for lp in self.layers)

    @property
    def num_int8_dataflow(self) -> int:
        """Layers carrying at least one schema-v3 int8 boundary."""
        return sum(lp.softmax != "float" or lp.norm != "float"
                   for lp in self.layers)

    @property
    def num_expert_layers(self) -> int:
        """Layers with a quantized ``experts`` block family (schema v4)."""
        return sum(lp.experts is not None and lp.experts.quantized
                   for lp in self.layers)

    def describe(self) -> str:
        n = self.num_layers
        cals = sorted({s.calibrator for lp in self.layers for s in
                       (lp.qkv, lp.attn_out, lp.ffn_in, lp.ffn_out,
                        lp.experts, lp.shared_ffn)
                       if s is not None and s.quantized}) or ["-"]
        flow = (f" FLOW {self.num_int8_dataflow}/{n}"
                if self.num_int8_dataflow else "")
        moe = (f" MOE {self.num_expert_layers}/{n}"
               if self.num_expert_layers else "")
        return (f"plan MHA {self.num_quant_mha}/{n} FFN "
                f"{self.num_quant_ffn}/{n} KV {self.num_quant_kv}/{n}"
                f"{flow}{moe} [{self.float_dtype}] "
                f"cal={','.join(cals)} #{self.fingerprint()[:12]}")

    @staticmethod
    def full_float(num_layers: int,
                   float_dtype: str = "bfloat16") -> "PrecisionPlan":
        return PrecisionPlan((FLOAT_LAYER,) * num_layers, float_dtype)

    @staticmethod
    def uniform(num_layers: int, layer: LayerPlan,
                float_dtype: str = "bfloat16") -> "PrecisionPlan":
        return PrecisionPlan((layer,) * num_layers, float_dtype)

    @staticmethod
    def prefix(num_layers: int, k: int, layer: Union[LayerPlan, LayerMode],
               float_dtype: str = "bfloat16", **mode_kw) -> "PrecisionPlan":
        """Quantize the first ``k`` layers under ``layer`` (a LayerPlan, or
        a LayerMode expanded via :meth:`LayerPlan.for_mode`)."""
        if not 0 <= k <= num_layers:
            raise ValueError(f"k={k} out of range for {num_layers} layers")
        if isinstance(layer, LayerMode):
            layer = LayerPlan.for_mode(layer, **mode_kw)
        return PrecisionPlan((layer,) * k + (FLOAT_LAYER,) * (num_layers - k),
                             float_dtype)

    @staticmethod
    def subset(num_layers: int, layers: Sequence[int],
               layer: Union[LayerPlan, LayerMode],
               float_dtype: str = "bfloat16", **mode_kw) -> "PrecisionPlan":
        """Quantize an arbitrary layer subset (the greedy strategies)."""
        layer_set = set(layers)
        bad = layer_set - set(range(num_layers))
        if bad:
            raise ValueError(f"layer indices {sorted(bad)} out of range")
        if isinstance(layer, LayerMode):
            layer = LayerPlan.for_mode(layer, **mode_kw)
        return PrecisionPlan(
            tuple(layer if i in layer_set else FLOAT_LAYER
                  for i in range(num_layers)), float_dtype)

    @staticmethod
    def from_policy(policy: EncoderPolicy, *, dynamic_acts: bool = False,
                    calibrator: str = "minmax") -> "PrecisionPlan":
        """EncoderPolicy -> PrecisionPlan shim (deprecated entry point: the
        mode lattice is a strict subset of what plans express)."""
        warnings.warn(
            "EncoderPolicy is deprecated as a precision description; "
            "use PrecisionPlan (this shim converts losslessly)",
            DeprecationWarning, stacklevel=2)
        return plan_from_policy(policy, dynamic_acts=dynamic_acts,
                                calibrator=calibrator)

    def to_policy(self) -> EncoderPolicy:
        """Project onto the paper's mode lattice (lossy for per-block or
        per-tensor-weight plans; exact for plans built from policies)."""
        return EncoderPolicy(self.modes, self.float_dtype)

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


PLANSET_VERSION = 1


@dataclasses.dataclass(frozen=True)
class PlanSet:
    """K fingerprinted :class:`PrecisionPlan` members keyed by cluster id.

    The input-adaptive precision identity: one deployment carries one weight
    tree and K precision plans, one per traffic cluster. Each member keeps
    its own ``fingerprint()``, so two clusters that landed the same plan
    content still get distinct cache entries and per-cluster activation
    scales. :class:`repro_torch.adaptive.PlanRouter` serves a set.

    ``members`` maps cluster id -> plan; ``default`` names the cluster that
    serves requests the router cannot classify. All members must describe
    the same layer count (they share one model), and cluster ids must be
    unique non-negative ints — both enforced at construction, so
    ``plan_lint`` surfaces them as load-time errors.
    """

    members: tuple         # ((cluster_id, PrecisionPlan), ...) sorted by id
    default: int = 0

    def __post_init__(self):
        pairs = tuple(sorted((int(c), p) for c, p in self.members))
        if not pairs:
            raise ValueError("PlanSet needs at least one member plan")
        seen: set = set()
        for cid, plan in pairs:
            if cid < 0:
                raise ValueError(f"cluster id {cid} is negative")
            if cid in seen:
                raise ValueError(f"duplicate cluster id {cid} in PlanSet")
            seen.add(cid)
            if not isinstance(plan, PrecisionPlan):
                raise TypeError(f"member for cluster {cid} is "
                                f"{type(plan).__name__}, not PrecisionPlan")
        counts = {cid: p.num_layers for cid, p in pairs}
        if len(set(counts.values())) > 1:
            raise ValueError(f"member plans disagree on layer count: "
                             f"{counts} — a PlanSet spans one model")
        if int(self.default) not in seen:
            raise ValueError(f"default cluster {self.default} has no "
                             f"member plan (have {sorted(seen)})")
        object.__setattr__(self, "members", pairs)
        object.__setattr__(self, "default", int(self.default))

    # -- mapping surface ----------------------------------------------------
    @property
    def plans(self) -> dict:
        return dict(self.members)

    @property
    def cluster_ids(self) -> tuple:
        return tuple(c for c, _ in self.members)

    def __len__(self) -> int:
        return len(self.members)

    def __iter__(self):
        return iter(self.members)

    def plan_for(self, cluster: int) -> PrecisionPlan:
        """Member plan for ``cluster``, falling back to ``default`` for ids
        the set does not cover (the router's unknown-traffic contract)."""
        d = self.plans
        return d.get(int(cluster), d[self.default])

    @property
    def num_layers(self) -> int:
        return self.members[0][1].num_layers

    def describe(self) -> str:
        body = "; ".join(f"c{cid}:{p.describe()}" for cid, p in self.members)
        return (f"planset K={len(self)} default=c{self.default} "
                f"#{self.fingerprint()[:12]} [{body}]")

    # -- constructors -------------------------------------------------------
    @staticmethod
    def single(plan: PrecisionPlan, cluster: int = 0) -> "PlanSet":
        """K=1 set — the routed form of an unrouted deployment."""
        return PlanSet(((cluster, plan),), default=cluster)

    @staticmethod
    def uniform(plan: PrecisionPlan, clusters: Sequence[int]) -> "PlanSet":
        """Same plan for every cluster (per-cluster *scales* still differ —
        calibration is cluster-conditional even when the plan is not)."""
        cids = tuple(clusters)
        return PlanSet(tuple((c, plan) for c in cids), default=cids[0])

    # -- serialization ------------------------------------------------------
    def to_dict(self) -> dict:
        return {"planset_version": PLANSET_VERSION,
                "default": self.default,
                "members": [{"cluster": cid, "plan": p.to_dict()}
                            for cid, p in self.members]}

    @classmethod
    def from_dict(cls, d: Mapping, *,
                  arch_family: Optional[str] = None) -> "PlanSet":
        version = d.get("planset_version")
        if version != PLANSET_VERSION:
            raise ValueError(f"planset_version {version!r} != "
                             f"{PLANSET_VERSION}")
        extra = set(d) - {"planset_version", "default", "members"}
        if extra:
            raise ValueError(f"unknown planset fields {sorted(extra)}")
        members = d.get("members")
        if not isinstance(members, (list, tuple)) or not members:
            raise ValueError("planset needs a non-empty 'members' list")
        pairs = []
        for m in members:
            if not isinstance(m, Mapping) or set(m) != {"cluster", "plan"}:
                raise ValueError(f"planset member must be "
                                 f"{{'cluster', 'plan'}}, got {m!r}")
            # PrecisionPlan.from_dict enforces the per-member schema rules
            # (kv_cache is v2-only, unknown fields rejected)
            pairs.append((int(m["cluster"]),
                          PrecisionPlan.from_dict(m["plan"],
                                                  arch_family=arch_family)))
        return cls(tuple(pairs), d.get("default", pairs[0][0]))

    def to_json(self, indent: Optional[int] = 1) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "PlanSet":
        return cls.from_dict(json.loads(text))

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            f.write(self.to_json() + "\n")
        return path

    @classmethod
    def load(cls, path: str) -> "PlanSet":
        with open(path) as f:
            return cls.from_json(f.read())

    def fingerprint(self) -> str:
        """Content hash of the whole set (member order is canonical: sorted
        by cluster id). Artifact bundles v3 persist this alongside each
        member's own fingerprint."""
        canon = json.dumps(self.to_dict(), sort_keys=True,
                           separators=(",", ":"))
        return hashlib.sha256(canon.encode("utf-8")).hexdigest()


def load_plan_or_planset(path: str) -> Union[PrecisionPlan, "PlanSet"]:
    """Load either a single-plan JSON or a PlanSet JSON, sniffing the
    ``planset_version`` key. Single-plan files load exactly as before —
    the PlanSet format is additive."""
    with open(path) as f:
        d = json.load(f)
    if isinstance(d, Mapping) and "planset_version" in d:
        return PlanSet.from_dict(d)
    return PrecisionPlan.from_dict(d)


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
