"""Port parity for the attention architectures beyond BERT, qwen2 and
mixtral: gemma2-2b (local and global layers, logit softcaps, sqrt(d)
embedding scale), granite-20b (MQA), deepseek-coder-33b (GQA 7),
hubert-xlarge (the audio front-end, a bidirectional LayerNorm / GELU
encoder), paligemma-3b (the vision prefix-LM) and deepseek-v2-236b (MLA and
160-expert MoE; its attention body has its own file,
``test_torch_mla.py``), each reduced, fed the same numpy inputs in both
packages with the JAX parameters carried across: the registry, execution
plans, parameter trees, float and quantized forwards, calibration, PTQ,
decode against prefill, the serving engine, ``Runtime.encode`` and the
pipeline with front-end inputs."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import all_configs as jax_all_configs
from repro.configs import get_config as jax_get_config
from repro.core.calibration import \
    synthetic_calibration_batches as jax_synthetic_batches
from repro.models import transformer as JT
from repro.serve import Request as JaxRequest
from repro.serve import Runtime as JaxRuntime
from repro.serve import ServeEngine as JaxEngine
from repro.toolkit.pipeline import Pipeline as JaxPipeline

from repro_torch.configs import ARCH_IDS, all_configs, get_config
from repro_torch.core.calibration import synthetic_calibration_batches
from repro_torch.interop import (flatten_names, params_from_numpy,
                                 params_to_numpy)
from repro_torch.models import transformer as T
from repro_torch.quant import ptq
from repro_torch.serve import Request, Runtime, ServeEngine
from repro_torch.toolkit import Pipeline

from test_torch_support import (arch_slice, golden_plans, jax_to_numpy,
                                rel_linf, to_jax_batches)

ARCHS = ("gemma2-2b", "granite-20b", "deepseek-coder-33b", "hubert-xlarge",
         "paligemma-3b", "deepseek-v2-236b")
DECODERS = ("gemma2-2b", "granite-20b", "deepseek-coder-33b", "paligemma-3b")
SERVED = DECODERS + ("deepseek-v2-236b",)
# the nine archs whose layers are attention layers, in the JAX order
ATTENTION_ARCHS = ("bert-base", "deepseek-coder-33b", "qwen2-0.5b",
                   "gemma2-2b", "granite-20b", "deepseek-v2-236b",
                   "mixtral-8x22b", "paligemma-3b", "hubert-xlarge")


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _tensors(batch):
    return {k: _t(v) for k, v in batch.items()}


def _forward(s, quantized, batch):
    params, plan = ((s["q"], s["qplan"]) if quantized
                    else (s["params"], s["float_plan"]))
    jparams, jplan = ((s["jq"], s["jqplan"]) if quantized
                      else (s["jparams"], s["jfloat_plan"]))
    with torch.inference_mode():
        got = T.forward(params, _tensors(batch), s["cfg"], plan)
    want, _ = JT.forward(jparams, to_jax_batches([batch])[0], s["jcfg"],
                         jplan, compute_dtype=jnp.float32)
    return got.numpy(), np.asarray(want)


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ATTENTION_ARCHS)
def test_registry_equals_jax_field_for_field(arch):
    """Every registered arch equals its JAX config in every field, full and
    reduced: a drift in either package fails here."""
    ours, theirs = all_configs()[arch], jax_all_configs()[arch]
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert dataclasses.asdict(ours.reduced()) == \
        dataclasses.asdict(theirs.reduced())
    assert ours.layer_kinds() == tuple(
        type(ours.layer_kinds()[0])(**dataclasses.asdict(k))
        for k in theirs.layer_kinds())


def test_registry_holds_the_attention_archs():
    """The port registers all eleven archs of the JAX package, ARCH_IDS in
    its order: the nine attention archs and the two recurrent ones, whose
    configs equal the JAX ones too (``test_torch_recurrent.py``)."""
    from repro.configs import ARCH_IDS as JAX_IDS
    assert ARCH_IDS == JAX_IDS and len(ARCH_IDS) == 11
    assert set(all_configs()) == set(jax_all_configs()) == set(ARCH_IDS)
    assert set(ARCH_IDS) - set(ATTENTION_ARCHS) == {"recurrentgemma-9b",
                                                    "xlstm-125m"}
    for arch in ("recurrentgemma-9b", "xlstm-125m"):
        assert get_config(arch).name == arch


# ---------------------------------------------------------------------------
# execution plans and parameter trees
# ---------------------------------------------------------------------------


def _groups(plan):
    return [(g.start, g.stop, g.mode.value, g.steps, g.quant_bmm, g.softmax,
             tuple(dataclasses.astuple(k) for k in g.kinds)) for g in plan]


@pytest.mark.parametrize("arch", ARCHS)
def test_build_plan_groups_like_jax(arch):
    """The execution groups (gemma2's local/global period, deepseek-v2's
    dense first layer) equal the JAX package's, full-size under the tiled
    golden plan and reduced under the float plan, so carried parameter
    trees unstack alike."""
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    plan, jplan = golden_plans(cfg.num_layers, cfg.moe is not None)
    assert _groups(T.build_plan(cfg, plan)) == \
        _groups(JT.build_plan(jcfg, jplan))
    s = arch_slice(arch)
    assert _groups(s["float_plan"]) == _groups(s["jfloat_plan"])
    assert _groups(s["qplan"]) == _groups(s["jqplan"])


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_tree_matches_jax(arch):
    """The port's seeded init builds the JAX tree leaf for leaf (names,
    shapes, dtypes): ``frontend_proj`` for the front-ends, the MLA leaves
    and the shared experts for deepseek-v2."""
    s = arch_slice(arch)
    ours = T.init_params(s["cfg"], seed=0, device="cpu")
    got = {n: (v.shape, v.dtype) for n, v in flatten_names(
        params_to_numpy(ours, s["float_plan"]))}
    want = {n: (v.shape, v.dtype) for n, v in flatten_names(
        jax_to_numpy(s["jparams"]))}
    assert got == want
    if s["cfg"].frontend is not None:
        assert "embed/frontend_proj/w" in got
    if s["cfg"].mla is not None:
        assert any(n.endswith("attn/wkv_b/w") for n in got)
        assert any(n.endswith("ffn/shared/wg/w") for n in got)


@pytest.mark.parametrize("arch", ARCHS)
def test_interop_round_trip_is_bit_exact(arch):
    """JAX tree -> port -> JAX layout gives every leaf back bit for bit,
    float and quantized, front-end projections and MLA leaves included."""
    s = arch_slice(arch)
    for jtree, plan in ((s["jparams"], s["float_plan"]),
                        (s["jq"], s["qplan"])):
        want = dict(flatten_names(jax_to_numpy(jtree)))
        got = dict(flatten_names(params_to_numpy(
            params_from_numpy(jax_to_numpy(jtree), plan, "cpu"), plan)))
        assert set(got) == set(want)
        for name, leaf in want.items():
            assert got[name].dtype == leaf.dtype, name
            np.testing.assert_array_equal(got[name], leaf, err_msg=name)
    names = dict(flatten_names(jax_to_numpy(s["jq"])))
    if s["cfg"].frontend is not None:
        assert "embed/frontend_proj/b" in names
    if s["cfg"].mla is not None:     # golden layer 0 quantizes the latent
        assert "groups/0/layers/0/attn/wkv_b/w/values" in names


# ---------------------------------------------------------------------------
# forwards
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_float_forward_matches_jax(arch):
    got, want = _forward(arch_slice(arch), False, arch_slice(arch)[
        "batches"][0])
    assert got.shape == want.shape
    assert rel_linf(want, got) <= 1e-5


@pytest.mark.parametrize("arch", ARCHS)
def test_quantized_forward_matches_jax(arch):
    """Under the tiled golden plan (its MoE arch: the experts variant), the
    port's reference path against the JAX reference on the JAX-quantized
    params carried across: within the +-1-code budget."""
    s = arch_slice(arch)
    got, want = _forward(s, True, s["batches"][1])
    assert np.isfinite(got).all()
    assert rel_linf(want, got) <= 5e-3


@pytest.mark.parametrize("arch", ARCHS)
def test_capture_stats_matches_jax(arch):
    """The port's calibration of the float model on the same batches gives
    the JAX package's sites and amax values (q_lat and c_kv for MLA)."""
    s = arch_slice(arch)
    got = ptq.capture_stats(s["params"], s["batches"], s["cfg"],
                            s["float_plan"], precision=s["plan"])
    want = s["jstats"]
    assert set(got) == set(want)
    for layer, sites in want.items():
        assert set(got[layer]) == set(sites), layer
        for site, v in sites.items():
            np.testing.assert_allclose(got[layer][site], v, rtol=1e-4,
                                       err_msg=f"{layer}/{site}")
    if s["cfg"].mla is not None:
        assert {"q_lat", "c_kv"} <= set(got["layer0"])


@pytest.mark.parametrize("arch", ARCHS)
def test_apply_plan_leaves_equal_jax(arch):
    """The port's PTQ from JAX's stats quantizes exactly the leaves JAX
    quantizes (the attn_mla sites included): int8 codes equal, scales
    within one ulp, float leaves equal."""
    s = arch_slice(arch)
    q, qplan = ptq.apply_plan(s["params"], s["cfg"], s["plan"], s["jstats"],
                              float_plan=s["float_plan"])
    assert _groups(qplan) == _groups(s["qplan"])
    got = dict(flatten_names(params_to_numpy(q, qplan)))
    want = dict(flatten_names(jax_to_numpy(s["jq"])))
    assert set(got) == set(want)
    for name, leaf in want.items():
        if leaf.dtype == np.int8:
            np.testing.assert_array_equal(got[name], leaf, err_msg=name)
        else:
            np.testing.assert_array_max_ulp(got[name], leaf, maxulp=1)
    quantized = {n.rsplit("/w/", 1)[0] for n in got if n.endswith("/values")}
    if s["cfg"].mla is not None:
        assert {f"groups/0/layers/0/attn/{w}" for w in
                ("wq_a", "wq_b", "wkv_a", "wkv_b", "wo")} <= quantized


@pytest.mark.parametrize("arch", ARCHS)
def test_synthetic_batches_have_jax_shapes(arch):
    """Audio configs calibrate on float frames, vision configs on tokens
    plus prefix embeddings: the JAX package's keys, shapes and dtypes."""
    cfg, jcfg = get_config(arch).reduced(), jax_get_config(arch).reduced()
    got = synthetic_calibration_batches(cfg, num_batches=2, batch_size=3,
                                        seq_len=5)
    want = jax_synthetic_batches(jcfg, num_batches=2, batch_size=3,
                                 seq_len=5)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert {k: (v.shape, np.dtype(v.dtype)) for k, v in g.items()} == \
            {k: (v.shape, np.dtype(v.dtype)) for k, v in w.items()}


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def _page_table(B, max_len, ps):
    pps = T.pages_per_slot(max_len, ps)
    return torch.arange(B * pps, dtype=torch.int32).reshape(B, pps), B * pps


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("arch", DECODERS)
def test_decode_matches_prefill(arch, paged):
    """Float caches (gemma2's local layers keep rings of the window past
    which the steps run; with ``paged`` the global layers page): one-token
    steps match the full forward within 2e-3, as the JAX package's own
    test holds them (the full forward is held to the JAX package's in
    :func:`test_float_forward_matches_jax`, the steps' tokens to its
    engine's in :func:`test_engine_matches_jax_engine`). paligemma prefills
    its image prefix and first token in one forward, then decodes its
    text."""
    s = arch_slice(arch)
    cfg, plan = s["cfg"], s["float_plan"]
    B, S = 2, 10
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    batch = {"tokens": toks}
    P = 0
    if cfg.frontend == "vision":
        P = cfg.num_prefix_embeds
        batch["prefix_embeds"] = rng.standard_normal(
            (B, P, cfg.frontend_dim)).astype(np.float32)
    max_len = P + S
    kw, pages = {}, None
    if paged:
        pages, npages = _page_table(B, max_len, 4)
        kw = dict(page_size=4, num_pages=npages)
    with torch.inference_mode():
        full = T.forward(s["params"], _tensors(batch), cfg, plan, chunk=None)
        caches = T.init_caches(cfg, plan, B, max_len, device="cpu", **kw)
        outs, first = [], 0
        if P:
            pre = dict(batch, tokens=toks[:, :1])
            lg, caches = T.forward(s["params"], _tensors(pre), cfg, plan,
                                   caches=caches, pos=0, chunk=None,
                                   pages=pages)
            outs.append(lg[:, -1])
            first = 1
        for t in range(first, S):
            lg, caches = T.decode_step(s["params"], _t(toks[:, t:t + 1]),
                                       caches, P + t, cfg, plan, pages=pages)
            outs.append(lg[:, 0])
    got = torch.stack(outs, 1).numpy()
    assert rel_linf(full[:, P:].numpy(), got) < 2e-3


def test_gemma2_mixed_cache_tree_matches_jax():
    """gemma2 paged: local layers keep float rings of min(window, max_len),
    global layers take int8 per-token pages; the engine's pool and
    ``kv_geometry`` count only the paged layers, and the tree's bytes are
    the JAX tree's."""
    s = arch_slice("gemma2-2b")
    cfg, jcfg = s["cfg"], s["jcfg"]
    kw = dict(page_size=4, num_pages=12,
              kv_schemes=("int8_per_token",) * cfg.num_layers)
    caches = T.init_caches(cfg, s["qplan"], 3, 16, device="cpu", **kw)
    jcaches = JT.init_caches(jcfg, s["jqplan"], 3, 16, jnp.float32, **kw)
    kinds = cfg.layer_kinds()
    for kind, c in zip(kinds, caches):
        if kind.local:
            assert set(c) == {"k", "v", "k_pos", "pos"}
            assert c["k"].shape == (3, cfg.sliding_window, 2, 16)
            assert c["k"].dtype == torch.float32
        else:
            assert c["pages_k"].dtype == torch.int8 and "pages_ks" in c
    assert {k.local for k in kinds} == {True, False}
    assert T.kv_geometry(caches) == JT.kv_geometry(jcaches) == \
        ("int8_per_token", 4, 12)
    assert T.cache_bytes(caches) == JT.cache_bytes(jcaches)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def _prompts(cfg, n=5):
    rng = np.random.default_rng(0)
    return [rng.integers(1, cfg.vocab_size, int(k)).tolist()
            for k in rng.integers(2, 7, n)]


def _engine_kw(cfg):
    # MLA pages its latent in float; every other arch int8 per token
    if cfg.mla is not None:
        return dict(page_size=4)
    return dict(page_size=4, kv_cache="int8_per_token")


@pytest.mark.parametrize("arch", SERVED)
def test_engine_matches_jax_engine(arch):
    """The golden-quantized model served greedily by both packages'
    engines (reference backends, 3 slots, paged caches: gemma2's mixed
    tree of rings and int8 pages, deepseek-v2's float latent pages): the
    same tokens, the same cache bytes and geometry, no page in use after."""
    s = arch_slice(arch)
    kw = _engine_kw(s["cfg"])
    eng = ServeEngine(s["cfg"], s["q"], s["qplan"], batch_slots=3,
                      max_len=24, device="cpu", **kw)
    jeng = JaxEngine(s["jcfg"], s["jq"], s["jqplan"], batch_slots=3,
                     max_len=24, **kw)
    for i, p in enumerate(_prompts(s["cfg"])):
        eng.submit(Request(uid=i, prompt=list(p), max_tokens=5))
        jeng.submit(JaxRequest(uid=i, prompt=list(p), max_tokens=5))
    got = {r.uid: r.output for r in eng.run()}
    assert got == {r.uid: r.output for r in jeng.run()}
    assert eng.kv_cache_bytes == jeng.kv_cache_bytes
    assert T.kv_geometry(eng.caches) == JT.kv_geometry(jeng.caches)
    assert eng.kv_pages_in_use == 0


@pytest.mark.parametrize("arch", SERVED)
def test_fused_equals_reference_on_cpu(arch):
    """On CPU tensors the fused backend runs the kernels' plain versions
    behind the same dispatch: the reference backend's tokens."""
    s = arch_slice(arch)
    outs = []
    for backend in ("fused", "reference"):
        eng = ServeEngine(s["cfg"], s["q"], s["qplan"], batch_slots=3,
                          max_len=24, backend=backend, device="cpu",
                          **_engine_kw(s["cfg"]))
        for i, p in enumerate(_prompts(s["cfg"], 3)):
            eng.submit(Request(uid=i, prompt=list(p), max_tokens=4))
        outs.append({r.uid: r.output for r in eng.run()})
    assert outs[0] == outs[1]


def test_encoder_only_arch_refuses_decode():
    s = arch_slice("hubert-xlarge")
    with pytest.raises(ValueError, match="encoder-only"):
        ServeEngine(s["cfg"], s["params"], s["float_plan"], device="cpu")


# ---------------------------------------------------------------------------
# front-end inputs through Runtime.encode and the pipeline
# ---------------------------------------------------------------------------


def _unembed(cfg):
    return lambda params, x: T.unembed(x, params, cfg)


def _frontend_inputs(cfg, rng, B, S):
    if cfg.frontend == "audio":
        return {"frames": rng.standard_normal(
            (B, S, cfg.frontend_dim)).astype(np.float32)}
    return {"tokens": rng.integers(1, cfg.vocab_size, (B, S)).astype(
        np.int32), "prefix_embeds": rng.standard_normal(
        (B, cfg.num_prefix_embeds, cfg.frontend_dim)).astype(np.float32)}


@pytest.mark.parametrize("quantized", [False, True], ids=["float", "golden"])
@pytest.mark.parametrize("arch", ["hubert-xlarge", "paligemma-3b"])
def test_runtime_encode_frontends_match_jax(arch, quantized):
    """``Runtime.encode`` with audio ``frames``, or tokens beside vision
    ``prefix_embeds``, ragged ``lengths`` padded with -1 positions past
    lengths + P: the JAX runtime's token-level logits, cut to P + S, for
    the real rows (3 of a bucket of 4)."""
    s = arch_slice(arch)
    cfg, jcfg = s["cfg"], s["jcfg"]
    rng = np.random.default_rng(5)
    inputs = _frontend_inputs(cfg, rng, 3, 6)
    lengths = np.array([6, 2, 4], np.int32)
    params, plan = ((s["q"], s["qplan"]) if quantized
                    else (s["params"], s["float_plan"]))
    jparams, jplan = ((s["jq"], s["jqplan"]) if quantized
                      else (s["jparams"], s["jfloat_plan"]))
    rt = Runtime(cfg, plan, head=_unembed(cfg), token_level=True,
                 device="cpu")
    jrt = JaxRuntime(jcfg, jplan, head=lambda p, x: JT.unembed(x, p, jcfg),
                     token_level=True)
    got = rt.encode(params, inputs, lengths)
    want = jrt.encode(jparams, inputs, lengths)
    P = cfg.num_prefix_embeds if cfg.frontend == "vision" else 0
    assert got.shape == want.shape == (3, P + 6, cfg.vocab_size)
    for b, n in enumerate(lengths):        # the real positions of each row
        assert rel_linf(want[b, :P + n], got[b, :P + n]) <= \
            (5e-3 if quantized else 1e-5)


def test_runtime_buckets_tokens_but_not_frames():
    """Frames run at their own length (no sequence bucket), tokens beside a
    prefix take the length bucket; a padded row attends to its real
    positions only, so it equals the row encoded alone."""
    s = arch_slice("hubert-xlarge")
    rt = Runtime(s["cfg"], s["float_plan"], device="cpu")
    rng = np.random.default_rng(2)
    frames = _frontend_inputs(s["cfg"], rng, 2, 5)["frames"]
    both = rt.encode(s["params"], {"frames": frames}, np.array([5, 3]))
    alone = rt.encode(s["params"], {"frames": frames[1:, :3]})
    assert rt.stats["buckets"] == [(1, 3), (2, 5)]
    assert rel_linf(alone[0], both[1, :3]) <= 1e-5
    v = arch_slice("paligemma-3b")
    rtv = Runtime(v["cfg"], v["float_plan"], device="cpu")
    rtv.encode(v["params"], _frontend_inputs(v["cfg"], rng, 3, 5))
    assert rtv.stats["buckets"] == [(4, 8)]


@pytest.mark.parametrize("arch", ["hubert-xlarge", "paligemma-3b"])
def test_pipeline_forward_takes_frontend_inputs(arch):
    """``Pipeline.forward`` (embedding -> encoder -> lm target) with frames
    or prefix embeddings: the JAX pipeline's logits over P + S positions,
    and ``predict_logits`` through the runtime equals it."""
    s = arch_slice(arch)
    pipe = Pipeline.build(s["cfg"], "lm", float_dtype="float32",
                          device="cpu")
    jpipe = JaxPipeline.build(s["jcfg"], "lm", float_dtype="float32")
    batch = _frontend_inputs(s["cfg"], np.random.default_rng(4), 2, 5)
    got = pipe.forward(s["params"], _tensors(batch)).numpy()
    want = np.asarray(jpipe.forward(s["jparams"],
                                    to_jax_batches([batch])[0]))
    P = s["cfg"].num_prefix_embeds if s["cfg"].frontend == "vision" else 0
    assert got.shape == (2, P + 5, s["cfg"].vocab_size)
    assert rel_linf(want, got) <= 1e-5
    pipe.params = s["params"]
    assert rel_linf(got, pipe.predict_logits(batch)) <= 1e-5
