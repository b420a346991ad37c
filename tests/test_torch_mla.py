"""Port parity for deepseek-v2's multi-head latent attention (MLA), reduced:
``init_mla``'s tree, the prefill block (per-head K and V expanded from the
latent) float and int8, the absorbed one-token step over the dense and the
paged latent caches against the JAX package's, decode against prefill, the
cache layouts, PTQ's ``attn_mla`` sites, the MLA body kept on the reference
path by the fused backend, the 160-expert top-6 dispatch at full width, and
the engine over dense latent rings."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.quant import ptq as jptq
from repro.serve import Request as JaxRequest
from repro.serve import ServeEngine as JaxEngine

from repro_torch.configs import get_config
from repro_torch.core.quantize import QuantizedTensor
from repro_torch.interop import flatten_names
from repro_torch.kernels.backend import ComputeBackend
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.quant import ptq
from repro_torch.serve import Request, ServeEngine

from test_torch_support import arch_slice, jax_to_numpy, rel_linf

ARCH = "deepseek-v2-236b"
Q_LORA = {"q_lora": None, "no_q_lora": 0}


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _to_port(tree):
    """A JAX float subtree as the port's nested dicts of CPU tensors."""
    if isinstance(tree, dict):
        return {k: _to_port(v) for k, v in tree.items()}
    return _t(np.array(tree))


def _cfgs(q_lora=None):
    cfg, jcfg = get_config(ARCH).reduced(), jax_get_config(ARCH).reduced()
    if q_lora is not None:
        cfg = cfg.replace(mla=dataclasses.replace(cfg.mla,
                                                  q_lora_rank=q_lora))
        jcfg = jcfg.replace(mla=dataclasses.replace(jcfg.mla,
                                                    q_lora_rank=q_lora))
    return cfg, jcfg


def _block(q_lora=None, seed=0):
    cfg, jcfg = _cfgs(q_lora)
    jp = JL.init_mla(jax.random.PRNGKey(seed), jcfg)
    return cfg, jcfg, jp, _to_port(jp)


@pytest.mark.parametrize("variant", list(Q_LORA))
def test_init_mla_tree_matches_jax(variant):
    """The latent projections, their norms and the query path (compressed
    ``wq_a``/``q_norm``/``wq_b``, or ``wq`` without q_lora) leaf for leaf."""
    cfg, jcfg, jp, _ = _block(Q_LORA[variant])
    gen = torch.Generator().manual_seed(0)
    ours = L.init_mla(gen, cfg)
    got = {n: tuple(v.shape) for n, v in flatten_names(ours)}
    want = {n: tuple(v.shape) for n, v in flatten_names(jax_to_numpy(jp))}
    assert got == want
    assert ("wq" in ours) == (Q_LORA[variant] == 0)


@pytest.mark.parametrize("variant", list(Q_LORA))
def test_prefill_block_matches_jax(variant):
    """The prefill form (K and V per head from the latent, the shared rope
    key broadcast over heads) on carried float params: within 1e-5."""
    cfg, jcfg, jp, p = _block(Q_LORA[variant], seed=1)
    x = np.random.default_rng(1).standard_normal((2, 7, cfg.d_model)).astype(
        np.float32)
    pos = np.arange(7, dtype=np.int32)
    want, _ = JL.mla_block(jnp.asarray(x), jp, jcfg,
                           positions=jnp.asarray(pos), spec=JL.MaskSpec())
    got = L.mla_block(_t(x), p, cfg, positions=_t(pos), spec=L.MaskSpec())
    assert rel_linf(np.asarray(want), got.numpy()) <= 1e-5


def test_int8_block_matches_jax():
    """Golden layer 0 (every MLA GEMM int8 at static scales, int8 score and
    value bmms, ``wkv_b`` dequantized for the expansion) as JAX quantized
    it: the port's block within the +-1-code budget, and its observer
    sites (q_lat, c_kv, the bmm operands) JAX's."""
    s = arch_slice(ARCH)
    p = s["q"]["layers"][0]["attn"]
    jp = jax.tree_util.tree_map(
        lambda a: a[0], s["jq"]["groups"][0]["layers"][0])["attn"]
    assert isinstance(p["wkv_b"]["w"], QuantizedTensor)
    x = np.random.default_rng(2).standard_normal(
        (2, 6, s["cfg"].d_model)).astype(np.float32)
    pos = np.arange(6, dtype=np.int32)
    quant = dict(enabled=True, softmax_mode="symmetric")
    jobs, obs = {}, {}
    want, _ = JL.mla_block(jnp.asarray(x), jp, s["jcfg"],
                           positions=jnp.asarray(pos), spec=JL.MaskSpec(),
                           quant=JL.AttnQuant(**quant), obs=jobs)
    got = L.mla_block(_t(x), p, s["cfg"], positions=_t(pos),
                      spec=L.MaskSpec(), quant=L.AttnQuant(**quant), obs=obs)
    assert rel_linf(np.asarray(want), got.numpy()) <= 5e-3
    assert set(obs) == set(jobs) >= {"attn_in", "q_lat", "c_kv", "q", "k",
                                     "p", "v", "attn_out"}
    for site, v in jobs.items():
        np.testing.assert_allclose(float(obs[site]), float(v), rtol=1e-5,
                                   err_msg=site)


def _steps(cfg, jcfg, p, jp, paged, n=6, B=2):
    """``n`` one-token steps of the block in both packages over fresh
    caches (pages of 2 tokens, slot b owning pages [b * pps, (b+1) * pps)),
    at per-row positions, slot 1 idle on the first step."""
    kind = cfg.layer_kinds()[0]
    kw = {}
    pages = jpages = None
    if paged:
        pps = T.pages_per_slot(n, 2)
        kw = dict(page_size=2, num_pages=B * pps)
        tbl = np.arange(B * pps, dtype=np.int32).reshape(B, pps)
        pages, jpages = _t(tbl), jnp.asarray(tbl)
    cache = T._layer_cache(cfg, kind, B, n, torch.float32, "cpu", **kw)
    jcache = JT._layer_cache(jcfg, kind, B, n, jnp.float32, **kw)
    rng = np.random.default_rng(3)
    outs, jouts = [], []
    for t in range(n):
        x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
        pos = np.array([[t], [max(t - 1, 0)]], np.int32)
        act = np.array([True, t > 0])
        o, cache = L.mla_block(_t(x), p, cfg, positions=_t(pos),
                               spec=L.MaskSpec(), kv_cache=cache,
                               active=_t(act), pages=pages)
        jo, jcache = JL.mla_block(jnp.asarray(x), jp, jcfg,
                                  positions=jnp.asarray(pos),
                                  spec=JL.MaskSpec(), kv_cache=jcache,
                                  active=jnp.asarray(act), pages=jpages)
        outs.append(o.numpy())
        jouts.append(np.asarray(jo))
    return np.stack(outs), np.stack(jouts), cache, jcache


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("variant", list(Q_LORA))
def test_absorbed_step_matches_jax(variant, paged):
    """The absorbed step (attention in the latent space against the
    ``ckv``/``krope`` cache, ``wkv_b`` folded into both sides) with
    continuous-batching positions and an idle slot: outputs within 1e-5 of
    JAX's, and the same latent cache contents."""
    cfg, jcfg, jp, p = _block(Q_LORA[variant], seed=2)
    got, want, cache, jcache = _steps(cfg, jcfg, p, jp, paged)
    assert rel_linf(want, got) <= 1e-5
    assert set(cache) == set(jcache)
    for key, leaf in jcache.items():
        np.testing.assert_allclose(cache[key].numpy(), np.asarray(leaf),
                                   rtol=1e-6, atol=1e-6, err_msg=key)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_decode_matches_prefill(paged):
    """The whole reduced deepseek-v2 (dense first layer, then MoE with a
    shared expert; capacity factor 16, so no routing drops, as the JAX
    package's own test sets it): one-token steps over the latent caches
    match the full forward within 2e-3."""
    s = arch_slice(ARCH)
    cfg = s["cfg"].replace(moe=dataclasses.replace(s["cfg"].moe,
                                                   capacity_factor=16.0))
    plan = s["float_plan"]
    B, S = 2, 10
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (B, S))
    kw, pages = {}, None
    if paged:
        pps = T.pages_per_slot(S, 4)
        kw = dict(page_size=4, num_pages=B * pps)
        pages = torch.arange(B * pps, dtype=torch.int32).reshape(B, pps)
    with torch.inference_mode():
        full = T.forward(s["params"], {"tokens": _t(toks)}, cfg, plan,
                         chunk=None)
        caches = T.init_caches(cfg, plan, B, S, device="cpu", **kw)
        outs = []
        for t in range(S):
            lg, caches = T.decode_step(s["params"], _t(toks[:, t:t + 1]),
                                       caches, t, cfg, plan, pages=pages)
            outs.append(lg[:, 0])
    assert rel_linf(full.numpy(), torch.stack(outs, 1).numpy()) < 2e-3


@pytest.mark.parametrize("layout", ["dense", "paged_float", "paged_int8"])
def test_cache_layout_matches_jax(layout):
    """The latent cache: ``ckv``/``krope`` rings, or float
    ``pages_ckv``/``pages_krope`` whatever the KV scheme asks (the latent
    is already the compressed form), with JAX's keys, shapes and dtypes."""
    cfg, jcfg = _cfgs()
    kw = {}
    if layout != "dense":
        kw = dict(page_size=4, num_pages=6,
                  kv_scheme="int8_per_token" if layout == "paged_int8"
                  else "float")
    kind = cfg.layer_kinds()[1]
    got = T._layer_cache(cfg, kind, 3, 8, torch.float32, "cpu", **kw)
    want = JT._layer_cache(jcfg, kind, 3, 8, jnp.float32, **kw)
    assert {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in got.items()} == \
        {k: (v.shape, str(v.dtype)) for k, v in want.items()}
    assert T.kv_geometry([got]) == JT.kv_geometry([want])
    if layout == "dense":
        assert {"ckv", "krope", "k_pos"} <= set(got)
    else:
        assert got["pages_ckv"].dtype == torch.float32


def test_site_map_matches_jax():
    """PTQ's site map: the attn_mla entries (q_lat feeds wq_b, c_kv feeds
    wkv_b) and every ported kind's entries equal the JAX package's, and
    each site rides the JAX block."""
    assert ptq.SITE_MAP["attn_mla"] == jptq.SITE_MAP["attn_mla"]
    for name, entries in ptq.SITE_MAP.items():
        assert entries == jptq.SITE_MAP[name], name
    for site, block in ptq.SITE_BLOCK.items():
        assert jptq.SITE_BLOCK[site] == block, site
    for arch in ("deepseek-v2-236b", "gemma2-2b", "hubert-xlarge"):
        cfg, jcfg = get_config(arch), jax_get_config(arch)
        for kind, jkind in zip(cfg.layer_kinds(), jcfg.layer_kinds()):
            assert ptq._kind_entries(cfg, kind) == \
                jptq._kind_entries(jcfg, jkind)


class _Spy(ComputeBackend):
    """The reference backend, recording the weights offered to ``linear``."""

    def __init__(self):
        self.offered = []

    def linear(self, x, p, *, act=None):
        self.offered.append(tuple(p["w"].shape))
        return None


def test_mla_body_stays_on_the_reference_path():
    """As in the JAX package, no backend is offered an MLA GEMM: a layer's
    backend sees only its FFN's (layer 0's dense GLU, a MoE layer's shared
    expert), so the fused backend launches no kernel for the MLA body."""
    s = arch_slice(ARCH)
    cfg = s["cfg"]
    x = _t(np.random.default_rng(5).standard_normal(
        (1, 4, cfg.d_model)).astype(np.float32))
    pos = torch.arange(4, dtype=torch.int32)
    kinds = cfg.layer_kinds()
    for i in (0, 1):
        spy = _Spy()
        with torch.inference_mode():
            T.layer_forward(x, s["q"]["layers"][i], cfg, kinds[i],
                            s["qplan"][0].mode, T.QuantScheme(),
                            positions=pos, obs=None, chunk=None,
                            backend=spy)
        F = cfg.d_ff if i == 0 else cfg.moe.d_ff_expert * cfg.moe.num_shared
        assert sorted(spy.offered) == sorted(
            [(cfg.d_model, F), (cfg.d_model, F), (F, cfg.d_model)]), i


def test_dispatch_at_full_expert_count_matches_jax():
    """deepseek-v2's router at full width: 160 experts, top 6, the 8 slots
    of a decode tick at capacity ceil(1.25 * 8 * 6 / 160) = 1: JAX's
    buffers, slots, drops and combine."""
    full = get_config(ARCH).moe
    E, K, T_, D = full.num_experts, full.top_k, 8, 24
    C = max(1, int(np.ceil(full.capacity_factor * T_ * K / E)))
    assert C == 1
    rng = np.random.default_rng(6)
    xt = rng.standard_normal((T_, D)).astype(np.float32)
    logits = rng.standard_normal((T_, E)).astype(np.float32)
    want = JL._dispatch_one(jnp.asarray(xt), jnp.asarray(logits), E, K, C)
    got = L._dispatch_one(_t(xt), _t(logits), E, K, C)
    for key, w, g in zip(("xe", "st", "sg", "keep", "slot"), want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   err_msg=key)
    assert int((~got[3]).sum()) > 0            # capacity 1 drops some
    ye = rng.standard_normal((E, C, D)).astype(np.float32)
    np.testing.assert_allclose(
        L._combine_one(_t(ye), *got[1:], T_, D, torch.float32).numpy(),
        np.asarray(JL._combine_one(jnp.asarray(ye), *want[1:], T_, D,
                                   jnp.float32)), rtol=1e-6, atol=1e-6)


def test_engine_over_dense_latent_rings_matches_jax():
    """Dense (unpaged) latent caches, 2 slots for 4 requests, so slots are
    reset and reused: the JAX engine's tokens."""
    s = arch_slice(ARCH)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, s["cfg"].vocab_size, n).tolist()
               for n in (3, 5, 2, 4)]
    eng = ServeEngine(s["cfg"], s["q"], s["qplan"], batch_slots=2,
                      max_len=16, device="cpu")
    jeng = JaxEngine(s["jcfg"], s["jq"], s["jqplan"], batch_slots=2,
                     max_len=16)
    for i, p in enumerate(prompts):
        eng.submit(Request(uid=i, prompt=list(p), max_tokens=4))
        jeng.submit(JaxRequest(uid=i, prompt=list(p), max_tokens=4))
    assert {r.uid: r.output for r in eng.run()} == \
        {r.uid: r.output for r in jeng.run()}
    assert eng.kv_cache_bytes == jeng.kv_cache_bytes
    assert all("ckv" in c for c in eng.caches)
