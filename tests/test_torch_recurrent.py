"""Port parity for the recurrent bodies: recurrentgemma-9b (RG-LRU layers
beside local attention) and xlstm-125m (mLSTM and sLSTM blocks), reduced,
fed the same numpy inputs in both packages with the JAX parameters carried
across. The blocks alone (one mLSTM chunk and two, the one-token step,
carried states, idle rows), the configs, parameter trees, float and
golden-quantized forwards, calibration, PTQ, decode against prefill, the
serving engine with a reused slot, and ``Runtime.encode`` across mLSTM
chunks. Float paths are held to 1e-5 (the RG-LRU scan and the chunked
mLSTM add in other orders than ``jax.lax``), quantized ones to 5e-3."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import all_configs as jax_all_configs
from repro.configs import get_config as jax_get_config
from repro.models import rglru as JR
from repro.models import transformer as JT
from repro.models import xlstm as JX
from repro.serve import Request as JaxRequest
from repro.serve import Runtime as JaxRuntime
from repro.serve import ServeEngine as JaxEngine

from repro_torch.configs import all_configs, get_config
from repro_torch.interop import flatten_names, params_to_numpy
from repro_torch.models import layers as L
from repro_torch.models import rglru as R
from repro_torch.models import transformer as T
from repro_torch.models import xlstm as X
from repro_torch.quant import ptq
from repro_torch.serve import Request, Runtime, ServeEngine

from test_torch_support import (arch_slice, jax_to_numpy, rel_linf,
                                to_jax_batches)

ARCHS = ("recurrentgemma-9b", "xlstm-125m")


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _tree_t(tree):
    """A numpy tree (dicts of arrays) as CPU tensors."""
    if isinstance(tree, dict):
        return {k: _tree_t(v) for k, v in tree.items()}
    return _t(np.asarray(tree))


def _close(got, want, tol=1e-5):
    got = got.detach().numpy() if torch.is_tensor(got) else got
    assert got.shape == np.asarray(want).shape
    assert rel_linf(np.asarray(want), got) <= tol


def _state_close(got: dict, want: dict, tol=1e-5):
    assert set(got) == set(want)
    for k in want:
        _close(got[k], np.asarray(want[k]), tol)


def _cfg(arch):
    return get_config(arch).reduced(), jax_get_config(arch).reduced()


def _rand_state(fn, cfg, B, rng):
    """A decode state of ``fn``'s shapes filled with values a run could
    carry (an sLSTM's n positive)."""
    state = {k: rng.standard_normal(v.shape).astype(np.float32) * 0.5
             for k, v in jax_to_numpy(fn(cfg, B)).items()}
    if "n" in state and state["n"].ndim == 3 and "c" in state:
        state["n"] = np.abs(state["n"]) + 1.0
    return state


# ---------------------------------------------------------------------------
# the blocks
# ---------------------------------------------------------------------------


BLOCKS = {
    "rglru": ("recurrentgemma-9b", JR.init_rglru, JR.rglru_mix,
              R.rglru_mix, JR.init_state),
    "mlstm": ("xlstm-125m", JX.init_mlstm, JX.mlstm_block, X.mlstm_block,
              JX.mlstm_state),
    "slstm": ("xlstm-125m", JX.init_slstm, JX.slstm_block, X.slstm_block,
              JX.slstm_state),
}


def _block_case(body, S, carried, B=3, seed=0):
    arch, jinit, jfn, fn, jstate = BLOCKS[body]
    cfg, jcfg = _cfg(arch)
    rng = np.random.default_rng(seed + S)
    jp = jinit(jax.random.PRNGKey(seed), jcfg)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    state = _rand_state(jstate, jcfg, B, rng) if carried else None
    active = np.array([True, False, True][:B]) if carried else None
    want = jfn(jnp.asarray(x), jp, jcfg,
               state=None if state is None else jax.tree_util.tree_map(
                   jnp.asarray, state),
               active=None if active is None else jnp.asarray(active))
    with torch.inference_mode():
        got = fn(_t(x), _tree_t(jax_to_numpy(jp)), cfg,
                 state=None if state is None else _tree_t(state),
                 active=None if active is None else _t(active))
    return got, want, state


def _log_forget_sum(x, p, cfg):
    """The sum over the sequence of an mLSTM block's log forget gates, per
    (row, head): the magnitude the chunk's stabilizer m is a difference
    of."""
    Dp, H = int(cfg.proj_factor * cfg.d_model), cfg.num_heads
    with torch.inference_mode():
        xm = L.dense(_t(x), p["up"])[..., :Dp]
        xc = X._silu(L.causal_conv1d(xm, p["conv"])[0])
        gates = L.dense(xc, p["wif"])
        return torch.nn.functional.logsigmoid(gates[..., H:]).sum(1).numpy()


@pytest.mark.parametrize("carried", [False, True], ids=["fresh", "carried"])
@pytest.mark.parametrize("body,S", [("rglru", 9), ("mlstm", 8),
                                    ("mlstm", 512), ("slstm", 7)])
def test_block_matches_jax(body, S, carried):
    """Each body over a sequence, from zero or from a carried state with an
    idle row: the output and the new state within 1e-5 (the mLSTM at
    S = 512 runs two chunks, so the chunk hand-off is held too). The
    mLSTM's stabilizer m is a sum of S log forget gates plus a running max
    of the same size, which cancel to a value near 0; it is held to 1e-5 of
    that sum's magnitude, the size of the numbers it is computed from."""
    (out, st), (jout, jst), state = _block_case(body, S, carried)
    _close(out, np.asarray(jout))
    if carried:
        jst = jax_to_numpy(jst)
        if body == "mlstm":
            arch, jinit = BLOCKS[body][:2]
            cfg, _ = _cfg(arch)
            x = np.random.default_rng(S).standard_normal(
                (3, S, cfg.d_model)).astype(np.float32)
            p = _tree_t(jax_to_numpy(jinit(jax.random.PRNGKey(0),
                                           _cfg(arch)[1])))
            scale = max(np.abs(jst["m"]).max(),
                        np.abs(_log_forget_sum(x, p, cfg)).max())
            assert np.abs(st["m"].numpy() - jst["m"]).max() <= 1e-5 * scale
            st = {k: v for k, v in st.items() if k != "m"}
            jst = {k: v for k, v in jst.items() if k != "m"}
        _state_close(st, jst)
        for k, v in st.items():      # the idle row keeps its old state
            assert np.array_equal(v[1].numpy(), state[k][1].astype(
                v.numpy().dtype)), k
    else:
        assert st is None and jst is None


@pytest.mark.parametrize("body", ["rglru", "mlstm", "slstm"])
def test_one_token_step_matches_jax(body):
    """S = 1 from a carried state: the decode update (the mLSTM's step
    path, not a chunk)."""
    (out, st), (jout, jst), _ = _block_case(body, 1, True)
    _close(out, np.asarray(jout))
    _state_close(st, jax_to_numpy(jst))


def test_mlstm_refuses_a_ragged_chunk():
    cfg, _ = _cfg("xlstm-125m")
    p = X.init_mlstm(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(ValueError, match="chunk"):
        X.mlstm_block(torch.zeros((1, 300, cfg.d_model)), p, cfg)


def test_rglru_softplus_is_logaddexp():
    """softplus past torch's threshold of 20 is log(1 + e^x), not x."""
    x = torch.tensor([-30.0, 0.0, 3.0, 8.0, 21.0, 40.0])
    np.testing.assert_allclose(
        R.softplus(x).numpy(),
        np.asarray(jax.nn.softplus(jnp.asarray(x.numpy()))), rtol=0,
        atol=0)


def test_rglru_scan_is_the_recurrence():
    """The doubling scan against the plain loop h_t = a_t h_{t-1} + b_t."""
    g = torch.Generator().manual_seed(1)
    a, b = torch.rand((2, 37, 5), generator=g), torch.randn((2, 37, 5),
                                                            generator=g)
    h0 = torch.randn((2, 5), generator=g)
    h, want = h0, []
    for t in range(37):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    _close(R.rglru_scan(a, b, h0), torch.stack(want, 1).numpy())


def test_select_state_keeps_idle_rows_bit_for_bit():
    g = torch.Generator().manual_seed(2)
    old = {"h": torch.randn((4, 3), generator=g),
           "C": torch.randn((4, 2, 3, 3), generator=g)}
    new = {k: torch.randn(v.shape, generator=g) for k, v in old.items()}
    active = torch.tensor([True, False, True, False])
    out = L.select_state(new, old, active)
    for k in old:
        assert out[k][~active].equal(old[k][~active])
        assert out[k][active].equal(new[k][active])
    assert L.select_state(new, old, None) is new


def test_causal_conv_matches_jax():
    """The W taps in the JAX order, then the bias; the carried left context
    and the new state."""
    from repro.models import layers as JL
    rng = np.random.default_rng(4)
    p = {"w": rng.standard_normal((4, 6)).astype(np.float32),
         "b": rng.standard_normal(6).astype(np.float32)}
    x = rng.standard_normal((2, 5, 6)).astype(np.float32)
    st = rng.standard_normal((2, 3, 6)).astype(np.float32)
    for state in (None, st):
        y, ns = L.causal_conv1d(_t(x), _tree_t(p),
                                None if state is None else _t(state))
        jy, jns = JL.causal_conv1d(jnp.asarray(x), p, None if state is None
                                   else jnp.asarray(state))
        np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
        np.testing.assert_array_equal(ns.numpy(), np.asarray(jns))


# ---------------------------------------------------------------------------
# configs and parameter trees
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_config_and_init_tree_match_jax(arch):
    """The config equals the JAX one field for field (full and reduced),
    and the seeded init builds the JAX tree leaf for leaf (lam, the sLSTM's
    r (4, H, dh, dh), the conv leaves)."""
    ours, theirs = all_configs()[arch], jax_all_configs()[arch]
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert dataclasses.asdict(ours.reduced()) == \
        dataclasses.asdict(theirs.reduced())
    s = arch_slice(arch)
    got = {n: (v.shape, v.dtype) for n, v in flatten_names(params_to_numpy(
        T.init_params(s["cfg"], seed=0, device="cpu"), s["float_plan"]))}
    want = {n: (v.shape, v.dtype) for n, v in flatten_names(
        jax_to_numpy(s["jparams"]))}
    assert got == want
    assert any(n.endswith("conv/w") for n in got)
    if arch == "xlstm-125m":
        assert any(n.endswith("blk/r") for n in got)
    else:
        assert any(n.endswith("rec/lam") for n in got)


# ---------------------------------------------------------------------------
# forwards, calibration, PTQ
# ---------------------------------------------------------------------------


def _forward(s, quantized, batch):
    params, plan = ((s["q"], s["qplan"]) if quantized
                    else (s["params"], s["float_plan"]))
    jparams, jplan = ((s["jq"], s["jqplan"]) if quantized
                      else (s["jparams"], s["jfloat_plan"]))
    with torch.inference_mode():
        got = T.forward(params, {k: _t(v) for k, v in batch.items()},
                        s["cfg"], plan)
    want, _ = JT.forward(jparams, to_jax_batches([batch])[0], s["jcfg"],
                         jplan, compute_dtype=jnp.float32)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("quantized", [False, True], ids=["float", "golden"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(arch, quantized):
    """Float within 1e-5; under the tiled golden plan, quantized by JAX and
    carried across, within 5e-3."""
    s = arch_slice(arch)
    got, want = _forward(s, quantized, s["batches"][1])
    assert np.isfinite(got).all()
    assert rel_linf(want, got) <= (5e-3 if quantized else 1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_capture_stats_and_apply_plan_match_jax(arch):
    """The port's calibration gives the JAX sites and amax values (rec_in,
    rec_gate_in, rec_out; blk_in, xm, qkv_in, blk_conv_in, blk_hidden), and
    its PTQ from JAX's stats quantizes exactly the leaves JAX's does: the
    int8 leaf names and codes equal, scales within one ulp, and no
    attention operand on a recurrent layer."""
    s = arch_slice(arch)
    got = ptq.capture_stats(s["params"], s["batches"], s["cfg"],
                            s["float_plan"], precision=s["plan"])
    assert set(got) == set(s["jstats"])
    for layer, sites in s["jstats"].items():
        assert set(got[layer]) == set(sites), layer
        for site, v in sites.items():
            np.testing.assert_allclose(got[layer][site], v, rtol=1e-4,
                                       err_msg=f"{layer}/{site}")
    q, qplan = ptq.apply_plan(s["params"], s["cfg"], s["plan"], s["jstats"],
                              float_plan=s["float_plan"])
    names = dict(flatten_names(params_to_numpy(q, qplan)))
    want = dict(flatten_names(jax_to_numpy(s["jq"])))
    assert set(names) == set(want)
    assert {n for n, v in names.items() if v.dtype == np.int8} == \
        {n for n, v in want.items() if v.dtype == np.int8} != set()
    for name, leaf in want.items():
        if leaf.dtype == np.int8:
            np.testing.assert_array_equal(names[name], leaf, err_msg=name)
        else:
            np.testing.assert_array_max_ulp(names[name], leaf, maxulp=1)
    kinds = s["cfg"].layer_kinds()
    for i, lp in enumerate(q["layers"]):
        if kinds[i].body != "attn":
            assert "attn" not in lp


# ---------------------------------------------------------------------------
# decode and serving
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_prefill_and_jax(arch):
    """Token-by-token decode (recurrentgemma's local ring wraps its window
    of 8): each step's logits equal the full forward's at that position
    within 1e-5, and the JAX package's decode steps."""
    s = arch_slice(arch)
    cfg, plan = s["cfg"], s["float_plan"]
    B, S = 2, 12
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (B, S)) \
        .astype(np.int32)
    jcaches = JT.init_caches(s["jcfg"], s["jfloat_plan"], B, S, jnp.float32)
    with torch.inference_mode():
        full = T.forward(s["params"], {"tokens": _t(toks)}, cfg, plan)
        caches = T.init_caches(cfg, plan, B, S, device="cpu")
        outs, jouts = [], []
        for t in range(S):
            lg, caches = T.decode_step(s["params"], _t(toks[:, t:t + 1]),
                                       caches, t, cfg, plan)
            jlg, jcaches = JT.decode_step(
                s["jparams"], jnp.asarray(toks[:, t:t + 1]), jcaches, t,
                s["jcfg"], s["jfloat_plan"], compute_dtype=jnp.float32)
            outs.append(lg[:, 0].numpy())
            jouts.append(np.asarray(jlg[:, 0]))
    got = np.stack(outs, 1)
    assert rel_linf(full.numpy(), got) <= 1e-5
    assert rel_linf(np.stack(jouts, 1), got) <= 1e-5


def _prompts(cfg, n=3):
    rng = np.random.default_rng(0)
    return [rng.integers(1, cfg.vocab_size, int(k)).tolist()
            for k in rng.integers(2, 7, n)]


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_jax_engine(arch):
    """The golden-quantized model served greedily by both packages' engines
    (reference backends): 3 requests on 2 slots, so a slot is re-admitted
    (an sLSTM's normalizer restarts at ones), the same tokens and cache
    bytes."""
    s = arch_slice(arch)
    eng = ServeEngine(s["cfg"], s["q"], s["qplan"], batch_slots=2,
                      max_len=24, device="cpu")
    jeng = JaxEngine(s["jcfg"], s["jq"], s["jqplan"], batch_slots=2,
                     max_len=24, cache_dtype=jnp.float32)
    for i, p in enumerate(_prompts(s["cfg"])):
        eng.submit(Request(uid=i, prompt=list(p), max_tokens=5))
        jeng.submit(JaxRequest(uid=i, prompt=list(p), max_tokens=5))
    got = {r.uid: r.output for r in eng.run()}
    assert got == {r.uid: r.output for r in jeng.run()}
    assert len(got) == 3
    assert eng.kv_cache_bytes == jeng.kv_cache_bytes
    assert eng.kv_pages_in_use == 0


@pytest.mark.parametrize("arch", ARCHS)
def test_readmitted_slot_equals_a_fresh_one(arch):
    """After a request ran in slot 0, re-admission resets the slot's rows to
    a fresh cache's leaf for leaf (the sLSTM's n to ones, a ring's k_pos to
    -1), and leaves the other slot as it was."""
    s = arch_slice(arch)
    eng = ServeEngine(s["cfg"], s["params"], s["float_plan"], batch_slots=2,
                      max_len=16, device="cpu")
    for i, p in enumerate(_prompts(s["cfg"], 2)):
        eng.submit(Request(uid=i, prompt=list(p), max_tokens=3))
    eng.run()
    other = [{k: v[1].clone() for k, v in c.items()} for c in eng.caches]
    eng._reset_slot(0)
    fresh = T.init_caches(s["cfg"], s["float_plan"], 1, 16, device="cpu")
    for c, f, o in zip(eng.caches, fresh, other):
        assert set(c) == set(f)
        for k in c:
            assert c[k][0].equal(f[k][0]), k
            assert c[k][1].equal(o[k]), k
    if arch == "xlstm-125m":
        assert any(bool((c["n"][0] == 1).all()) for c in eng.caches
                   if "c" in c)


@pytest.mark.parametrize("arch", ARCHS)
def test_fused_equals_reference_on_cpu(arch):
    """On CPU tensors the fused backend runs the kernels' plain versions
    behind the same dispatch (recurrentgemma's FFN and local-attention
    boundary; nothing on xlstm's blocks): the reference backend's tokens."""
    s = arch_slice(arch)
    outs = []
    for backend in ("fused", "reference"):
        eng = ServeEngine(s["cfg"], s["q"], s["qplan"], batch_slots=2,
                          max_len=24, backend=backend, device="cpu")
        for i, p in enumerate(_prompts(s["cfg"])):
            eng.submit(Request(uid=i, prompt=list(p), max_tokens=4))
        outs.append({r.uid: r.output for r in eng.run()})
    assert outs[0] == outs[1]


def test_runtime_encode_across_mlstm_chunks_matches_jax():
    """``Runtime.encode`` of 300 tokens takes the 512 bucket (two mLSTM
    chunks; a bucket is S <= 256 or a multiple of it): the JAX runtime's
    token-level logits on the real rows. Within 5e-5, not 1e-5: inside a
    chunk the decay exponent b_t - b_s + li_s - m_t is a difference of
    cumulative log forget gates of size ~0.7 t (~180 at t = 256), where one
    float32 rounding is 1.5e-5, so two float32 implementations drift apart
    with the position in the chunk (3.7e-6 at S = 64, 1.4e-5 past 128)."""
    s = arch_slice("xlstm-125m")
    cfg, jcfg = s["cfg"], s["jcfg"]
    toks = np.random.default_rng(6).integers(1, cfg.vocab_size, (2, 300)) \
        .astype(np.int32)
    rt = Runtime(cfg, s["float_plan"], max_len=512, token_level=True,
                 head=lambda p, x: T.unembed(x, p, cfg), device="cpu")
    jrt = JaxRuntime(jcfg, s["jfloat_plan"], max_len=512, token_level=True,
                     head=lambda p, x: JT.unembed(x, p, jcfg))
    got = rt.encode(s["params"], {"tokens": toks})
    want = jrt.encode(s["jparams"], {"tokens": toks})
    assert rt.stats["buckets"] == [(2, 512)]
    assert got.shape == want.shape == (2, 300, cfg.vocab_size)
    assert rel_linf(want, got) <= 5e-5
