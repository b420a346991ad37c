"""Token groups and expert parallelism for the MoE archs on a serving mesh.

The JAX package's ``moe_block`` dispatches one token group per data shard,
taking the group count from its ``constrain`` argument's ``dsize`` and
nothing else (``src/repro/models/layers.py:1022``). A stub ``constrain``
that returns its input and carries ``dsize = 2`` gives JAX's grouped
dispatch on the CPU with no mesh at all: the reference for the port's
``moe_block(groups=2)``, on reduced mixtral-8x22b and deepseek-v2-236b
(with its shared expert), float, static int8 and per-token int8 expert
stacks, through the reference backend. An odd token count falls back to
one group, as in JAX.

The accumulator mode of the routed expert GEMM (per-expert tensor
parallelism over ``wd``'s hidden units) is held to the whole GEMM: two
halves of the accumulator sum to the whole one exactly, and its epilogue
on the sum equals the unsharded output bit for bit.

Then 2 gloo ranks, spawned once for the module from
``tests/torch_mesh_worker.py`` (which imports no JAX), serve both reduced
MoE archs at (data=2, model=1), expert parallel with 2 of the 4 experts a
rank, and at (data=1, model=2), each expert's hidden units split:
calibration on each mesh equals the unmeshed stats exactly; data parallel
equals the unmeshed runtime with 2 token groups bit for bit (a batch the
data axis splits, one whose rows it does not, an odd token count); tensor
parallel is within ``test_torch_mesh.py``'s rtol 1e-5 / atol 1e-6 of the
unmeshed encode under the all-int8 plans (int32 sums: exact) and, taken
relative to the output's largest magnitude, on the float tree (its
row-parallel float partials sum in another order); where such a float sum
feeds an int8 code (golden v4's float attention output, the FFN-only
plans' float attention) one code can flip at a tie, and the encode is held
to the encoder's one-code budget, rel-Linf 5e-3. Decode tokens equal, with
no page in use after.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import layers as JL
from repro.quant import ptq as jptq

from repro_torch.configs import get_config
from repro_torch.core.calibration import synthetic_calibration_batches
from repro_torch.core.quantize import QuantizedTensor, quantize
from repro_torch.distributed import comm
from repro_torch.kernels.backend import get_backend
from repro_torch.kernels.expert_gemm import (quant_expert_gemm_acc,
                                             quant_expert_gemm_epilogue,
                                             quant_expert_gemm_plain)
from repro_torch.models import layers as L

import torch_mesh_worker as W
from test_torch_support import GOLDEN_V4, jax_to_numpy, rel_linf

ARCHS = W.MOE_ARCHS
MODES = ("float", "static", "per_token")
RANKS = (0, 1)
SPAWN_S = 300.0
REF = get_backend("reference")


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _port(tree):
    """A JAX MoE parameter tree (numpy) as the port's: each
    {"values", "scale", "zero_point"} dict a QuantizedTensor."""
    if isinstance(tree, dict):
        if set(tree) == {"values", "scale", "zero_point"}:
            return QuantizedTensor(_t(tree["values"]), _t(tree["scale"]),
                                   None)
        return {k: _port(v) for k, v in tree.items()}
    return _t(tree)


def _case(arch, mode, shape=(2, 4)):
    """Reduced ``arch``'s MoE FFN in both packages, its capacity factor cut
    to 0.5 so that a group of 4 tokens drops routings (capacity 1 a group,
    2 ungrouped), and an input of ``shape`` tokens. The int8 modes quantize
    the expert stacks per expert and per channel; the static one takes
    each expert's activation scale from an ungrouped JAX forward's
    observers."""
    jcfg, cfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    jcfg = jcfg.replace(moe=dataclasses.replace(jcfg.moe,
                                                capacity_factor=0.5))
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=0.5))
    jp = JL.init_moe(jax.random.PRNGKey(1), jcfg)
    x = np.random.default_rng(2).standard_normal(
        shape + (cfg.d_model,)).astype(np.float32)
    if mode != "float":
        obs = {}
        JL.moe_block(jnp.asarray(x), jp, jcfg, obs=obs)
        site = {"wg": "expert_in", "wu": "expert_in", "wd": "expert_hidden"}
        for key in ("wg", "wu", "wd"):
            jp[key] = {"w": jptq.quantize_weight(jp[key]["w"])}
            if mode == "static":
                jp[key]["xs"] = (obs[site[key]] / 127.0).reshape(-1, 1, 1)
    return jcfg, cfg, jp, _port(jax_to_numpy(jp)), x


class _Stub:
    """The JAX package's ``constrain`` slot with a data axis of ``dsize``
    and no mesh: every activation passes through unchanged."""

    def __init__(self, dsize):
        self.dsize = dsize

    def __call__(self, a, _):
        return a


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_grouped_moe_block_matches_jax(arch, mode, monkeypatch):
    """Two groups of 4 tokens: each group's keep and slots equal JAX's
    dispatch of that group exactly, and the output is within 1e-5 of JAX's
    grouped ``moe_block`` (test_torch_moe's tolerance); the groups change
    the result."""
    jcfg, cfg, jp, p, x = _case(arch, mode)
    want = np.asarray(JL.moe_block(jnp.asarray(x), jp, jcfg,
                                   constrain=_Stub(2)))
    seen = []
    dispatch = L._dispatch_one

    def spy(*args):
        out = dispatch(*args)
        seen.append(out)
        return out
    monkeypatch.setattr(L, "_dispatch_one", spy)
    got = L.moe_block(_t(x), p, cfg, backend=REF, groups=2)
    assert rel_linf(want, got.numpy()) <= 1e-5
    mo = cfg.moe
    E, K, D = mo.num_experts, mo.top_k, cfg.d_model
    xg = jnp.asarray(x).reshape(2, 4, D)
    logits = jnp.einsum("gtd,de->gte", xg, jp["router"]["w"])
    C = int(np.ceil(mo.capacity_factor * 4 * K / E))
    assert len(seen) == 2 and seen[0][0].shape == (E, C, D)
    for g in range(2):
        _, _, _, keep, slot = JL._dispatch_one(xg[g], logits[g], E, K, C)
        np.testing.assert_array_equal(seen[g][3].numpy(), np.asarray(keep))
        np.testing.assert_array_equal(seen[g][4].numpy(), np.asarray(slot))
    ungrouped = np.asarray(JL.moe_block(jnp.asarray(x), jp, jcfg))
    assert np.abs(ungrouped - want).max() > 1e-3


@pytest.mark.parametrize("arch", ARCHS)
def test_odd_token_count_falls_back_to_one_group(arch):
    """5 tokens do not split in two: both packages run one group."""
    jcfg, cfg, jp, p, x = _case(arch, "per_token", shape=(1, 5))
    want = np.asarray(JL.moe_block(jnp.asarray(x), jp, jcfg,
                                   constrain=_Stub(2)))
    got = L.moe_block(_t(x), p, cfg, backend=REF, groups=2)
    assert L.moe_groups(5, 2) == 1 and L.moe_groups(8, 2) == 2
    np.testing.assert_array_equal(
        got.numpy(), L.moe_block(_t(x), p, cfg, backend=REF).numpy())
    assert rel_linf(want, got.numpy()) <= 1e-5


def _stack(seed=0, G=2, E=4, C=3, D=64, F=48):
    g = torch.Generator().manual_seed(seed)
    xe = torch.randn((G, E, C, D), generator=g)
    w = torch.randn((E, D, F), generator=g)
    ws = w.abs().amax(dim=1, keepdim=True) / 127.0          # (E, 1, F)
    wq = QuantizedTensor(quantize(w, ws), ws, None)
    xs = xe.abs().amax(dim=(0, 2, 3)).reshape(E, 1, 1) / 127.0
    return xe, wq, xs


def test_accumulator_halves_sum_to_the_whole():
    """The accumulator mode's plain version over two halves of D sums to
    the whole accumulator exactly, and the epilogue on the sum equals the
    unsharded GEMM bit for bit."""
    xe, wq, xs = _stack()
    codes = quantize(xe, xs.reshape(1, -1, 1, 1))
    whole = quant_expert_gemm_acc(codes, wq.values)
    assert whole.dtype == torch.int32
    half = xe.shape[-1] // 2
    parts = [quant_expert_gemm_acc(codes[..., s].contiguous(),
                                   wq.values[:, s].contiguous())
             for s in (slice(0, half), slice(half, None))]
    torch.testing.assert_close(parts[0] + parts[1], whole, rtol=0, atol=0)
    y = quant_expert_gemm_epilogue(parts[0] + parts[1], wq.scale,
                                   xs.reshape(1, -1, 1, 1))
    want = quant_expert_gemm_plain(xe, wq.values, wq.scale, xs)
    torch.testing.assert_close(y, want, rtol=0, atol=0)


@pytest.mark.parametrize("backend", ["reference", "fused"])
@pytest.mark.parametrize("static", [True, False], ids=["static", "per_token"])
def test_backend_accumulators_of_two_ranks_equal_the_whole(backend, static):
    """``expert_gemm_acc`` on two halves of D, per-token codes at the whole
    row's amax (``row_amax``), summed and dequantized: equal to the
    backend's unsharded ``expert_gemm`` bit for bit. A float stack
    declines."""
    xe, wq, xs = _stack(seed=1)
    xs = xs if static else None
    be = get_backend(backend)
    half = xe.shape[-1] // 2
    whole_amax = xe.abs().amax(dim=-1)

    def rows(a):
        return torch.maximum(a, whole_amax)
    accs, scales = [], []
    for s in (slice(0, half), slice(half, None)):
        w = QuantizedTensor(wq.values[:, s].contiguous(), wq.scale, None)
        acc, x_scale = be.expert_gemm_acc(xe[..., s].contiguous(), w, xs,
                                          row_amax=rows)
        accs.append(acc)
        scales.append(x_scale)
    torch.testing.assert_close(scales[0], scales[1], rtol=0, atol=0)
    y = quant_expert_gemm_epilogue(accs[0] + accs[1], wq.scale, scales[0])
    torch.testing.assert_close(y, be.expert_gemm(xe, wq, xs), rtol=0, atol=0)
    assert be.expert_gemm_acc(xe, torch.randn(4, 64, 48), xs) is None


# ---------------------------------------------------------------------------
# two ranks over gloo
# ---------------------------------------------------------------------------


def _job():
    rng = np.random.default_rng(0)
    job = {}
    for arch in ARCHS:
        cfg = get_config(arch).reduced()
        job[arch] = {
            "batches": synthetic_calibration_batches(cfg, num_batches=2,
                                                     seq_len=16),
            "encodes": {s: {"tokens": rng.integers(1, cfg.vocab_size, s)
                            .astype(np.int32)}
                        for s in ((4, 8), (3, 4), (3, 5))},
            "prompts": [rng.integers(1, cfg.vocab_size, int(n)).tolist()
                        for n in rng.integers(2, 7, 6)],
            "golden_v4": GOLDEN_V4}
    return job


@pytest.fixture(scope="module")
def ranks():
    return comm.spawn(2, W.run_moe, (_job(),), device="cpu", threads=1,
                      deadline_s=SPAWN_S)


PLANS = [("mixtral-8x22b", "golden_v4"), ("mixtral-8x22b", "int8"),
         ("deepseek-v2-236b", "static"), ("deepseek-v2-236b", "per_token"),
         ("deepseek-v2-236b", "int8"), ("deepseek-v2-236b", "float")]
QUANTIZED = [c for c in PLANS if c[1] != "float"]
BUDGET = 5e-3            # the encoder's one-code budget
SHAPES = ("(4, 8)", "(3, 4)", "(3, 5)")


@pytest.mark.parametrize("rank", RANKS)
def test_ranks_import_no_jax(ranks, rank):
    assert ranks[rank]["rank"] == rank
    assert ranks[rank]["jax modules"] == []


@pytest.mark.parametrize("topology", W.TOPOLOGIES)
@pytest.mark.parametrize("arch,plan", QUANTIZED)
def test_mesh_stats_equal_unmeshed_stats(ranks, arch, plan, topology):
    """Calibration on a mesh runs whole batches (one token group each, as
    the JAX package's observers see them) split over the ranks."""
    for r in ranks:
        m = r["moe"]
        assert m[f"{arch} {plan} stats {topology}"] == \
            m[f"{arch} {plan} stats"]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch,plan", PLANS)
def test_dp_encode_equals_the_grouped_unmeshed_encode(ranks, arch, plan,
                                                      shape):
    """(4, 8): each rank's rows are its group, its experts' rows come by
    all-to-all; (3, 4): every rank routes both groups of 6 tokens (their
    boundary inside a row) and all-gathers its experts' outputs; (3, 5):
    15 tokens, one group. Bit for bit, float stacks included, and every
    rank returns the whole output."""
    for r in ranks:
        m = r["moe"]
        got = m[f"{arch} {plan} {shape} 2,1"]
        np.testing.assert_array_equal(got, m[f"{arch} {plan} {shape} "
                                             f"grouped"])
    grouped = ranks[0]["moe"][f"{arch} {plan} {shape} grouped"]
    unmeshed = ranks[0]["moe"][f"{arch} {plan} {shape} unmeshed"]
    assert (np.array_equal(grouped, unmeshed)) == (shape == "(3, 5)")


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch,plan", PLANS)
def test_tp_encode_matches_unmeshed(ranks, arch, plan, shape):
    for r in ranks:
        m = r["moe"]
        want = m[f"{arch} {plan} {shape} unmeshed"]
        got = m[f"{arch} {plan} {shape} 1,2"]
        if plan == "int8":
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        elif plan == "float":
            scale = np.abs(want).max()
            np.testing.assert_allclose(got / scale, want / scale, rtol=1e-5,
                                       atol=1e-6)
        else:
            assert rel_linf(want, got) <= BUDGET


@pytest.mark.parametrize("topology", W.TOPOLOGIES)
@pytest.mark.parametrize("arch,plan", PLANS)
def test_decode_tokens_equal_unmeshed(ranks, arch, plan, topology):
    """Data parallel against the unmeshed engine with 2 token groups (a
    rank's 2 slots its group), tensor parallel against the plain unmeshed
    engine; no page in use after; a DP rank holds 2 of the 4 slots."""
    ref = "grouped" if topology == "2,1" else "unmeshed"
    for r in ranks:
        m = r["moe"]
        tokens, pages, slots = m[f"{arch} {plan} decode {topology}"]
        want = m[f"{arch} {plan} decode {ref}"][0]
        assert sorted(want) == list(range(6))
        assert all(len(o) == 5 for o in want.values())
        assert tokens == want and pages == 0
        assert slots == (2 if topology == "2,1" else 4)


@pytest.mark.parametrize("arch,plan", PLANS)
def test_dp_ranks_hold_half_the_experts(ranks, arch, plan):
    cfg = get_config(arch).reduced()
    E, D, F = cfg.moe.num_experts, cfg.d_model, cfg.moe.d_ff_expert
    assert ranks[0]["moe"][f"{arch} {plan} experts held 2,1"] == \
        (E // 2, D, F)
