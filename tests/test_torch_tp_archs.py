"""Tensor parallelism for MLA, the recurrent bodies and the front-ends.

Two gloo ranks, spawned once for the module from
``tests/torch_mesh_worker.py`` (which imports no JAX), serve reduced
deepseek-v2-236b (MLA: heads over ``model``, ``q_lat`` all-gathered before
``q_norm``, the whole latent cached on every rank), hubert-xlarge (audio
``frames`` through the column-parallel ``frontend_proj``), paligemma-3b
(its vision prefix the same way, the prefix-LM mask), recurrentgemma-9b
(the RG-LRU on a rank's channels beside its MQA local attention) and
xlstm-125m (mLSTM and sLSTM on a rank's heads) at (data=1, model=2), each
against the unmeshed port (which the arch suites hold to JAX):

* calibration on the mesh equals the unmeshed stats exactly;
* under the all-int8 plan (every GEMM int8 at per-token scales: the ranks
  sum int32 accumulators) the encode is within ``test_torch_mesh.py``'s
  rtol 1e-5 / atol 1e-6; the float tree within the same tolerance taken
  relative to the output's largest magnitude (its row-parallel float
  partials sum in another order); hubert under the int8 span within the
  encoder's one-code budget, rel-Linf 5e-3 (its float front-end GEMM feeds
  int8 codes);
* decode tokens equal, with no page in use after;
* a rank holds its block of the sharded leaves.
"""
import numpy as np
import pytest

from repro_torch.configs import get_config
from repro_torch.core.calibration import synthetic_calibration_batches
from repro_torch.distributed import comm

import torch_mesh_worker as W
from test_torch_support import rel_linf

ARCHS = W.TP_ARCHS
DECODERS = tuple(a for a in ARCHS if get_config(a).supports_decode)
RANKS = (0, 1)
SPAWN_S = 300.0
BUDGET = 5e-3


def _job():
    rng = np.random.default_rng(0)
    job = {}
    for arch in ARCHS:
        cfg = get_config(arch).reduced()
        if cfg.frontend == "audio":
            inputs = {"frames": rng.standard_normal(
                (3, 12, cfg.frontend_dim)).astype(np.float32)}
        else:
            inputs = {"tokens": rng.integers(1, cfg.vocab_size, (3, 8))
                      .astype(np.int32)}
            if cfg.frontend == "vision":
                inputs["prefix_embeds"] = rng.standard_normal(
                    (3, cfg.num_prefix_embeds, cfg.frontend_dim)).astype(
                    np.float32)
        job[arch] = {
            "batches": synthetic_calibration_batches(cfg, num_batches=2,
                                                     seq_len=16),
            "inputs": inputs,
            "prompts": [rng.integers(1, cfg.vocab_size, int(n)).tolist()
                        for n in rng.integers(2, 7, 6)]}
    return job


@pytest.fixture(scope="module")
def ranks():
    return comm.spawn(2, W.run_tp_archs, (_job(),), device="cpu", threads=1,
                      deadline_s=SPAWN_S)


def _plans(arch):
    return ("float", "int8") + (("span",) if arch == "hubert-xlarge"
                                else ())


@pytest.mark.parametrize("rank", RANKS)
def test_ranks_import_no_jax(ranks, rank):
    assert ranks[rank]["rank"] == rank
    assert ranks[rank]["jax modules"] == []


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_stats_equal_unmeshed_stats(ranks, arch):
    for r in ranks:
        for plan in _plans(arch)[1:]:
            assert r["archs"][f"{arch} {plan} stats"] is True


@pytest.mark.parametrize("arch,plan", [(a, p) for a in ARCHS
                                       for p in _plans(a)])
def test_tp_encode_matches_unmeshed(ranks, arch, plan):
    for r in ranks:
        a = r["archs"]
        want = a[f"{arch} {plan} encode unmeshed"]
        got = a[f"{arch} {plan} encode 1,2"]
        assert got.shape == want.shape and np.isfinite(got).all()
        if plan == "int8":
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        elif plan == "float":
            scale = np.abs(want).max()
            np.testing.assert_allclose(got / scale, want / scale, rtol=1e-5,
                                       atol=1e-6)
        else:
            assert rel_linf(want, got) <= BUDGET
    np.testing.assert_array_equal(ranks[0]["archs"][f"{arch} {plan} encode "
                                                    f"1,2"],
                                  ranks[1]["archs"][f"{arch} {plan} encode "
                                                    f"1,2"])


@pytest.mark.parametrize("plan", ["float", "int8"])
@pytest.mark.parametrize("arch", DECODERS)
def test_tp_decode_tokens_equal_unmeshed(ranks, arch, plan):
    for r in ranks:
        a = r["archs"]
        want, pages0, slots0 = a[f"{arch} {plan} decode unmeshed"]
        got, pages, slots = a[f"{arch} {plan} decode 1,2"]
        assert sorted(want) == list(range(6))
        assert all(len(o) == 5 for o in want.values())
        assert got == want and pages == pages0 == 0 and slots == slots0 == 4


def test_ranks_hold_their_blocks(ranks):
    """MLA's ``wkv_b`` on its head-major columns (2 of 4 heads of 16 + 16),
    the front-ends' ``frontend_proj`` on its d_model columns, the RG-LRU's
    input GEMMs on their R columns and ``wo`` on its rows, xlstm's
    projections on their columns (``up``, ``wif`` too) and ``down`` on its
    rows."""
    loc = {a: ranks[0]["archs"][f"{a} local"] for a in ARCHS}
    assert loc["deepseek-v2-236b"] == {"wkv_b": (32, 64)}
    assert loc["hubert-xlarge"] == loc["paligemma-3b"] == {
        "frontend_proj": (32, 32)}
    assert loc["recurrentgemma-9b"] == {"wx": (64, 32), "wg": (64, 32),
                                        "wa": (64, 32), "wi": (64, 32),
                                        "wo": (32, 64)}
    assert loc["xlstm-125m"] == {"up": (64, 128), "wq": (128, 64),
                                 "wk": (128, 64), "wv": (128, 64),
                                 "wif": (128, 4), "down": (64, 64)}
