"""Port parity: the paper's main path, ``toolkit.Pipeline.predict_texts``
(tokenizer -> embedding -> encoder -> target), against the JAX package's on
the same numpy inputs: the WordPiece tokenizer, the synthetic task batches,
the policy lattice, the serving metrics, every target head, and the whole
pipeline on reduced bert-base under the float and the golden plan, on the
reference and the fused backends (whose kernels run their plain versions on
the CPU). Logits are compared at one batch bucket: a request served alone
and in a batch may differ in the last bits even in JAX
(``test_encoder_micro_batch_invariance``)."""
import ast
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import precision as JP
from repro.core.plan import PrecisionPlan as JaxPlan
from repro.data import pipeline as JD
from repro.data.tokenizer import WordPieceTokenizer as JaxTokenizer
from repro.models import transformer as JT
from repro.quant import ptq as jptq
from repro.serve import metrics as JM
from repro.toolkit import targets as JTG
from repro.toolkit.registry import TARGETS as JTARGETS
from repro.toolkit.pipeline import Pipeline as JaxPipeline

from repro_torch import kernels
from repro_torch.configs import get_config
from repro_torch.core import precision as P
from repro_torch.core.plan import PrecisionPlan
from repro_torch.data import pipeline as D
from repro_torch.data.tokenizer import WordPieceTokenizer
from repro_torch.interop import params_from_numpy
from repro_torch.models import transformer as T
from repro_torch.serve import EncoderRequest, EncoderServeEngine
from repro_torch.serve import metrics as M
from repro_torch.toolkit import Pipeline, TARGETS, get_target
from repro_torch.toolkit import targets as TG

from test_torch_support import GOLDEN, jax_to_numpy, rel_linf, \
    to_jax_batches

ROOT = Path(__file__).resolve().parents[1]
BUDGET = 5e-3            # the ±1-code budget of the int8 paths
SEQ = 16


# ---------------------------------------------------------------------------
# the port imports nothing of JAX or of the JAX package
# ---------------------------------------------------------------------------


def _imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


@pytest.mark.parametrize("path", sorted(
    (ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro", "flax"), (path, name)


# ---------------------------------------------------------------------------
# tokenizer
# ---------------------------------------------------------------------------


def _corpus(n=60, seed=0):
    rng = np.random.default_rng(seed)
    words = ["the", "quant", "quantized", "model", "layer", "layers",
             "Attention", "encoder", "tokens", "precision", "mixed",
             "int8", "café", "naïve", "résumé", "中", "文", "模型", "量化"]
    punct = [",", ".", "!", "?", ";", "(", ")", "-"]
    out = []
    for _ in range(n):
        k = int(rng.integers(3, 12))
        toks = [words[int(rng.integers(len(words)))] if rng.random() > 0.2
                else punct[int(rng.integers(len(punct)))] for _ in range(k)]
        out.append(" ".join(toks))
    return out


TEXTS = ["The quantized model, layer by layer!", "naïve café résumé",
         "中文模型量化 int8", "unseen wordz ?!", "", "precision-mixed (int8)"]


@pytest.mark.parametrize("granularity", ["wordpiece", "char"])
def test_tokenizer_matches_jax(granularity):
    corpus = _corpus()
    ours = WordPieceTokenizer.train(corpus, vocab_size=96,
                                    granularity=granularity)
    theirs = JaxTokenizer.train(corpus, vocab_size=96,
                                granularity=granularity)
    assert ours.vocab == theirs.vocab
    assert ours.vocab_size == theirs.vocab_size <= 96
    for text in TEXTS:
        assert ours.encode(text) == theirs.encode(text)
        assert ours.decode(ours.encode(text)) == \
            theirs.decode(theirs.encode(text))
    for a, b in zip(TEXTS, TEXTS[1:]):
        assert ours.encode_pair(a, b) == theirs.encode_pair(a, b)
    ids, mask = ours.encode_batch(TEXTS, 12)
    jids, jmask = theirs.encode_batch(TEXTS, 12)
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(mask, jmask)


# ---------------------------------------------------------------------------
# task data, policies, metrics
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("task", sorted(D.TASKS))
def test_get_batch_matches_jax(task):
    assert sorted(D.TASKS) == sorted(JD.TASKS)
    spec = D.make_task(task, vocab_size=500, seq_len=24, seed=3)
    jspec = JD.make_task(task, vocab_size=500, seq_len=24, seed=3)
    assert spec.__dict__ == jspec.__dict__
    for split in ("train", "dev"):
        for index in (0, 5):
            b = D.get_batch(spec, index, 6, split)
            jb = JD.get_batch(jspec, index, 6, split)
            assert sorted(b) == sorted(jb)
            for k in b:
                np.testing.assert_array_equal(b[k], jb[k])
                assert b[k].dtype == jb[k].dtype


def test_eval_accuracy_matches_jax():
    spec = D.make_task("tnews", vocab_size=200, seq_len=16)
    jspec = JD.make_task("tnews", vocab_size=200, seq_len=16)

    def predict(batch):          # a fixed rule both packages score alike
        return batch["tokens"][:, 0] % spec.n_classes
    assert D.eval_accuracy(predict, spec, batches=3, batch_size=8) == \
        JD.eval_accuracy(predict, jspec, batches=3, batch_size=8)


@pytest.mark.parametrize("name", ["float", "ffn", "full", "ffn3", "full1",
                                  "full0"])
def test_make_policy_matches_jax(name):
    cfg = get_config("bert-base")
    ours = P.make_policy(cfg, name, "float32")
    theirs = JP.make_policy(jax_get_config("bert-base"), name, "float32")
    assert [m.value for m in ours.modes] == [m.value for m in theirs.modes]
    assert ours.describe() == theirs.describe()
    assert ours.group_boundaries() == [
        (s, e, P.LayerMode(m.value))
        for s, e, m in theirs.group_boundaries()]


def test_make_policy_refuses_bad_names():
    with pytest.raises(ValueError):
        P.make_policy(get_config("bert-base"), "half")
    with pytest.raises(ValueError):
        P.EncoderPolicy.prefix(4, 5, P.LayerMode.FULLY_QUANT)
    with pytest.raises(ValueError):
        P.EncoderPolicy.subset(4, [4], P.LayerMode.FULLY_QUANT)


@pytest.mark.parametrize("stride", [1, 2, 5])
def test_paper_grid_matches_jax(stride):
    ours = P.paper_grid(12, "bfloat16", stride)
    theirs = JP.paper_grid(12, "bfloat16", stride)
    assert [(n, k, p.describe(), [m.value for m in p.modes])
            for n, k, p in ours] == \
        [(n, k, p.describe(), [m.value for m in p.modes])
         for n, k, p in theirs]


def test_subset_and_plan_coercion_match_jax():
    from repro.core.plan import as_plan as jax_as_plan
    from repro_torch.core.plan import as_plan
    ours = P.EncoderPolicy.subset(6, [0, 2, 5], P.LayerMode.QUANT_FFN_ONLY)
    theirs = JP.EncoderPolicy.subset(6, [0, 2, 5],
                                     JP.LayerMode.QUANT_FFN_ONLY)
    assert ours.describe() == theirs.describe()
    for dyn in (False, True):
        assert as_plan(ours, dynamic_acts=dyn).fingerprint() == \
            jax_as_plan(theirs, dynamic_acts=dyn).fingerprint()


def test_latency_summary_matches_jax():
    rng = np.random.default_rng(0)
    xs = list(rng.exponential(0.02, 200))
    assert M.latency_summary(xs) == JM.latency_summary(xs)
    assert M.latency_summary([]) == JM.latency_summary([])
    assert M.LATENCY_BUCKETS == JM.LATENCY_BUCKETS
    assert M.CORE_METRICS == JM.CORE_METRICS


def test_metrics_registry_renders_like_jax():
    def fill(mod):
        reg = mod.MetricsRegistry()
        reg.counter("samp_requests_completed_total", "done",
                    labels={"engine": "encoder"}).inc(3)
        reg.gauge("samp_queue_depth", "queued", fn=lambda: 7)
        reg.gauge("samp_batch_occupancy", labels={"q": 'a"b'}).set(0.5)
        h = reg.histogram("samp_request_latency_seconds", "latency")
        for v in (0.0004, 0.003, 0.2, 12.0):
            h.observe(v)
        adopted = mod.Histogram("samp_extra_seconds", {"path": "x"},
                                buckets=(0.1, 1.0))
        adopted.observe(0.5)
        reg.register(adopted, "histogram", "adopted")
        return reg.render()
    assert fill(M) == fill(JM)


def test_engine_stats_read_engine_counters():
    cfg = get_config("bert-base").reduced()
    fp = PrecisionPlan.full_float(cfg.num_layers, "float32")
    params = T.init_params(cfg, fp, seed=0, head=("cls", 3), device="cpu")
    eng = EncoderServeEngine(cfg, params, T.build_plan(cfg, fp),
                             max_batch=4, device="cpu")
    for i, n in enumerate((5, 9, 3)):
        eng.submit(EncoderRequest(uid=i, tokens=list(range(1, n + 1))))
    assert eng.stats["queue_depth"] == 3
    eng.run()
    s = eng.stats
    want = M.engine_counters(eng)
    assert {k: s[k] for k in want} == want
    assert s["completed"] == 3 and s["queue_depth"] == 0
    assert s["retraces"] == s["executables"] == 2   # buckets (1, 8), (2, 16)


# ---------------------------------------------------------------------------
# target heads
# ---------------------------------------------------------------------------


def test_target_registry_matches_jax():
    assert TARGETS.names() == ["cls", "lm", "pair_matching", "seq_labeling"]
    assert TG.TARGET_FOR_TASK_KIND == JTG.TARGET_FOR_TASK_KIND
    for name in TARGETS:
        ours, theirs = get_target(name), JTARGETS.get(name)
        assert (ours.token_level, ours.default_task) == \
            (theirs.token_level, theirs.default_task)
    with pytest.raises(KeyError):
        get_target("nope")
    with pytest.raises(KeyError):
        TARGETS.register("cls", TG.CLS)


@pytest.mark.parametrize("name", ["cls", "pair_matching", "seq_labeling",
                                  "lm"])
def test_target_heads_match_jax(name):
    """Each head's logits on the same hidden states and carried params."""
    import jax.numpy as jnp
    jcfg = jax_get_config("bert-base").reduced()
    cfg = get_config("bert-base").reduced()
    spec, jspec = get_target(name), JTARGETS.get(name)
    jparams = JT.init_params(jax.random.PRNGKey(1), jcfg,
                             JaxPlan.full_float(jcfg.num_layers, "float32"))
    head = jspec.init(jax.random.PRNGKey(2), jcfg, 7, jnp.float32)
    if head is not None:
        jparams["head"] = head
    plan = T.build_plan(cfg, PrecisionPlan.full_float(cfg.num_layers,
                                                      "float32"))
    params = params_from_numpy(jax_to_numpy(jparams), plan, "cpu")
    hidden = np.random.default_rng(3).standard_normal(
        (3, 10, cfg.d_model)).astype(np.float32)
    want = np.asarray(jspec.apply(jparams, jnp.asarray(hidden), jcfg))
    got = spec.apply(params, torch.from_numpy(hidden), cfg).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(spec.predict(got).numpy(),
                                  np.asarray(jspec.predict(want)))
    # the head the port initialises has the JAX head's layout
    mine = spec.init(torch.Generator().manual_seed(0), cfg, 7)
    assert jax.tree_util.tree_structure(jax_to_numpy(head)) == \
        jax.tree_util.tree_structure(
            None if mine is None else {k: {n: np.asarray(t) for n, t in
                                           v.items()}
                                       for k, v in mine.items()})


# ---------------------------------------------------------------------------
# the whole pipeline on reduced bert-base
# ---------------------------------------------------------------------------


def _carry(jparams, plan):
    return params_from_numpy(jax_to_numpy(jparams), plan, "cpu")


def _pipelines(task, backend="reference", seed=0):
    """The JAX float pipeline and the port's, with the JAX pipeline's
    init_params carried across."""
    jcfg = jax_get_config("bert-base").reduced()
    cfg = get_config("bert-base").reduced()
    jpipe = JaxPipeline.build(jcfg, task, seq_len=SEQ, float_dtype="float32")
    jpipe.init_params(jax.random.PRNGKey(seed))
    pipe = Pipeline.build(cfg, task, seq_len=SEQ, float_dtype="float32",
                          backend=backend, device="cpu")
    pipe.params = _carry(jpipe.params, pipe.plan)
    assert pipe.precision.fingerprint() == jpipe.precision.fingerprint()
    return jpipe, pipe


@pytest.fixture(scope="module")
def golden():
    """The float tnews pipelines, JAX's PTQ output under the golden plan,
    and both packages' quantized siblings (the port on both backends)."""
    jpipe, pipe = _pipelines("tnews")
    jplan, plan = JaxPlan.load(GOLDEN), PrecisionPlan.load(GOLDEN)
    batches = [D.get_batch(pipe.task, i, 4, "train") for i in range(2)]
    batches = [{"tokens": b["tokens"], "segments": b["segments"]}
               for b in batches]
    jstats = jptq.capture_stats(jpipe.params, to_jax_batches(batches),
                                jpipe.cfg, jpipe.plan, precision=jplan)
    jq, jqplan = jptq.apply_plan(jpipe.params, jpipe.cfg, jplan, jstats,
                                 float_plan=jpipe.plan)
    jqpipe = jpipe.with_policy(jq, jqplan, jplan)
    qplan = T.build_plan(pipe.cfg, plan)
    qparams = _carry(jq, qplan)
    out = {"jpipe": jpipe, "pipe": pipe, "jqpipe": jqpipe}
    for backend in ("reference", "fused"):
        base = Pipeline.build(pipe.cfg, "tnews", seq_len=SEQ,
                              float_dtype="float32", backend=backend,
                              device="cpu")
        out[backend] = base.with_policy(qparams, qplan, plan)
    return out


def _batch(task_spec, n=5, index=0):
    b = D.get_batch(task_spec, index, n, "dev")
    return {k: v for k, v in b.items() if k != "labels"}


def test_float_predict_logits_match_jax(golden):
    b = _batch(golden["pipe"].task)
    got = golden["pipe"].predict_logits(b)
    want = np.asarray(golden["jpipe"].predict_logits(b))
    assert got.shape == want.shape == (5, 15)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(golden["pipe"].predict(b),
                                  np.asarray(golden["jpipe"].predict(b)))


def test_forward_composes_the_stages_like_jax(golden):
    b = _batch(golden["pipe"].task, n=3)
    got = golden["pipe"].forward(golden["pipe"].params,
                                 {k: torch.from_numpy(v)
                                  for k, v in b.items()})
    import jax.numpy as jnp
    want = golden["jpipe"].forward(golden["jpipe"].params,
                                   {k: jnp.asarray(v) for k, v in b.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("backend", ["reference", "fused"])
def test_golden_predict_logits_match_jax(golden, backend):
    """Under the golden plan, on either backend of the port, against the
    JAX reference backend at the same bucket: identical predictions, logits
    within the ±1-code budget."""
    jq = golden["jqpipe"]
    for index in range(2):
        b = _batch(golden["pipe"].task, n=8, index=index)
        got = golden[backend].predict_logits(b)
        want = np.asarray(jq.predict_logits(b))
        assert rel_linf(want, got) <= BUDGET
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_golden_fused_launches_nothing_on_cpu(golden):
    kernels.reset_launches()
    golden["fused"].predict_logits(_batch(golden["pipe"].task))
    assert not any(kernels.launch_counts().values())


def test_with_policy_shares_the_runtime(golden):
    pipe, q = golden["pipe"], golden["reference"]
    assert golden["fused"].runtime is not q.runtime
    sib = pipe.with_policy(q.params, q.plan, q.precision)
    assert sib.runtime._exe is pipe.runtime._exe
    assert sib.runtime._stats is pipe.runtime._stats
    assert sib.tokenizer.tokenizer is pipe.tokenizer.tokenizer
    before = pipe.runtime.stats["executables"]
    b = _batch(pipe.task, n=2)
    pipe.predict_logits(b)
    sib.predict_logits(b)
    keys = {k[1] for k in pipe.runtime._exe}
    # (backend, plan fingerprint, mesh fingerprint, cluster): "unmeshed"
    # without a mesh, None for an unrouted runtime
    assert ("reference", pipe.precision.fingerprint(), "unmeshed",
            None) in keys
    assert ("reference", sib.precision.fingerprint(), "unmeshed",
            None) in keys
    assert pipe.runtime.stats["executables"] >= before + 1
    # an EncoderPolicy coerces through the lossless shim, as in JAX
    pol = P.make_policy(pipe.cfg, "ffn2", "float32")
    assert pipe.with_policy(pipe.params, T.build_plan(pipe.cfg, pol),
                            pol).precision.fingerprint() == \
        golden["jpipe"].with_policy(
            golden["jpipe"].params, None,
            JP.make_policy(golden["jpipe"].cfg, "ffn2",
                           "float32")).precision.fingerprint()


@pytest.fixture(scope="module")
def tokenizer():
    corpus = _corpus(80, seed=1)
    return (WordPieceTokenizer.train(corpus, vocab_size=128),
            JaxTokenizer.train(corpus, vocab_size=128))


@pytest.mark.parametrize("backend", ["reference", "fused"])
def test_predict_texts_matches_jax(golden, tokenizer, backend):
    """Raw strings through the golden-plan pipelines: the same token ids
    and the same predictions."""
    ours, theirs = tokenizer
    texts = _corpus(6, seed=9) + ["中文 int8 model!"]
    pipe, jq = golden[backend], golden["jqpipe"]
    pipe.tokenizer.tokenizer = ours
    jq.tokenizer.tokenizer = theirs
    ids = pipe.tokenizer(texts)
    jids = jq.tokenizer(texts)
    for k in ids:
        np.testing.assert_array_equal(ids[k], jids[k])
    np.testing.assert_array_equal(pipe.predict_texts(texts),
                                  np.asarray(jq.predict_texts(texts)))
    pairs = list(zip(texts[:3], texts[3:6]))
    np.testing.assert_array_equal(pipe.predict_texts(pairs),
                                  np.asarray(jq.predict_texts(pairs)))


def test_predict_texts_needs_a_tokenizer(golden):
    pipe = Pipeline.build(golden["pipe"].cfg, "tnews", device="cpu")
    with pytest.raises(ValueError):
        pipe.predict_texts(["a b"])
    with pytest.raises(ValueError):
        pipe.predict({"tokens": np.ones((1, 4), np.int32)})


@pytest.mark.parametrize("task", ["tnews", "afqmc", "ner", "lm"])
def test_eval_matches_jax(task):
    """Accuracy over two small dev batches, each task with its default
    head (cls, pair_matching, seq_labeling, lm)."""
    jpipe, pipe = _pipelines(task, seed=4)
    assert pipe.target.spec.name == jpipe.target.spec.name
    assert pipe.describe().startswith(
        f"Pipeline[{pipe.cfg.name}] task={task} "
        f"target={pipe.target.spec.name} policy=")
    acc = pipe.eval(batches=2, batch_size=4)
    jacc = jpipe.eval(batches=2, batch_size=4)
    assert acc == jacc
    b = _batch(pipe.task, n=4)
    np.testing.assert_allclose(pipe.predict_logits(b),
                               np.asarray(jpipe.predict_logits(b)),
                               rtol=1e-5, atol=1e-5)


def test_pipeline_matches_the_encoder_engine(golden):
    """The pipeline predicts through the engine's runtime: the same token
    ids at the same bucket give the same logits as EncoderServeEngine."""
    pipe = golden["fused"]
    b = _batch(pipe.task, n=4)
    eng = EncoderServeEngine(pipe.cfg, pipe.params, pipe.plan,
                             backend="fused", max_batch=4, max_len=SEQ,
                             device="cpu")
    for i in range(4):
        eng.submit(EncoderRequest(uid=i, tokens=b["tokens"][i].tolist(),
                                  segments=b["segments"][i].tolist()))
    done = sorted(eng.run(), key=lambda r: r.uid)
    np.testing.assert_array_equal(np.stack([r.logits for r in done]),
                                  pipe.predict_logits(b))


def test_init_params_builds_every_head():
    cfg = get_config("bert-base").reduced()
    for task in ("tnews", "afqmc", "ner", "lm"):
        pipe = Pipeline.build(cfg, task, seq_len=SEQ, device="cpu")
        params = pipe.init_params(torch.Generator().manual_seed(0))
        assert ("head" in params) == (task != "lm")
        out = pipe.predict_logits(_batch(pipe.task, n=2))
        assert np.isfinite(out).all()
        assert out.shape[-1] == (cfg.vocab_size if task == "lm"
                                 else pipe.target.n_out)
