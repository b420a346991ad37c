"""The rank side of ``tests/test_torch_mesh.py`` (this module holds no
tests). Each rank that ``repro_torch.distributed.comm.spawn`` starts imports
this module, which imports torch and the port only: never JAX, nothing of
``repro``. :func:`run` rebuilds the reduced models from the numpy inputs
the test hands it and serves them unmeshed and on the two 2-rank
topologies, (data=2, model=1) and (data=1, model=2); the test asserts on
what every rank returns. :func:`run_moe` (``tests/test_torch_moe_mesh.py``)
does the same for the MoE archs, and :func:`run_tp_archs`
(``tests/test_torch_tp_archs.py``) for MLA, the recurrent bodies and the
front-ends at (data=1, model=2).
"""
from __future__ import annotations

import sys

import torch

GOLDEN = "tests/data/golden_plan.json"
TOPOLOGIES = ("2,1", "1,2")


def _jax_loaded() -> list[str]:
    return sorted(m for m in sys.modules
                  if m == "jax" or m.startswith("jax.") or m == "repro"
                  or m.startswith("repro."))


def _dynamic_plan(num_layers: int):
    """Every layer fully quantized at per-token scales: the attention's
    int8 matmuls then code at dynamic per-tensor scales, which a mesh
    reduces over every rank."""
    from repro_torch.core.plan import LayerMode, LayerPlan, PrecisionPlan
    lp = LayerPlan.for_mode(LayerMode.FULLY_QUANT, dynamic_acts=True)
    return PrecisionPlan((lp,) * num_layers, "float32")


def _bert(job: dict) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.core.plan import PrecisionPlan
    from repro_torch.interop import params_from_numpy
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.models import transformer as T
    from repro_torch.quant import ptq
    from repro_torch.serve import EncoderRequest, EncoderServeEngine, Runtime

    cfg = get_config("bert-base").reduced().replace(num_layers=4)
    golden = PrecisionPlan.load(GOLDEN)
    float_plan = T.build_plan(cfg, PrecisionPlan.full_float(4, "float32"))
    params = params_from_numpy(job["params"], float_plan, "cpu")
    batches = job["batches"]
    out = {"stats": ptq.capture_stats(params, batches, cfg, float_plan,
                                      precision=golden)}
    meshes = {t: make_serving_mesh(t) for t in TOPOLOGIES}
    for t, mesh in meshes.items():
        out[f"stats {t}"] = ptq.capture_stats(
            params, batches, cfg, float_plan, precision=golden, mesh=mesh)
    qparams, qplan = ptq.apply_plan(params, cfg, golden, out["stats"],
                                    float_plan=float_plan)

    def head(p, h):
        return T.apply_head(h, p, "cls")
    inputs, lengths = job["inputs"], job["lengths"]
    for backend in ("reference", "fused"):
        rt0 = Runtime(cfg, qplan, precision=golden, head=head,
                      backend=backend, device="cpu")
        out[f"{backend} unmeshed"] = rt0.encode(qparams, inputs, lengths)
        for t, mesh in meshes.items():
            rt = rt0.share(qplan, precision=golden, mesh=mesh)
            out[f"{backend} {t}"] = rt.encode(qparams, inputs, lengths)
            out[f"identity {t}"] = rt.identity
        s = rt0.stats
        out[f"{backend} cache"] = (s["traces"], s["executables"])
        # the DP rows against an unmeshed encode of this rank's rows at the
        # bucket the rank ran (Bb / dp rows)
        B = len(lengths)
        rt_dp = rt0.share(qplan, precision=golden, mesh=meshes["2,1"])
        Bb = -(-B // 2) * 2
        lo, hi = rt_dp.rows(Bb)
        own = Runtime(cfg, qplan, precision=golden, head=head,
                      backend=backend, device="cpu", min_batch=hi - lo)
        out[f"{backend} rank rows"] = (lo, min(hi, B))
        out[f"{backend} rank rows unmeshed"] = own.encode(
            qparams, {k: v[lo:min(hi, B)] for k, v in inputs.items()},
            lengths[lo:min(hi, B)])
    # dynamic attention scales: one amax over every rank's rows and heads
    dyn = _dynamic_plan(cfg.num_layers)
    stats = ptq.capture_stats(params, batches, cfg, float_plan,
                              precision=dyn)
    dparams, dplan = ptq.apply_plan(params, cfg, dyn, stats,
                                    float_plan=float_plan)
    rt0 = Runtime(cfg, dplan, precision=dyn, head=head, backend="fused",
                  device="cpu")
    out["dynamic unmeshed"] = rt0.encode(dparams, inputs, lengths)
    for t, mesh in meshes.items():
        out[f"dynamic {t}"] = rt0.share(dplan, precision=dyn,
                                        mesh=mesh).encode(dparams, inputs,
                                                          lengths)
    server = EncoderServeEngine(cfg, qparams, qplan, target="cls",
                                mesh=meshes["2,1"], max_batch=4,
                                device="cpu")
    for i in range(B):
        server.submit(EncoderRequest(
            uid=i, tokens=[int(x) for x in inputs["tokens"][i, :lengths[i]]]))
    out["engine predictions"] = {r.uid: int(r.prediction)
                                 for r in server.run()}
    # every leaf the rules shard is held sharded
    out["sharded leaf"] = tuple(
        server.params["layers"][0]["attn"]["wq"]["w"].values.shape)
    return out


def _qwen(job: dict) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.core.plan import PrecisionPlan
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.models import transformer as T
    from repro_torch.quant import ptq
    from repro_torch.serve import Request, ServeEngine

    cfg = get_config("qwen2-0.5b").reduced()
    golden = PrecisionPlan.load(GOLDEN)
    fp = PrecisionPlan.full_float(cfg.num_layers, "float32")
    float_plan = T.build_plan(cfg, fp)
    params = T.init_params(cfg, fp, seed=0, device="cpu")
    stats = ptq.capture_stats(params, job["batches"], cfg, float_plan,
                              precision=golden)
    qparams, qplan = ptq.apply_plan(params, cfg, golden, stats,
                                    float_plan=float_plan)
    meshes = {"unmeshed": None}
    meshes.update({t: make_serving_mesh(t) for t in TOPOLOGIES})
    out = {}
    for cache in ("dense", "int8 pages"):
        kw = ({} if cache == "dense"
              else {"page_size": 4, "kv_cache": "int8_per_token"})
        for t, mesh in meshes.items():
            eng = ServeEngine(cfg, qparams, qplan, batch_slots=4, max_len=32,
                              precision=golden, backend="fused",
                              device="cpu", mesh=mesh, **kw)
            for i, prompt in enumerate(job["prompts"]):
                eng.submit(Request(uid=i, prompt=list(prompt),
                                   max_tokens=job["max_tokens"]))
            done = eng.run()
            out[f"{cache} {t}"] = {r.uid: r.output for r in done}
            out[f"{cache} {t} pages"] = eng.kv_pages_in_use
            out[f"{cache} {t} slots"] = T.cache_slots(eng.caches)
    dyn = _dynamic_plan(cfg.num_layers)
    stats = ptq.capture_stats(params, job["batches"], cfg, float_plan,
                              precision=dyn)
    dparams, dplan = ptq.apply_plan(params, cfg, dyn, stats,
                                    float_plan=float_plan)
    for t, mesh in meshes.items():
        eng = ServeEngine(cfg, dparams, dplan, batch_slots=4, max_len=32,
                          precision=dyn, backend="fused", device="cpu",
                          mesh=mesh, page_size=4, kv_cache="int8_per_token")
        for i, prompt in enumerate(job["prompts"]):
            eng.submit(Request(uid=i, prompt=list(prompt),
                               max_tokens=job["max_tokens"]))
        out[f"dynamic {t}"] = {r.uid: r.output for r in eng.run()}
        if t == "1,2":
            out["kv heads 1,2"] = tuple(eng.caches[0]["pages_k"].shape)
    return out


def _archs(job: dict) -> dict:
    """The other dense decoders on a mesh, their float trees unquantized:
    gemma2-2b (local rings beside paged global layers, softcaps, a tied
    vocab-parallel table scaled by sqrt(d)) and granite-20b (MQA: its one
    KV head cannot split, so attention runs on all heads after an
    all-gather; an untied vocab-parallel ``lm_head``)."""
    from repro_torch.configs import get_config
    from repro_torch.core.plan import PrecisionPlan
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.models import transformer as T
    from repro_torch.serve import Request, ServeEngine

    out = {}
    meshes = {"unmeshed": None}
    meshes.update({t: make_serving_mesh(t) for t in TOPOLOGIES})
    for arch in ("gemma2-2b", "granite-20b"):
        cfg = get_config(arch).reduced()
        fp = PrecisionPlan.full_float(cfg.num_layers, "float32")
        params = T.init_params(cfg, fp, seed=0, device="cpu")
        plan = T.build_plan(cfg, fp)
        for t, mesh in meshes.items():
            eng = ServeEngine(cfg, params, plan, batch_slots=2, max_len=16,
                              page_size=4, device="cpu", mesh=mesh)
            for i, prompt in enumerate(job["prompts"][:2]):
                eng.submit(Request(uid=i, prompt=list(prompt)[:5],
                                   max_tokens=4))
            out[f"{arch} {t}"] = {r.uid: r.output for r in eng.run()}
    return out


def run(rank: int, device, job: dict) -> dict:
    """Serve ``job``'s models on this rank; returns what the test
    checks."""
    out = {"rank": rank, "backend": torch.distributed.get_backend()}
    out["bert"] = _bert(job["bert"])
    out["qwen"] = _qwen(job["qwen"])
    out["archs"] = _archs(job["qwen"])
    out["jax modules"] = _jax_loaded()
    return out


# ---------------------------------------------------------------------------
# the MoE, MLA, recurrent and front-end archs
# ---------------------------------------------------------------------------

MOE_ARCHS = ("mixtral-8x22b", "deepseek-v2-236b")
TP_ARCHS = ("deepseek-v2-236b", "hubert-xlarge", "paligemma-3b",
            "recurrentgemma-9b", "xlstm-125m")


def _float(cfg):
    from repro_torch.core.plan import PrecisionPlan
    from repro_torch.models import transformer as T
    fp = PrecisionPlan.full_float(cfg.num_layers, "float32")
    return fp, T.build_plan(cfg, fp), T.init_params(cfg, fp, seed=0,
                                                     device="cpu")


def _ffn_plan(cfg, dynamic_acts=False):
    """Every FFN block int8 (static scales), and on an MoE config the
    experts family, static or per token."""
    from repro_torch.core.plan import plan_from_policy
    from repro_torch.core.precision import make_policy
    from repro_torch.core.samp import moe_family_variant
    plan = plan_from_policy(make_policy(cfg, "ffn", float_dtype="float32"))
    if cfg.moe is not None:
        plan = moe_family_variant(plan, dynamic_acts=dynamic_acts)
    return plan


def _int8_plan(cfg):
    """Every GEMM int8 at per-token scales (the attention's batched
    matmuls too) and per-token expert stacks: no float sum that tensor
    parallelism splits feeds an int8 code."""
    from repro_torch.core.samp import moe_family_variant
    return moe_family_variant(_dynamic_plan(cfg.num_layers),
                              dynamic_acts=True)


def _serve_tokens(cfg, tree, plan, precision, mesh, prompts, *,
                  runtime=None, **kw):
    """Decode ``prompts`` on 4 slots: (tokens by uid, pages in use after,
    slots this rank holds)."""
    from repro_torch.models import transformer as T
    from repro_torch.serve import Request, ServeEngine
    eng = ServeEngine(cfg, tree, plan, batch_slots=4, max_len=24,
                      precision=precision, backend="fused", device="cpu",
                      mesh=mesh, runtime=runtime, **kw)
    for i, prompt in enumerate(prompts):
        eng.submit(Request(uid=i, prompt=list(prompt), max_tokens=5))
    out = {r.uid: r.output for r in eng.run()}
    return out, eng.kv_pages_in_use, T.cache_slots(eng.caches)


def _moe(job: dict) -> dict:
    """mixtral-8x22b (golden v4: static per-expert scales, then per-token
    ones) and deepseek-v2-236b (every FFN int8 with static, then per-token
    experts; float), and both under an all-int8 plan, at both topologies:
    calibration, encode and decode."""
    from repro_torch.configs import get_config
    from repro_torch.core.plan import PrecisionPlan
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.quant import ptq
    from repro_torch.serve import Runtime

    meshes = {t: make_serving_mesh(t) for t in TOPOLOGIES}
    out = {}
    for arch in MOE_ARCHS:
        cfg = get_config(arch).reduced()
        _, float_plan, params = _float(cfg)
        a = job[arch]
        plans = ({"golden_v4": PrecisionPlan.load(a["golden_v4"])}
                 if arch == "mixtral-8x22b" else
                 {"static": _ffn_plan(cfg),
                  "per_token": _ffn_plan(cfg, dynamic_acts=True),
                  "float": None})
        plans["int8"] = _int8_plan(cfg)
        kw = {"page_size": 4} if cfg.mla is not None else {}
        for name, plan in plans.items():
            key = f"{arch} {name}"
            if plan is None:
                tree, eplan = params, float_plan
            else:
                stats = ptq.capture_stats(params, a["batches"], cfg,
                                          float_plan, precision=plan)
                out[f"{key} stats"] = stats
                for t, mesh in meshes.items():
                    out[f"{key} stats {t}"] = ptq.capture_stats(
                        params, a["batches"], cfg, float_plan,
                        precision=plan, mesh=mesh)
                tree, eplan = ptq.apply_plan(params, cfg, plan, stats,
                                             float_plan=float_plan)
            rt = Runtime(cfg, eplan, precision=plan, backend="fused",
                         device="cpu")
            grouped = Runtime(cfg, eplan, precision=plan, backend="fused",
                              device="cpu", moe_groups=2)
            runs = {"unmeshed": (None, rt), "grouped": (None, grouped)}
            runs.update({t: (m, rt.share(eplan, precision=plan, mesh=m))
                         for t, m in meshes.items()})
            for t, (mesh, r) in runs.items():
                for shape, inputs in a["encodes"].items():
                    out[f"{key} {shape} {t}"] = r.encode(tree, inputs)
                out[f"{key} decode {t}"] = _serve_tokens(
                    cfg, tree, eplan, plan, mesh, a["prompts"],
                    runtime=None if mesh is not None or t == "unmeshed"
                    else Runtime(cfg, eplan, precision=plan,
                                 backend="fused", device="cpu",
                                 moe_groups=2), **kw)
            out[f"{key} experts held 2,1"] = tuple(
                runs["2,1"][1].local_params(tree)["layers"][1]["ffn"]["wg"]
                ["w"].shape)
    return out


def _tp_archs(job: dict) -> dict:
    """deepseek-v2's MLA, hubert's audio front-end, paligemma's vision
    prefix, recurrentgemma's RG-LRU and xlstm's mLSTM and sLSTM at
    (data=1, model=2) against unmeshed, float and under the all-int8 plan
    (hubert also under the int8 span, its attention kernel on the rank's
    heads): calibration, encode and decode."""
    from repro_torch.configs import get_config
    from repro_torch.core.plan import PrecisionPlan
    from repro_torch.core.samp import int8_dataflow_variant
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.quant import ptq
    from repro_torch.serve import Runtime

    mesh = make_serving_mesh("1,2")
    out = {}
    for arch in TP_ARCHS:
        cfg = get_config(arch).reduced()
        _, float_plan, params = _float(cfg)
        a = job[arch]
        plans = {"float": None, "int8": _int8_plan(cfg)}
        if arch == "hubert-xlarge":
            plans["span"] = int8_dataflow_variant(PrecisionPlan.load(GOLDEN))
        kw = {"page_size": 4} if arch != "xlstm-125m" else {}
        for name, plan in plans.items():
            if plan is None:
                tree, eplan = params, float_plan
            else:
                stats = ptq.capture_stats(params, a["batches"], cfg,
                                          float_plan, precision=plan)
                out[f"{arch} {name} stats"] = stats == ptq.capture_stats(
                    params, a["batches"], cfg, float_plan, precision=plan,
                    mesh=mesh)
                tree, eplan = ptq.apply_plan(params, cfg, plan, stats,
                                             float_plan=float_plan)
            for t, m in (("unmeshed", None), ("1,2", mesh)):
                rt = Runtime(cfg, eplan, precision=plan, backend="fused",
                             device="cpu", mesh=m)
                out[f"{arch} {name} encode {t}"] = rt.encode(tree,
                                                             a["inputs"])
                if cfg.supports_decode:
                    out[f"{arch} {name} decode {t}"] = _serve_tokens(
                        cfg, tree, eplan, plan, m, a["prompts"], **kw)
        out[f"{arch} local"] = _local_shapes(
            cfg, Runtime(cfg, float_plan, device="cpu",
                         mesh=mesh).local_params(params))
    return out


def _local_shapes(cfg, tree) -> dict:
    """A few leaves of a rank's block whose split the tests pin."""
    lay = tree["layers"]
    if cfg.mla is not None:
        return {"wkv_b": tuple(lay[0]["attn"]["wkv_b"]["w"].shape)}
    if cfg.frontend is not None:
        return {"frontend_proj": tuple(
            tree["embed"]["frontend_proj"]["w"].shape)}
    body = lay[0]["rec"] if "rec" in lay[0] else lay[0]["blk"]
    return {k: tuple(v["w"].shape) for k, v in body.items()
            if isinstance(v, dict) and "w" in v and k != "conv"}


def run_moe(rank: int, device, job: dict) -> dict:
    """Serve ``job``'s MoE archs on this rank; returns what the test
    checks."""
    return {"rank": rank, "moe": _moe(job), "jax modules": _jax_loaded()}


def run_tp_archs(rank: int, device, job: dict) -> dict:
    """Serve ``job``'s MLA, recurrent and front-end archs on this rank at
    (data=1, model=2)."""
    return {"rank": rank, "archs": _tp_archs(job),
            "jax modules": _jax_loaded()}
