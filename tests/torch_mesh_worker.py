"""The rank side of ``tests/test_torch_mesh.py`` (this module holds no
tests). Each rank that ``repro_torch.distributed.comm.spawn`` starts imports
this module, which imports torch and the port only: never JAX, nothing of
``repro``. :func:`run` rebuilds the reduced models from the numpy inputs
the test hands it and serves them unmeshed and on the two 2-rank
topologies, (data=2, model=1) and (data=1, model=2); the test asserts on
what every rank returns.
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
