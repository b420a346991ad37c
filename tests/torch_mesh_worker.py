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


# ---------------------------------------------------------------------------
# training on a mesh (tests/test_torch_train_mesh.py)
# ---------------------------------------------------------------------------


def train_batch(cfg, B: int, S: int, seed: int) -> dict:
    """A numpy batch the loss of ``cfg`` takes: tokens (+ vision prefix
    embeddings), or audio frames with frame labels."""
    import numpy as np
    rng = np.random.default_rng(seed)
    if cfg.frontend == "audio":
        return {"frames": rng.standard_normal(
                    (B, S, cfg.frontend_dim)).astype(np.float32),
                "labels": rng.integers(0, cfg.vocab_size, (B, S))}
    b = {"tokens": rng.integers(1, cfg.vocab_size, (B, S))}
    if cfg.frontend == "vision":
        b["prefix_embeds"] = rng.standard_normal(
            (B, cfg.num_prefix_embeds, cfg.frontend_dim)).astype(np.float32)
    return b


def _numpy_tree(tree) -> dict:
    from repro_torch.interop import flatten_names
    return {n: t.detach().cpu().numpy() for n, t in flatten_names(tree)}


def _trainer(cfg, mesh=None, **kw):
    from repro_torch.core.plan import PrecisionPlan
    from repro_torch.train import AdamW, TrainConfig, Trainer
    tk = dict(remat=False, compute_dtype="float32", log_every=1)
    tk.update(kw.pop("tcfg", {}))
    return Trainer(cfg, PrecisionPlan.full_float(cfg.num_layers, "float32"),
                   mesh=mesh, optimizer=AdamW(lr=kw.pop("lr", 1e-3)),
                   tcfg=TrainConfig(**tk), device="cpu", **kw)


def _autograd_cases(mesh_dp, mesh_tp) -> dict:
    """Each differentiable collective's forward and backward on this rank:
    seeded x and upstream gradient y (the same on both ranks where the
    collective takes, or gives, a tensor every rank holds whole), the
    output and x's gradient."""
    import torch
    from repro_torch.distributed import autograd as ag
    rank = mesh_tp.rank
    # name: (mesh, f, x replicated, y replicated)
    cases = {"copy_to": (mesh_tp, lambda x, m: ag.copy_to(x, m, "model"),
                         True, False),
             "reduce_from": (mesh_tp,
                             lambda x, m: ag.reduce_from(x, m, "model"),
                             False, True),
             "gather": (mesh_tp, lambda x, m: ag.gather(x, m, "model", -1),
                        False, True),
             "all_to_all": (mesh_dp,
                            lambda x, m: ag.all_to_all(x, m, "data"),
                            False, False),
             "fsdp_gather": (mesh_dp,
                             lambda x, m: ag.fsdp_gather(x, m, "data", 0),
                             False, False)}
    out = {}
    for name, (mesh, f, x_rep, y_rep) in cases.items():
        gx = torch.Generator().manual_seed(17 + (0 if x_rep else rank))
        gy = torch.Generator().manual_seed(29 + (0 if y_rep else rank))
        x = torch.randn((4, 6), generator=gx, requires_grad=True)
        with torch.enable_grad():
            y_out = f(x, mesh)
        y = torch.randn(y_out.shape, generator=gy)
        (grad,) = torch.autograd.grad(y_out, x, y)
        out[name] = {k: v.detach().numpy() for k, v in
                     (("x", x), ("y", y), ("out", y_out), ("grad", grad))}
    return out


def _arch_grads(job, meshes) -> dict:
    """One step's loss and gathered gradients of every reduced config on
    each topology, beside the unmeshed port's (rank 0): at the mesh's MoE
    token groups, and at ``grad_accum = dp`` (one micro-batch a rank's
    rows, one group each)."""
    import torch
    from repro_torch.configs import get_config
    out = {}
    for arch in job["archs"]:
        cfg = get_config(arch).reduced()
        batch = train_batch(cfg, *job["batch"], seed=0)
        for t, mesh in meshes.items():
            dp = mesh.size("data")
            tr = _trainer(cfg, mesh)
            state = tr.init_state(0)
            loss, grads = tr.loss_and_grads(state.params, batch)
            whole = tr.layout.whole(grads)
            rec = {"loss": float(loss),
                   "norm": float(tr.layout.global_norm(grads))}
            if mesh.rank == 0:
                from repro_torch.train.optimizer import global_norm
                rec["grads"] = _numpy_tree(whole)
                rec["whole norm"] = float(global_norm(whole))
                ref = _trainer(cfg, moe_groups=dp if cfg.moe else 1)
                p = ref.init_state(0).params
                rl, rg = ref.loss_and_grads(p, batch)
                rec["unmeshed"] = (float(rl), _numpy_tree(rg))
                if dp > 1:
                    acc = _trainer(cfg, tcfg={"grad_accum": dp})
                    al, ag_ = acc.loss_and_grads(p, batch)
                    rec["accum"] = (float(al), _numpy_tree(ag_))
            out[f"{arch} {t}"] = rec
            torch.distributed.barrier()
    return out


def _jax_steps(job, meshes) -> dict:
    """``steps`` meshed steps from the JAX package's initial params (carried
    in as numpy) on each topology: losses, grad norms, gathered params."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import get_batch, make_task
    from repro_torch.interop import params_from_numpy
    from repro_torch.train import TrainState
    out = {}
    for name, spec in job["jax"].items():
        cfg = get_config(spec["arch"]).reduced()
        task = make_task(spec["task"], vocab_size=cfg.vocab_size, seq_len=16)
        for t, mesh in meshes.items():
            tr = _trainer(cfg, mesh, head=spec["head"],
                          tcfg={"remat": spec["remat"]})
            params = params_from_numpy(spec["params"], tr.plan, "cpu")
            state = tr.shard(TrainState(params, tr.optimizer.init(params)))
            step = tr.make_step()
            losses, norms = [], []
            for i in range(spec["steps"]):
                p, o, e, m = step(state.params, state.opt_state,
                                  state.err_state, get_batch(task, i, 8))
                state = TrainState(p, o, e, tr.layout)
                losses.append(float(m["loss"]))
                norms.append(float(m["grad_norm"]))
            tree = state.as_tree(tr.plan)
            out[f"{name} {t}"] = {"losses": losses, "norms": norms,
                                  "params": tree["params"],
                                  "step": int(tree["opt"]["step"])}
    return out


def _zero3(meshes) -> dict:
    """qwen2's bytes a rank holds at (data=2, model=1): params, moments,
    error state, and each leaf's local and whole shapes."""
    from repro_torch.configs import get_config
    from repro_torch.interop import flatten_names
    cfg = get_config("qwen2-0.5b").reduced()
    tr = _trainer(cfg, meshes["2,1"], tcfg={"compress_pod_grads": True})
    s = tr.init_state(0)

    def nbytes(tree):
        return sum(t.numel() * t.element_size()
                   for _, t in flatten_names(tree))
    whole = _trainer(cfg).init_state(0).params
    return {"params": nbytes(s.params), "mu": nbytes(s.opt_state.mu),
            "nu": nbytes(s.opt_state.nu), "err": nbytes(s.err_state),
            "local": {n: tuple(t.shape) for n, t in flatten_names(s.params)},
            "whole": {n: tuple(t.shape) for n, t in flatten_names(whole)},
            "fsdp": {n: d for n, d in tr.layout.fsdp_dim.items()}}


def _pod(job) -> dict:
    """The int8 pod all-reduce on (pod=2, data=1, model=1): the job's
    tensors (the same on both ranks) through ``compress_allreduce`` and the
    pytree form; then a compressed training step of qwen2 against the
    unmeshed port at ``grad_accum = 2``."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.distributed import compression
    from repro_torch.launch.mesh import ProcessMesh
    mesh = ProcessMesh({"pod": 2, "data": 1, "model": 1})
    out = {}
    for key, (g, err) in job["pod"].items():
        r, e = compression.compress_allreduce(
            torch.from_numpy(g), torch.from_numpy(err), mesh=mesh)
        out[key] = (r.numpy(), e.numpy())
    cfg = get_config("qwen2-0.5b").reduced()
    batch = train_batch(cfg, *job["batch"], seed=1)
    tr = _trainer(cfg, mesh, tcfg={"compress_pod_grads": True})
    s = tr.init_state(0)
    loss, grads = tr.loss_and_grads(s.params, batch)
    p, o, e, m = tr.make_step()(s.params, s.opt_state, s.err_state, batch)
    out["step"] = {"loss": float(m["loss"]), "grads": _numpy_tree(grads),
                   "err": _numpy_tree(e), "params": _numpy_tree(p)}
    acc = _trainer(cfg, tcfg={"grad_accum": 2, "compress_pod_grads": True})
    a = acc.init_state(0)
    al, ag_ = acc.loss_and_grads(a.params, batch)
    # the unmeshed update of the plain version's q * scale
    q, err = compression.compress_allreduce_pytree(ag_, a.err_state)
    p2, _ = acc.optimizer.update(q, a.opt_state, a.params)
    out["unmeshed"] = {"loss": float(al), "grads": _numpy_tree(ag_),
                       "err": _numpy_tree(err), "params": _numpy_tree(p2)}
    return out


def _checkpoints(job, meshes) -> dict:
    """Checkpoints across topologies, in the job's directories: a run at
    (2, 1) checkpoints at 2 steps; (1, 2) resumes it to 3; (1, 2) resumes
    the JAX package's checkpoint to 3. Each restore, gathered, and the
    logs."""
    import torch
    from repro_torch.checkpoint import store
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import get_batch, make_task
    from repro_torch.train import TrainState
    cfg = get_config("qwen2-0.5b").reduced()
    task = make_task("lm", vocab_size=cfg.vocab_size, seq_len=16)

    def batches(i):
        return get_batch(task, i, 8)
    out = {}
    ck = job["ckpt"]
    tr = _trainer(cfg, meshes["2,1"], tcfg={
        "steps": 2, "checkpoint_dir": ck["mesh"], "checkpoint_every": 2})
    logs = []
    s = tr.fit(tr.init_state(0), batches, log=logs.append)
    out["written"] = s.as_tree(tr.plan)
    out["write logs"] = logs
    for key, src in (("mesh to mesh", ck["mesh"]), ("jax to mesh",
                                                    ck["jax"])):
        tr = _trainer(cfg, meshes["1,2"], tcfg={
            "steps": 3, "checkpoint_dir": src, "checkpoint_every": 100})
        fresh = tr.init_state(1)
        back = TrainState.from_tree(
            store.restore(src, 2, fresh.as_tree(tr.plan)), tr.plan, "cpu",
            layout=tr.layout)
        logs = []
        end = tr.fit(fresh, batches, log=logs.append)
        out[key] = {"restored": back.as_tree(tr.plan), "logs": logs,
                    "step": int(end.opt_state.step)}
        torch.distributed.barrier()
    return out


def run_train_mesh(rank: int, device, job: dict) -> dict:
    """Train on this rank: every job of ``tests/test_torch_train_mesh.py``
    on 2 gloo ranks."""
    from repro_torch.distributed import comm
    from repro_torch.launch.mesh import make_serving_mesh
    meshes = {t: make_serving_mesh(t) for t in TOPOLOGIES}
    comm.reset_stats()
    out = {"rank": rank,
           "autograd": _autograd_cases(meshes["2,1"], meshes["1,2"]),
           "archs": _arch_grads(job, meshes),
           "jax": _jax_steps(job, meshes),
           "zero3": _zero3(meshes),
           "pod": _pod(job),
           "ckpt": _checkpoints(job, meshes),
           "stats": dict(comm.STATS)}
    out["jax modules"] = _jax_loaded()
    return out
