"""Port parity for the rules of multi-GPU serving
(``repro_torch.distributed.sharding``, ``repro_torch.launch.mesh`` and
``repro_torch.launch.shapes``) against
``repro``'s, on the CPU with no process group: every parameter spec of every
arch under the float and the ``ffn`` policy on JAX's own shapes and on fake
meshes of (16, 16), (4, 4), (2, 1) and (1, 2), training and serving rules;
the batch and cache specs and ``dp_size``; the port's own trees named
through ``interop``; the slicing of a quantized tree to a rank's block; and
four tests of ``tests/test_mesh_serving.py`` ported (the fingerprint, the
cache key, the dp bucket and the sub-tile decline, which the port does
not share: its kernels take a rank's block at any width)."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.configs import get_config as jax_get_config
from repro.core.precision import make_policy as jax_make_policy
from repro.distributed import sharding as JS
from repro.launch import shapes as JSH
from repro.core.precision import EncoderPolicy as JEncoderPolicy
from repro.launch.dryrun import abstract_stats, quantized_param_specs
from repro.models import transformer as JT
from repro.quant import ptq as jptq

from repro_torch.configs import get_config
from repro_torch.core.plan import PrecisionPlan
from repro_torch.core.precision import make_policy
from repro_torch.core.quantize import QuantizedTensor
from repro_torch.distributed import sharding as S
from repro_torch.interop import flatten_names, params_to_numpy
from repro_torch.kernels.backend import get_backend
from repro_torch.launch import mesh as M
from repro_torch.launch import shapes as SH
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.serve import Runtime
from repro_torch.serve.runtime import bucket_size

from test_torch_support import GOLDEN


class FakeMesh:
    """Enough of a mesh for specs, keys and slicing (no ranks)."""

    def __init__(self, shape, coords=None):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)
        self.coords = coords or {a: 0 for a in shape}
        self.rank = 0


MESHES = ({"data": 16, "model": 16}, {"data": 4, "model": 4},
          {"data": 2, "model": 1}, {"data": 1, "model": 2})


def _norm(spec) -> tuple:
    """A spec as a plain tuple of axis names, axis tuples and None; a
    one-axis tuple as its axis (JAX's PartitionSpec holds ``("data",)`` as
    ``"data"``, and compares them equal)."""
    return tuple((e[0] if len(e) == 1 else tuple(e))
                 if isinstance(e, (tuple, list)) else e for e in spec)


@functools.lru_cache(maxsize=None)
def _jax_trees(arch: str) -> dict:
    """JAX's abstract param trees of ``arch``: the float init and the
    ``ffn`` policy's quantized tree, as (path, shape) leaves. One
    ``eval_shape`` traces both: ``quantized_param_specs``'s own build,
    returning the float tree it quantizes beside it."""
    cfg = jax_get_config(arch)

    def build():
        params = JT.init_params(jax.random.PRNGKey(0), cfg,
                                JEncoderPolicy.full_float(cfg.num_layers),
                                dtype=jnp.bfloat16)
        qp, _ = jptq.apply_policy(params, cfg, jax_make_policy(cfg, "ffn"),
                                  abstract_stats(cfg))
        return {"float": params, "ffn": qp}
    out = {}
    for policy, tree in jax.eval_shape(build).items():
        flat, _ = jax.tree_util.tree_flatten_with_path(tree)
        out[policy] = [(JS._path_str(kp), tuple(leaf.shape))
                       for kp, leaf in flat]
    return out


# ---------------------------------------------------------------------------
# the rule table
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("policy", ["float", "ffn"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_jax(arch, policy):
    """Every leaf of the arch's abstract tree gets JAX's spec, on every
    fake mesh, under the training (FSDP) and the serving rules."""
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    leaves = _jax_trees(arch)[policy]
    sharded = 0
    for shape in MESHES:
        for fsdp in (True, False):
            jr = JS.Rules(jcfg, FakeMesh(shape), fsdp=fsdp)
            pr = S.Rules(cfg, FakeMesh(shape), fsdp=fsdp)
            for path, leaf_shape in leaves:
                want = _norm(jr.spec_for(path, leaf_shape))
                got = _norm(pr.spec_for(path, leaf_shape))
                assert got == want, (path, leaf_shape, shape, fsdp)
                sharded += any(e is not None for e in got)
    assert sharded > 0


def test_quantized_scales_shard_with_their_weights():
    """Every per-channel scale leaf of JAX's quantized qwen2 tree
    (``quantized_param_specs``) carries the port's spec of its weight's
    values on the same dims; broadcast (size-1) dims replicate."""
    cfg = jax_get_config("qwen2-0.5b")
    rules = S.Rules(get_config("qwen2-0.5b"),
                    FakeMesh({"data": 4, "model": 4}), fsdp=False)
    flat, _ = jax.tree_util.tree_flatten_with_path(
        quantized_param_specs(cfg, jax_make_policy(cfg, "full")))
    shapes = {JS._path_str(kp): tuple(leaf.shape) for kp, leaf in flat}
    checked = 0
    for path, shape in shapes.items():
        spath = path[: -len("/values")] + "/scale"
        if not path.endswith("/values") or spath not in shapes:
            continue
        w_spec = _norm(rules.spec_for(path, shape))
        s_shape = shapes[spath]
        s_spec = _norm(rules.spec_for(spath, s_shape))
        for d, (ws, ss) in enumerate(zip(w_spec, s_spec)):
            assert ss == (None if s_shape[d] == 1 else ws), (path, d)
        checked += 1
    assert checked > 0


@pytest.mark.parametrize("shape", MESHES)
def test_dp_size_and_batch_specs_match_jax(shape):
    for arch in ("bert-base", "qwen2-0.5b", "hubert-xlarge", "paligemma-3b"):
        jcfg, cfg = jax_get_config(arch), get_config(arch)
        jr = JS.Rules(jcfg, FakeMesh(shape), fsdp=False)
        pr = S.Rules(cfg, FakeMesh(shape), fsdp=False)
        assert pr.dp_size == jr.dp_size
        for name, cell in JSH.SHAPES.items():
            if not JSH.cell_supported(jcfg, name)[0]:
                continue
            for B in (cell.global_batch, 6, 1):
                cell_b = dataclasses.replace(cell, global_batch=B,
                                             seq_len=min(cell.seq_len, 512))
                batch = JSH.batch_specs(jcfg, cell_b)
                want = jr.batch_spec(batch)
                got = pr.batch_spec(batch)
                assert {k: _norm(v) for k, v in got.items()} == \
                    {k: _norm(v) for k, v in want.items()}, (arch, name, B)


def test_batch_spec_and_dp_size():
    """Port of the JAX test: a 4-way dp mesh shards divisible batches."""
    rules = S.Rules(get_config("bert-base").reduced(),
                    FakeMesh({"data": 4, "model": 2}), fsdp=False)
    assert rules.dp_size == 4
    spec = rules.batch_spec({"tokens": torch.empty((8, 16), device="meta"),
                             "lengths": torch.empty((8,), device="meta")})
    assert spec["tokens"] == S.P(("data",), None)
    assert spec["lengths"] == S.P(("data",))
    ragged = rules.batch_spec({"tokens": torch.empty((6, 16),
                                                     device="meta")})
    assert ragged["tokens"] == S.P(None)


CACHE_ARCHS = ("qwen2-0.5b", "gemma2-2b", "granite-20b", "mixtral-8x22b",
               "deepseek-v2-236b", "recurrentgemma-9b", "xlstm-125m")


@pytest.mark.parametrize("arch", CACHE_ARCHS)
def test_cache_specs_match_jax(arch):
    """JAX's cache trees (dense rings, paged pools, latent caches,
    recurrent states) get JAX's specs; the port's own cache list (one dict
    a layer, no stack dim) gets them without the stack dim."""
    jcfg, cfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    jplan = JT.build_plan(jcfg, jax_make_policy(jcfg, "float"))
    plan = T.build_plan(cfg, make_policy(cfg, "float"))
    for paged in (None, 4):
        jtree = jax.eval_shape(lambda: JT.init_caches(
            jcfg, jplan, 8, 32, page_size=paged))
        flat, _ = jax.tree_util.tree_flatten_with_path(jtree)
        port = T.init_caches(cfg, plan, 8, 32, page_size=paged,
                             device="meta")
        for shape in MESHES:
            jr = JS.Rules(jcfg, FakeMesh(shape), fsdp=False)
            pr = S.Rules(cfg, FakeMesh(shape), fsdp=False)
            want = {JS._path_str(kp): _norm(s) for kp, s in zip(
                (kp for kp, _ in flat),
                jax.tree_util.tree_leaves(
                    jr.cache_spec(jtree),
                    is_leaf=lambda x: isinstance(
                        x, jax.sharding.PartitionSpec)))}
            got = {k: _norm(v) for k, v in pr.cache_spec(jtree).items()}
            assert got == want, (arch, paged, shape)
            # the port's layer i is step s of group g's kind j
            own = pr.cache_spec(port)
            i = 0
            for g, grp in enumerate(plan):
                for s in range(grp.steps):
                    for j in range(len(grp.kinds)):
                        for key in port[i]:
                            assert _norm(own[f"{i}/0/{key}"]) == \
                                want[f"{g}/{j}/{key}"][1:], (arch, i, key)
                        i += 1


@pytest.mark.parametrize("arch", ["bert-base", "qwen2-0.5b", "gemma2-2b",
                                  "mixtral-8x22b"])
def test_port_tree_specs_match_jax_through_interop(arch):
    """The port's own quantized tree, named by ``interop``'s JAX layout,
    gets JAX's specs (without the stack dim for its per-layer list)."""
    cfg, jcfg = get_config(arch).reduced(), jax_get_config(arch).reduced()
    fp = PrecisionPlan.full_float(cfg.num_layers, "float32")
    params = T.init_params(cfg, fp, seed=0, device="cpu")
    policy = make_policy(cfg, "ffn")
    from repro_torch.core.plan import plan_from_policy
    from repro_torch.quant import ptq
    precision = plan_from_policy(policy)
    stats = {f"layer{i}": {s: 1.0 for s in (
        "attn_in", "attn_out", "q", "k", "p", "v", "ffn_in", "ffn_hidden",
        "ffn_in_e", "shared_ffn_in", "shared_ffn_hidden")}
        for i in range(cfg.num_layers)}
    qparams, qplan = ptq.apply_plan(params, cfg, precision, stats,
                                    float_plan=T.build_plan(cfg, fp))
    names = dict(flatten_names(params_to_numpy(qparams, qplan)))
    where = {}
    i = 0
    for g, grp in enumerate(qplan):
        for s in range(grp.steps):
            for j in range(len(grp.kinds)):
                where[i] = (g, s, j)
                i += 1
    for shape in MESHES:
        jr = JS.Rules(jcfg, FakeMesh(shape), fsdp=False)
        pr = S.Rules(cfg, FakeMesh(shape), fsdp=False)
        own = pr.params_spec(qparams)
        seen = set()
        for name, spec in own.items():
            if name.startswith("layers/"):
                _, i, sub = name.split("/", 2)
                g, s, j = where[int(i)]
                jname = f"groups/{g}/layers/{j}/{sub}"
                want = _norm(jr.spec_for(jname, names[jname].shape))[1:]
            else:
                jname = name
                want = _norm(jr.spec_for(name, names[name].shape))
            seen.add(jname)
            assert _norm(spec) == want, (arch, name, shape)
        assert seen == set(names)


# ---------------------------------------------------------------------------
# a rank's block
# ---------------------------------------------------------------------------


def test_shard_params_slices_values_scales_and_biases():
    """On a (1, 2) mesh each rank's block of a quantized BERT tree holds
    its columns of the column-parallel weights (values and per-channel
    scales alike), its rows of the row-parallel ones, its slice of every
    bias and table the rules shard, and the global per-tensor scales; the
    blocks of the two ranks put back together are the tree."""
    cfg = get_config("bert-base").reduced()
    fp = PrecisionPlan.full_float(cfg.num_layers, "float32")
    params = T.init_params(cfg, fp, seed=0, head=("cls", 5), device="cpu")
    from repro_torch.quant import ptq
    precision = PrecisionPlan.load(GOLDEN)
    stats = {f"layer{i}": {s: 1.0 for s in (
        "attn_in", "attn_out", "q", "k", "p", "v", "ffn_in", "ffn_hidden")}
        for i in range(cfg.num_layers)}
    q, _ = ptq.apply_plan(params, cfg, precision, stats,
                          float_plan=T.build_plan(cfg, fp))
    rules = S.Rules(cfg, FakeMesh({"data": 1, "model": 2}), fsdp=False)
    blocks = [S.shard_params(q, rules, FakeMesh(
        {"data": 1, "model": 2}, {"data": 0, "model": m})) for m in (0, 1)]
    assert all(isinstance(b, S.ShardedParams) for b in blocks)
    assert blocks[0].topology == ("data=1,model=2", 0)
    wq = q["layers"][0]["attn"]["wq"]["w"]        # per-channel, column
    assert isinstance(wq, QuantizedTensor)
    for m, b in enumerate(blocks):
        w = b["layers"][0]["attn"]["wq"]["w"]
        n = wq.values.shape[1] // 2
        assert w.values.equal(wq.values[:, m * n:(m + 1) * n])
        assert w.scale.equal(wq.scale[:, m * n:(m + 1) * n])
        wo = b["layers"][0]["ffn"]["wo"]            # row-parallel + bias
        k = q["layers"][0]["ffn"]["wo"]["w"].values.shape[0] // 2
        assert wo["w"].values.equal(
            q["layers"][0]["ffn"]["wo"]["w"].values[m * k:(m + 1) * k])
        assert wo["b"].shape[0] == cfg.d_model // 2
        # layer 3's qkv weights are int8 per tensor: the global scale
        w3 = b["layers"][3]["attn"]["wq"]["w"]
        assert w3.scale.equal(q["layers"][3]["attn"]["wq"]["w"].scale)
        assert b["embed"]["tok"].shape == (cfg.vocab_size, cfg.d_model // 2)
        assert b["final_norm"]["scale"] is q["final_norm"]["scale"]
        assert b["head"]["out"]["w"] is q["head"]["out"]["w"]
    whole = torch.cat([b["layers"][1]["ffn"]["wi"]["w"].values
                       for b in blocks], dim=1)
    assert whole.equal(q["layers"][1]["ffn"]["wi"]["w"].values)


def test_vocab_parallel_table_splits_rows():
    cfg = get_config("qwen2-0.5b").reduced()
    params = T.init_params(cfg, None, seed=0, device="cpu")
    rules = S.Rules(cfg, FakeMesh({"data": 1, "model": 2}), fsdp=False)
    b = S.shard_params(params, rules, FakeMesh({"data": 1, "model": 2},
                                               {"data": 0, "model": 1}))
    V = cfg.vocab_size
    assert b["embed"]["tok"].equal(params["embed"]["tok"][V // 2:])
    assert b["layers"][0]["attn"]["wk"]["w"].shape == (cfg.d_model,
                                                      cfg.kv_dim // 2)


# ---------------------------------------------------------------------------
# tests/test_mesh_serving.py, ported
# ---------------------------------------------------------------------------


def test_mesh_fingerprint():
    assert S.mesh_fingerprint(None) == "unmeshed"
    m12 = FakeMesh({"data": 1, "model": 2})
    m21 = FakeMesh({"data": 2, "model": 1})
    assert S.mesh_fingerprint(m12) == "data=1,model=2"
    assert S.mesh_fingerprint(m21) == "data=2,model=1"
    assert S.mesh_fingerprint(m12) != S.mesh_fingerprint(m21)
    assert S.mesh_fingerprint(FakeMesh({"data": 1, "model": 2})) == \
        S.mesh_fingerprint(m12) == JS.mesh_fingerprint(m12)
    assert JS.mesh_fingerprint(None) == S.mesh_fingerprint(None)


def tiny_bert(num_layers=4):
    return get_config("bert-base").reduced().replace(num_layers=num_layers)


def test_runtime_cache_key_never_collides_across_meshes():
    """The same plan on different topologies (and unmeshed) takes distinct
    cache keys while the runtimes share one cache; ``identity`` names the
    topology, ``"unmeshed"`` without one."""
    cfg = tiny_bert(2)
    plan = T.build_plan(cfg, make_policy(cfg, "float"))
    rt = Runtime(cfg, plan, device="cpu")
    sib12 = rt.share(plan, mesh=FakeMesh({"data": 1, "model": 2}))
    sib21 = rt.share(plan, mesh=FakeMesh({"data": 2, "model": 1}))
    keys = {rt._plan_key, sib12._plan_key, sib21._plan_key}
    assert len(keys) == 3
    assert sib12._exe is rt._exe and sib21._exe is rt._exe
    assert sib12.share(plan)._plan_key == sib12._plan_key
    assert sib12.share(plan, mesh=None)._plan_key == rt._plan_key
    assert rt.identity["mesh"] == "unmeshed"
    assert sib12.identity["mesh"] == "data=1,model=2"


def test_meshed_bucket_rounds_to_dp_multiples():
    cfg = tiny_bert(2)
    plan = T.build_plan(cfg, make_policy(cfg, "float"))
    rt = Runtime(cfg, plan, mesh=FakeMesh({"data": 3, "model": 1},
                                          {"data": 1, "model": 0}),
                 device="cpu")
    assert rt._dp == 3
    for B, want in ((1, 3), (2, 3), (3, 6), (4, 6), (5, 9)):
        Bb = bucket_size(B, rt.min_batch)
        if Bb % rt._dp:
            Bb = -(-Bb // rt._dp) * rt._dp
        assert Bb == want and Bb % 3 == 0, (B, Bb)
    # the rank's rows: its block of a divisible batch, else all rows
    assert rt.rows(6) == (2, 4) and rt.rows(4) == (0, 4)


def test_fused_backend_declines_sub_tile_shards():
    """Unlike the JAX backend, which declines a GEMM whose per-rank shard
    is narrower than its 128-wide MXU tile, the fused backend claims a
    rank's block at any width (every op sees local tensors): qwen2's
    ``wk`` at tp 2 (896 x 64) and the row-parallel ``wo`` block (448 rows)
    run the kernel route, equal to the reference GEMM, and so does a rank's
    decode attention on its one KV head."""
    import repro_torch.kernels.backend as B
    assert not hasattr(B, "MIN_SHARD_TILE")
    fused, ref = get_backend("fused"), get_backend("reference")
    g = torch.Generator().manual_seed(0)
    x = torch.randn((4, 896), generator=g)
    w = QuantizedTensor(torch.randint(-127, 128, (896, 64), generator=g,
                                      dtype=torch.int8),
                        torch.rand((1, 64), generator=g) * 1e-2, None)
    y = fused.linear(x, {"w": w})
    assert y is not None and y.shape == (4, 64)
    assert ref.linear(x, {"w": w}) is None
    want = L.dense(x, {"w": w})
    torch.testing.assert_close(y, want, rtol=1e-6, atol=1e-6)
    w_row = QuantizedTensor(torch.randint(-127, 128, (448, 896),
                                          generator=g, dtype=torch.int8),
                            torch.rand((1, 896), generator=g) * 1e-2, None)
    got = fused.linear_acc(x[:, :448], {"w": w_row},
                           row_amax=lambda a: a)
    assert got is not None and got[0].dtype == torch.int32
    # a rank's decode step: 7 query heads on its one KV head
    pages = {"pages_k": torch.zeros((4, 4, 1, 16), dtype=torch.int8),
             "pages_v": torch.zeros((4, 4, 1, 16), dtype=torch.int8),
             "pages_ks": torch.ones((4, 4, 1)),
             "pages_vs": torch.ones((4, 4, 1)),
             "pages_pos": torch.zeros((4, 4), dtype=torch.int32)}
    o = fused.decode_attention(
        torch.randn((2, 1, 7, 16), generator=g), pages,
        torch.tensor([[0, 1], [2, 3]]), positions=torch.tensor([[3], [5]]),
        active=torch.tensor([True, True]), scale=0.25, softcap=None,
        static_scales={}, p_scale=None)
    assert o is not None and o.shape[2] == 7


# ---------------------------------------------------------------------------
# launch.mesh and launch.shapes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec", ["2", "a,b", "0,1", "1,-2"])
def test_serving_mesh_parse_errors_match_jax(spec):
    from repro.launch.mesh import make_serving_mesh as jax_mesh
    with pytest.raises(ValueError) as theirs:
        jax_mesh(spec)
    with pytest.raises(ValueError) as ours:
        M.make_serving_mesh(spec)
    assert str(ours.value) == str(theirs.value)


def test_serving_mesh_1_1_is_unmeshed_and_others_need_ranks():
    assert M.make_serving_mesh("1,1") is None
    with pytest.raises(ValueError, match="comm.spawn"):
        M.make_serving_mesh("2,1")
    with pytest.raises(ValueError, match="spawn"):
        M.make_production_mesh()
    with pytest.raises(ValueError, match="spawn"):
        M.make_production_mesh(multi_pod=True)


def test_shape_cells_match_jax():
    assert {k: dataclasses.asdict(v) for k, v in SH.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in JSH.SHAPES.items()}
    for arch in ARCH_IDS:
        for name in JSH.SHAPES:
            assert SH.cell_supported(get_config(arch), name) == \
                JSH.cell_supported(jax_get_config(arch), name)


_DTYPES = {jnp.int32: torch.int32, jnp.bfloat16: torch.bfloat16}


@pytest.mark.parametrize("arch", ["bert-base", "qwen2-0.5b",
                                  "hubert-xlarge", "paligemma-3b"])
def test_meta_specs_match_jax(arch):
    """Batch, cache and param specs on the meta device: JAX's shapes and
    dtypes (params by their ``interop`` names)."""
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    for name, cell in JSH.SHAPES.items():
        if not JSH.cell_supported(jcfg, name)[0]:
            continue
        want = JSH.batch_specs(jcfg, cell)
        got = SH.batch_specs(cfg, SH.SHAPES[name])
        assert sorted(got) == sorted(want)
        for k, v in got.items():
            assert v.device.type == "meta"
            assert tuple(v.shape) == tuple(want[k].shape)
            assert v.dtype == _DTYPES[want[k].dtype.type]
    jpol, pol = jax_make_policy(jcfg, "float"), make_policy(cfg, "float")
    jp = JSH.params_specs(jcfg, jpol)
    p = SH.params_specs(cfg, pol)
    flat, _ = jax.tree_util.tree_flatten_with_path(jp)
    want = {JS._path_str(kp): tuple(l.shape) for kp, l in flat}
    got = {n: tuple(v.shape) for n, v in flatten_names(
        _meta_layout(p, T.build_plan(cfg, pol)))}
    assert got == want
    if cfg.supports_decode:
        caches = SH.cache_specs(cfg, T.build_plan(cfg, pol),
                                SH.SHAPES["decode_32k"])
        assert caches[0]["pos"].device.type == "meta"
        assert caches[0]["pos"].shape == (128,)


def _meta_layout(params, plan) -> dict:
    """The JAX layout of a meta tree (``params_to_numpy`` would read the
    values): each group's layers stacked as (steps, ...) meta tensors."""
    layers = params["layers"]
    out = {k: v for k, v in params.items() if k != "layers"}

    def stack(nodes):
        first = nodes[0]
        if isinstance(first, dict):
            return {k: stack([n[k] for n in nodes]) for k in first}
        return torch.empty((len(nodes),) + tuple(first.shape),
                           dtype=first.dtype, device="meta")
    out["groups"] = [
        {"layers": [stack([layers[g.start + s * len(g.kinds) + j]
                           for s in range(g.steps)])
                    for j in range(len(g.kinds))]}
        for g in plan]
    return out


@pytest.mark.parametrize("arch,shape", [
    ("mixtral-8x22b", {"data": 2, "model": 1}),
    ("deepseek-v2-236b", {"data": 1, "model": 2}),
    ("xlstm-125m", {"data": 1, "model": 2}),
    ("recurrentgemma-9b", {"data": 1, "model": 2}),
    ("hubert-xlarge", {"data": 1, "model": 2}),
    ("paligemma-3b", {"data": 1, "model": 2}),
    ("xlstm-125m", {"data": 2, "model": 1}),
    ("qwen2-0.5b", {"data": 1, "model": 2}),
    ("granite-20b", {"data": 2, "model": 2}),
])
def test_meshes_of_every_arch_build_a_runtime(arch, shape):
    """Since item 8d every config serves on a mesh: the MoE configs on
    either axis (an MoE layer's token groups follow the data axis, one a
    rank where it splits a batch), tensor parallelism for MLA, the
    recurrent bodies and the front-ends. The runtime takes the mesh and
    keys on it."""
    cfg = get_config(arch).reduced()
    plan = T.build_plan(cfg, make_policy(cfg, "float"))
    mesh = FakeMesh(shape)
    rt = Runtime(cfg, plan, mesh=mesh, device="cpu")
    assert rt.mesh is mesh
    assert rt.identity["mesh"] == S.mesh_fingerprint(mesh)
    dp = shape["data"]
    assert rt.moe_args(4) == {"moe_groups": dp, "data_shard": dp > 1}
    assert rt.moe_args(3) == {"moe_groups": dp, "data_shard": False}
