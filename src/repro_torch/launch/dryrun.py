"""Multi-pod dry-run (port of ``repro.launch.dryrun``): every (arch x shape
x mesh) cell on ``meta`` tensors, with no card and no process group.

For each cell this script:
  1. lays out :func:`make_production_mesh`'s shapes (16 x 16 single-pod,
     2 x 16 x 16 multi-pod) as a :class:`~repro_torch.launch.mesh.
     RecordingMesh`, as its first rank;
  2. builds the cell's trees on ``meta`` (nothing is allocated): the
     parameters (the float init, or for a quantized policy the PTQ
     transform itself over it with placeholder statistics, as ``repro``'s
     ``quantized_param_specs``), the batch and the decode caches;
  3. adds up the rank's argument bytes, each leaf's block under
     :class:`~repro_torch.distributed.sharding.Rules`: the params
     (training: FSDP over ``data``; serving: replicated over it), for a
     train cell the AdamW moments and step under the trainer's ZeRO-3
     :class:`~repro_torch.train.trainer.MeshLayout`, the caches under
     ``cache_spec``, the batch under ``batch_spec`` (and decode's scalar
     position), as XLA's ``argument_size_in_bytes`` counts the arguments of
     ``repro``'s cell;
  4. runs the rank's step once on its blocks under
     ``torch.utils.flop_counter.FlopCounterMode`` on the reference backend:
     a train cell the trainer's step (``lm_loss`` forward and backward with
     remat, its FSDP gathers and reduce-scatters, the update), a prefill
     cell :func:`~repro_torch.launch.shapes.prefill_step`, a decode cell one
     ``decode_step`` with the rows gathered as the serving runtime gathers
     them;
  5. records the step's collectives from the mesh (calls and input bytes
     by kind, as :data:`repro_torch.distributed.comm.STATS` counts them)
     and writes the cell's record to ``results/dryrun/<cell>.json``
     (incremental: a cell with a record is skipped unless ``--force``).

A cell whose step cannot run on ``meta`` (an op that reads tensor values,
as a ring cache's write slot or a page table's ``nonzero`` do) records
``error`` with its trace, as ``repro`` records a compile failure.

The record keeps ``repro``'s fields where the port has a counterpart:
``status`` (``ok``, ``skip`` with ``cell_supported``'s reason, ``error``),
``num_devices``, ``memory.argument_bytes``, ``corrected.flops`` (the
step's matmul FLOPs, one rank), ``corrected.collective_bytes``,
``collectives`` and ``wall_s``. XLA-only fields have no analogue and are
not written: ``lower_s``, ``compile_s``, ``memory.temp_bytes`` /
``output_bytes`` / ``alias_bytes`` / ``code_bytes``, ``cost`` and
``hlo_ops``. ``repro``'s ``collective_bytes`` sums each collective's output
shape from the HLO; the port's sums each call's input, as ``comm.STATS``.

``repro.launch.hlo_cost`` has no counterpart: it re-reads XLA's HLO to
multiply ``while`` bodies by their trip counts, which ``cost_analysis``
counts once. An eager step runs every layer, and ``FlopCounterMode`` counts
each, so there is no trip count to correct.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2-0.5b --shape decode_32k
  python -m repro_torch.launch.dryrun --all --mesh both
  python -m repro_torch.launch.dryrun --all --mesh single --policy ffn8
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.plan import PrecisionPlan, plan_from_policy
from repro_torch.core.precision import make_policy
from repro_torch.distributed.sharding import Rules, shard_params
from repro_torch.interop import flatten_names, map_leaves
from repro_torch.kernels.backend import get_backend
from repro_torch.launch import shapes as SH
from repro_torch.launch.mesh import RecordingMesh
from repro_torch.models import transformer as T
from repro_torch.quant import ptq
from repro_torch.train.optimizer import AdamW
from repro_torch.train.trainer import TrainConfig, Trainer, TrainState

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun")

#: the production meshes' shapes (``make_production_mesh``)
MESH_SHAPES = {"single": {"data": 16, "model": 16},
               "multi": {"pod": 2, "data": 16, "model": 16}}


def abstract_stats(cfg) -> dict:
    """Placeholder per-layer amax stats (value 1.0): scale values shape
    nothing the dry-run reads."""
    sites = ("attn_in", "attn_out", "q", "k", "p", "v", "q_lat", "c_kv",
             "ffn_in", "ffn_hidden", "ffn_in_e", "shared_ffn_in",
             "shared_ffn_hidden", "rec_in", "rec_gate_in", "rec_out",
             "blk_in", "blk_conv_in", "blk_hidden", "qkv_in", "xm")
    return {f"layer{i}": {s: 1.0 for s in sites}
            for i in range(cfg.num_layers)}


def cell_params(cfg, precision: PrecisionPlan, param_dtype=torch.bfloat16,
                device="meta") -> tuple[dict, tuple]:
    """``(params, execution plan)`` of a cell: the float init, or the PTQ
    transform of it under ``precision`` with :func:`abstract_stats`."""
    float_prec = PrecisionPlan.full_float(cfg.num_layers,
                                          precision.float_dtype)
    params = T.init_params(cfg, float_prec, device=device, dtype=param_dtype)
    if not (precision.num_quant_ffn or precision.num_quant_mha):
        return params, T.build_plan(cfg, precision)
    return ptq.apply_plan(params, cfg, precision, abstract_stats(cfg),
                          float_plan=T.build_plan(cfg, float_prec))


def block_bytes(tree, specs: dict, mesh) -> int:
    """The bytes of the rank's block of every leaf of ``tree``, each named
    leaf cut under its spec in ``specs`` (a leaf with none whole)."""
    total = 0
    for name, leaf in flatten_names(tree):
        n = leaf.numel()
        for entry in specs.get(name, ()):
            for a in (entry if isinstance(entry, tuple) else (entry,)):
                if a is not None:
                    n //= mesh.size(a)
        total += n * leaf.element_size()
    return total


def _batch_bytes(rules, batch: dict, mesh) -> int:
    specs = rules.batch_spec(batch)
    return block_bytes(batch, specs, mesh)


def _cache_bytes(rules, caches, mesh) -> int:
    specs = rules.cache_spec(caches)
    total = 0
    for i, c in enumerate(caches):
        total += block_bytes(c, {k: specs[f"{i}/0/{k}"] for k in c}, mesh)
    return total


# ---------------------------------------------------------------------------
# the steps, on any mesh (the tests run them on gloo ranks too)
# ---------------------------------------------------------------------------


def train_step(cfg, policy, params, batch, mesh, *, device="meta"):
    """The trainer's step on ``mesh`` with remat, as ``repro``'s cell
    builds it, in float32 (``repro`` computes in bfloat16; ``meta`` has no
    autocast, and the matmuls' FLOPs do not depend on the dtype):
    the whole state cut to this rank's ZeRO-3 blocks, then one step on the
    global ``batch`` (each rank takes its rows). Returns the step's
    outputs."""
    trainer = Trainer(cfg, policy, mesh=mesh, optimizer=AdamW(lr=1e-4),
                      tcfg=TrainConfig(remat=True, compute_dtype="float32"),
                      device=device)
    state = trainer.shard(TrainState(params, trainer.optimizer.init(params)))
    return trainer.make_step()(state.params, state.opt_state, None, batch)


def serve_rows(cfg, mesh, B: int) -> tuple[int, int, dict]:
    """The rank's rows ``[lo, hi)`` of a serving batch of ``B`` and the
    MoE arguments, as the serving runtime splits a batch over the dp axes
    (``pod`` and ``data``) where they divide it."""
    dp, index = (1, 0) if mesh is None else mesh.index(
        ("pod", "data") if "pod" in mesh.axis_names else ("data",))
    if dp == 1 or B % dp:
        return 0, B, {"moe_groups": dp, "data_shard": False}
    n = B // dp
    return index * n, (index + 1) * n, {"moe_groups": dp,
                                        "data_shard": True}


def decode_step(cfg, plan, local_params, local_caches, tokens, pos, mesh):
    """One serving decode step at the scalar position ``pos`` over the
    rank's rows of ``tokens`` (B, 1), on the reference backend; the logits
    of every row gathered over the dp axes as the runtime gathers them."""
    lo, hi, moe = serve_rows(cfg, mesh, tokens.shape[0])
    logits, caches = T.decode_step(local_params, tokens[lo:hi], local_caches,
                                   pos, cfg, plan, mesh=mesh,
                                   backend=get_backend("reference"), **moe)
    if moe["data_shard"]:
        for axis in ("data", "pod"):
            logits = mesh.all_gather(logits, axis, 0)
    return logits, caches


def prefill(cfg, plan, rules, local_params, batch, local_caches, mesh):
    """Serving prefill over the rank's rows of ``batch``
    (:func:`~repro_torch.launch.shapes.prefill_step`), at the attention
    chunk the rules pick for the global batch."""
    lead = batch.get("tokens", batch.get("frames"))
    B, S = lead.shape[0], lead.shape[1]
    lo, hi, moe = serve_rows(cfg, mesh, B)
    rows = {k: v[lo:hi] for k, v in batch.items() if k != "labels"}
    return SH.prefill_step(local_params, rows, local_caches, cfg, plan,
                           mesh=mesh, backend=get_backend("reference"),
                           chunk=rules.attn_chunk(B, S, cfg.num_heads),
                           **moe)


# ---------------------------------------------------------------------------
# a cell
# ---------------------------------------------------------------------------


def _float32(tree):
    """``tree`` with its half-precision leaves as float32 (on ``meta`` a
    cast allocates nothing): the port computes in float32, and a matmul of
    a float32 activation by a bfloat16 weight is an error on a device."""
    return map_leaves(tree, lambda _n, t: t.to(torch.float32)
                      if t.dtype in (torch.bfloat16, torch.float16) else t)


def build_cell(arch: str, shape_name: str, mesh, policy_name: str = "float",
               param_dtype=torch.bfloat16, *, cfg=None,
               cell=None) -> dict:
    """Run one cell on ``mesh`` (a :class:`RecordingMesh`): the rank's
    argument bytes (the trees at ``param_dtype``, as ``repro``'s cell
    holds them), and its step's FLOPs and collectives (the step on float32
    copies: the port computes in float32). ``cfg`` / ``cell`` override the
    named config and shape (the tests' reduced ones). Raises
    ``ValueError`` ``SKIP ...`` for a cell ``cell_supported`` skips."""
    cfg = cfg or get_config(arch)
    cell = cell or SH.SHAPES[shape_name]
    ok, why = SH.cell_supported(cfg, shape_name)
    if not ok:
        raise ValueError(f"SKIP {arch}/{shape_name}: {why}")
    policy = make_policy(cfg, policy_name)
    precision = plan_from_policy(policy)
    train = cell.kind == "train"
    rules = Rules(cfg, mesh, fsdp=train)
    batch = SH.batch_specs(cfg, cell, compute_dtype=param_dtype)
    mem = {"batch_bytes": _batch_bytes(rules, batch, mesh)}
    batch = _float32(batch)
    params, plan = cell_params(cfg, precision, param_dtype)
    specs = rules.params_spec(params)
    mem["params_bytes"] = block_bytes(params, specs, mesh)
    flops = FlopCounterMode(display=False)
    if train:
        # AdamW's first and second moments (float32) take the params'
        # blocks under the trainer's ZeRO-3 layout; the step is an int32
        mem["opt_bytes"] = 2 * block_bytes(_float32(params), specs,
                                           mesh) + 4
        mesh.reset()
        with flops:
            train_step(cfg, policy, _float32(params), batch, mesh)
    else:
        local = shard_params(_float32(params), rules, mesh)
        B, S = cell.global_batch, cell.seq_len
        local_caches, mem["cache_bytes"] = None, 0
        if cfg.supports_decode:
            mem["cache_bytes"] = _cache_bytes(rules, SH.cache_specs(
                cfg, plan, cell, cache_dtype=param_dtype), mesh)
            lo, hi, _ = serve_rows(cfg, mesh, B)
            local_caches = T.init_caches(cfg, plan, hi - lo, S,
                                         torch.float32, device="meta",
                                         mesh=mesh)
        mesh.reset()
        with flops, torch.no_grad():
            if cell.kind == "prefill":
                prefill(cfg, plan, rules, local, batch, local_caches, mesh)
            else:
                mem["batch_bytes"] += 4          # the scalar position
                decode_step(cfg, plan, local, local_caches,
                            batch["tokens"], S - 1, mesh)
    mem["argument_bytes"] = sum(v for k, v in mem.items()
                                if k.endswith("_bytes"))
    collectives = {k: {"bytes": int(mesh.bytes[k]), "count": int(n)}
                   for k, n in sorted(mesh.calls.items())}
    return {"memory": mem, "flops": int(flops.get_total_flops()),
            "collectives": collectives,
            "collective_bytes": int(sum(mesh.bytes.values()))}


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             policy_name: str = "float", out_dir: str = RESULTS_DIR,
             force: bool = False) -> dict:
    cell_id = f"{arch}__{shape_name}__{mesh_kind}__{policy_name}"
    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_dir, cell_id + ".json")
    if os.path.exists(out_path) and not force:
        with open(out_path) as f:
            return json.load(f)
    record = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
              "policy": policy_name, "package": "repro_torch",
              "status": "error"}
    t0 = time.time()
    try:
        mesh = RecordingMesh(MESH_SHAPES[mesh_kind])
        got = build_cell(arch, shape_name, mesh, policy_name)
        record.update(
            status="ok", num_devices=mesh.size("pod") * mesh.size("data")
            * mesh.size("model"), memory=got["memory"],
            corrected={"flops": got["flops"],
                       "collective_bytes": got["collective_bytes"]},
            collectives=got["collectives"])
    except ValueError as e:
        if str(e).startswith("SKIP"):
            record.update(status="skip", reason=str(e))
        else:
            record.update(status="error", error=str(e),
                          trace=traceback.format_exc()[-2000:])
    except Exception as e:      # a step that cannot run on meta is data
        record.update(status="error", error=f"{type(e).__name__}: {e}",
                      trace=traceback.format_exc()[-2000:])
    record["wall_s"] = round(time.time() - t0, 1)
    with open(out_path, "w") as f:
        json.dump(record, f, indent=1)
    return record


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None,
                    choices=list(SH.SHAPES) + [None])
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--policy", default="float")
    ap.add_argument("--all", action="store_true",
                    help="every (arch x shape) cell")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=RESULTS_DIR)
    args = ap.parse_args(argv)

    archs = [a for a in ARCH_IDS if a != "bert-base"] \
        if args.arch is None else [args.arch]
    shapes = list(SH.SHAPES) if args.shape is None else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if not args.all and args.arch is None:
        ap.error("pass --arch or --all")

    for arch in archs:
        for shape in shapes:
            for mk in meshes:
                rec = run_cell(arch, shape, mk, args.policy, args.out,
                               args.force)
                flops = rec.get("corrected", {}).get("flops", 0)
                print(f"{arch:22s} {shape:12s} {mk:6s} {args.policy:6s} "
                      f"-> {rec['status']:5s} "
                      f"flops/dev={flops:.3e} wall={rec.get('wall_s')}s"
                      + (f"  ({rec.get('error', rec.get('reason', ''))})"
                         if rec["status"] != "ok" else ""),
                      flush=True)


if __name__ == "__main__":
    main()
