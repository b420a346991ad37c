"""The modular inference pipeline: tokenizer -> embedding -> encoder -> target
(port of ``repro.toolkit.pipeline``).

The paper's §3.1 decomposition as first-class objects. Each stage is a thin,
independently-usable wrapper over the substrate
(``repro_torch.data.tokenizer``, ``repro_torch.models.transformer``);
:class:`Pipeline` composes them into exactly the forward the substrate
executes, and predicts through the serving :class:`Runtime`, so a Pipeline
prediction equals what ``EncoderServeEngine`` returns for the same token ids
at the same batch bucket.

A Pipeline is built from an :class:`~repro_torch.configs.base.ArchConfig`
plus a task spec (name or :class:`~repro_torch.data.pipeline.TaskSpec`);
the target head is resolved from the ``TARGETS`` registry (default: the
head matching the task kind). ``with_policy()`` rebinds the same stages to
quantized params under a new execution plan (the post-PTQ pipeline).

The port serves in the params' dtype (float32), so there is no
``compute_dtype``; the plan's ``float_dtype`` is part of its fingerprint,
and the compute dtype of fine-tuning (``SAMP.finetune``). ``mesh=`` (a
:class:`~repro_torch.launch.mesh.ProcessMesh`) serves the pipeline's
predictions SPMD through its runtime; :meth:`Pipeline.forward` composes the
stages over whole params.
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.device import resolve_device
from repro_torch.core.plan import PrecisionPlan, as_plan
from repro_torch.core.precision import EncoderPolicy
from repro_torch.data.pipeline import (TaskSpec, eval_accuracy, get_batch,
                                       make_task)
from repro_torch.data.tokenizer import WordPieceTokenizer
from repro_torch.distributed.sharding import mesh_fingerprint
from repro_torch.kernels.backend import get_backend
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.serve.runtime import Runtime
from repro_torch.toolkit.registry import get_target
from repro_torch.toolkit.targets import TARGET_FOR_TASK_KIND, TargetSpec


# ---------------------------------------------------------------------------
# stages
# ---------------------------------------------------------------------------


class TokenizerStage:
    """Raw text -> model inputs (numpy). Synthetic tasks arrive
    pre-tokenized, so the tokenizer is optional; when present (a
    :class:`~repro_torch.data.tokenizer.WordPieceTokenizer`)
    ``encode_batch`` produces padded ``tokens``/``segments`` ready for the
    embedding stage."""

    def __init__(self, tokenizer: Optional[WordPieceTokenizer] = None,
                 seq_len: int = 64):
        self.tokenizer = tokenizer
        self.seq_len = seq_len

    def __call__(self, texts: Sequence) -> dict:
        if self.tokenizer is None:
            raise ValueError("pipeline built without a tokenizer; feed "
                             "pre-tokenized batches or pass tokenizer=")
        if texts and isinstance(texts[0], (tuple, list)):   # sentence pairs
            ids = np.full((len(texts), self.seq_len),
                          self.tokenizer.index["[PAD]"], np.int32)
            seg = np.zeros((len(texts), self.seq_len), np.int32)
            for i, (a, b) in enumerate(texts):
                ti, si = self.tokenizer.encode_pair(a, b)
                ti, si = ti[:self.seq_len], si[:self.seq_len]
                ids[i, :len(ti)] = ti
                seg[i, :len(si)] = si
            return {"tokens": ids, "segments": seg}
        ids, _ = self.tokenizer.encode_batch(list(texts), self.seq_len)
        return {"tokens": ids, "segments": np.zeros_like(ids)}


class EmbeddingStage:
    """Model inputs -> first-layer activations (token + position + segment
    embeddings), on the compute backend's ``fused_embed`` where it claims
    the gather."""

    def __init__(self, cfg: ArchConfig, backend=None):
        self.cfg = cfg
        self.backend = backend

    def __call__(self, params: dict, batch: dict, *,
                 positions) -> torch.Tensor:
        return T.embed_inputs(params, batch, self.cfg, positions=positions,
                              backend=self.backend)


class EncoderStage:
    """Activations -> final-norm hidden states under an execution plan (the
    per-layer SAMP precision modes compiled into groups), executed on a
    compute backend (reference PyTorch or the fused CUDA kernels)."""

    def __init__(self, cfg: ArchConfig, plan, scheme: T.QuantScheme,
                 backend=None):
        self.cfg = cfg
        self.plan = plan
        self.scheme = scheme
        self.backend = backend

    def __call__(self, params: dict, x: torch.Tensor, *,
                 positions) -> torch.Tensor:
        x = T.run_groups(x, params, self.cfg, self.plan, self.scheme,
                         positions=positions, backend=self.backend)
        return L.norm(x, params["final_norm"], self.cfg.norm_kind)


class TargetStage:
    """Hidden states -> task logits via the registered head."""

    def __init__(self, spec: TargetSpec, n_out: int, cfg: ArchConfig):
        self.spec = spec
        self.n_out = n_out
        self.cfg = cfg

    def __call__(self, params: dict, hidden: torch.Tensor) -> torch.Tensor:
        return self.spec.apply(params, hidden, self.cfg)


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------


class Pipeline:
    """tokenizer -> embedding -> encoder -> target, under one
    :class:`~repro_torch.core.plan.PrecisionPlan`, on one device
    (``"cuda"`` by default; ``"cpu"`` runs the kernels' plain versions).
    Hold one Pipeline per deployed configuration: ``with_policy`` derives
    the quantized sibling from PTQ output and shares this pipeline's
    runtime (one callable cache, keyed by plan fingerprint)."""

    def __init__(self, cfg: ArchConfig, task: TaskSpec, target: TargetSpec,
                 *, n_out: Optional[int] = None,
                 policy: Optional[Union[PrecisionPlan,
                                        EncoderPolicy]] = None,
                 plan=None, scheme: T.QuantScheme = T.QuantScheme(),
                 params: Optional[dict] = None,
                 tokenizer: Optional[WordPieceTokenizer] = None,
                 backend="reference",
                 device: Union[str, torch.device] = "cuda", mesh=None):
        self.cfg = cfg
        self.task = task
        self.backend = get_backend(backend)
        # the serving mesh the runtime places the predictions on (None =
        # one device); part of the runtime's cache key
        self.mesh = mesh
        self.device = resolve_device(device)
        # the precision description is always a PrecisionPlan internally;
        # EncoderPolicies coerce through the lossless shim
        self.policy = (PrecisionPlan.full_float(cfg.num_layers)
                       if policy is None
                       else as_plan(policy,
                                    dynamic_acts=scheme.dynamic_acts))
        self.scheme = scheme
        self.params = params
        n_out = n_out if n_out is not None else max(task.n_classes, 1)
        # -- the four stages -------------------------------------------------
        self.tokenizer = TokenizerStage(tokenizer, task.seq_len)
        self.embedding = EmbeddingStage(cfg, backend=self.backend)
        self.encoder = EncoderStage(cfg, plan if plan is not None
                                    else T.build_plan(cfg, self.policy),
                                    scheme, backend=self.backend)
        self.target = TargetStage(target, n_out, cfg)
        self._runtime: Optional[Runtime] = None

    @classmethod
    def build(cls, cfg: ArchConfig, task: Union[str, TaskSpec], *,
              target: Optional[str] = None, n_out: Optional[int] = None,
              seq_len: int = 64, float_dtype: str = "bfloat16",
              scheme: T.QuantScheme = T.QuantScheme(),
              tokenizer: Optional[WordPieceTokenizer] = None,
              backend="reference",
              device: Union[str, torch.device] = "cuda",
              mesh=None) -> "Pipeline":
        """ArchConfig + task spec -> float Pipeline (params uninitialized;
        call ``init_params`` or bind carried-over params). ``backend``
        picks the compute backend quantized blocks execute on (reference |
        fused | auto — see repro_torch.kernels.backend); ``mesh`` the
        serving mesh its runtime predicts on."""
        if isinstance(task, str):
            task = make_task(task, vocab_size=cfg.vocab_size,
                             seq_len=seq_len)
        spec = get_target(target or TARGET_FOR_TASK_KIND[task.kind])
        policy = PrecisionPlan.full_float(cfg.num_layers, float_dtype)
        return cls(cfg, task, spec, n_out=n_out, policy=policy,
                   scheme=scheme, tokenizer=tokenizer, backend=backend,
                   device=device, mesh=mesh)

    # -- construction --------------------------------------------------------
    @property
    def plan(self):
        return self.encoder.plan

    @property
    def precision(self) -> PrecisionPlan:
        """The pipeline's PrecisionPlan (alias of ``policy``)."""
        return self.policy

    @property
    def runtime(self) -> Runtime:
        """The bucketed runtime this pipeline predicts through (and hands
        to the serving engines, so predict and serve share one cache).
        Params are call arguments. Cache keys fold the precision plan's
        fingerprint, so ``with_policy`` siblings share this runtime."""
        if self._runtime is None:
            spec, cfg = self.target.spec, self.cfg
            self._runtime = Runtime(
                cfg, self.plan, scheme=self.scheme,
                precision=self.precision,
                head=lambda p, h: spec.apply(p, h, cfg),
                token_level=spec.token_level, backend=self.backend,
                device=self.device, mesh=self.mesh)
        return self._runtime

    def init_params(self, gen: torch.Generator,
                    dtype=torch.float32) -> dict:
        """Float init on the pipeline's device: the base model params from a
        seed drawn from ``gen`` (a ``torch.Generator`` on that device), then
        the target head's params from ``gen``. Random like the JAX
        package's, not the same numbers: parity tests carry JAX parameters
        across with :func:`repro_torch.interop.params_from_numpy`."""
        seed = int(torch.randint(0, 2**31 - 1, (1,), generator=gen,
                                 device=gen.device))
        params = T.init_params(self.cfg, self.policy, seed=seed,
                               device=self.device, dtype=dtype)
        head = self.target.spec.init(gen, self.cfg, self.target.n_out,
                                     device=self.device, dtype=dtype)
        if head is not None:
            params["head"] = head
        self.params = params
        return params

    def with_policy(self, params: dict, plan,
                    policy: Union[PrecisionPlan, EncoderPolicy]
                    ) -> "Pipeline":
        """Same stages, new precision: bind PTQ output (params packed under
        ``plan``) into a sibling Pipeline that shares this pipeline's
        runtime — its callables land in the same cache under the new plan's
        fingerprint."""
        pipe = Pipeline(self.cfg, self.task, self.target.spec,
                        n_out=self.target.n_out, policy=policy, plan=plan,
                        scheme=self.scheme, params=params,
                        tokenizer=self.tokenizer.tokenizer,
                        backend=self.backend, device=self.device,
                        mesh=self.mesh)
        pipe._runtime = self.runtime.share(plan, scheme=self.scheme,
                                           precision=pipe.precision,
                                           backend=pipe.backend)
        return pipe

    # -- forward / predict ---------------------------------------------------
    def forward(self, params: dict, batch: dict) -> torch.Tensor:
        """Compose the stages: batch (tensors on the device) -> logits, at
        the batch's own shape (no bucket, no padding)."""
        lead = batch.get("tokens", batch.get("frames"))
        S = lead.shape[1]
        if self.cfg.frontend == "vision" and "prefix_embeds" in batch:
            S += batch["prefix_embeds"].shape[1]
        positions = torch.arange(S, dtype=torch.int32, device=lead.device)
        with torch.inference_mode():
            x = self.embedding(params, batch, positions=positions)
            hidden = self.encoder(params, x, positions=positions)
            return self.target(params, hidden)

    def _model_inputs(self, batch: dict) -> dict:
        keep = ("tokens", "segments", "frames", "prefix_embeds")
        return {k: np.asarray(v) for k, v in batch.items() if k in keep}

    def predict_logits(self, batch: dict) -> np.ndarray:
        """Task logits for one batch, through the runtime's bucketed cache
        (padded to the (batch, length) bucket, the padding masked)."""
        if self.params is None:
            raise ValueError("pipeline has no params; call init_params() "
                             "or bind params")
        return self.runtime.encode(self.params, self._model_inputs(batch))

    def predict(self, batch: dict) -> np.ndarray:
        """Predicted class ids for one batch (class per sequence, or per
        token for token-level targets)."""
        return np.asarray(self.target.spec.predict(
            self.predict_logits(batch)))

    def predict_texts(self, texts: Sequence) -> np.ndarray:
        """Raw strings (or (a, b) pairs for matching) -> predictions."""
        return self.predict(self.tokenizer(texts))

    # -- eval ----------------------------------------------------------------
    def eval(self, *, batches: int = 8, batch_size: int = 64,
             split: str = "dev") -> float:
        """Dev-set accuracy on the pipeline's task: classification/matching/
        tagging accuracy vs labels, next-token accuracy for LM tasks."""
        if self.task.kind != "lm":
            return eval_accuracy(self.predict, self.task, batches=batches,
                                 batch_size=batch_size, split=split)
        correct = total = 0
        for i in range(batches):
            b = get_batch(self.task, i, batch_size, split)
            pred = self.predict(b)[:, :-1]
            want = b["tokens"][:, 1:]
            correct += int((pred == want).sum())
            total += int(np.prod(want.shape))
        return correct / max(total, 1)

    # -- training hook -------------------------------------------------------
    def loss_fn(self):
        """A loss callable with the Trainer's signature
        ``(params, batch, cfg, plan, scheme, **kw)``, routed through the
        registered target head (``lm``: :func:`~repro_torch.models.
        transformer.lm_loss`). It runs the float forward with no compute
        backend, as training does."""
        spec = self.target.spec
        if spec.name == "lm":
            return T.lm_loss

        def loss(params, batch, cfg, plan, scheme=T.QuantScheme(), **kw):
            hidden = T.forward(params, batch, cfg, plan, scheme,
                               return_hidden=True, **kw)
            return spec.loss(spec.apply(params, hidden, cfg),
                             batch["labels"])
        return loss

    def describe(self) -> str:
        return (f"Pipeline[{self.cfg.name}] task={self.task.name} "
                f"target={self.target.spec.name} "
                f"policy={self.policy.describe()} "
                f"backend={self.backend.name} device={self.device} "
                f"mesh={mesh_fingerprint(self.mesh)}")
