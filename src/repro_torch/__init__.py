"""SAMP on PyTorch and CUDA — the port of the JAX package ``repro``.

The package mirrors ``repro``'s layout (``configs``, ``core``, ``data``,
``kernels``, ``models``, ``quant``, ``toolkit``, ``serve``) so each module
has a named counterpart, and it is held against that counterpart by the
``tests/test_torch_*.py`` parity suite. It imports ``torch`` and numpy only:
nothing of JAX and nothing of ``repro``.

It covers the paper's main path, ``toolkit.Pipeline.predict_texts``
(tokenizer -> embedding -> encoder -> target), encoder serving under
schema-v1 and v3 plans, qwen2 and mixtral decode over dense and paged
int8 KV caches, PTQ and calibration, and all eight of the JAX package's
Pallas kernels as hand-written CUDA kernels (``kernels.ops``) behind the
``reference | fused | auto`` backend registry.

The paper's own workflow runs through the :class:`SAMP` facade
(``repro_torch.toolkit.samp``): calibrate, search the mixed-precision grid
(Algorithm 1 over accuracy and latency, the latency measured on the card or
modeled by the H100 roofline), apply, save a deployable bundle, load it and
serve it. ``from repro_torch import SAMP`` loads the toolkit on first use.

Entry points default to ``device="cuda"`` and raise when no CUDA device is
present; pass ``device="cpu"`` to run the plain PyTorch versions.
"""
_TOOLKIT_EXPORTS = ("SAMP", "AutotuneReport", "Pipeline", "TargetSpec",
                    "PrecisionPlan", "LayerPlan", "QuantSpec",
                    "SEARCH_STRATEGIES", "register_strategy",
                    "save_artifact", "load_artifact", "register_target",
                    "register_latency_backend", "toolkit")

__all__ = list(_TOOLKIT_EXPORTS)


def __getattr__(name):
    # the toolkit loads on first use, so ``import repro_torch.configs``
    # stays cheap
    if name in _TOOLKIT_EXPORTS:
        import importlib
        toolkit = importlib.import_module("repro_torch.toolkit")
        return toolkit if name == "toolkit" else getattr(toolkit, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(__all__)
