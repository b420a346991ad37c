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

Entry points default to ``device="cuda"`` and raise when no CUDA device is
present; pass ``device="cpu"`` to run the plain PyTorch versions.
"""
