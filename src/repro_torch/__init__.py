"""SAMP on PyTorch and CUDA — the port of the JAX package ``repro``.

The package mirrors ``repro``'s layout (``configs``, ``core``, ``kernels``,
``models``, ``quant``, ``toolkit``, ``serve``) so each module has a named
counterpart, and it is held against that counterpart by the
``tests/test_torch_*.py`` parity suite. It imports ``torch`` and numpy only:
nothing of JAX and nothing of ``repro``.

This first slice covers BERT-family encoder serving under schema-v1
precision plans: configs and plans, quantization and calibration, the four
CUDA kernels (``quant_linear``, ``addnorm_quant``, ``dynamic_quant``,
``fused_embed``) behind the ``reference | fused | auto`` backend registry,
the encoder forward, PTQ, and ``serve.EncoderServeEngine``.

Entry points default to ``device="cuda"`` and raise when no CUDA device is
present; pass ``device="cpu"`` to run the plain PyTorch versions.
"""
