"""PyTorch/CUDA port of the ``repro`` serving stack.

The JAX package ``repro`` is the reference; this package mirrors its
layout module by module (``repro_torch.models.layers`` beside
``repro.models.layers``, and so on) and is held against it by the
``tests/test_torch_*.py`` parity tests. It imports ``torch`` and numpy,
never ``jax`` and nothing from ``repro``.

Entry points (``runtime.engine.Engine``, ``models.transformer.Transformer``,
``launch.serve``, the CNN graph builders of ``models.cnn``) run on
``"cuda"`` unless the caller passes ``device="cpu"``; on the card,
prefill and decode attention and the RG-LRU scan run the hand-written
kernels under ``csrc/``. ``core`` is the port's copy of the reference's
VR-PRUNE toolchain (Edge-PRUNE's graph, analyzer, synthesis, simulator
and explorer).
"""
