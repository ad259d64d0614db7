"""PyTorch/CUDA port of the fused-BPT influence system in ``repro``.

The package mirrors ``repro``'s module paths (``repro/core/rrr.py`` is
``repro_torch/core/rrr.py``) and keeps its results bit-identical: batch
``b`` of a sketch pool is a pure function of ``(graph, master_seed, b)`` in
both packages.  The LM substrate's serving path (``models/``,
``serve/engine.py``, ``launch/serve.py``) matches the reference's logits
within float32 rounding.  It imports ``torch`` and ``numpy`` only, never
``jax`` or ``repro``.

Tensors carry an explicit device.  Entry points that create tensors take
``device=`` and default to ``"cuda"``; without a GPU they raise unless the
caller asks for ``device="cpu"``, which runs every kernel's plain PyTorch
version.  Packed colour masks are ``torch.int32`` tensors holding uint32
bit patterns (``convert.masks_to_numpy`` views them as uint32).
"""
