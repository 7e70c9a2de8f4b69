"""PyTorch + CUDA port of the Δ-SGD federated-learning system.

The JAX package ``repro`` is the reference; this package mirrors its
module layout (``repro_torch/core/flat.py`` <-> ``repro/core/flat.py``)
and never imports it or ``jax``. Entry points run on ``cuda`` unless the
caller passes ``device="cpu"`` (see ``repro_torch.device``). The per-step
Δ-SGD kernels are hand-written CUDA C++ under
``repro_torch/kernels/delta_sgd/csrc``; on a CPU tensor their wrappers
run the plain PyTorch version instead.
"""
