"""rag_tpu_torch: the PyTorch/CUDA port of rag_tpu for one NVIDIA H100.

Serving slice: a committed checkpoint's task paths run through
``continual.inference.RoutedInference`` on the card, with the three TPU
kernels of that path rewritten by hand in CUDA C++ (``csrc/``). The package
imports torch and numpy only, never jax or rag_tpu.
"""
