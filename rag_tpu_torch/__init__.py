"""rag_tpu_torch: the PyTorch/CUDA port of rag_tpu for one NVIDIA H100.

A committed checkpoint's task paths are served through
``continual.inference.RoutedInference`` and trained through
``train.trainer.make_train_step`` on the card, with the seven TPU kernels
of that path (three forward, four backward) rewritten by hand in CUDA C++
(``csrc/``). The Scene Router (``models.router``) picks each frame's task
path, and ``data.synthetic`` makes the styled synthetic scenes it learns
from. The package imports torch and numpy only, never jax or rag_tpu.
"""
