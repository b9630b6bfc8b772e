"""rag_tpu_torch: the PyTorch/CUDA port of rag_tpu for one NVIDIA H100.

A committed checkpoint's task paths are served through
``continual.inference.RoutedInference`` and trained through
``train.trainer.make_train_step`` on the card, with the seven TPU kernels
of that path (three forward, four backward) rewritten by hand in CUDA C++
(``csrc/``). The package imports torch and numpy only, never jax or
rag_tpu.
"""
