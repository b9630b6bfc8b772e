"""rag_tpu_torch: the PyTorch/CUDA port of rag_tpu for one NVIDIA H100.

``continual.driver.ContinualDriver`` learns a sequence of scenes (cell
search on the supernet, growth, op search, fine-tune, the forgetting
matrix, checkpoints); a grown network's task paths are served through
``continual.inference.RoutedInference`` and trained through
``train.trainer.make_train_step`` on the card, with the seven TPU kernels
of that path (three forward, four backward) rewritten by hand in CUDA C++
(``csrc/``). The Scene Router (``models.router``) picks each frame's task
path. ``python -m rag_tpu_torch.cli`` runs an experiment from filename
lists (``data.stereo_dataset``, ``data.manifests``; the native loader of
``runtime.native``) or styled synthetic scenes (``data.synthetic``), with
stage files and resume. The self-supervised (``continual.
self_supervised``) and monocular-depth (``continual.depth_driver``)
variants run through the same driver's hooks. ``parallel`` runs the steps
over a process group, data-parallel or with the matching volumes' H
split over a model axis, and ``search.scene_parallel`` searches every
scene's cell at once. The package imports torch, numpy and PIL, never
jax or rag_tpu.
"""
