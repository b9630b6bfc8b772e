#!/usr/bin/env bash
# Canonical launcher of the port on one NVIDIA GPU: the counterpart of
# run_rag_tpu.sh, with the same hyperparameters (cell: 100ep/bs8/lr.002/
# lr_a.01; op: 100ep/bs6/lr.001/lr_a.01/o_size10; train: 400ep/bs4/lr.001/
# wd.003; 4 scenes; the Scene Router trained after each task).
#
# Run it from the root of the checkout. Without filename lists it runs on
# styled synthetic stereograms. Real data:
#   python -m rag_tpu_torch.data.manifests /data/DrivingStereo filenames
#   scripts/run_rag_tpu_torch.sh --filenames-dir filenames \
#       --checkpoint-dir ckpt --id canonical
# and, after a kill, the same line with --resume. Later flags override
# earlier ones (e.g. --epochs 2 for a quick run).
set -e
python -m rag_tpu_torch.cli \
  --c_epochs 100 --c_batch 8 --c_lr 0.002 --c_lr_a 0.01 \
  --o_epochs 100 --o_batch 6 --o_lr 0.001 --o_lr_a 0.01 --o_size 10 \
  --epochs 400 --batch 4 --lr 0.001 --lamb 0.003 \
  --num-tasks 4 --train-router "$@"
