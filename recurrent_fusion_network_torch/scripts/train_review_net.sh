#!/bin/bash
# ReviewNet XE training of the PyTorch port on a single encoder, on the CUDA
# card (reference train_review_net.sh; the JAX package's
# scripts/train_review_net.sh, with the same variables and flags). Run from
# the repo root; PYTHON names the interpreter (default python).
set -e
set -o pipefail
PYTHON=${PYTHON:-python}
ID=${ID:-review_net}
FEATURE=${FEATURE:-inception_v3}
mkdir -p log checkpoint
"$PYTHON" -m recurrent_fusion_network_torch.main \
  --caption_model review_net --feature_type ${FEATURE} \
  --id ${ID} --seed ${SEED:-1} \
  --batch_size 10 --seq_per_img 5 \
  --optim adam --optim_lr 5e-4 \
  --learning_rate_decay_start 1 --learning_rate_decay_every 3 \
  --learning_rate_decay_rate 0.8 \
  --drop_prob_lm 0.3 --drop_prob_reason 0.3 \
  --save_checkpoint_every 5000 --val_images_use 5000 \
  --num_eval_no_improve 20 \
  "$@" 2>&1 | tee log/log_${ID}
