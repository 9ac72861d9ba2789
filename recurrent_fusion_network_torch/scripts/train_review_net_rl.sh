#!/bin/bash
# ReviewNet SCST fine-tune of the PyTorch port, on the CUDA card, from the
# XE best triple (reference train_review_net_rl.sh; the JAX package's
# scripts/train_review_net_rl.sh, with the same variables and flags). Run
# from the repo root; PYTHON names the interpreter (default python).
set -e
set -o pipefail
PYTHON=${PYTHON:-python}
ID=${ID:-review_net}
FEATURE=${FEATURE:-inception_v3}
mkdir -p log checkpoint
"$PYTHON" -m recurrent_fusion_network_torch.main_rl \
  --caption_model review_net --feature_type ${FEATURE} \
  --id ${ID} --seed ${SEED:-1} \
  --start_from checkpoint --load_model_id ${ID} --load_lr 1 \
  --batch_size 10 --seq_per_img 5 \
  --optim adam --optim_rl_lr 5e-5 \
  --cider_weight 1.0 --entropy_reg 0.01 \
  --save_checkpoint_every 5000 --val_images_use 5000 \
  "$@" 2>&1 | tee log/log_rl_${ID}
