#!/bin/bash
# Multi-checkpoint ensemble evaluation of the PyTorch port, on the CUDA card
# (reference eval_ensemble.sh; the JAX package's scripts/eval_ensemble.sh,
# with the same variables and flags); pass the seed ids via MODEL_IDS (comma
# separated). Run from the repo root; PYTHON names the interpreter (default
# python).
set -e
set -o pipefail
PYTHON=${PYTHON:-python}
"$PYTHON" -m recurrent_fusion_network_torch.eval_ensemble \
  --model_path checkpoint \
  --model_ids ${MODEL_IDS:-rfnet_seed1,rfnet_seed2,rfnet_seed3,rfnet_seed4} \
  --rl_prefix ${RL:-1} \
  --eval_split ${SPLIT:-test} --beam_size ${BEAM:-3} --language_eval 1 \
  --eval_flip_ensemble ${FLIP:-0} \
  "$@"
