#!/bin/bash
# Single-model beam-search evaluation of the PyTorch port, on the CUDA card
# (reference eval_single.sh; the JAX package's scripts/eval_single.sh, with
# the same variables and flags). Run from the repo root; PYTHON names the
# interpreter (default python).
set -e
set -o pipefail
PYTHON=${PYTHON:-python}
"$PYTHON" -m recurrent_fusion_network_torch.eval \
  --model_path checkpoint --load_model_id ${ID:-rfnet_seed1} \
  --eval_split ${SPLIT:-test} --beam_size ${BEAM:-3} --language_eval 1 \
  "$@"
