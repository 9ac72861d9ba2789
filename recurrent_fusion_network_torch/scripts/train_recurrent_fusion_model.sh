#!/bin/bash
# Multi-seed RFNet XE training fleet of the PyTorch port, on one CUDA card.
# Counterpart of the reference's train_recurrent_fusion_model.sh (one job
# per GPU via CUDA_VISIBLE_DEVICES, :7-30) and of scripts/ of the JAX
# package. FLEET_MODE=fleet (default): one process trains the N seeds
# seed by seed (--n_seeds); seed r's triples land under rank r and equal
# the solo run of rank r. FLEET_MODE=loop: one process per seed. Canonical
# hyperparameters from the reference script (:15-29). Run from the repo
# root; PYTHON names the interpreter (default python).
set -e
set -o pipefail
PYTHON=${PYTHON:-python}
ID=${ID:-rfnet}
NUM_SEEDS=${NUM_SEEDS:-8}
FLEET_MODE=${FLEET_MODE:-fleet}
mkdir -p log checkpoint

# PARITY=1 pins the strict reference architecture (untied attention keys);
# the default is the tied-keys profile
COMMON_ARGS=(
  --reference_parity ${PARITY:-0}
  --caption_model recurrent_fusion_model --feature_type feat_array
  --batch_size 10 --seq_per_img 5
  --optim adam --optim_lr 5e-4
  --learning_rate_decay_start 1 --learning_rate_decay_every 3
  --learning_rate_decay_rate 0.8
  --use_flip 1 --use_crop 1
  --use_label_smoothing 1 --label_smoothing_epsilon 0.1
  --drop_prob_lm 0.3 --drop_prob_reason 0.3 --drop_prob_fusion 0.3
  --save_checkpoint_every 5000 --val_images_use 5000
  --num_eval_no_improve 20
)

if [ "$FLEET_MODE" = "loop" ]; then
  for ((SEED=1; SEED<=NUM_SEEDS; SEED++)); do
    "$PYTHON" -m recurrent_fusion_network_torch.main \
      --id ${ID}_seed${SEED} --seed ${SEED} \
      "${COMMON_ARGS[@]}" \
      "$@" 2>&1 | tee log/log_${ID}_seed${SEED}
  done
else
  # FLEET_DEVICES above 1 asks for the fleet over devices: not ported,
  # --num_dp_devices raises (ROADMAP queue 1 M10)
  "$PYTHON" -m recurrent_fusion_network_torch.main \
    --id ${ID} --seed 1 --n_seeds ${NUM_SEEDS} \
    --num_dp_devices ${FLEET_DEVICES:-1} \
    "${COMMON_ARGS[@]}" \
    "$@" 2>&1 | tee log/log_${ID}_fleet
fi
