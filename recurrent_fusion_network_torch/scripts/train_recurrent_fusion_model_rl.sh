#!/bin/bash
# Multi-seed RFNet SCST fine-tune of the PyTorch port, on one CUDA card,
# warm-started from each seed's XE best triple (reference
# train_recurrent_fusion_model_rl.sh:16-36). FLEET_MODE=fleet (default):
# one process fine-tunes the N seeds seed by seed (--n_seeds), seed r from
# the rank-r XE best triple. FLEET_MODE=loop: one process per seed. Run from
# the repo root; PYTHON names the interpreter (default python).
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
  --optim adam --optim_rl_lr 5e-5 --optim_rl_lr_ratio 2.0
  --cider_weight 1.0 --entropy_reg 0.01
  --save_checkpoint_every 5000 --val_images_use 5000
  --num_eval_no_improve 20
)

if [ "$FLEET_MODE" = "loop" ]; then
  for ((SEED=1; SEED<=NUM_SEEDS; SEED++)); do
    "$PYTHON" -m recurrent_fusion_network_torch.main_rl \
      --id ${ID}_seed${SEED} --seed ${SEED} \
      --start_from checkpoint --load_model_id ${ID}_seed${SEED} --load_lr 1 \
      "${COMMON_ARGS[@]}" \
      "$@" 2>&1 | tee log/log_rl_${ID}_seed${SEED}
  done
else
  # FLEET_DEVICES above 1: not ported, --num_dp_devices raises (M10)
  "$PYTHON" -m recurrent_fusion_network_torch.main_rl \
    --id ${ID} --seed 1 --n_seeds ${NUM_SEEDS} \
    --num_dp_devices ${FLEET_DEVICES:-1} \
    --start_from checkpoint --load_model_id ${ID} --load_lr 1 \
    "${COMMON_ARGS[@]}" \
    "$@" 2>&1 | tee log/log_rl_${ID}_fleet
fi
