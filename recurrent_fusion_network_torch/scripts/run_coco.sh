#!/bin/bash
# End-to-end COCO Karpathy runbook of the PyTorch port: one command from
# mounted data and backbone weights to the evaluated fleet, on one CUDA card
# (prepro -> extract -> XE fleet -> SCST fleet -> single and ensemble eval),
# every stage through the port's CLIs (python -m recurrent_fusion_network_torch.*).
#
# Real run (needs COCO and the backbone weights mounted):
#   COCO_IMAGES=/data/coco/images \
#   KARPATHY_JSON=/data/dataset_coco.json \
#   WEIGHTS_DIR=/data/weights \
#   recurrent_fusion_network_torch/scripts/run_coco.sh
#
#   WEIGHTS_DIR layout (a missing file -> that backbone runs from a random
#   init and the run is a pipeline smoke, not a quality run):
#     resnet101.pth  densenet161.pth          (torchvision state dicts)
#     inception_v3.npz  inception_v4.npz  inception_resnet_v2.npz
#                                            (flat-npz conversions; see
#                                             data/feature_extraction/*.py)
#
# Dry run (no data needed; drives every stage on a generated 8-image corpus
# at the flagship encoder widths; each seed writes a flagship triple per
# boundary, several GB, under checkpoint/):
#   DRY_RUN=1 bash recurrent_fusion_network_torch/scripts/run_coco.sh
#
# Knobs: ID (run id), NUM_SEEDS (default 8; dry 2), DATA_DIR (default data),
# STAGES (comma subset of prepro,features,xe,rl,eval to resume a run),
# FLEET_DEVICES (default 1: the fleet trains seed by seed on one card; a
# value above 1 asks for the multi-device fleet, which is not ported and
# raises, ROADMAP queue 1 M10), RESUME (auto|0|1: a requeued invocation
# continues preempted fleets from their rolling per-seed triples; see the
# requeue block below), PYTHON (the interpreter every stage runs under,
# default python).
set -e
set -o pipefail  # a failed stage fails the run even through `| tee`
cd "$(dirname "$0")/../.."

export PYTHON=${PYTHON:-python}
DRY_RUN=${DRY_RUN:-0}
if [ "$DRY_RUN" = "1" ]; then
  # dry artifacts stay away from the default paths, data and run id alike:
  # checkpoints and logs are keyed by ID, so a later real STAGES=rl run
  # never warm-starts from a dry triple
  DATA_DIR=${DATA_DIR:-data/dryrun}
  ID=${ID:-dryrun}
else
  DATA_DIR=${DATA_DIR:-data}
  ID=${ID:-rfnet}
fi
FEATURES_ROOT=${FEATURES_ROOT:-${DATA_DIR}/features}
STAGES=${STAGES:-prepro,features,xe,rl,eval}
export FLEET_DEVICES=${FLEET_DEVICES:-1}
if [ "$DRY_RUN" = "1" ]; then
  NUM_SEEDS=${NUM_SEEDS:-2}
  ENSEMBLE_EVAL_ARGS=()
  VARIANTS=original        # dry training turns flip / crop augmentation off
  EXTRACT_ARGS=(--batch_size 2)
  TRAIN_COMMON=(--batch_size 2 --seq_per_img 5 --use_flip 0 --use_crop 0
                --max_iterations 4 --save_checkpoint_every 2
                --val_images_use 4 --losses_log_every 1)
  EVAL_ARGS=(--val_images_use 4)
else
  NUM_SEEDS=${NUM_SEEDS:-8}
  VARIANTS=all
  EXTRACT_ARGS=(--batch_size 16)
  TRAIN_COMMON=()
  EVAL_ARGS=()
  : "${COCO_IMAGES:?set COCO_IMAGES (COCO image dir) or DRY_RUN=1}"
  : "${KARPATHY_JSON:?set KARPATHY_JSON (dataset_coco.json) or DRY_RUN=1}"
  WEIGHTS_DIR=${WEIGHTS_DIR:-}
  # the fleet holds one seed's state on the card at a time; the ensemble
  # eval holds every member's weights at once, so it reads them in bf16
  # (the score math stays f32)
  ENSEMBLE_EVAL_ARGS=(--dtype bfloat16)
fi

has_stage() { case ",$STAGES," in *",$1,"*) return 0;; *) return 1;; esac; }

mkdir -p "$DATA_DIR" log checkpoint

# ---------------------------------------------------------------- dry corpus
if [ "$DRY_RUN" = "1" ]; then
  COCO_IMAGES=${DATA_DIR}/dry_images
  KARPATHY_JSON=${DATA_DIR}/dry_dataset_coco.json
  WEIGHTS_DIR=""
  "$PYTHON" - "$COCO_IMAGES" "$KARPATHY_JSON" <<'PYEOF'
import json, os, sys
import numpy as np
from PIL import Image

images_dir, karpathy_json = sys.argv[1], sys.argv[2]
os.makedirs(images_dir, exist_ok=True)
rng = np.random.RandomState(0)
nouns = ["dog", "cat", "man", "woman", "car", "bench"]
verbs = ["sitting on", "standing near", "running past"]
images = []
for i in range(8):
    name = f"COCO_dry_{i:012d}.jpg"
    Image.fromarray(rng.randint(0, 255, (64, 64, 3), np.uint8)).save(
        os.path.join(images_dir, name))
    sents = []
    for _ in range(5):
        s = (f"a {nouns[rng.randint(len(nouns))]} "
             f"{verbs[rng.randint(len(verbs))]} "
             f"a {nouns[rng.randint(len(nouns))]}")
        sents.append({"tokens": s.split(), "raw": s})
    split = ["train", "train", "train", "train", "train", "val",
             "test", "restval"][i]
    images.append({"filename": name, "filepath": "dry", "cocoid": i,
                   "split": split, "sentences": sents})
with open(karpathy_json, "w") as f:
    json.dump({"images": images, "dataset": "coco"}, f)
print(f"dry corpus: 8 images -> {images_dir}, {karpathy_json}")
PYEOF
fi

# ------------------------------------------------------------------- prepro
if has_stage prepro; then
  echo "== stage prepro: labels + top-words + train-idf ngrams"
  "$PYTHON" -m recurrent_fusion_network_torch.data.prepro_labels \
    --input_json "$KARPATHY_JSON" \
    --output_json "$DATA_DIR/cocotalk.json" \
    --output_labels "$DATA_DIR/cocotalk_label.npz" \
    --output_top_words "$DATA_DIR/vocab_train.pkl" \
    $([ "$DRY_RUN" = "1" ] && echo "--word_count_threshold 1")
  # --karpathy_json: df over the untruncated sentence tokens, the
  # reference script's source (the label matrix truncates at 16)
  "$PYTHON" -m recurrent_fusion_network_torch.data.prepro_ngrams \
    --input_json "$DATA_DIR/cocotalk.json" \
    --input_labels "$DATA_DIR/cocotalk_label.npz" \
    --karpathy_json "$KARPATHY_JSON" \
    --output_pkl "$DATA_DIR/coco-train-idxs.p"
fi

# ----------------------------------------------------------------- features
# registry_name  arch  att_grid  image_size  weights_file
# image sizes give each arch its native final grid (registry att_num):
# resnet 448->14x14, inception* 299->8x8, densenet 224->7x7
ENCODERS=(
  "resnet               resnet101            14  448  resnet101.pth"
  "inception_v4         inception_v4          8  299  inception_v4.npz"
  "inception_v3         inception_v3          8  299  inception_v3.npz"
  "densenet             densenet161           7  224  densenet161.pth"
  "inception_resnet_v2  inception_resnet_v2   8  299  inception_resnet_v2.npz"
)
if has_stage features; then
  for row in "${ENCODERS[@]}"; do
    read -r name arch att imsz wfile <<<"$row"
    out="$FEATURES_ROOT/$name/packed"
    wflag=()
    if [ -n "$WEIGHTS_DIR" ] && [ -f "$WEIGHTS_DIR/$wfile" ]; then
      wflag=(--torch_weights "$WEIGHTS_DIR/$wfile")
    else
      echo "WARNING: no weights for $arch ($wfile) - random init," \
           "features are pipeline-smoke only"
    fi
    echo "== stage features: $arch -> $out (att ${att}x${att}, ${imsz}px)"
    "$PYTHON" -m recurrent_fusion_network_torch.data.feature_extraction.extract \
      --images_dir "$COCO_IMAGES" --output_dir "$out" \
      --arch "$arch" --att_size "$att" --image_size "$imsz" \
      --variants "$VARIANTS" \
      "${wflag[@]}" "${EXTRACT_ARGS[@]}"
  done
fi

DATA_FLAGS=(
  --input_json "$DATA_DIR/cocotalk.json"
  --input_label_h5 "$DATA_DIR/cocotalk_label.npz"
  --top_words_path "$DATA_DIR/vocab_train.pkl"
  --data_root "$FEATURES_ROOT"
)

# ------------------------------------------------------- preemption requeue
# RESUME=auto (default): re-invoking the same command after a preemption
# (the training loops write their rolling triples on SIGTERM) continues each
# fleet from its rolling per-seed triples. RESUME=0 always starts afresh;
# RESUME=1 requires the rolling files and fails fast. The features stage
# resumes on its own: the extractor keeps a progress marker per encoder and
# its default --resume 1 continues at the recorded row. The port writes
# pickle triples only (orbax checkpoints are ROADMAP queue 1 M11).
RESUME=${RESUME:-auto}
XE_RESUME_ARGS=()
RL_RESUME_ARGS=()
if [ "$RESUME" != "0" ]; then
  if [ -f "checkpoint/model_${ID}_0.pkl" ]; then
    XE_RESUME_ARGS=(--start_from checkpoint --load_model_id "$ID")
    echo "resume: xe fleet continues from checkpoint/model_${ID}_*"
  elif [ "$RESUME" = "1" ] && has_stage xe; then
    echo "RESUME=1 but no rolling XE checkpoints for id $ID" >&2
    exit 1
  fi
  if [ -f "checkpoint/rl_model_${ID}_0.pkl" ]; then
    # the rl script's default --start_from is the XE warm start; adding
    # --rl_resume 1 switches it to resuming this SCST run's rl_ files
    RL_RESUME_ARGS=(--rl_resume 1)
    echo "resume: rl fleet continues from checkpoint/rl_model_${ID}_*"
  fi
fi

SCRIPTS=recurrent_fusion_network_torch/scripts

# ----------------------------------------------------------------------- xe
if has_stage xe; then
  echo "== stage xe: ${NUM_SEEDS}-seed XE fleet"
  ID=$ID NUM_SEEDS=$NUM_SEEDS FLEET_MODE=fleet \
    bash "$SCRIPTS/train_recurrent_fusion_model.sh" \
    "${DATA_FLAGS[@]}" "${TRAIN_COMMON[@]}" --language_eval 1 \
    "${XE_RESUME_ARGS[@]}"
fi

# ----------------------------------------------------------------------- rl
if has_stage rl; then
  echo "== stage rl: ${NUM_SEEDS}-seed SCST fleet (warm start from XE best)"
  ID=$ID NUM_SEEDS=$NUM_SEEDS FLEET_MODE=fleet \
    bash "$SCRIPTS/train_recurrent_fusion_model_rl.sh" \
    --cider_df "$DATA_DIR/coco-train-idxs.p" \
    "${DATA_FLAGS[@]}" "${TRAIN_COMMON[@]}" --language_eval 1 \
    "${RL_RESUME_ARGS[@]}"
fi

# --------------------------------------------------------------------- eval
if has_stage eval; then
  echo "== stage eval: single rank-0 +RL model on test"
  "$PYTHON" -m recurrent_fusion_network_torch.eval --model_path checkpoint \
    --load_model_id "$ID" \
    --rl_prefix 1 --eval_split test --beam_size 3 --language_eval 1 \
    "${DATA_FLAGS[@]}" "${EVAL_ARGS[@]}" \
    2>&1 | tee "log/eval_single_${ID}"
  echo "== stage eval: ${NUM_SEEDS}-member mean-logit ensemble on test"
  "$PYTHON" -m recurrent_fusion_network_torch.eval_ensemble --model_path checkpoint \
    --model_ids "$ID" --n_ranks "$NUM_SEEDS" --rl_prefix 1 \
    --eval_split test --beam_size 3 --language_eval 1 \
    "${DATA_FLAGS[@]}" "${EVAL_ARGS[@]}" "${ENSEMBLE_EVAL_ARGS[@]}" \
    2>&1 | tee "log/eval_ensemble_${ID}"
fi

echo "run_coco.sh: all requested stages (${STAGES}) completed"
