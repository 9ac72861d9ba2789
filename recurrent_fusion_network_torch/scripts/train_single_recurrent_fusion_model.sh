#!/bin/bash
# Single-seed RFNet XE training of the PyTorch port (reference
# train_single_recurrent_fusion_model.sh): the fleet script at one seed.
set -e
set -o pipefail
NUM_SEEDS=1 ID=${ID:-rfnet_single} exec bash "$(dirname "$0")/train_recurrent_fusion_model.sh" "$@"
