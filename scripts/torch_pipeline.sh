#!/bin/bash
# Single-run pipeline of the PyTorch port (the twin of scripts/pipeline.sh):
#   config=<path under configs/> tag=<run tag> ./scripts/torch_pipeline.sh
# Runs on the card; cpu=1 runs on the CPU. default=<yml> names a default
# config to merge under the run's.
set -e
if ! [[ ${tag:0:1} =~ ^[0-9] ]]; then
    run_tag="$(date +"%m%d")_$tag"
else
    run_tag=$tag
fi
python -m dbw_torch.train.trainer --tag "$run_tag" --config "$config" \
    ${default:+--default "$default"} ${cpu:+--cpu}
