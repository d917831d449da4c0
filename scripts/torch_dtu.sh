#!/bin/bash
# All 10 DTU eval scans through the PyTorch port (the twin of scripts/dtu.sh).
#
# Default: one Trainer run per scan, one after the other
# (scripts/torch_pipeline.sh). sharded=1: all scans as one multi-scene run
# (scripts/torch_multi_scene_pipeline.py, the scenes one after the other on
# one card). cpu=1 runs on the CPU.
set -e
SCANS="24 31 40 45 55 59 63 75 83 105"
if [ "${sharded}" = "1" ]; then
    cfgs=""
    for id in $SCANS; do cfgs="$cfgs dtu/scan${id}.yml"; done
    python scripts/torch_multi_scene_pipeline.py -t "${tag:-dtu_sweep}" -c $cfgs \
        ${n_seeds:+--n-seeds $n_seeds} ${resume:+--resume} ${cpu:+--cpu}
else
    for id in $SCANS; do
        tag=${tag}_scan${id} config=dtu/scan${id}.yml ./scripts/torch_pipeline.sh
    done
fi
