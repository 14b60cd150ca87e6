#!/bin/bash
# Fault-tolerant launcher of the PyTorch trainer (the twin of train.sh). On a
# crash it restarts train_torch.py and resumes from the newest checkpoint,
# <results>/*/checkpoints/<7 digits>.pt, through --ckpt; otherwise it loops,
# as train.sh does (stop it with Ctrl-C).
#
# Usage: ./train_torch.sh <data-path> [extra train_torch.py flags...]
set -u

DATA_PATH="${1:?usage: ./train_torch.sh <data-path> [flags...]}"
shift || true
RESULTS_DIR="${RESULTS_DIR:-results}"
TRAIN="$(cd "$(dirname "$0")" && pwd)/train_torch.py"
mkdir -p logs

latest_ckpt() {
    # newest checkpoint file across all experiments
    ls -d "${RESULTS_DIR}"/*/checkpoints/[0-9][0-9][0-9][0-9][0-9][0-9][0-9].pt 2>/dev/null | sort | tail -n 1
}

while true; do
    CKPT="$(latest_ckpt)"
    if [ -n "${CKPT}" ]; then
        echo "Resuming from ${CKPT}"
        python "${TRAIN}" --data-path "${DATA_PATH}" --results-dir "${RESULTS_DIR}" \
            --ckpt "${CKPT}" "$@" 2>&1 | tee -a logs/train.log
    else
        python "${TRAIN}" --data-path "${DATA_PATH}" --results-dir "${RESULTS_DIR}" \
            "$@" 2>&1 | tee -a logs/train.log
    fi
    echo "train_torch.py exited (${PIPESTATUS[0]}); restarting in 1s..." | tee -a logs/train.log
    sleep 1
done
