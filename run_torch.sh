#!/usr/bin/env bash
# Full SM3 reproduction with the PyTorch port (sm3x_torch) on one NVIDIA GPU:
# the twin of run.sh over tools/*_torch.py, with .pth checkpoints.
#
# All four stages with the reference hyperparameters. --world-size 2
# reproduces the reference's per-GPU contrastive-negative pools (it trained
# SSL on two GPUs); the port runs on one device. DEVICE=cpu runs the same
# chain on the CPU. STAGES picks the stages to run, in the order given
# (default: the four of run.sh); stage1_control is stage1_eval's recipe on
# randomly initialised encoders, the control a probe of SSL features is
# read against.
set -euo pipefail

DATA="${DATA:-./data/7PC}"
DEVICE="${DEVICE:-cuda}"
STATS=(--mean 0.7833 0.6712 0.6026 --std 0.2139 0.2472 0.2571)
# rolling checkpoint.pth cadence (crash protection only; ckp_N.pth and
# best_eval.pth are unaffected); resume a stage with --resume-path
CKPT_FREQ="${CKPT_FREQ:-50}"
BASE=(-a resnet50 --data-name SevenPCBaseDataset --data-path "$DATA"
      --img-sz 224 224 --num-labels 8 --ckpt-freq "$CKPT_FREQ"
      --device "$DEVICE" "${STATS[@]}")
SSL_LOG="${SSL_LOG:-./logs/backbone}"
MLC_LOG="${MLC_LOG:-./logs/mlc_train}"

stage1_ssl() {
    python tools/backbone_train_torch.py "${BASE[@]}" \
        --arch-version v32 --proj-dim 128 --temperature 0.1 \
        --epochs 400 -b 96 -lr 1e-6 --world-size 2 --amp \
        --log-path "$SSL_LOG" --proj-name sm3_r50_backbone
}

stage1_eval() {  # linear eval of selected SSL checkpoints
    local epoch
    for epoch in 49 99 149 199 249 299 349 399; do
        python tools/backbone_eval_torch.py "${BASE[@]}" \
            --epochs 50 -b 128 -lr 1e-3 --finetune fc --amp \
            --pretrain-path "$SSL_LOG/ckp_${epoch}.pth" \
            --log-path "$SSL_LOG/test_${epoch}" \
            --proj-name sm3_r50_backbone_eval
    done
}

stage1_control() {  # linear eval of random-init encoders (no pretrain)
    python tools/backbone_eval_torch.py "${BASE[@]}" \
        --epochs 50 -b 128 -lr 1e-3 --finetune fc --amp \
        --log-path "$SSL_LOG/control" \
        --proj-name sm3_r50_backbone_eval
}

stage2_mlc() {
    python tools/mlc_train_torch.py "${BASE[@]}" \
        --epochs 150 -b 256 -lr 1e-4 --temperature 1 \
        --mlc-proj v4 --mlc-proj-dim 512 \
        --num-heads 1 --sa-dim-ff 128 --sa-dropout 0.1 \
        --extractor-proj-dim 128 \
        --extractor-weights "$SSL_LOG/ckp_399.pth" \
        --log-path "$MLC_LOG" --proj-name SM3_MLC_train_v4_r50
}

stage2_eval() {  # supervised finetune/eval of selected MLC checkpoints
    local epoch
    for epoch in 49 99 149; do
        python tools/mlc_eval_torch.py "${BASE[@]}" \
            --epochs 100 -b 128 -lr 1e-3 --finetune projector \
            --mlc-proj v4 --mlc-proj-dim 512 \
            --num-heads 1 --sa-dim-ff 128 --sa-dropout 0.1 \
            --extractor-proj-dim 128 \
            --pretrain-path "$MLC_LOG/ckp_${epoch}.pth" \
            --log-path "$MLC_LOG/test_${epoch}" \
            --proj-name SM3_MLC_eval_v4_r50
    done
}

# per-stage wall-clock markers
stamp() { echo "=== $1 $(date +%s) $(date -u +%FT%TZ) ==="; }

STAGES="${STAGES:-stage1_ssl stage1_eval stage2_mlc stage2_eval}"
for stage in $STAGES; do
    case "$stage" in
        stage1_ssl|stage1_eval|stage1_control|stage2_mlc|stage2_eval) ;;
        *) echo "unknown stage $stage" >&2; exit 2 ;;
    esac
    stamp "$stage:start"; "$stage"; stamp "$stage:end"
done
