#!/bin/bash
# Reproduces the shipped henan_512 checkpoint and artifacts end to end:
# henan recon (1200 steps) -> adversarial finetune (600) -> held-out +
# train evals for both phases -> the committed tts-chinese artifact clip
# -> bench lines -> 896x512 batch-4 grad-accum NaN probes.
#
# Idempotent and relaunchable: every stage is guarded by its output, and
# the train stages loop on rc=3 (the trainer's stall-watchdog exit) so a
# stalled run resumes from the last Orbax checkpoint automatically.
# This is the exact script the round-3 run executed (see
# artifacts/README.md for the resulting eval numbers).
cd /root/repo
mkdir -p out
HIMG=checkpoints/henan_synth_frames
HKP='/root/reference/*pinyin_data/henan/keypoints_henan'
AUD=/root/reference/input_audio/henan
log() { echo "[chain $(date +%H:%M:%S)] $*"; }

# ---- Stage 1: henan recon 1200 steps at 896x512 batch 2 ----------------
if ! grep -q '"steps": 1200' checkpoints/henan_512/train_recon.log 2>/dev/null; then
  log "stage 1: henan recon"
  while true; do
    python -u -m text2video.cli train-gan \
      --images "$HIMG" --keypoints "$HKP" \
      --ckpt checkpoints/henan_512 --width 896 --height 512 \
      --source-width 1920 --source-height 1080 \
      --device-data --lambda-adv 0 --lr 5e-4 --steps 1200 \
      --batch-size 2 --clip-len 8 --max-frames 2600 \
      --sample-every 300 --stall-timeout 1200 \
      >> checkpoints/henan_512/train_recon.log 2>&1
    rc=$?
    log "henan recon exited rc=$rc"
    [ $rc -ne 3 ] && break
    log "watchdog resume..."
  done
fi

# snapshot the recon phase for side-by-side eval
if [ ! -d checkpoints/henan_512_recon ]; then
  cp -r checkpoints/henan_512 checkpoints/henan_512_recon
fi

# ---- Stage 2: henan adversarial finetune (600 steps) -------------------
if [ ! -s checkpoints/henan_512/train_adv.log ] || \
   ! grep -q '"steps"' checkpoints/henan_512/train_adv.log; then
  log "stage 2: henan adv"
  while true; do
    python -u -m text2video.cli train-gan \
      --images "$HIMG" --keypoints "$HKP" \
      --ckpt checkpoints/henan_512 --width 896 --height 512 \
      --source-width 1920 --source-height 1080 \
      --device-data --lambda-adv 0.5 --d-lr-scale 0.25 --lr 1e-4 \
      --steps 600 --batch-size 2 --clip-len 8 --max-frames 2600 \
      --sample-every 150 --stall-timeout 1200 \
      >> checkpoints/henan_512/train_adv.log 2>&1
    rc=$?
    log "henan adv exited rc=$rc"
    [ $rc -ne 3 ] && break
    log "watchdog resume..."
  done
fi

# ---- Stage 3: henan evals (recon + adv, holdout + train) ----------------
for ck in henan_512_recon henan_512; do
  for split in holdout train; do
    if [ ! -s out/eval_${ck}_$split.json ]; then
      log "stage 3: eval $ck $split"
      timeout 2400 python tools/eval_gan.py --ckpt checkpoints/$ck \
        --images "$HIMG" --keypoints "$HKP" \
        --width 896 --height 512 --source-width 1920 --source-height 1080 \
        --split $split \
        > out/eval_${ck}_$split.json 2> out/eval_${ck}_$split.err
      log "eval $ck $split: $(cat out/eval_${ck}_$split.json)"
    fi
  done
done

# ---- Stage 4: Mandarin artifact clip ------------------------------------
if ! ls out/render_henan/henan/*.mp4 >/dev/null 2>&1; then
  log "stage 4: render henan tts-chinese clip"
  timeout 3600 python -u -m text2video.cli tts-chinese \
    "正在为您查询合肥的天气情况" henan f \
    --out out/render_henan \
    --aligner-model text2video/data/mandarin_henan.am \
    --gan-checkpoint checkpoints/henan_512 \
    --tts-pool "$AUD/正在为您查询合肥的天.wav" "正在为您查询合肥的天气情况" \
    > out/render_henan.log 2>&1
  log "render rc=$?"
fi

# ---- Stage 5: bench measurements ----------------------------------------
if [ ! -s out/bench_gen.json ]; then
  log "stage 5: bench gen"
  timeout 2400 python bench.py > out/bench_gen.json 2> out/bench_gen.err
  log "bench gen: $(cat out/bench_gen.json)"
fi
if [ ! -s out/bench_e2e512.json ]; then
  log "stage 5b: bench e2e 512x512"
  timeout 3600 python bench.py --mode e2e --load-size 512 \
    > out/bench_e2e512.json 2> out/bench_e2e512.err
  log "bench e2e512: $(cat out/bench_e2e512.json)"
fi

# ---- Stage 6: NaN frontier probes ----------------------------------------
if [ ! -s out/nan_probe_accum2.log ]; then
  timeout 2400 python tools/nan_probe.py --height 512 --width 896 \
    --batch 4 --clip 8 --lambda-adv 0 --no-vgg --l1 10 --grad-accum 2 \
    > out/nan_probe_accum2.log 2>&1
  log "accum2: $(grep 'g_flow\|g_loss' out/nan_probe_accum2.log | tr '\n' ' ')"
fi
if [ ! -s out/nan_probe_accum4.log ]; then
  timeout 2400 python tools/nan_probe.py --height 512 --width 896 \
    --batch 4 --clip 8 --lambda-adv 0 --no-vgg --l1 10 --grad-accum 4 \
    > out/nan_probe_accum4.log 2>&1
  log "accum4: $(grep 'g_flow\|g_loss' out/nan_probe_accum4.log | tr '\n' ' ')"
fi
log "CHAIN DONE"
