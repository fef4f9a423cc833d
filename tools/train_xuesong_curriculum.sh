#!/bin/bash
# Reproduces the xuesong checkpoint and artifacts end to end — the
# reference's actual second shipped identity (reference README.md:20-26,
# voice per=3 at tts_request.py:33-35): recon (1200 steps) -> adversarial
# finetune (600) -> held-out + train evals for both phases -> a committed
# tts-chinese artifact clip. Mirrors tools/train_henan_curriculum.sh; the
# xuesong canvas is 1280x720 (config.py PersonProfile), so loadSize-512
# training runs at 896x512 from the staged synthetic frames.
#
# Idempotent and relaunchable: every stage is guarded by its output, and
# the train stages loop on rc=3 (the trainer's stall-watchdog exit) so a
# stalled run resumes from the last Orbax checkpoint automatically.
cd /root/repo
mkdir -p out
XIMG=checkpoints/xuesong_synth_frames
XKP='/root/reference/*pinyin_data/xuesong/keypoints_xuesong'
AUD=/root/reference/input_audio/xuesong
# Full transcript of the 16.85s pool wav, digits as spoken (verified
# against input_timestamp/xuesong/中国海油今天.txt: 72 syllables,
# "12"="yi er", "17-2" spoken as three syllables).
POOL_TEXT="中国海油今天六月二日上午发布消息随着最后一条一二英寸海底管线终止封头入海我国最大水深海底管线铺设项目陵水一七二气田海底管线铺设工作首阶段作业顺利完工"
log() { echo "[chain $(date +%H:%M:%S)] $*"; }

# ---- Stage 1: xuesong recon 1200 steps at 896x512 batch 2 ---------------
if ! grep -q '"steps": 1200' checkpoints/xuesong_512/train_recon.log 2>/dev/null; then
  log "stage 1: xuesong recon"
  mkdir -p checkpoints/xuesong_512
  while true; do
    python -u -m text2video.cli train-gan \
      --images "$XIMG" --keypoints "$XKP" \
      --ckpt checkpoints/xuesong_512 --width 896 --height 512 \
      --source-width 1280 --source-height 720 \
      --device-data --lambda-adv 0 --lr 5e-4 --steps 1200 \
      --batch-size 2 --clip-len 8 --max-frames 2600 \
      --sample-every 300 --stall-timeout 1200 \
      >> checkpoints/xuesong_512/train_recon.log 2>&1
    rc=$?
    log "xuesong recon exited rc=$rc"
    [ $rc -ne 3 ] && break
    log "watchdog resume..."
  done
fi

# snapshot the recon phase for side-by-side eval
if [ ! -d checkpoints/xuesong_512_recon ]; then
  cp -r checkpoints/xuesong_512 checkpoints/xuesong_512_recon
fi

# ---- Stage 2: xuesong adversarial finetune (600 steps) ------------------
if [ ! -s checkpoints/xuesong_512/train_adv.log ] || \
   ! grep -q '"steps"' checkpoints/xuesong_512/train_adv.log; then
  log "stage 2: xuesong adv"
  while true; do
    python -u -m text2video.cli train-gan \
      --images "$XIMG" --keypoints "$XKP" \
      --ckpt checkpoints/xuesong_512 --width 896 --height 512 \
      --source-width 1280 --source-height 720 \
      --device-data --lambda-adv 0.5 --d-lr-scale 0.25 --lr 1e-4 \
      --steps 600 --batch-size 2 --clip-len 8 --max-frames 2600 \
      --sample-every 150 --stall-timeout 1200 \
      >> checkpoints/xuesong_512/train_adv.log 2>&1
    rc=$?
    log "xuesong adv exited rc=$rc"
    [ $rc -ne 3 ] && break
    log "watchdog resume..."
  done
fi

# ---- Stage 3: xuesong evals (recon + adv, holdout + train) ---------------
for ck in xuesong_512_recon xuesong_512; do
  for split in holdout train; do
    if [ ! -s out/eval_${ck}_$split.json ]; then
      log "stage 3: eval $ck $split"
      timeout 2400 python tools/eval_gan.py --ckpt checkpoints/$ck \
        --images "$XIMG" --keypoints "$XKP" \
        --width 896 --height 512 --source-width 1280 --source-height 720 \
        --split $split \
        > out/eval_${ck}_$split.json 2> out/eval_${ck}_$split.err
      log "eval $ck $split: $(cat out/eval_${ck}_$split.json)"
    fi
  done
done

# ---- Stage 4: xuesong artifact clip --------------------------------------
if ! ls out/render_xuesong/xuesong/*.mp4 >/dev/null 2>&1; then
  log "stage 4: render xuesong tts-chinese clip"
  timeout 3600 python -u -m text2video.cli tts-chinese \
    "中国海油今天上午发布消息" xuesong f \
    --out out/render_xuesong \
    --aligner-model text2video/data/mandarin_xuesong.am \
    --gan-checkpoint checkpoints/xuesong_512 \
    --tts-pool "$AUD/中国海油今天.wav" "$POOL_TEXT" \
    > out/render_xuesong.log 2>&1
  log "render rc=$?"
fi
log "CHAIN DONE"
