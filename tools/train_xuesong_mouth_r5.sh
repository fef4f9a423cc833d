#!/bin/bash
# Round-5 xuesong curriculum with MOUTH-METRIC checkpoint selection
# (VERDICT r4 item 6). Round 4 found the adversarial phase raises
# whole-frame PSNR but LOWERS mouth-crop PSNR on the synthetic-avatar
# targets, and shipped the whole-frame-selected checkpoint anyway. This
# chain (a) anchors the mouth through training with the new --l1-mouth
# term (trainer.py lambda_l1_mouth — extra L1 on the 96 px crop
# tools/eval_gan.py scores), (b) snapshots the adversarial phase every
# 150 steps, and (c) SELECTS the shipped checkpoint on held-out mouth
# PSNR subject to whole-frame non-regression vs the recon baseline.
#
# Idempotent and relaunchable: stages are guarded by their outputs and
# train stages loop on rc=3 (stall-watchdog) to resume from Orbax.
cd /root/repo
mkdir -p out
XIMG=checkpoints/xuesong_synth_frames
XKP='/root/reference/*pinyin_data/xuesong/keypoints_xuesong'
AUD=/root/reference/input_audio/xuesong
POOL_TEXT="中国海油今天六月二日上午发布消息随着最后一条一二英寸海底管线终止封头入海我国最大水深海底管线铺设项目陵水一七二气田海底管线铺设工作首阶段作业顺利完工"
log() { echo "[r5chain $(date +%H:%M:%S)] $*"; }

train_args=(--images "$XIMG" --keypoints "$XKP"
  --ckpt checkpoints/xuesong_512 --width 896 --height 512
  --source-width 1280 --source-height 720
  --device-data --batch-size 2 --clip-len 8 --max-frames 2600
  --l1-mouth 5 --stall-timeout 1200)

# ---- Stage 0: synthetic avatar frames -----------------------------------
if [ ! -d "$XIMG" ] || [ "$(ls "$XIMG" | wc -l)" -lt 2000 ]; then
  log "stage 0: staging synthetic frames"
  python tools/make_synthetic_frames.py --keypoints "$XKP" --out "$XIMG" \
    --width 896 --height 512 --source-width 1280 --source-height 720 \
    --limit 2600 || exit 1
fi

# ---- Stage 1: recon 1200 steps (with the mouth anchor) -------------------
if ! grep -q '"steps": 1200' checkpoints/xuesong_512/train_recon.log 2>/dev/null; then
  log "stage 1: recon"
  mkdir -p checkpoints/xuesong_512
  while true; do
    python -u -m text2video.cli train-gan "${train_args[@]}" \
      --lambda-adv 0 --lr 5e-4 --steps 1200 --sample-every 300 \
      >> checkpoints/xuesong_512/train_recon.log 2>&1
    rc=$?; log "recon rc=$rc"; [ $rc -ne 3 ] && break; log "resume..."
  done
fi
if [ ! -d checkpoints/xuesong_512_recon ]; then
  cp -r checkpoints/xuesong_512 checkpoints/xuesong_512_recon
fi

# ---- Stage 2: adversarial finetune in selectable segments ----------------
# NOTE: --steps is RELATIVE (run N more steps from the resumed
# checkpoint); with save_every=200 the Orbax keeper retains the last 3
# step dirs, so 3 segments of 200 steps give candidates at 1400 / 1600
# / 1800 alongside the 1200-step recon baseline.
for seg in 1400 1600 1800; do
  snap=checkpoints/xuesong_512_adv$seg
  if [ ! -d "$snap" ]; then
    log "stage 2: adv segment to step $seg"
    while true; do
      python -u -m text2video.cli train-gan "${train_args[@]}" \
        --lambda-adv 0.5 --d-lr-scale 0.25 --lr 1e-4 \
        --steps 200 --sample-every 200 \
        >> checkpoints/xuesong_512/train_adv.log 2>&1
      rc=$?; log "adv seg $seg rc=$rc"; [ $rc -ne 3 ] && break; log "resume..."
    done
    mkdir -p "$snap"
    cp checkpoints/xuesong_512/config.json "$snap"/
    cp -r "checkpoints/xuesong_512/step_0000$seg" "$snap"/
  fi
done

# ---- Stage 3: eval every candidate on the holdout ------------------------
for ck in xuesong_512_recon xuesong_512_adv1400 xuesong_512_adv1600 \
          xuesong_512_adv1800; do
  if [ ! -s out/eval_r5_${ck}_holdout.json ]; then
    log "stage 3: eval $ck"
    timeout 2400 python tools/eval_gan.py --ckpt checkpoints/$ck \
      --images "$XIMG" --keypoints "$XKP" \
      --width 896 --height 512 --source-width 1280 --source-height 720 \
      --split holdout \
      > out/eval_r5_${ck}_holdout.json 2> out/eval_r5_${ck}_holdout.err
    log "eval $ck: $(cat out/eval_r5_${ck}_holdout.json)"
  fi
done

# ---- Stage 4: mouth-metric selection ------------------------------------
if [ ! -s out/xuesong_r5_select.json ]; then
  log "stage 4: select on mouth PSNR (whole-frame non-regression)"
  python - <<'PYEOF' | tee out/xuesong_r5_select.json
import json
cands = ["xuesong_512_recon", "xuesong_512_adv1400",
         "xuesong_512_adv1600", "xuesong_512_adv1800"]
rows = {c: json.load(open(f"out/eval_r5_{c}_holdout.json")) for c in cands}
base = rows["xuesong_512_recon"]
best, why = None, None
for c in cands:
    r = rows[c]
    if r["psnr_db"] < base["psnr_db"] - 0.3:
        continue  # whole-frame regression
    if best is None or r["mouth_psnr_db"] > rows[best]["mouth_psnr_db"]:
        best = c
print(json.dumps({"selected": best, "rows": rows}))
PYEOF
  sel=$(python -c "import json;print(json.load(open('out/xuesong_r5_select.json'))['selected'])")
  log "selected: $sel"
  rm -rf checkpoints/xuesong_512_selected
  cp -r checkpoints/$sel checkpoints/xuesong_512_selected
fi

# ---- Stage 5: train-split eval of the winner + artifact clip -------------
sel=$(python -c "import json;print(json.load(open('out/xuesong_r5_select.json'))['selected'])")
if [ ! -s out/eval_r5_selected_train.json ]; then
  timeout 2400 python tools/eval_gan.py --ckpt checkpoints/xuesong_512_selected \
    --images "$XIMG" --keypoints "$XKP" \
    --width 896 --height 512 --source-width 1280 --source-height 720 \
    --split train > out/eval_r5_selected_train.json 2>/dev/null
fi
if ! ls out/render_xuesong_r5/xuesong/*.mp4 >/dev/null 2>&1; then
  log "stage 5: render artifact clip from $sel"
  timeout 3600 python -u -m text2video.cli tts-chinese \
    "中国海油今天上午发布消息" xuesong f \
    --out out/render_xuesong_r5 \
    --aligner-model text2video/data/mandarin_xuesong.am \
    --gan-checkpoint checkpoints/xuesong_512_selected \
    --tts-pool "$AUD/中国海油今天.wav" "$POOL_TEXT" \
    > out/render_xuesong_r5.log 2>&1
  log "render rc=$?"
fi
log "R5 CHAIN DONE"
