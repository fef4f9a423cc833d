#!/bin/bash
# Continuation v2 (tools/train_henan_mouth_r5.sh tail): waits for the
# in-flight recon trainer to exit (it overshoots to step 1500 — the
# stall-watchdog resume re-applied the RELATIVE --steps 1200), then one
# 600-step adversarial run; the Orbax keeper (save_every=200,
# keep_last=3) retains the last three step dirs as selection
# candidates. All step numbers are discovered, not hardcoded.
cd /root/repo
HIMG=checkpoints/henan_synth_frames
HKP='/root/reference/*pinyin_data/henan/keypoints_henan'
AUD=/root/reference/input_audio/henan
log() { echo "[henan-r5b $(date +%H:%M:%S)] $*"; }

# Anchored ps check: a plain pgrep -f self-matched the launcher shell
# whose cmdline embeds this script's text (the exact failure mode
# CLAUDE.md warns about); the bracket breaks the self-match.
while ps -eo cmd | grep -qE "^python -u -m text2video[.]cli train-gan"; do
  sleep 60
done
log "recon trainer exited"
last_recon=$(ls checkpoints/henan_512 | grep -oE 'step_[0-9]+' | sort | tail -1)
log "recon baseline: $last_recon"
if [ ! -d checkpoints/henan_512_recon ]; then
  mkdir -p checkpoints/henan_512_recon
  cp checkpoints/henan_512/config.json checkpoints/henan_512_recon/
  cp -r "checkpoints/henan_512/$last_recon" checkpoints/henan_512_recon/
fi

if [ ! -s out/henan_r5_evals.json ]; then
  if [ ! -f /tmp/henan_adv_done ]; then
    log "stage 2: adv 600 steps"
    while true; do
      python -u -m text2video.cli train-gan \
        --images "$HIMG" --keypoints "$HKP" \
        --ckpt checkpoints/henan_512 --width 896 --height 512 \
        --source-width 1920 --source-height 1080 \
        --device-data --batch-size 2 --clip-len 8 --max-frames 2600 \
        --l1-mouth 5 --stall-timeout 1200 \
        --lambda-adv 0.5 --d-lr-scale 0.25 --lr 1e-4 \
        --steps 600 --sample-every 200 \
        >> checkpoints/henan_512/train_adv.log 2>&1
      rc=$?; log "adv rc=$rc"; [ $rc -ne 3 ] && break; log "resume..."
    done
    touch /tmp/henan_adv_done
  fi
  cands="checkpoints/henan_512_recon"
  for d in $(ls -d checkpoints/henan_512/step_* | sort | tail -3); do
    seg=$(basename "$d" | grep -oE '[0-9]+$' | sed 's/^0*//')
    snap=checkpoints/henan_512_adv$seg
    if [ ! -d "$snap" ]; then
      mkdir -p "$snap"
      cp checkpoints/henan_512/config.json "$snap"/
      cp -r "$d" "$snap"/
    fi
    cands="$cands $snap"
  done
  log "stage 3: eval sweep over: $cands"
  timeout 3600 python tools/eval_gan_many.py \
    --ckpts $cands \
    --out-prefix out/eval_r5_ \
    --images "$HIMG" --keypoints "$HKP" \
    --width 896 --height 512 --source-width 1920 --source-height 1080 \
    --split holdout > out/henan_r5_evals.json 2> out/henan_r5_evals.err
  log "evals: $(cat out/henan_r5_evals.json)"
fi

if [ ! -s out/henan_r5_select.json ]; then
  python - <<'PYEOF' | tee out/henan_r5_select.json
import json
rows = [json.loads(l) for l in open("out/henan_r5_evals.json") if l.strip()]
base = rows[0]  # recon first
best = None
for r in rows:
    if r["psnr_db"] < base["psnr_db"] - 0.3:
        continue
    if best is None or r["mouth_psnr_db"] > best["mouth_psnr_db"]:
        best = r
print(json.dumps({"selected": best["ckpt"], "rows": rows}))
PYEOF
  sel=$(python -c "import json;print(json.load(open('out/henan_r5_select.json'))['selected'])")
  log "selected: $sel"
  rm -rf checkpoints/henan_512_selected
  cp -r "$sel" checkpoints/henan_512_selected
fi

if ! ls out/render_henan_r5/henan/*.mp4 >/dev/null 2>&1; then
  log "stage 4: render clip"
  timeout 3600 python -u -m text2video.cli tts-chinese \
    "正在为您查询合肥的天气情况" henan f \
    --out out/render_henan_r5 \
    --aligner-model text2video/data/mandarin_henan.am \
    --gan-checkpoint checkpoints/henan_512_selected \
    --tts-pool "$AUD/正在为您查询合肥的天.wav" "正在为您查询合肥的天气情况" \
    > out/render_henan_r5.log 2>&1
  log "render rc=$?"
fi
log "HENAN R5B DONE"
