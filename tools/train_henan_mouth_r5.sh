#!/bin/bash
# Round-5 henan curriculum with the mouth-crop L1 anchor and
# mouth-metric checkpoint selection — the henan half of VERDICT r4
# item 6 (same recipe as tools/train_xuesong_mouth_r5.sh; see that
# script's header). NOTE: --steps is RELATIVE (run N more steps).
cd /root/repo
mkdir -p out
HIMG=checkpoints/henan_synth_frames
HKP='/root/reference/*pinyin_data/henan/keypoints_henan'
AUD=/root/reference/input_audio/henan
log() { echo "[henan-r5 $(date +%H:%M:%S)] $*"; }

train_args=(--images "$HIMG" --keypoints "$HKP"
  --ckpt checkpoints/henan_512 --width 896 --height 512
  --source-width 1920 --source-height 1080
  --device-data --batch-size 2 --clip-len 8 --max-frames 2600
  --l1-mouth 5 --stall-timeout 1200)

# ---- Stage 0: synthetic avatar frames -----------------------------------
if [ ! -d "$HIMG" ] || [ "$(ls "$HIMG" | wc -l)" -lt 2000 ]; then
  log "stage 0: staging synthetic frames"
  python tools/make_synthetic_frames.py --keypoints "$HKP" --out "$HIMG" \
    --width 896 --height 512 --source-width 1920 --source-height 1080 \
    --limit 2600 || exit 1
fi

# ---- Stage 1: recon 1200 steps (with the mouth anchor) -------------------
if ! grep -q '"steps": 1200' checkpoints/henan_512/train_recon.log 2>/dev/null; then
  log "stage 1: recon"
  mkdir -p checkpoints/henan_512
  while true; do
    python -u -m text2video.cli train-gan "${train_args[@]}" \
      --lambda-adv 0 --lr 5e-4 --steps 1200 --sample-every 300 \
      >> checkpoints/henan_512/train_recon.log 2>&1
    rc=$?; log "recon rc=$rc"; [ $rc -ne 3 ] && break; log "resume..."
  done
fi
if [ ! -d checkpoints/henan_512_recon ]; then
  mkdir -p checkpoints/henan_512_recon
  cp checkpoints/henan_512/config.json checkpoints/henan_512_recon/
  cp -r checkpoints/henan_512/step_00001200 checkpoints/henan_512_recon/
fi

# ---- Stage 2: adversarial segments (200 steps each, snapshot each) -------
for seg in 1400 1600 1800; do
  snap=checkpoints/henan_512_adv$seg
  if [ ! -d "$snap" ]; then
    log "stage 2: adv segment to step $seg"
    while true; do
      python -u -m text2video.cli train-gan "${train_args[@]}" \
        --lambda-adv 0.5 --d-lr-scale 0.25 --lr 1e-4 \
        --steps 200 --sample-every 200 \
        >> checkpoints/henan_512/train_adv.log 2>&1
      rc=$?; log "adv seg $seg rc=$rc"; [ $rc -ne 3 ] && break; log "resume..."
    done
    mkdir -p "$snap"
    cp checkpoints/henan_512/config.json "$snap"/
    cp -r "checkpoints/henan_512/step_0000$seg" "$snap"/
  fi
done

# ---- Stage 3: paired eval + selection ------------------------------------
if [ ! -s out/henan_r5_evals.json ]; then
  log "stage 3: eval sweep (one compile)"
  timeout 3600 python tools/eval_gan_many.py \
    --ckpts checkpoints/henan_512_recon checkpoints/henan_512_adv1400 \
            checkpoints/henan_512_adv1600 checkpoints/henan_512_adv1800 \
    --out-prefix out/eval_r5_ \
    --images "$HIMG" --keypoints "$HKP" \
    --width 896 --height 512 --source-width 1920 --source-height 1080 \
    --split holdout > out/henan_r5_evals.json 2> out/henan_r5_evals.err
  log "evals: $(cat out/henan_r5_evals.json)"
fi
if [ ! -s out/henan_r5_select.json ]; then
  python - <<'PYEOF' | tee out/henan_r5_select.json
import json
cands = ["henan_512_recon", "henan_512_adv1400", "henan_512_adv1600",
         "henan_512_adv1800"]
rows = {c: json.load(open(f"out/eval_r5_{c}_holdout.json")) for c in cands}
base = rows["henan_512_recon"]
best = None
for c in cands:
    r = rows[c]
    if r["psnr_db"] < base["psnr_db"] - 0.3:
        continue
    if best is None or r["mouth_psnr_db"] > rows[best]["mouth_psnr_db"]:
        best = c
print(json.dumps({"selected": best, "rows": rows}))
PYEOF
  sel=$(python -c "import json;print(json.load(open('out/henan_r5_select.json'))['selected'])")
  log "selected: $sel"
  rm -rf checkpoints/henan_512_selected
  cp -r checkpoints/$sel checkpoints/henan_512_selected
fi

# ---- Stage 4: artifact clip from the winner ------------------------------
if ! ls out/render_henan_r5/henan/*.mp4 >/dev/null 2>&1; then
  sel=$(python -c "import json;print(json.load(open('out/henan_r5_select.json'))['selected'])")
  log "stage 4: render clip from $sel"
  timeout 3600 python -u -m text2video.cli tts-chinese \
    "正在为您查询合肥的天气情况" henan f \
    --out out/render_henan_r5 \
    --aligner-model text2video/data/mandarin_henan.am \
    --gan-checkpoint checkpoints/henan_512_selected \
    --tts-pool "$AUD/正在为您查询合肥的天.wav" "正在为您查询合肥的天气情况" \
    > out/render_henan_r5.log 2>&1
  log "render rc=$?"
fi
log "HENAN R5 CHAIN DONE"
