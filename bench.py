"""Benchmarks for the pose2frame stack on one GPU.

Default mode measures on-device autoregressive generation throughput at
the reference's 512-class resolution (BASELINE.md): the reference
renderer ran vid2vid test.py frame-by-frame on one GPU (reference:
text2video_audio.sh:42) with no published numbers, so the baseline bar is
real-time playback at 25 fps (align_english.py:34).
Prints ONE JSON line naming the device it ran on: {"metric", "value",
"unit", "vs_baseline", "device": {platform, kind, count, card}, ...}.
Refuses to run without a GPU.

Other modes:
  --mode e2e     full text->video wall clock for a ~10 s utterance on the
                 committed fadg0 identity (TTS -> alignment -> pose ->
                 rasterize -> GAN -> mux), warm.
  --mode batch   generation throughput with B=4 utterances batched.
  --mode jacobi  Jacobi parallel decoding throughput.
"""

import argparse
import json
import os
import time

# Single-CPU hosts: unbounded BLAS thread pools oversubscribe and
# multiply host-side matmul cost ~100x. Must be set before numpy loads.
os.environ.setdefault("OPENBLAS_NUM_THREADS", "1")
os.environ.setdefault("OMP_NUM_THREADS", "1")

import numpy as np

BASELINE_FPS = 25.0  # real-time at the reference's output frame rate
H, W = 384, 512
# 256 frames ~= a 10 s utterance at 25 fps — representative of the
# reference's real workload (<=1200-frame runs).
T = 256
TIMED_RUNS = 3
# Dense peak rates by jax device_kind. Source: NVIDIA H100 SXM data sheet
# (dense, no sparsity), at the card's full 700 W power limit.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "hbm_bytes_s": 3.35e12},
}


def peak(kind: str) -> dict:
    """Peak rates of ``kind``; an unknown device is an error."""
    if kind not in PEAKS:
        raise KeyError(f"no peak rates for device kind {kind!r}")
    return PEAKS[kind]


def _device() -> dict:
    import jax

    from text2video.runtime import card_name_and_power_limit, require_gpu

    dev = require_gpu()
    return {
        "platform": dev.platform,
        "kind": dev.device_kind,
        "count": len(jax.devices()),
        "card": card_name_and_power_limit().splitlines()[0],
    }


def _analytic_frame_flops(
    h: int,
    w: int,
    base_ch: int = 64,
    n_downsample: int = 3,
    n_blocks: int = 9,
    label_ch: int = 9,
    prev_ch: int = 6,
) -> float:
    """Closed-form conv FLOPs of one CompositeGenerator forward: every
    conv at 2*H*W*Cin*Cout*K^2; elementwise/norm/warp work is <1% and
    ignored."""
    mac = 0.0
    ch = base_ch
    mac += h * w * (label_ch + prev_ch) * ch * 49  # 7x7 stem
    hh, ww = h, w
    for _ in range(n_downsample):
        hh, ww = hh // 2, ww // 2
        mac += hh * ww * ch * (2 * ch) * 9
        ch *= 2
    mac += n_blocks * 2 * (hh * ww * ch * ch * 9)
    for _ in range(n_downsample):
        hh, ww = hh * 2, ww * 2
        mac += hh * ww * ch * (ch // 2) * 9
        ch //= 2
    mac += h * w * ch * 6 * 49  # merged heads, 7x7
    return 2.0 * mac


def _measure_gen(renderer, batch: int) -> float:
    """Warm + timed chunked autoregressive generation; returns fps."""
    import jax
    import jax.numpy as jnp

    rng = np.random.RandomState(0)
    labels_u8 = rng.randint(0, 256, size=(batch, T, H, W, 3), dtype=np.uint8)
    labels = jnp.asarray(labels_u8.astype(np.float32) / 127.5 - 1.0)

    def generate_once() -> None:
        jax.block_until_ready(renderer.generate_device(labels))

    generate_once()  # compile + warm
    times = []
    for _ in range(TIMED_RUNS):
        t0 = time.perf_counter()
        generate_once()
        times.append(time.perf_counter() - t0)
    return batch * T / min(times)


def _gen_bench(batch: int, with_extras: bool = False) -> None:
    from text2video.render import Renderer

    device = _device()
    flops = peak(device["kind"])["bf16_flops"]
    renderer = Renderer.create(height=H, width=W)
    renderer.time_bucket = 128
    fps = _measure_gen(renderer, batch)
    frame_flops = _analytic_frame_flops(H, W)

    def mfu(f: float) -> float:
        return round(frame_flops * f / flops, 4)

    suffix = "" if batch == 1 else f"_b{batch}"
    line = {
        "metric": f"pose2frame_generation_fps_512x384{suffix}",
        "value": round(fps, 2),
        "unit": "frames/sec",
        "vs_baseline": round(fps / BASELINE_FPS, 3),
        "mfu": mfu(fps),
        "flops_per_frame": round(frame_flops),
        "device": device,
    }
    if with_extras:
        # The batch-1 scan is the latency config; batched serving
        # (run_audio_batch: 4 utterances as one scan) is the throughput
        # config. Report both on one line.
        renderer.time_bucket = 64
        fps4 = _measure_gen(renderer, 4)
        line["batch4"] = {
            "fps": round(fps4, 2),
            "vs_baseline": round(fps4 / BASELINE_FPS, 3),
            "mfu": mfu(fps4),
        }
    print(json.dumps(line))


def _jacobi_bench(sweeps: int) -> None:
    """Jacobi parallel decoding throughput: k batched whole-timeline
    sweeps instead of the sequential scan (render.py::render_jacobi).
    Trades sweeps x FLOPs for wide batches; reports output fps plus both
    useful MFU (delivered frames) and executed MFU (all sweeps)."""
    import jax.numpy as jnp

    from text2video.render import Renderer

    device = _device()
    flops = peak(device["kind"])["bf16_flops"]
    renderer = Renderer.create(height=H, width=W)
    rng = np.random.RandomState(0)
    labels_u8 = rng.randint(0, 256, size=(T, H, W, 3), dtype=np.uint8)
    labels = jnp.asarray(labels_u8.astype(np.float32) / 127.5 - 1.0)

    def once() -> None:
        renderer.jacobi_device(labels, sweeps).block_until_ready()

    once()  # compile + warm
    times = []
    for _ in range(TIMED_RUNS):
        t0 = time.perf_counter()
        once()
        times.append(time.perf_counter() - t0)

    fps = T / min(times)
    frame_flops = _analytic_frame_flops(H, W)
    print(
        json.dumps(
            {
                "metric": f"pose2frame_jacobi{sweeps}_fps_512x384",
                "value": round(fps, 2),
                "unit": "frames/sec",
                "vs_baseline": round(fps / BASELINE_FPS, 3),
                "mfu": round(frame_flops * fps / flops, 4),
                "mfu_executed": round(
                    sweeps * frame_flops * fps / flops, 4
                ),
                "device": device,
            }
        )
    )


def _e2e_bench(load_size: int = 0, bucket: int = 0) -> None:
    """Full pipeline on a ~10 s utterance, warm wall clock vs real time.

    load_size > 0 measures a square canvas of that size (512 = the
    BASELINE.md north star exactly; the fadg0 profile's native canvas is
    512x384, so square runs scale its keypoints onto the square canvas).
    load_size 0/None keeps the native 512x384 shape."""
    import dataclasses
    import tempfile

    from text2video.config import PipelineConfig, get_profile
    from text2video.frontend.tts import FormantTTS
    from text2video.pipeline import Text2VideoPipeline
    from text2video.render import Renderer
    from text2video.testing import SA1_TEXT, english_aligner, write_identity

    device = _device()
    text = SA1_TEXT + " " + SA1_TEXT  # ~10 s of synthetic speech
    audio = FormantTTS().synthesize(text, 16000)
    dur_s = len(audio) / 16000.0

    h, w = (load_size, load_size) if load_size else (H, W)
    with tempfile.TemporaryDirectory() as tmp:
        identity = write_identity(os.path.join(tmp, "identity"))
        aligner = english_aligner(identity)
        profile = get_profile("fadg0", data_dir=identity)
        if load_size:
            profile = dataclasses.replace(profile, canvas=(w, h))
        renderer = Renderer.create(height=h, width=w)
        if bucket:
            renderer.time_bucket = bucket
        pipe = Text2VideoPipeline(
            PipelineConfig(person=profile, out_dir=tmp),
            renderer=renderer,
            aligner=aligner,
        )
        res = aligner.align(audio, text)

        def once():
            return pipe.synthesize(res.phones, "bench", audio=audio)

        once()  # compile + warm
        walls, runs = [], []
        for _ in range(2):
            t0 = time.perf_counter()
            runs.append(once())
            walls.append(time.perf_counter() - t0)
        wall = min(walls)
        run = runs[walls.index(wall)]

    clip_s = run.num_frames / 25.0
    print(
        json.dumps(
            {
                "metric": f"e2e_text2video_realtime_factor_{w}x{h}",
                "value": round(clip_s / wall, 3),
                "unit": "x realtime (audio %.1fs, video %.1fs, wall %.2fs)"
                % (dur_s, clip_s, wall),
                "vs_baseline": round(clip_s / wall, 3),
                "stage_seconds": {
                    k: round(v, 3)
                    for k, v in (run.stage_seconds or {}).items()
                },
                "device": device,
            }
        )
    )


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument(
        "--mode", choices=["gen", "e2e", "batch", "jacobi"], default="gen"
    )
    parser.add_argument("--bucket", type=int, default=0,
                        help="e2e mode: override renderer.time_bucket")
    parser.add_argument("--sweeps", type=int, default=2)
    parser.add_argument(
        "--load-size", type=int, default=None,
        help="e2e mode: square canvas at this size (512 = BASELINE.md "
        "north-star shape exactly; omit for the native 512x384)",
    )
    args = parser.parse_args()
    from text2video.runtime import use_compile_cache

    use_compile_cache()
    if args.mode == "gen":
        _gen_bench(batch=1, with_extras=True)
    elif args.mode == "batch":
        _gen_bench(batch=4)
    elif args.mode == "jacobi":
        _jacobi_bench(args.sweeps)
    else:
        _e2e_bench(load_size=args.load_size or 0, bucket=args.bucket)


if __name__ == "__main__":
    main()
