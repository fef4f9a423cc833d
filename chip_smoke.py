"""Smoke test of text2video on an NVIDIA GPU: the main path end to end at
full model width, every device path checked against its plain reference.

    python chip_smoke.py             # one card: all one-card phases
    python chip_smoke.py --cards 4   # four cards: data-parallel serving
                                     # and training against one card

Phases (one card, one process): device, e2e (text -> FormantTTS ->
native aligner -> pose -> device rasterizer -> generator scan -> frame
wire -> native JPEG -> MP4/AVI, cold then warm), correctness (generator
against its float32 reference, rasterizer against the host path, device
pose against host pose), batched + Jacobi, train, modules. The model is
the shipped CompositeGenerator (base 64, 9 resblocks, bf16) at 512x384
with random weights from a seed; the identity is the committed fadg0
fixture (text2video/testing.py). Any failed check raises, so the process
exits non-zero. The last stdout line is the JSON result; nothing is
printed as a result without a GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import struct
import sys
import time

import numpy as np

T_BATCH = 128  # frames per utterance in the batched and Jacobi phases
SEED = 0
# The shipped generator's width and depth (render.py, Renderer.create
# defaults) and the trainer's defaults at the same width.
MODEL = dict(base_ch=64, n_blocks=9)
TRAIN = dict(height=384, width=512)


def log(phase: str, **kv) -> None:
    items = " ".join(f"{k}={v}" for k, v in kv.items())
    print(f"[{phase}] {items}", flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def mp4_sample_count(path: str) -> int:
    """Sample count of the MP4's single track (its ``stsz`` box)."""
    with open(path, "rb") as f:
        data = f.read()
    i = data.find(b"stsz")
    check(i >= 0, f"{path}: no stsz box")
    return struct.unpack(">I", data[i + 12 : i + 16])[0]


def _mean_abs(a, b) -> float:
    return float(np.mean(np.abs(np.asarray(a, np.float32)
                                - np.asarray(b, np.float32))))


def _ssim(a, b) -> float:
    """Global SSIM of two uint8 images (tests/test_rasterize.py's form)."""
    a = a.astype(np.float64)
    b = b.astype(np.float64)
    mu_a, mu_b = a.mean(), b.mean()
    cov = ((a - mu_a) * (b - mu_b)).mean()
    c1, c2 = (0.01 * 255) ** 2, (0.03 * 255) ** 2
    return ((2 * mu_a * mu_b + c1) * (2 * cov + c2)) / (
        (mu_a**2 + mu_b**2 + c1) * (a.var() + b.var() + c2)
    )


class Smoke:
    def __init__(self, card: str):
        from text2video.render import Renderer
        from text2video.runtime import REPO_ROOT
        from text2video.testing import english_aligner, write_identity

        self.card = card
        self.work = os.path.join(REPO_ROOT, "out", "chip_smoke")
        shutil.rmtree(self.work, ignore_errors=True)
        self.identity = write_identity(os.path.join(self.work, "identity"))
        self.aligner = english_aligner(self.identity)
        self.renderer = Renderer.create(height=384, width=512, seed=SEED,
                                        **MODEL)
        self.e_prod = None  # generator mean |prod - ref|, set by correctness

    # ---- e2e -----------------------------------------------------------

    def e2e(self):
        from text2video.config import PipelineConfig, get_profile
        from text2video.io import wire_native
        from text2video.pipeline import Text2VideoPipeline
        from text2video.testing import SA1_TEXT

        self.profile = get_profile("fadg0", data_dir=self.identity)
        pipe = Text2VideoPipeline(
            PipelineConfig(person=self.profile,
                           out_dir=os.path.join(self.work, "e2e")),
            renderer=self.renderer,
            aligner=self.aligner,
        )
        self.pipe = pipe
        text = SA1_TEXT + " " + SA1_TEXT
        for label in ("cold", "warm"):
            t0 = time.perf_counter()
            run = pipe.run_tts(text, "f")
            wall = time.perf_counter() - t0
            stages = {k: round(v, 4) for k, v in run.stage_seconds.items()}
            log("e2e", run=label, wall_s=round(wall, 3),
                frames=run.num_frames,
                video_s=round(run.num_frames / self.profile.fps, 2),
                stage_seconds=json.dumps(stages), card=f'"{self.card}"')
        exts = {os.path.splitext(f)[1] for f in run.files}
        check({".mp4", ".wav", ".avi"} <= exts, f"missing outputs: {exts}")
        for f in run.files:
            check(os.path.getsize(f) > 0, f"empty output {f}")
        mp4 = [f for f in run.files if f.endswith(".mp4")][0]
        n = mp4_sample_count(mp4)
        check(n == run.num_frames, f"mp4 has {n} samples, run {run.num_frames}")
        # The streamed dct path hands coefficients to the native codec;
        # the yuv/cv2 route would record a host-side render_decode stage.
        native = (wire_native._lib is not None
                  and "render_decode" not in run.stage_seconds
                  and "render_pull" in run.stage_seconds)
        check(native, "streamed path did not use the native codec")
        log("e2e", ok=True, mp4_samples=n, native_codec=native)
        # The same (deterministic) speech again, for the pose checks.
        self.ts = self.aligner.align(_tts(text), text).phones

    # ---- correctness at full width -------------------------------------

    def correctness(self):
        import jax
        import jax.numpy as jnp

        from text2video.models.generator import CompositeGenerator
        from text2video.ops.rasterize import (
            rasterize_batch,
            rasterize_frame_host,
        )

        r = self.renderer
        gen = r.generator
        rng = np.random.RandomState(SEED)
        lab = jnp.asarray(rng.uniform(-1, 1, (1, 384, 512, 9)), jnp.float32)
        prev = jnp.asarray(rng.uniform(-1, 1, (1, 384, 512, 6)), jnp.float32)
        hp = jnp.ones((1,), jnp.float32)
        ref_gen = CompositeGenerator(dtype=jnp.float32, phase_form=False,
                                     **MODEL)
        plain_bf16 = CompositeGenerator(dtype=jnp.bfloat16, phase_form=False,
                                        **MODEL)
        prod = jax.jit(gen.apply)(r.params, lab, prev, hp)[0]
        plain = jax.jit(plain_bf16.apply)(r.params, lab, prev, hp)[0]
        with jax.default_matmul_precision("highest"):
            ref = jax.jit(ref_gen.apply)(r.params, lab, prev, hp)[0]
        e_prod = _mean_abs(prod, ref)
        e_plain = _mean_abs(plain, ref)
        e_max = float(np.max(np.abs(np.asarray(prod, np.float32)
                                    - np.asarray(ref))))
        log("correctness", check="generator", mean_abs_prod_ref=e_prod,
            mean_abs_plain_bf16_ref=e_plain, max_abs_prod_ref=e_max,
            bound=3 * e_plain + 1e-3)
        check(np.isfinite(np.asarray(prod, np.float32)).all(),
              "generator output not finite")
        check(e_prod <= 3 * e_plain + 1e-3,
              f"generator: {e_prod} > 3 * {e_plain} + 1e-3")
        self.e_prod = e_prod

        # Pose: device (float32 XLA) against host (float64), and timings.
        stage = self.pipe.pose_stage
        host = stage.run(self.ts, device=False)
        dev = stage.run(self.ts, device=True)  # compile
        t0 = time.perf_counter()
        host = stage.run(self.ts, device=False)
        t_host = time.perf_counter() - t0
        t0 = time.perf_counter()
        dev = stage.run(self.ts, device=True)
        t_dev = time.perf_counter() - t0
        err = max(
            float(np.max(np.abs(a - b)))
            for a, b in ((dev.face, host.face), (dev.pose, host.pose),
                         (dev.face_smooth, host.face_smooth),
                         (dev.pose_smooth, host.pose_smooth))
        )
        log("correctness", check="pose", frames=host.num_frames,
            max_abs_px=err, host_s=round(t_host, 5),
            device_s=round(t_dev, 5))
        check(err <= 1e-3, f"pose device/host {err} px > 1e-3")

        # Rasterizer: device against the host path, and run to run.
        hands = stage.table.hands[host.plan.carrier]
        args = (host.face_smooth, host.pose_smooth, hands[:, 0],
                hands[:, 1], self.profile.canvas)
        a = rasterize_batch(*args, chunk=r.time_bucket)
        b = rasterize_batch(*args, chunk=r.time_bucket)
        check(np.array_equal(a, b), "device rasterizer not deterministic")
        ssims = []
        for t in range(a.shape[0]):
            want = rasterize_frame_host(
                args[0][t], args[1][t], args[2][t], args[3][t], args[4]
            )
            ssims.append(_ssim(a[t], want))
        log("correctness", check="rasterizer", frames=a.shape[0],
            min_ssim=round(min(ssims), 5), byte_equal_runs=True)
        check(min(ssims) >= 0.96, f"rasterizer SSIM {min(ssims)} < 0.96")
        self.labels_u8 = a

    # ---- batched + Jacobi ----------------------------------------------

    def batched(self):
        import jax
        import jax.numpy as jnp

        r = self.renderer
        gen = r.generator
        rng = np.random.RandomState(SEED + 1)
        lab = jnp.asarray(rng.uniform(-1, 1, (4, 384, 512, 9)), jnp.float32)
        prev = jnp.asarray(rng.uniform(-1, 1, (4, 384, 512, 6)), jnp.float32)
        hp = jnp.ones((4,), jnp.float32)
        fwd = jax.jit(gen.apply)
        b4 = np.asarray(fwd(r.params, lab, prev, hp)[0], np.float32)
        rows = [
            _mean_abs(b4[i], fwd(r.params, lab[i:i + 1], prev[i:i + 1],
                                 hp[i:i + 1])[0][0])
            for i in range(4)
        ]
        log("batched", check="batch4_vs_batch1_forward",
            mean_abs_rows=rows, bound=self.e_prod)
        check(max(rows) <= self.e_prod,
              f"batch-4 rows differ from batch-1 by {rows} > {self.e_prod}")

        # Four windows of the e2e utterance's label maps.
        t = self.labels_u8.shape[0]
        check(t >= T_BATCH, f"utterance has {t} < {T_BATCH} frames")
        step = (t - T_BATCH) // 3
        labels = np.stack(
            [self.labels_u8[i * step : i * step + T_BATCH] for i in range(4)]
        )
        for label in ("cold", "warm"):
            t0 = time.perf_counter()
            frames = r.render_many(labels)
            wall = time.perf_counter() - t0
            log("batched", run=label, batch=4, frames=T_BATCH,
                wall_s=round(wall, 3),
                ms_per_frame=round(1e3 * wall / (4 * T_BATCH), 3),
                card=f'"{self.card}"')
        check(frames.shape == labels.shape, f"render_many {frames.shape}")

        norm = jnp.asarray(labels[0].astype(np.float32) / 127.5 - 1.0)
        for label in ("cold", "warm"):
            t0 = time.perf_counter()
            out = r.jacobi_device(norm, 2).block_until_ready()
            wall = time.perf_counter() - t0
            log("jacobi", run=label, sweeps=2, frames=T_BATCH,
                wall_s=round(wall, 3),
                ms_per_frame=round(1e3 * wall / T_BATCH, 3),
                card=f'"{self.card}"')
        check(bool(jnp.isfinite(out).all()), "jacobi frames not finite")

    # ---- train ---------------------------------------------------------

    def train(self):
        import jax

        from text2video.train.trainer import (
            TrainConfig,
            create_trainer_state,
            make_train_step,
        )

        cfg = TrainConfig(**TRAIN)
        state = create_trainer_state(cfg, seed=SEED)
        step = jax.jit(make_train_step(cfg), donate_argnums=(0,))
        batch = _train_batch(1, 4, SEED)
        for i in range(2):
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            g, d = float(metrics["g_loss"]), float(metrics["d_loss"])
            wall = time.perf_counter() - t0
            log("train", step=i, g_loss=g, d_loss=d, wall_s=round(wall, 3),
                card=f'"{self.card}"')
            check(np.isfinite(g) and np.isfinite(d), f"losses {g}, {d}")


def _tts(text: str):
    from text2video.frontend.audio import ALIGN_SAMPLE_RATE
    from text2video.frontend.tts import FormantTTS

    return FormantTTS().synthesize(text, ALIGN_SAMPLE_RATE)


def _train_batch(b: int, t: int, seed: int) -> dict:
    rng = np.random.RandomState(seed)
    return {
        "labels": rng.uniform(-1, 1, (b, t, 384, 512, 3)).astype(np.float32),
        "reals": rng.uniform(-1, 1, (b, t, 384, 512, 3)).astype(np.float32),
        "face_centers": np.full((b, t, 2), (256.0, 250.0), np.float32),
    }


def four_cards(card: str) -> None:
    """Data-parallel batched serving and training on four cards, each
    against the same work on one card."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from text2video.config import PipelineConfig, get_profile
    from text2video.models.generator import CompositeGenerator
    from text2video.parallel.mesh import make_mesh
    from text2video.pipeline import Text2VideoPipeline
    from text2video.frontend.audio import ALIGN_SAMPLE_RATE, save_wav
    from text2video.render import Renderer
    from text2video.runtime import REPO_ROOT
    from text2video.testing import english_aligner, write_identity
    from text2video.train.trainer import (
        TrainConfig,
        create_trainer_state,
        make_train_step,
    )

    check(len(jax.devices()) >= 4, f"need 4 GPUs, have {jax.devices()}")
    mesh = make_mesh(n_data=4)
    data, repl = NamedSharding(mesh, P("data")), NamedSharding(mesh, P())
    r = Renderer.create(height=384, width=512, seed=SEED, **MODEL)
    gen = r.generator

    # Per-forward check: the batch sharded over four cards against the
    # same batch on one card, bounded by the bf16 generator's own error
    # against its float32 reference.
    rng = np.random.RandomState(SEED + 1)
    lab = jnp.asarray(rng.uniform(-1, 1, (4, 384, 512, 9)), jnp.float32)
    prev = jnp.asarray(rng.uniform(-1, 1, (4, 384, 512, 6)), jnp.float32)
    hp = jnp.ones((4,), jnp.float32)
    one = np.asarray(jax.jit(gen.apply)(r.params, lab, prev, hp)[0],
                     np.float32)
    with jax.default_matmul_precision("highest"):
        ref = jax.jit(CompositeGenerator(
            dtype=jnp.float32, phase_form=False, **MODEL).apply)(
                r.params, lab[:1], prev[:1], hp[:1])[0]
    bound = _mean_abs(one[:1], ref)
    four = jax.jit(gen.apply)(
        jax.device_put(r.params, repl), jax.device_put(lab, data),
        jax.device_put(prev, data), jax.device_put(hp, data))[0]
    rows = [_mean_abs(np.asarray(four[i], np.float32), one[i])
            for i in range(4)]
    log("cards4", check="sharded_forward_vs_one_card", mean_abs_rows=rows,
        bound=bound)
    check(max(rows) <= bound, f"sharded forward rows {rows} > {bound}")

    # Batched serving through the pipeline: 4 utterances, 4 cards vs 1.
    work = os.path.join(REPO_ROOT, "out", "chip_smoke4")
    shutil.rmtree(work, ignore_errors=True)
    identity = write_identity(os.path.join(work, "identity"))
    pipe = Text2VideoPipeline(
        PipelineConfig(person=get_profile("fadg0", data_dir=identity),
                       out_dir=os.path.join(work, "out")),
        renderer=r,
        aligner=english_aligner(identity),
    )
    texts = [
        "She had your dark suit in greasy wash water all year",
        "Do they make it",
        "She slipped and sprained her ankle",
        "Don't ask me to carry an oily rag like that",
    ]
    items = []
    for i, text in enumerate(texts):
        path = os.path.join(work, f"utt{i}.wav")
        save_wav(path, _tts(text), ALIGN_SAMPLE_RATE)
        items.append((text, path))
    for name, m in (("cards4", mesh), ("cards1", None)):
        for label in ("cold", "warm"):
            t0 = time.perf_counter()
            res = pipe.run_audio_batch(items, mesh=m)
            wall = time.perf_counter() - t0
            frames = sum(x.num_frames for x in res)
            log(name, run=label, path="run_audio_batch", utterances=4,
                frames=frames, wall_s=round(wall, 3),
                render_s=round(res[0].stage_seconds["render"], 3),
                card=f'"{card}"')
        check(all(os.path.getsize(f) > 0 for x in res for f in x.files),
              "empty batch outputs")

    # One data-parallel train step: global batch 4 on 4 cards vs 1 card.
    cfg = TrainConfig(**TRAIN)
    batch = _train_batch(4, 4, SEED)
    step = make_train_step(cfg)
    losses = {}
    for name, m in (("cards1", None), ("cards4", mesh)):
        state = create_trainer_state(cfg, seed=SEED)
        if m is None:
            fn = jax.jit(step)
            args = (state, batch)
        else:
            fn = jax.jit(step, in_shardings=(repl, data),
                         out_shardings=(repl, None))
            args = (jax.device_put(state, repl),
                    jax.device_put(batch, data))
        t0 = time.perf_counter()
        _, metrics = fn(*args)
        g, d = float(metrics["g_loss"]), float(metrics["d_loss"])
        losses[name] = (g, d)
        log(name, path="train_step", g_loss=g, d_loss=d,
            wall_s=round(time.perf_counter() - t0, 3), card=f'"{card}"')
    (g1, d1), (g4, d4) = losses["cards1"], losses["cards4"]
    rel = max(abs(g4 - g1) / abs(g1), abs(d4 - d1) / abs(d1))
    log("cards4", check="train_step_vs_one_card", max_rel_diff=rel)
    check(rel <= 1e-2, f"4-card losses {losses} differ by {rel}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--cards", type=int, choices=(1, 4), default=1)
    args = parser.parse_args(argv)

    from text2video import runtime

    allowed = runtime.import_allowed()
    dev = runtime.require_gpu()
    import jax

    cache = runtime.use_compile_cache()
    card = runtime.card_name_and_power_limit().splitlines()[0]
    log("device", nvidia_smi=f'"{card}"', device_kind=f'"{dev.device_kind}"',
        count=len(jax.devices()), jax=jax.__version__, compile_cache=cache)

    if args.cards == 4:
        four_cards(card)
    else:
        smoke = Smoke(card)
        smoke.e2e()
        smoke.correctness()
        smoke.batched()
        smoke.train()

    loaded = runtime.third_party_modules()
    foreign = runtime.foreign_modules(allowed)
    log("modules", third_party=",".join(loaded), outside_allowed=foreign)
    check(not foreign, f"loaded modules outside the allowed set: {foreign}")

    print(runtime.card_name_and_power_limit().splitlines()[0], flush=True)
    print(json.dumps({
        "ok": True,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
