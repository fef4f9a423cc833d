"""GAN training loop: sharded steps, metrics, Orbax checkpoints.

The reference trains vid2vid with ``train.py --dataset_mode pose ...
--gpu_ids 0,...,7 --batchSize 8`` (torch DataParallel; reference:
README.md:169-177). Here: one jitted train step (train/trainer.py) pjit'd
over a ("data", "model") mesh, host-side clip sampling (train/data.py),
wall-clock + loss logging, periodic Orbax saves.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Optional

import jax
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from text2video.parallel.mesh import make_mesh, param_specs
from text2video.train import checkpoints as ckpt
from text2video.train.data import PoseClipDataset
from text2video.train import trainer
from text2video.train.trainer import (
    TrainConfig,
    TrainerState,
    create_trainer_state,
    make_train_step,
)


class _StallWatchdog:
    """Kills the process when training stops making progress.

    A step that never completes (a hung device, collective or input
    pipeline) blocks the loop's sync forever, and no Python-level timeout
    can interrupt it. The watchdog thread exits the process (code 3)
    when no progress is petted within ``timeout`` seconds; combined with
    the loop's checkpoint auto-resume, an outer retry
    (``until train-gan ...; do :; done`` keyed on the exit code) turns a
    stall into a bounded delay instead of a lost run.
    """

    EXIT_CODE = 3

    def __init__(self, timeout: float, log_fn: Callable[[str], None]):
        import threading

        self.timeout = timeout
        self.log_fn = log_fn
        self._lock = threading.Lock()
        # First deadline is generous: compile + dataset upload happen
        # before the first pet.
        self._deadline = time.time() + timeout + 1800.0
        self._stopped = False
        threading.Thread(target=self._run, daemon=True).start()

    def pet(self) -> None:
        with self._lock:
            self._deadline = time.time() + self.timeout

    def stop(self) -> None:
        with self._lock:
            self._stopped = True

    def _run(self) -> None:
        while True:
            time.sleep(5.0)
            with self._lock:
                if self._stopped:
                    return
                if time.time() > self._deadline:
                    self.log_fn(
                        f"watchdog: no training progress in "
                        f"{self.timeout:.0f}s — presumed stalled, "
                        f"exiting {self.EXIT_CODE} for resume"
                    )
                    os._exit(self.EXIT_CODE)


def train_gan(
    dataset: PoseClipDataset,
    cfg: Optional[TrainConfig] = None,
    steps: int = 1000,
    batch_size: int = 2,
    seed: int = 0,
    ckpt_dir: Optional[str] = None,
    save_every: int = 200,
    log_every: int = 10,
    n_data: Optional[int] = None,
    n_model: int = 1,
    device_data: bool = False,
    sample_every: int = 0,
    stall_timeout: float = 0.0,
    vgg_params=None,
    log_fn: Callable[[str], None] = print,
) -> TrainerState:
    """Train the pose2frame GAN; returns the final state.

    device_data=True keeps the whole dataset resident on device as uint8
    (one upload) and gathers clips by index inside the jitted step — the
    host->device traffic per step shrinks to a [B, T] index array. Use
    when the input pipeline can't keep up; the dataset must fit in
    device memory.

    stall_timeout>0 arms a :class:`_StallWatchdog` that exits the
    process when no step completes for that many seconds; rely on
    checkpoint auto-resume to continue.
    """
    w, h = dataset.canvas
    cfg = cfg or TrainConfig(height=h, width=w)
    auto_accum = trainer.safe_grad_accum(cfg, batch_size, dataset.clip_len)
    if auto_accum != cfg.grad_accum:
        log_fn(
            f"grad_accum auto-raised {cfg.grad_accum} -> {auto_accum}: "
            f"batch {batch_size} x clip {dataset.clip_len} at "
            f"{cfg.width}x{cfg.height} crosses the measured NaN hazard "
            "(trainer.safe_grad_accum); micro-batched gradients are "
            "mathematically identical"
        )
        cfg = dataclasses.replace(cfg, grad_accum=auto_accum)
    if n_data is None:
        # Largest divisor of the batch size that fits the device count.
        avail = max(len(jax.devices()) // n_model, 1)
        n_data = max(
            d for d in range(1, avail + 1) if batch_size % d == 0
        )
    mesh = make_mesh(n_data=n_data, n_model=n_model)
    state = create_trainer_state(cfg, seed=seed, vgg_params=vgg_params)
    if ckpt_dir is not None and ckpt.latest_step_dir(ckpt_dir):
        state = ckpt.restore_state(ckpt_dir, state)
        log_fn(f"resumed from step {int(state.step)}")

    step_fn = make_train_step(cfg)

    specs_state = jax.tree.map(lambda _: P(), state)
    specs_state = specs_state.replace(
        g_params=param_specs(state.g_params, mesh),
        d_params=param_specs(state.d_params, mesh),
    )

    def shard(tree):
        return jax.tree.map(
            lambda s: NamedSharding(mesh, s),
            tree,
            is_leaf=lambda x: isinstance(x, P),
        )

    state = jax.device_put(state, shard(specs_state))
    batch_sharding = NamedSharding(mesh, P("data"))

    augment = device_data and (
        cfg.aug_jitter_px > 0
        or cfg.aug_drop_prob > 0
        or cfg.aug_face_drop_prob > 0
        or cfg.aug_scale_crop
    )
    if cfg.aug_scale_crop and not device_data:
        log_fn(
            "aug_scale_crop requires --device-data (labels re-rasterize "
            "on device from the transformed tracks); ignoring the flag"
        )
    if device_data:
        import jax.numpy as jnp

        repl = NamedSharding(mesh, P())
        if augment:
            # Augmented mode: keep keypoint *tracks* resident (tiny) and
            # re-rasterize perturbed label maps inside the step — fresh
            # augmentation noise every step, no label upload at all
            # (train/augment.py; reference keypoint2img.py:119-123).
            from text2video.ops.rasterize import (
                _rasterize_chunk,
                _round_up,
            )
            from text2video.train.augment import augment_tracks

            reals_u8, centers_np = dataset.flat_reals_centers()
            tracks = [
                jax.device_put(x, repl)
                for x in dataset.flat_track_arrays()
            ]
            w, h = dataset.canvas
            n_samples = _round_up(max(w, h), 128)
            reals_all = jax.device_put(reals_u8, repl)
            centers_all = jax.device_put(centers_np, repl)
            log_fn(
                f"device-resident dataset (augmented): "
                f"{reals_u8.nbytes / 1e6:.0f} MB frames + keypoint tracks; "
                "labels rasterize on device per step"
            )

            from text2video.train.augment import (
                make_scale_crop_branches,
                scale_crop_scales,
                scale_crop_transform_track,
            )

            def gather_step_aug(st, fa, pa, hl, hr, ra, ca, idx, key):
                b, t = idx.shape
                flat = idx.reshape(-1)
                key, key_sc = jax.random.split(key)
                f, p, l, r = augment_tracks(
                    fa[flat], pa[flat], hl[flat], hr[flat], key,
                    drop_prob=cfg.aug_drop_prob,
                    jitter_px=cfg.aug_jitter_px,
                    face_drop_prob=cfg.aug_face_drop_prob,
                )
                to_f = lambda x: x.astype(jnp.float32) / 127.5 - 1.0
                reals_f = to_f(ra[idx])
                centers = ca[idx]
                if cfg.aug_scale_crop:
                    # Random zoom + aligned crop (reference
                    # randomScaleHeight_and_scaledCrop): one scale per
                    # step (lax.switch branch), per-sample crop offsets;
                    # keypoint tracks and face centers get the SAME
                    # affine so the pair stays registered
                    # (tests/test_augment.py).
                    scales = scale_crop_scales(cfg.aug_scale_max)
                    kb, ko = jax.random.split(key_sc)
                    si = jax.random.randint(kb, (), 0, len(scales))
                    u = jax.random.uniform(ko, (b, 2))
                    reals_f, off, s = jax.lax.switch(
                        si,
                        make_scale_crop_branches(b, t, h, w, scales),
                        reals_f, u,
                    )
                    off_flat = jnp.repeat(off, t, axis=0)[:, None, :]
                    f = scale_crop_transform_track(f, 70, s, off_flat, h, w)
                    p = scale_crop_transform_track(p, 25, s, off_flat, h, w)
                    l = scale_crop_transform_track(l, 21, s, off_flat, h, w)
                    r = scale_crop_transform_track(r, 21, s, off_flat, h, w)
                    centers = centers * s + (s - 1.0) / 2.0 - off[:, None, :]
                labels_u8 = _rasterize_chunk(
                    f, p, l, r, width=w, height=h, n_samples=n_samples
                )
                batch = {
                    "labels": jax.lax.with_sharding_constraint(
                        to_f(labels_u8).reshape(b, t, h, w, 3),
                        batch_sharding,
                    ),
                    "reals": jax.lax.with_sharding_constraint(
                        reals_f, batch_sharding
                    ),
                    "face_centers": jax.lax.with_sharding_constraint(
                        centers, batch_sharding
                    ),
                }
                return step_fn(st, batch)

            jit_step = jax.jit(
                gather_step_aug,
                in_shardings=(
                    shard(specs_state),
                    repl, repl, repl, repl, repl, repl, None, None,
                ),
                out_shardings=(shard(specs_state), None),
                donate_argnums=(0,),
            )
            aug_key = jax.random.PRNGKey(seed + 1)
        else:
            labels_u8, reals_u8, centers_np = dataset.flat_arrays()
            labels_all = jax.device_put(labels_u8, repl)
            reals_all = jax.device_put(reals_u8, repl)
            centers_all = jax.device_put(centers_np, repl)
            log_fn(
                f"device-resident dataset: {labels_u8.nbytes / 1e6:.0f} MB "
                f"labels + {reals_u8.nbytes / 1e6:.0f} MB frames uploaded "
                "once"
            )

            def gather_step(st, la, ra, ca, idx):
                to_f = lambda x: x.astype(jnp.float32) / 127.5 - 1.0
                batch = {
                    "labels": jax.lax.with_sharding_constraint(
                        to_f(la[idx]), batch_sharding
                    ),
                    "reals": jax.lax.with_sharding_constraint(
                        to_f(ra[idx]), batch_sharding
                    ),
                    "face_centers": jax.lax.with_sharding_constraint(
                        ca[idx], batch_sharding
                    ),
                }
                return step_fn(st, batch)

            jit_step = jax.jit(
                gather_step,
                in_shardings=(shard(specs_state), repl, repl, repl, None),
                out_shardings=(shard(specs_state), None),
                donate_argnums=(0,),
            )
    else:
        jit_step = jax.jit(
            step_fn,
            in_shardings=(shard(specs_state), None),
            out_shardings=(shard(specs_state), None),
            donate_argnums=(0,),
        )

    # Visual training snapshots (the role of vid2vid's HTML snapshot
    # pages): render one fixed clip with the current generator and write a
    # [real | fake | label] strip next to the checkpoints.
    sample_fn = None
    sample_batch = None
    if sample_every > 0 and ckpt_dir is not None:
        from text2video.train.trainer import _generate_clip, _models

        gen = _models(cfg)[0]
        sample_batch = dataset.batch(np.random.RandomState(123), 1)

        def _sample(g_params, labels, reals):
            fakes, _ = _generate_clip(gen, cfg, g_params, labels, reals)
            return fakes

        sample_fn = jax.jit(_sample)

    def save_snapshot(step_num: int) -> None:
        import cv2  # noqa: PLC0415

        fakes = np.asarray(
            sample_fn(
                state.g_params,
                sample_batch["labels"],
                sample_batch["reals"],
            )
        )

        def to_u8(x):
            return np.clip((x + 1.0) * 127.5, 0, 255).astype(np.uint8)

        strip = np.concatenate(
            [
                np.concatenate(list(to_u8(sample_batch["reals"][0])), axis=1),
                np.concatenate(list(to_u8(fakes[0])), axis=1),
                np.concatenate(list(to_u8(sample_batch["labels"][0])), axis=1),
            ],
            axis=0,
        )
        os.makedirs(ckpt_dir, exist_ok=True)
        cv2.imwrite(
            os.path.join(ckpt_dir, f"sample_{step_num:08d}.jpg"),
            cv2.cvtColor(strip, cv2.COLOR_RGB2BGR),
        )

    rng = np.random.RandomState(seed)
    t0 = time.time()
    frames_done = 0
    last_saved = -1
    watchdog = (
        _StallWatchdog(stall_timeout, log_fn) if stall_timeout > 0 else None
    )
    for i in range(steps):
        if augment:
            idx = np.stack(
                [dataset.sample_clip_indices(rng) for _ in range(batch_size)]
            )
            state, metrics = jit_step(
                state, *tracks, reals_all, centers_all, idx,
                jax.random.fold_in(aug_key, i),
            )
        elif device_data:
            idx = np.stack(
                [dataset.sample_clip_indices(rng) for _ in range(batch_size)]
            )
            state, metrics = jit_step(
                state, labels_all, reals_all, centers_all, idx
            )
        else:
            batch = dataset.batch(
                rng, batch_size,
                with_flow=cfg.flow_supervision == "reference",
            )
            batch = jax.device_put(batch, batch_sharding)
            state, metrics = jit_step(state, batch)
        frames_done += batch_size * dataset.clip_len
        if (i + 1) % log_every == 0:
            m = {k: float(v) for k, v in metrics.items()}
            dt = time.time() - t0
            log_fn(
                f"step {int(state.step)}: "
                + " ".join(f"{k}={v:.4f}" for k, v in sorted(m.items()))
                + f" | {frames_done / dt:.1f} frames/s"
            )
            if watchdog is not None:
                watchdog.pet()  # the float() above is the sync point
        if sample_fn is not None and (i + 1) % sample_every == 0:
            save_snapshot(int(state.step))
        if ckpt_dir is not None and (i + 1) % save_every == 0:
            ckpt.save_state(ckpt_dir, jax.device_get(state), cfg)
            last_saved = int(state.step)
    if ckpt_dir is not None and int(state.step) != last_saved:
        ckpt.save_state(ckpt_dir, jax.device_get(state), cfg)
    if watchdog is not None:
        watchdog.stop()
    return state
